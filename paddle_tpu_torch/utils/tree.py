"""Nested dicts and lists of tensors (parameter, gradient, optimizer and
cache trees): the pytree helpers the port needs, and ``value_and_grad``
for training steps written outside ``trainer.SGD`` (JAX's
``jax.value_and_grad`` over a parameter tree)."""


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``
    (same structure; dicts matched by key), keeping the structure.  Lists
    and tuples come back as lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def value_and_grad(fn, params):
    """``(fn(params), gradient tree)``: the scalar ``fn`` of the tree and
    its gradient with respect to every leaf, as ``jax.value_and_grad``
    gives it -- zeros for a leaf ``fn`` does not read.  Marks the leaves
    as requiring grad."""
    import torch
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    value = fn(params)
    grads = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, torch.autograd.grad(
                 value, leaves, allow_unused=True))}
    return value.detach(), tree_map(lambda p: grads[id(p)], params)
