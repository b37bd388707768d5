"""Finite-difference gradient checking (``paddle_tpu/testing/
gradcheck.py``).

Reference: the `--job=checkgrad` trainer mode (trainer/Trainer.cpp
checkGradient) and the per-layer numerical sweeps of
gserver/tests/test_LayerGrad.cpp + LayerGradUtil.{h,cpp} testLayerGrad:266
(perturb parameters, compare analytic vs (f(x+h)-f(x-h))/2h).

The analytic side is autograd's (through the kernels' backward on the
card); the central differences run in each leaf's own dtype, as JAX's.
"""

import numpy as np
import torch

from paddle_tpu_torch import device as _device


def _paths(tree, path=()):
    """(keystr, leaf) in JAX's flattening order (dict keys sorted); the
    key strings as ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield "".join(f"[{k!r}]" for k in path), tree


def _replace(tree, target, value, path=()):
    """``tree`` with the leaf at keystr ``target`` replaced by ``value``."""
    if isinstance(tree, dict):
        return {k: _replace(v, target, value, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, target, value, path + (i,))
                          for i, v in enumerate(tree))
    return value if "".join(f"[{k!r}]" for k in path) == target else tree


def check_grads(loss_fn, params, eps=1e-3, rtol=2e-2, atol=1e-4,
                max_elems_per_leaf=4, rng=None, raise_on_fail=True):
    """Compare autograd's gradient of ``loss_fn(params)`` (a tree of
    tensors -> a scalar tensor) against central differences on a random
    subset of elements per parameter leaf.

    Returns [(path, max_rel_err, ok)] covering EVERY leaf (the reference
    checkgrad reports diffs across the whole model); with raise_on_fail
    an AssertionError listing all failures is raised at the end."""
    rng = rng or np.random.RandomState(0)
    flat = list(_paths(params))
    leaves = [leaf.detach().clone().requires_grad_(True) for _, leaf in flat]
    view = params
    for (path, _), leaf in zip(flat, leaves):
        view = _replace(view, path, leaf)
    analytic = torch.autograd.grad(loss_fn(view), leaves, allow_unused=True)
    results = []
    failures = []
    with torch.no_grad():
        for (path, leaf), g in zip(flat, analytic):
            orig = leaf.detach()
            g = np.zeros(orig.shape) if g is None \
                else g.detach().cpu().numpy()
            base = orig.cpu().numpy().astype(np.float64)
            n = base.size
            idxs = rng.choice(n, size=min(max_elems_per_leaf, n),
                              replace=False)
            max_err = 0.0
            bad = False
            for idx in idxs:
                delta = np.zeros(n)
                delta[idx] = eps
                delta = delta.reshape(base.shape)

                # the perturbed leaf in its own dtype (float64 sweeps stay
                # float64, float32 models stay float32)
                def loss_at(value):
                    t = torch.tensor(value, device=orig.device).to(
                        orig.dtype)
                    return float(loss_fn(_replace(params, path, t)))

                num = (loss_at(base + delta) - loss_at(base - delta)) \
                    / (2 * eps)
                ana = float(g.reshape(-1)[idx])
                err = abs(num - ana) / max(abs(num), abs(ana), atol)
                max_err = max(max_err, err)
                if not (err < rtol or abs(num - ana) < atol):
                    bad = True
                    failures.append(
                        f"{path}[{idx}]: analytic={ana:.6g} "
                        f"numeric={num:.6g} rel={err:.3g}")
            results.append((path, max_err, not bad))
    if failures and raise_on_fail:
        raise AssertionError("gradient mismatches:\n  "
                             + "\n  ".join(failures))
    return results


def check_topology_grads(topology, feed, generator=None, device=None, **kw):
    """checkgrad over a Topology's mean cost (the --job=checkgrad flow):
    the parameters drawn from ``generator`` (seed 0 by default) on
    ``device`` (the card unless "cpu"), the graph in test mode."""
    generator = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    params = topology.init(generator, device=_device.resolve(device))

    def loss_fn(p):
        out = topology.apply(p, feed, mode="test")
        outs = out if isinstance(out, tuple) else (out,)
        return sum(torch.mean(o.data if hasattr(o, "lengths") else o)
                   for o in outs)

    return check_grads(loss_fn, params, **kw)

