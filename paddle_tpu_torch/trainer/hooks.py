"""Parameter updater hooks — the static pruning hook
(``paddle_tpu/trainer/hooks.py``).

Reference: paddle/parameter/ParameterUpdaterHook.cpp:36
(StaticPruningHook): a 0/1 mask is applied to the parameter VALUE once
at init and to the GRADIENT on every update, so pruned weights stay
exactly zero through training.  The reference loads the mask from a
packed-bit file (StaticMaskHeader {uint32 version; size_t size} then
MSB-first bits, ParameterUpdaterHook.cpp:106-126); later API revisions
instead derive it from the smallest-magnitude fraction of the
initialized weights (HookAttribute(type='pruning', sparsity_ratio=r)).
Both forms are supported, as in the JAX package.

Masks are float32 0/1 tensors on the parameters' device, in the
parameters' tree layout ({param_key: {leaf: mask}}); ``SGD`` multiplies
the values by them once and every step's gradients before the
optimizer (and before gradient accumulation).
"""

import struct

import numpy as np
import torch

from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_map

_MASK_VERSION = 0


def write_mask_file(path, mask_flat):
    """Write the reference's packed-bit mask format (for tests/tools)."""
    if isinstance(mask_flat, torch.Tensor):
        mask_flat = mask_flat.detach().cpu().numpy()
    bits = np.asarray(mask_flat).reshape(-1) != 0
    size = bits.size
    packed = np.packbits(bits)        # MSB-first, zero-padded — matches ref
    with open(path, "wb") as f:
        f.write(struct.pack("<IQ", _MASK_VERSION, size))
        f.write(packed.tobytes())


def load_mask_file(path, expect_size=None):
    """Read the reference mask file -> float32 0/1 flat numpy array."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12:
            raise ConfigError(f"pruning mask {path!r}: truncated header")
        version, size = struct.unpack("<IQ", header)
        if version != _MASK_VERSION:
            raise ConfigError(
                f"pruning mask {path!r}: unsupported version {version}")
        payload = f.read((size + 7) // 8)
    if len(payload) < (size + 7) // 8:
        raise ConfigError(
            f"pruning mask {path!r}: truncated payload ({len(payload)} bytes "
            f"for {size} bits)")
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))[:size]
    if expect_size is not None and size != expect_size:
        raise ConfigError(
            f"pruning mask {path!r}: mask size {size} != parameter size "
            f"{expect_size}")
    return bits.astype(np.float32)


def _normalize_hooks(update_hooks):
    hooks = update_hooks if isinstance(update_hooks, (list, tuple)) \
        else [update_hooks]
    out = []
    for h in hooks:
        if h is None:
            continue
        if not isinstance(h, dict):
            raise ConfigError(f"unsupported update hook {h!r}")
        if h.get("type") != "pruning":
            raise ConfigError(
                f"unsupported update hook type {h.get('type')!r} "
                "(only 'pruning' exists — reference "
                "ParameterUpdaterHook.cpp:168)")
        out.append(h)
    return out


def _ratio_mask(leaf, ratio):
    """Zero the ``ratio`` fraction of smallest-|w| entries (per leaf):
    the k-th smallest |w| is the threshold and only entries strictly
    above it are kept, so ties at the threshold fall as in JAX."""
    flat = leaf.detach().abs().reshape(-1)
    k = int(round(float(ratio) * flat.numel()))
    if k <= 0:
        return torch.ones_like(leaf, dtype=torch.float32)
    if k >= flat.numel():
        return torch.zeros_like(leaf, dtype=torch.float32)
    threshold = torch.sort(flat).values[k - 1]
    return (leaf.detach().abs() > threshold).to(torch.float32)


def _is_bias_leaf(name):
    return name == "b" or name.startswith("bias")


def _leaf_mask(leaf, hook, where):
    if hook.get("mask_filename"):
        flat = load_mask_file(hook["mask_filename"],
                              expect_size=leaf.numel())
        return torch.tensor(flat.reshape(tuple(leaf.shape)),
                            device=leaf.device)
    if hook.get("sparsity_ratio") is not None:
        return _ratio_mask(leaf, hook["sparsity_ratio"])
    raise ConfigError(
        f"pruning hook on {where!r} needs sparsity_ratio= or mask_filename=")


def _collect_hooked_attrs(topology):
    """Yield (param_key, leaf_name_or_None, hooks) for every attr carrying
    update_hooks.  leaf_name None = all weight leaves of the parameter;
    'w{i}' = the i-th input's weight (fc param_attr list / mixed-layer
    projection spec)."""
    for node in topology.order:
        key = topology._param_key(node)
        pa = node.cfg.get("param_attr")
        if isinstance(pa, dict) and pa.get("update_hooks"):
            yield key, None, _normalize_hooks(pa["update_hooks"])
        elif isinstance(pa, (list, tuple)):
            for i, p in enumerate(pa):
                if isinstance(p, dict) and p.get("update_hooks"):
                    yield (key, f"w{i}",
                           _normalize_hooks(p["update_hooks"]))
        for k, part in enumerate(node.cfg.get("parts") or ()):
            spec = part[1] if isinstance(part, (list, tuple)) else {}
            sp = spec.get("param_attr") if isinstance(spec, dict) else None
            if isinstance(sp, dict) and sp.get("update_hooks"):
                yield key, f"w{k}", _normalize_hooks(sp["update_hooks"])


def _leaves_with_names(tree, path=()):
    """(path, leaf) pairs of a nested dict in JAX's flattening order
    (keys sorted); a leaf's name is the last key of its path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_names(tree[k], path + (k,))
    else:
        yield path, tree


def _rebuild(tree, leaves, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    return leaves[path]


def build_masks(topology, params):
    """Collect pruning masks for every parameter whose param_attr carries
    update_hooks.  Returns {param_key: mask tree} (possibly empty)."""
    hook_cfg = {}   # (key, leaf): hooks — detects conflicting shares
    for key, leaf_name, hooks in _collect_hooked_attrs(topology):
        if not hooks:
            continue
        prev = hook_cfg.get((key, leaf_name))
        if prev is not None and prev != hooks:
            raise ConfigError(
                f"parameter {key!r} is shared with conflicting update_hooks")
        hook_cfg[(key, leaf_name)] = hooks

    masks = {}
    for (key, leaf_name), hooks in hook_cfg.items():
        if key not in params:
            raise ConfigError(f"update_hooks on {key!r}: no such parameter")
        paths = list(_leaves_with_names(params[key]))
        if leaf_name is not None:
            named = {str(p[-1]) if p else "" for p, _ in paths}
            if leaf_name not in named:
                raise ConfigError(
                    f"update_hooks on {key!r}: no weight leaf "
                    f"{leaf_name!r} (has {sorted(named)})")
        for h in hooks:
            leaves = {}
            for path, leaf in paths:
                last = str(path[-1]) if path else ""
                if leaf_name is not None:
                    hit = last == leaf_name
                else:
                    # attr-level hook governs the WEIGHTS; a bias is its own
                    # parameter in the reference (bias_attr), never pruned
                    hit = not _is_bias_leaf(last)
                leaves[path] = (_leaf_mask(leaf, h, key) if hit else
                                torch.ones_like(leaf, dtype=torch.float32))
            m = _rebuild(params[key], leaves)
            masks[key] = m if key not in masks \
                else tree_map(torch.mul, masks[key], m)
    return masks


def apply_masks(tree, masks):
    """Multiply masked entries of a params-shaped tree (values or grads);
    a new tree, non-hooked keys passed through untouched."""
    if not masks:
        return tree
    out = dict(tree)
    for key, mask in masks.items():
        out[key] = tree_map(lambda t, m: t * m.to(t.dtype), tree[key], mask)
    return out
