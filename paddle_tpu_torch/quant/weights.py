"""Per-channel symmetric int8 weights for the LM trunk
(``paddle_tpu/quant/weights.py``, copied; it imports no JAX here).

* Only 2-D float32 weights with >= ``min_size`` elements quantize (the
  attention projections, the FFN, the tied embedding); biases, layer
  norms and the positional table stay float32.
* A quantized leaf is ``{"q": int8 [.., dout], "s": float32 [1, dout]}``
  (symmetric, one scale per OUT channel: ``amax / 127`` over every axis
  but the last).  The JAX package's artifact format ``{"__int8__",
  "__scale__"}`` is read everywhere too.
* Dequantization happens at the matmul boundary inside each model entry
  point (``maybe_dequant`` in every ``lm_*`` call): the widened float32
  tree is a transient of the call, so no float32 copy of a quantized
  weight stays resident between steps.

Identity-scale exactness: with scale 1 and integer values in [-127,
127] the round trip ``dequantize_leaf(quantize_leaf(w))`` is bit for bit
``w`` (``torch.round`` is half to even, as ``jnp.round``)."""

import numpy as np
import torch

# leaf formats: this module's {"q", "s"} and the JAX package's
# export.quantize_params {"__int8__", "__scale__"}
_LEAF_KEYS = (("q", "s"), ("__int8__", "__scale__"))

# Committed training-quality budget of the int8 weight-streaming step
# (``trainer.SGD(quant_weights=True)``): max per-step |loss_int8 -
# loss_f32| / max(|loss_f32|, 1) over a short run against the float32
# twin, the JAX package's number (``scripts/bench.bench_trainer_int8``).
TRAIN_LOSS_BUDGET = 0.05


def _is_int8(x):
    # numpy and JAX say "int8", torch "torch.int8"; "uint8" must not match
    return str(getattr(x, "dtype", "")) in ("int8", "torch.int8")


def _leaf_keys(leaf):
    if isinstance(leaf, dict):
        for qk, sk in _LEAF_KEYS:
            if qk in leaf and sk in leaf and _is_int8(leaf[qk]):
                return qk, sk
    return None


def is_quantized_leaf(leaf):
    """True for a quantized-weight leaf (``{"q", "s"}`` or
    ``{"__int8__", "__scale__"}`` with an int8 payload)."""
    return _leaf_keys(leaf) is not None


def map_leaves(fn, tree):
    """``fn`` over the leaves of a nested dict/list tree, a quantized
    leaf counting as one leaf."""
    if is_quantized_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    """The leaves in JAX's flattening order (dict keys sorted), a
    quantized leaf counting as one."""
    if is_quantized_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def quantize_leaf(w, axis=None):
    """Symmetric per-channel int8: scales over every axis but the last
    (``axis=None``) -> ``{"q", "s"}``.  A zero channel quantizes to
    zeros with scale 0 (dequantization rebuilds exact zeros).  The
    division by the scale is kept (not a reciprocal's product), as in
    JAX."""
    w = torch.as_tensor(w)
    axes = axis if axis is not None else tuple(range(w.dim() - 1))
    amax = w.abs().amax(dim=axes, keepdim=True) if axes else w.abs()
    # a tensor divisor: PyTorch's CUDA kernels turn a division by a
    # Python scalar into a product with its reciprocal, an ulp off
    s = amax / torch.full_like(amax, 127.0)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(w / safe), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.float32)}


def dequantize_leaf(leaf):
    qk, sk = _leaf_keys(leaf)
    return leaf[qk].to(torch.float32) * leaf[sk]


def _quantize_2d(min_size):
    def q(x):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
                or x.dim() != 2 or x.numel() < min_size:
            return x
        return quantize_leaf(x)
    return q


def quantize_lm(params, min_size=1024):
    """Quantize a ``models/transformer`` decoder-only trunk: every 2-D
    float32 weight with >= ``min_size`` elements becomes a ``{"q", "s"}``
    pair; everything else (biases, norms, ``pos``) passes through.  Feed
    the result anywhere the float tree went (``DecodeEngine``,
    ``lm_prefill``, ``lm_generate``): the entry points dequantize at the
    matmul boundary.  The learned positional table stays float32: it is
    added to activations, not consumed by a matmul."""
    pos = params.get("pos") if isinstance(params, dict) else None
    if pos is not None:
        params = {k: v for k, v in params.items() if k != "pos"}
    out = map_leaves(_quantize_2d(min_size), params)
    if pos is not None:
        out["pos"] = pos
    return out


def quantize_tree(params, min_size=1024):
    """``quantize_lm`` for a generic params tree (the trainer's int8
    weight-streaming mode): every 2-D float32 leaf with >= ``min_size``
    elements, no ``pos`` special case.  Deterministic (round half to
    even, clip), so requantizing the same masters rebuilds the same
    tree."""
    return map_leaves(_quantize_2d(min_size), params)


def dequant_tree(params):
    """The float tree: quantized leaves widened, float leaves passed
    through untouched (the same tensors)."""
    return map_leaves(
        lambda l: dequantize_leaf(l) if is_quantized_leaf(l) else l, params)


def is_quantized_tree(tree):
    """True when any leaf of the (nested dict/list) tree is quantized."""
    if is_quantized_leaf(tree):
        return True
    if isinstance(tree, dict):
        return any(is_quantized_tree(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_quantized_tree(v) for v in tree)
    return False


def maybe_dequant(params):
    """The model entry points' hook: dequantize a quantized tree, pass a
    float tree through untouched (one walk, no copy)."""
    if is_quantized_tree(params):
        return dequant_tree(params)
    return params


def weight_shape(leaf):
    """Logical (pre-quantization) shape of a weight leaf, quantized or
    not."""
    keys = _leaf_keys(leaf)
    if keys is not None:
        return tuple(leaf[keys[0]].shape)
    return tuple(np.shape(leaf))


def quantized_weight_shapes(params):
    """Shapes of every quantized weight in the tree."""
    return [weight_shape(l) for l in _leaves(params)
            if is_quantized_leaf(l)]


def _floating(x):
    dt = getattr(x, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    return dt is not None and np.issubdtype(dt, np.floating)


def float_leaf_shapes(params):
    """Shapes of the tree's non-quantized floating leaves."""
    return [tuple(np.shape(l)) for l in _leaves(params)
            if not is_quantized_leaf(l) and _floating(l)]


def _nbytes(x):
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(np.shape(x))) * np.dtype(x.dtype).itemsize


def param_bytes(params):
    """Resident bytes of a params tree as stored (int8 codes plus
    float32 scale sidecars for a quantized tree)."""
    total = 0
    for l in _leaves(params):
        keys = _leaf_keys(l)
        if keys is not None:
            total += int(np.prod(np.shape(l[keys[0]]))) \
                + int(np.prod(np.shape(l[keys[1]]))) * 4
        elif hasattr(l, "dtype"):
            total += _nbytes(l)
    return total
