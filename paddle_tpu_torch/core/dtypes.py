"""The dtype policy (``paddle_tpu/core/dtypes.py``): parameters and
optimizer state in ``param_dtype`` (float32), the products of
``ops/linear.matmul`` in ``compute_dtype``, reductions in float32.

The JAX package's auto policy computes in bf16 only on a TPU, float32
elsewhere.  The port runs on no TPU, so auto is float32: every path keeps
its float32 numbers unless bf16 is asked for (``set_policy(
compute_dtype="bfloat16")``, ``SGD(compute_dtype=torch.bfloat16)``, the
trainer CLI's ``--dtype bfloat16``, ``BENCH_DTYPE``).  The policy is
process-global, as the reference's is."""

import torch

from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch

_param_dtype = torch.float32
# None = auto (float32: see the module docstring)
_compute_dtype = None

_NAMES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
_FLOATS = tuple(_NAMES.values())


def _dtype(d):
    return _NAMES[d] if isinstance(d, str) else d


def set_policy(param_dtype="float32", compute_dtype=None):
    """compute_dtype=None restores the auto policy (float32)."""
    global _param_dtype, _compute_dtype
    _param_dtype = _dtype(param_dtype)
    _compute_dtype = None if compute_dtype is None else _dtype(compute_dtype)


def param_dtype():
    return _param_dtype


def compute_dtype():
    return torch.float32 if _compute_dtype is None else _compute_dtype


def to_compute(x):
    """Float activations to the compute dtype; other dtypes unchanged."""
    return x.to(compute_dtype()) if x.dtype in _FLOATS else x


def to_param(x):
    return x.to(_param_dtype)


def cast_tree(tree, dtype):
    """float32 tensors -> ``dtype`` over dicts, lists and tuples, and the
    ``.data`` of a (nested) SequenceBatch; ids, lengths, masks and other dtypes
    pass through.  The trainer's mixed-precision boundary cast (its step
    and ``test``), as JAX's ``cast_tree``."""
    if isinstance(tree, SequenceBatch):
        return SequenceBatch(cast_tree(tree.data, dtype), tree.lengths)
    if isinstance(tree, NestedSequenceBatch):
        return tree._replace(data=cast_tree(tree.data, dtype))
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree
