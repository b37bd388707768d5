"""Dense matmul and fc (``paddle_tpu/ops/linear.py``).

The JAX package feeds the TPU's matrix unit bf16 operands with an f32
accumulator, and off the TPU computes in float32 (``core/dtypes.py``).
The port computes in float32 on both devices (TF32 off,
``device.resolve``): a bf16 or f16 operand is widened to float32 first,
so the product is JAX's float32 accumulator, not torch's low-precision
result.  The bf16 policy itself (bf16 products on the card) is a later
ROADMAP item (A2).  A plain product outside any kernel goes to
``torch.matmul``, as the JAX package left it to XLA."""

import torch

from paddle_tpu_torch.ops import activations

_LOW = (torch.bfloat16, torch.float16)


def matmul(x, w):
    """x [..., in] @ w [in, out] -> [..., out]; bf16 / f16 operands are
    widened to float32, so low precision in gives float32 out."""
    if x.dtype in _LOW:
        x = x.float()
    if w.dtype in _LOW:
        w = w.float()
    return torch.matmul(x, w)


def fc(x, w, b=None, act=None):
    """y = act(x @ w + b).  x [..., in], w [in, out], b [out]."""
    y = matmul(x, w)
    if b is not None:
        y = y + b
    return activations.get(act)(y)
