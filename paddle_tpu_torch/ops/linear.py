"""Dense matmul and fc (``paddle_tpu/ops/linear.py``).

The JAX package feeds the TPU's matrix unit bf16 operands with an f32
accumulator.  This slice computes in float32 on both devices (TF32 off,
``device.resolve``); the bf16 policy is a later ROADMAP item, because
torch's bf16 matmul returns bf16 where JAX returns the f32 accumulator.
A plain product outside any kernel goes to ``torch.matmul``, as the JAX
package left it to XLA."""

import torch

from paddle_tpu_torch.ops import activations


def matmul(x, w):
    """x [..., in] @ w [in, out] -> [..., out], float32."""
    return torch.matmul(x, w)


def fc(x, w, b=None, act=None):
    """y = act(x @ w + b).  x [..., in], w [in, out], b [out]."""
    y = matmul(x, w)
    if b is not None:
        y = y + b
    return activations.get(act)(y)
