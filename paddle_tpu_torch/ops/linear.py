"""Dense matmul (``paddle_tpu/ops/linear.py``).

The JAX package feeds the TPU's matrix unit bf16 operands with an f32
accumulator.  This slice computes in float32 on both devices (TF32 off,
``device.resolve``); the bf16 policy is a later ROADMAP item, because
torch's bf16 matmul returns bf16 where JAX returns the f32 accumulator.
A plain product outside any kernel goes to ``torch.matmul``, as the JAX
package left it to XLA."""

import torch


def matmul(x, w):
    """x [..., in] @ w [in, out] -> [..., out], float32."""
    return torch.matmul(x, w)
