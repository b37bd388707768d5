"""Dense matmul, fc and the projections that feed ``mixed_layer``
(``paddle_tpu/ops/linear.py``; reference FullyConnectedLayer and the
projection zoo: FullMatrixProjection, TransposedFullMatrixProjection,
IdentityProjection, DotMulProjection, ScalingProjection, DotMulOperator,
LinearCombinationLayer).  The projections' products go through
``matmul``, so the dtype policy holds for them too.

``matmul`` follows the dtype policy (``core/dtypes``) as JAX's does: both
operands are cast to ``compute_dtype()`` and the product comes back in
``promote(compute_dtype, float32)``, the accumulator.

- Under the float32 policy (auto: the port runs on no TPU) a bf16 or f16
  operand is widened to float32 and the product is float32 (TF32 off,
  ``device.resolve``), so low precision in gives JAX's float32
  accumulator, not torch's low-precision result.
- Under the bf16 policy float32 operands are ROUNDED to bf16 and the
  product is the float32 accumulator of the bf16 values.  On the card
  that is ``torch.mm(a, b, out_dtype=torch.float32)`` (``aten::mm.dtype``,
  bf16 tensor cores accumulating in float32); it has no derivative, so
  ``_MmBf16`` gives it one.  JAX's transpose of the product multiplies
  the float32 cotangent by the bf16 operand in float32 and rounds each
  gradient to its operand's dtype; ``_MmBf16`` splits the cotangent into
  two bf16 terms (hi + lo, all but 2^-16 of it) and sums their two
  products in float32, so its gradients are JAX's up to summation order
  before the one rounding.  The CPU build has no ``mm.dtype``: there the
  rounded operands are widened to float32 and multiplied, which is
  JAX's accumulator up to summation order (a product of two bf16 values
  is exact in float32), and autograd differentiates it as JAX does.
- Under a float16 policy both devices take that last route: two float16
  terms of the cotangent would flush its values below float16's range.

Never ``torch.matmul`` of two bf16 tensors: that rounds the accumulator
to bf16.  A plain product outside any kernel goes to torch, as the JAX
package left it to XLA."""

import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.ops import activations

_LOW = (torch.bfloat16, torch.float16)


class _MmBf16(torch.autograd.Function):
    """[M, K] x [K, N] of bf16 operands on the card, the float32
    accumulator out; the backward's products take the float32 cotangent
    as two bf16 terms."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        hi = g.to(a.dtype)
        lo = (g - hi).to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            bt = b.t()
            da = torch.mm(hi, bt, out_dtype=torch.float32).add_(
                torch.mm(lo, bt, out_dtype=torch.float32)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            at = a.t()
            db = torch.mm(at, hi, out_dtype=torch.float32).add_(
                torch.mm(at, lo, out_dtype=torch.float32)).to(b.dtype)
        return da, db


def matmul(x, w):
    """x [..., in] @ w [in, out] -> [..., out] under the dtype policy:
    the operands in the compute dtype, the product in
    promote(compute dtype, float32)."""
    cd = dtypes.compute_dtype()
    if cd == torch.float32:
        if x.dtype in _LOW:
            x = x.float()
        if w.dtype in _LOW:
            w = w.float()
        return torch.matmul(x, w)
    acc = torch.promote_types(cd, torch.float32)
    x, w = x.to(cd), w.to(cd)
    if acc == cd:
        return torch.matmul(x, w)
    if x.device.type == "cuda" and cd == torch.bfloat16:
        y = _MmBf16.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(acc), w.to(acc))


def fc(x, w, b=None, act=None):
    """y = act(x @ w + b).  x [..., in], w [in, out], b [out]."""
    y = matmul(x, w)
    if b is not None:
        y = y + b
    return activations.get(act)(y)


def full_matrix_projection(x, w):
    return matmul(x, w)


def trans_full_matrix_projection(x, w):
    """w stored [out, in] (reference TransposedFullMatrixProjection)."""
    return matmul(x, w.t())


def identity_projection(x, offset=0, size=None):
    if size is None:
        return x
    return x[..., offset:offset + size]


def dotmul_projection(x, w):
    """Elementwise scale by a learned vector: x * w, w [size]."""
    return x * w


def scaling_projection(x, w):
    """Scale the whole input by a learned scalar w [1]."""
    return x * w.reshape(())


def dotmul_operator(a, b, scale=1.0):
    return scale * a * b


def linear_comb(x, w, size):
    """LinearCombinationLayer / convex_comb: weights [..., K] over K
    vectors [..., K*size] -> [..., size]."""
    k = w.shape[-1]
    xs = x.reshape(*x.shape[:-1], k, size)
    return torch.einsum("...k,...ks->...s", w, xs)
