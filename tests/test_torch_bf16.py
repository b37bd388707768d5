"""bf16 operands in the port's products and attention against the JAX
package's (``paddle_tpu/ops/linear.py``, ``paddle_tpu/ops/attention.py``)
on the CPU, where JAX computes in float32 (``core/dtypes.py``).

``matmul`` widens bf16 operands to float32 and returns the float32
product, as JAX's returns its float32 accumulator: the two agree within
1e-5 relative on the same bf16 values.  The attention logits are formed
in float32 and the softmax weights cast to v's dtype before P.V: the
port's bf16 result (bf16, as JAX's) is held against the float32 result
of the same values and may be no further from it than JAX's is (the
dense path rounds the same way as JAX, bit for bit here; the chunked
path sums P.V per chunk in another order).  The float32 path is held
bit for bit against the product of float32 operands as it was.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as jax_attn
from paddle_tpu.ops import linear as jax_linear
from paddle_tpu_torch.ops import attention as attn
from paddle_tpu_torch.ops import linear

REL = 1e-5


def _bf16_pair(a):
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()


@pytest.mark.parametrize("lo", ["bfloat16", "float16"])
def test_matmul_returns_the_float32_product(lo):
    """[64, 256] x [256, 128] of low-precision values: float32 out,
    within 1e-5 relative of JAX's accumulator (the port's float32
    product of the widened values, exact against it here)."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    jd, td = getattr(jnp, lo), getattr(torch, lo)
    want = np.asarray(jax_linear.matmul(jnp.asarray(x, jd),
                                        jnp.asarray(w, jd)))
    got = linear.matmul(torch.tensor(x).to(td), torch.tensor(w).to(td))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=REL,
                               atol=REL * np.abs(want).max())
    # a low-precision operand beside a float32 one widens too
    mixed = linear.matmul(torch.tensor(x).to(td), torch.tensor(w))
    assert mixed.dtype == torch.float32
    # the float32 path is the plain product, bit for bit
    np.testing.assert_array_equal(
        linear.matmul(torch.tensor(x), torch.tensor(w)).numpy(),
        (torch.tensor(x) @ torch.tensor(w)).numpy())


def _qkv(seed=0, b=2, h=2, t=64, d=32):
    rng = np.random.RandomState(seed)
    return [3 * rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("path, chunks", [("dense", None),
                                          ("chunked", (512, 512)),
                                          ("chunked", (16, 16))])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_attention_error_no_larger_than_jax(path, chunks, causal):
    """Causal and full attention at B 2, H 2, T 64, dh 32 (inputs x3):
    the result keeps bf16, and its max abs error against the float32
    result is no larger than JAX's."""
    q, k, v = _qkv()
    ref = np.asarray(jax_attn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, use_flash=False))
    (jq, tq), (jk, tk), (jv, tv) = map(_bf16_pair, (q, k, v))
    if path == "dense":
        want = jax_attn.dot_product_attention(jq, jk, jv, causal=causal,
                                              use_flash=False)
        got = attn.dot_product_attention(tq, tk, tv, causal=causal,
                                         use_flash=False)
    else:
        kw = dict(causal=causal, q_chunk=chunks[0], k_chunk=chunks[1])
        want = jax_attn.chunked_attention(jq, jk, jv, **kw)
        got = attn.chunked_attention(tq, tk, tv, **kw)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    jax_err = np.abs(np.asarray(want.astype(jnp.float32)) - ref).max()
    port_err = np.abs(got.float().numpy() - ref).max()
    assert port_err <= jax_err, (port_err, jax_err)
    if path == "dense":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_bf16_logits_are_formed_in_float32():
    """online_softmax_block's logits and carry take q's dtype promoted
    with float32; float32 inputs give the unchanged float32 block."""
    q, k, v = (torch.tensor(a[:, :, :8]) for a in _qkv(1))
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    out16 = attn.online_softmax_block(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16(), m, l, acc)
    assert all(t.dtype == torch.float32 for t in out16)
    out32 = attn.online_softmax_block(q, k, v, m, l, acc)
    s = torch.einsum("...qd,...kd->...qk", q, k)
    m_new = torch.maximum(m, s.amax(-1))
    np.testing.assert_array_equal(out32[0].numpy(), m_new.numpy())
    # bf16 logits from float32 products of the bf16 values, not bf16 ones
    s16 = torch.einsum("...qd,...kd->...qk", q.bfloat16().float(),
                       k.bfloat16().float())
    np.testing.assert_array_equal(
        out16[0].numpy(), torch.maximum(m, s16.amax(-1)).numpy())
