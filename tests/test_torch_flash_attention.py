"""Kernel B, the ``flash_attention`` forward: the port's plain version
(o and lse — what the CPU runs, and what the CUDA kernel is held to on
the card) against the JAX Pallas kernel in interpret mode, causal and
non-causal, and against the JAX masked path on a ragged T; plus the
wrapper's dispatch and argument checks.

Tolerance 1e-5: float32 on both sides, blocked online softmax vs a
materialized one (sums in different orders, a few ulps on O(1) values).
"""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as jax_attn
from paddle_tpu_torch.ops.kernels import flash_attention as fk

# the ops.pallas package re-exports the flash_attention FUNCTION under the
# submodule's name
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = 1e-5


def _qkv(rng, b, h, tq, tk, d):
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("causal, tq, tk", [(True, 32, 32),
                                            (False, 16, 24)])
def test_plain_matches_jax_kernel_interpret(np_rng, causal, tq, tk):
    """o through the public wrapper (8x8 blocks, so several kv blocks
    stream) and lse through the forward the custom_vjp saves."""
    b, h, d = 2, 2, 16
    q, k, v = _qkv(np_rng, b, h, tq, tk, d)
    scale = 1.0 / np.sqrt(d)
    want_o = np.asarray(jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=8, block_k=8, interpret=True))
    _o, want_lse = jax_fa._fwd(
        jnp.asarray(q.reshape(b * h, tq, d)),
        jnp.asarray(k.reshape(b * h, tk, d)),
        jnp.asarray(v.reshape(b * h, tk, d)), scale, causal, 8, 8, True)
    o, lse = fk.flash_attention_plain(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(o.numpy(), want_o, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, tq),
                               np.asarray(want_lse), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t", [13, 37])
def test_plain_matches_jax_masked_path_on_ragged_t(np_rng, t):
    """A T no block size divides: the TPU wrapper falls back to the
    masked path; the port's kernel masks the ragged edge itself and
    both are held to that masked path."""
    q, k, v = _qkv(np_rng, 2, 3, t, t, 16)
    want = np.asarray(jax_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        use_flash=False))
    via_jax_wrapper = np.asarray(jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    o, lse = fk.flash_attention_plain(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(o.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(o.numpy(), via_jax_wrapper, atol=TOL,
                               rtol=TOL)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    logits = np.where(np.tril(np.ones((t, t), bool)), logits, -np.inf)
    want_lse = np.log(np.exp(logits - logits.max(-1, keepdims=True))
                      .sum(-1)) + logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL, rtol=TOL)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing(np_rng):
    q, k, v = _torch(*_qkv(np_rng, 1, 2, 9, 9, 32))
    before = fk.launches
    o = fk.flash_attention(q, k, v, causal=True)
    o2, lse = fk.flash_attention_fwd(q, k, v, scale=0.3)
    assert fk.launches == before
    np.testing.assert_array_equal(
        o.numpy(), fk.flash_attention_plain(q, k, v, causal=True)[0].numpy())
    want = fk.flash_attention_plain(q, k, v, scale=0.3)
    np.testing.assert_array_equal(o2.numpy(), want[0].numpy())
    np.testing.assert_array_equal(lse.numpy(), want[1].numpy())


@pytest.mark.parametrize("bad, exc", [
    (lambda q, k, v: (q, k[:, :, :5].contiguous(),
                      v[:, :, :5].contiguous(), True), ValueError),
    (lambda q, k, v: (q.double(), k, v, False), TypeError),
    # head dim 640: a width the kernels do not compile
    (lambda q, k, v: (torch.cat([q] * 40, -1), torch.cat([k] * 40, -1),
                      torch.cat([v] * 40, -1), False), ValueError),
    (lambda q, k, v: (q.transpose(1, 2), k, v, False), ValueError),
    (lambda q, k, v: (q, k, v[:, :1].contiguous(), False), ValueError),
])
def test_bad_arguments_raise(np_rng, bad, exc):
    q, k, v = _torch(*_qkv(np_rng, 1, 2, 9, 9, 16))
    q2, k2, v2, causal = bad(q, k, v)
    with pytest.raises(exc):
        fk.flash_attention(q2, k2, v2, causal=causal)
