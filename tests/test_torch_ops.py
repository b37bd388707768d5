"""The port's LM ops (paddle_tpu_torch.ops) against the JAX package's on
identical numpy inputs, on the CPU.

Tolerances: both sides compute in float32; reductions (mean/var,
matmul, softmax) are summed in different orders by XLA and by PyTorch,
which moves results by a few ulps — 1e-5 absolute on O(1) values.
Gathers and head repeats copy values and must match exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops import attention as jax_attn
from paddle_tpu.ops import embedding as jax_emb
from paddle_tpu.ops import linear as jax_linear
from paddle_tpu.ops import norm as jax_norm
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.ops import attention, embedding, linear, norm

TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_layer_norm_matches_jax(np_rng):
    x = _rand(np_rng, 3, 5, 32) * 3 + 1
    g, b = _rand(np_rng, 32), _rand(np_rng, 32)
    want = np.asarray(jax_norm.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                          jnp.asarray(b)))
    got = norm.layer_norm(_t(x), _t(g), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_embedding_out_of_range_ids_give_exact_zero_rows(np_rng):
    table = _rand(np_rng, 10, 8)
    ids = np.asarray([[-1, 0, 9, 10, 3], [4, 100, -7, 2, 9]], np.int32)
    want = np.asarray(jax_emb.embedding_lookup(jnp.asarray(table),
                                               jnp.asarray(ids)))
    got = embedding.embedding_lookup(_t(table), _t(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, 0].any() and not got[0, 3].any() \
        and not got[1, 1].any() and not got[1, 2].any()


def test_matmul_matches_jax(np_rng):
    x, w = _rand(np_rng, 4, 3, 16), _rand(np_rng, 16, 8)
    want = np.asarray(jax_linear.matmul(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(linear.matmul(_t(x), _t(w)).numpy(), want,
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_jax(np_rng, batched):
    x = _rand(np_rng, 2, 3, 7, 16)
    pos = (np_rng.randint(0, 60, (2, 7)) if batched
           else np.arange(7) + 5).astype(np.int32)
    want = np.asarray(jax_attn.rope(jnp.asarray(x), jnp.asarray(pos)))
    got = attention.rope(_t(x), _t(pos)).numpy()
    # angles up to ~60 rad: cos/sin of float32 arguments differ by ~1 ulp
    # of the angle between the two libraries' implementations
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_repeat_kv_heads_matches_jax(np_rng):
    kv = _rand(np_rng, 2, 2, 5, 4)
    want = np.asarray(jax_attn.repeat_kv_heads(jnp.asarray(kv), 6))
    np.testing.assert_array_equal(
        attention.repeat_kv_heads(_t(kv), 6).numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_masked_path_matches_jax(np_rng, causal):
    q, k, v = (_rand(np_rng, 2, 3, 6, 8) for _ in range(3))
    mask = np_rng.rand(2, 1, 6, 6) > 0.3
    mask[..., 0] = True
    want = np.asarray(jax_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), causal=causal, use_flash=False))
    got = attention.dot_product_attention(_t(q), _t(k), _t(v),
                                          mask=_t(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("per_lane", [False, True])
def test_attend_matches_jax_with_gqa(np_rng, per_lane):
    """_attend (the masked path every attention kernel is held to): 4
    query heads over 2 grouped KV heads, a shared [B, T] mask or a
    per-lane [B, Tq, T] mask."""
    b, tq, t, heads, dh = 2, 3, 10, 4, 8
    q = _rand(np_rng, b, tq, heads * dh)
    k, v = _rand(np_rng, b, t, 2 * dh), _rand(np_rng, b, t, 2 * dh)
    pos = np.asarray([4, 9])
    if per_lane:
        mask = np.arange(t)[None, None] <= (pos[:, None]
                                            + np.arange(tq))[..., None] - 2
    else:
        mask = np.arange(t)[None] <= pos[:, None]
    want = np.asarray(jax_tf._attend(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), heads,
                                     jnp.asarray(mask)))
    got = torch_tf._attend(_t(q), _t(k), _t(v), heads, _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
