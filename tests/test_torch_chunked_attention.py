"""``chunked_attention``, ``segment_mask`` and the segment-id route of
``ops/attention.dot_product_attention`` against the JAX package's
(``paddle_tpu/ops/attention.py``), which computes them in plain XLA: no
kernel on either side.

Shapes: an unmasked pair of lengths with Tq * Tk >= 2048^2 (the route's
threshold), causal and not, ragged against the 512-row chunks; a key
mask; packed rows labelled by segment ids, on the dense path and through
the chunks (small chunks, so that the labels cross chunk boundaries),
with ``kv_segment_ids`` for a cross-attention; the gradients of the
chunked path (recomputed per key chunk on both sides); and the
refusals JAX makes.

Tolerance 1e-5 absolute and relative: float32 on both sides, the same
online softmax over the same chunks summed by another library.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as jax_attn
from paddle_tpu_torch.ops import attention as attn

TOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for t in (tq, tk, tk)]


@functools.lru_cache(maxsize=None)
def _long(causal, tq, tk):
    """Inputs over the route's threshold and JAX's result."""
    q, k, v = _qkv(tq + tk + causal, 1, 2, tq, tk, 8)
    want = np.asarray(jax_attn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, use_flash=False))
    return q, k, v, want


@pytest.mark.parametrize("causal, tq, tk", [(False, 2048, 2048),
                                            (True, 2048, 2048),
                                            (False, 1500, 2900),
                                            (True, 1800, 2400)])
def test_route_takes_chunked_attention_as_jax(monkeypatch, causal, tq, tk):
    """No mask and Tq * Tk >= 2048^2: both packages take
    chunked_attention (the port's call counted), and agree."""
    assert tq * tk >= attn._CHUNKED_MIN
    q, k, v, want = _long(causal, tq, tk)
    calls = []
    real = attn.chunked_attention

    def counted(*args, **kw):
        calls.append(kw.get("causal"))
        return real(*args, **kw)

    monkeypatch.setattr(attn, "chunked_attention", counted)
    got = attn.dot_product_attention(*map(torch.tensor, (q, k, v)),
                                     causal=causal, use_flash=False)
    assert calls == [causal]
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), want)


def test_chunked_with_key_mask_matches_jax():
    q, k, v = _qkv(3, 2, 2, 600, 700, 8)
    km = np.ones((2, 700), np.float32)
    km[0, 650:] = 0.0
    km[1, :30] = 0.0
    want = jax_attn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                      key_mask=jnp.asarray(km), q_chunk=256,
                                      k_chunk=128)
    got = attn.chunked_attention(*map(torch.tensor, (q, k, v)),
                                 key_mask=torch.tensor(km), q_chunk=256,
                                 k_chunk=128)
    _close(got.numpy(), want)


def _packed(seed, b, t, cuts, pad):
    """Segment labels [B, T]: runs 1, 2, ... cut at ``cuts``, the last
    ``pad`` positions 0 (padding)."""
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        bounds = [0] + sorted(cuts[r]) + [t - pad[r]]
        for i, (a, e) in enumerate(zip(bounds, bounds[1:])):
            seg[r, a:e] = i + 1
    return seg


@pytest.mark.parametrize("causal", [False, True])
def test_segment_ids_dense_path_matches_jax(np_rng, causal):
    """Packed rows on the dense path (below the threshold): the
    segment mask, with and without a key mask."""
    q, k, v = _qkv(11 + causal, 2, 2, 48, 48, 16)
    seg = _packed(0, 2, 48, [[10, 30], [17]], [5, 0])
    km = (seg > 0).astype(np.float32)
    for key_mask in (None, km):
        extra_j = {} if key_mask is None else dict(
            key_mask=jnp.asarray(key_mask))
        extra_t = {} if key_mask is None else dict(
            key_mask=torch.tensor(key_mask))
        want = jax_attn.dot_product_attention(
            *map(jnp.asarray, (q, k, v)), causal=causal, use_flash=False,
            q_segment_ids=jnp.asarray(seg), **extra_j)
        got = attn.dot_product_attention(
            *map(torch.tensor, (q, k, v)), causal=causal,
            q_segment_ids=torch.tensor(seg), **extra_t)
        _close(got.numpy(), want)


def test_segment_mask_matches_jax():
    seg = _packed(0, 2, 20, [[4, 9], [13]], [3, 0])
    kv = _packed(1, 2, 24, [[7], [2, 11]], [0, 5])
    for a, b in ((seg, None), (seg, kv)):
        want = jax_attn.segment_mask(jnp.asarray(a),
                                     None if b is None else jnp.asarray(b))
        got = attn.segment_mask(torch.tensor(a),
                                None if b is None else torch.tensor(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal, cross", [(False, False), (True, False),
                                           (False, True)])
def test_segment_ids_through_chunks_match_jax(causal, cross):
    """Packed rows through chunked_attention with chunks of 16 (labels
    crossing chunk boundaries, ragged last chunks); ``cross``: the keys
    labelled by kv_segment_ids of their own length."""
    tq, tk = (70, 90) if cross else (75, 75)
    q, k, v = _qkv(21 + causal + 2 * cross, 2, 2, tq, tk, 8)
    qseg = _packed(0, 2, tq, [[20, 41], [33]], [4, 0])
    kwj, kwt = {}, {}
    if cross:
        kseg = _packed(1, 2, tk, [[25, 60], [50]], [0, 6])
        kwj["kv_segment_ids"] = jnp.asarray(kseg)
        kwt["kv_segment_ids"] = torch.tensor(kseg)
    want = jax_attn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, q_chunk=16, k_chunk=16,
        q_segment_ids=jnp.asarray(qseg), **kwj)
    got = attn.chunked_attention(
        *map(torch.tensor, (q, k, v)), causal=causal, q_chunk=16,
        k_chunk=16, q_segment_ids=torch.tensor(qseg), **kwt)
    _close(got.numpy(), want)


def test_segment_ids_route_over_the_threshold_matches_jax():
    """Packed rows over the threshold: both packages take the chunks
    with the labels applied per chunk pair."""
    q, k, v = _qkv(31, 1, 1, 2048, 2048, 8)
    seg = _packed(0, 1, 2048, [[300, 1000, 1700]], [20])
    want = jax_attn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, use_flash=False,
        q_segment_ids=jnp.asarray(seg))
    got = attn.dot_product_attention(
        *map(torch.tensor, (q, k, v)), causal=True,
        q_segment_ids=torch.tensor(seg))
    _close(got.numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_gradients_match_jax(causal):
    """The gradients of chunked_attention (each key chunk recomputed in
    the backward on both sides) against jax.vjp."""
    q, k, v = _qkv(41 + causal, 1, 2, 40, 40, 8)
    do = np.random.RandomState(7).standard_normal(q.shape).astype(
        np.float32)

    def f(q, k, v):
        return jax_attn.chunked_attention(q, k, v, causal=causal, q_chunk=16,
                                          k_chunk=16)

    want_o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    got_o = attn.chunked_attention(*leaves, causal=causal, q_chunk=16,
                                   k_chunk=16)
    got_o.backward(torch.tensor(do))
    _close(got_o.detach().numpy(), want_o)
    for g, w in zip(leaves, want):
        _close(g.grad.numpy(), w)


def test_refusals_match_jax():
    """kv_segment_ids without q_segment_ids, and segment ids on the
    flash route: JAX raises ValueError on both, and so does the port."""
    q, k, v = _qkv(5, 1, 1, 128, 128, 8)
    seg = np.ones((1, 128), np.int32)
    for fn, arr in ((attn.dot_product_attention, torch.tensor),
                    (jax_attn.dot_product_attention, jnp.asarray)):
        args = [arr(x) for x in (q, k, v)]
        with pytest.raises(ValueError, match="kv_segment_ids without"):
            fn(*args, kv_segment_ids=arr(seg))
        with pytest.raises(ValueError, match="no mask support"):
            fn(*args, q_segment_ids=arr(seg), use_flash=True)
    with pytest.raises(ValueError, match="kv_segment_ids without"):
        attn.chunked_attention(*map(torch.tensor, (q, k, v)),
                               kv_segment_ids=torch.tensor(seg))


def test_multi_head_attention_passes_segment_ids():
    """multi_head_attention hands its segment ids to the route: packed
    rows against JAX's on the same weights."""
    rng = np.random.RandomState(9)
    b, t, d, h = 2, 24, 32, 2
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    ws = [(rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
          for _ in range(4)]
    seg = _packed(0, b, t, [[7, 15], [11]], [3, 0])
    want = jax_attn.multi_head_attention(
        jnp.asarray(x), jnp.asarray(x), *map(jnp.asarray, ws), h,
        causal=True, q_segment_ids=jnp.asarray(seg))
    got = attn.multi_head_attention(
        torch.tensor(x), torch.tensor(x), *map(torch.tensor, ws), h,
        causal=True, q_segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
