"""The serving path at head dims other than the compiled 16/32/64/128, on
the CPU, against the JAX package.

The decode kernels take any head dim up to 128 and the multiples of 128
up to 512 (padded inside the kernel to a compiled width on the card);
their plain versions are held against JAX's four Pallas kernels in
interpret mode at dh 8 and 96, float32 and int8 caches.  The model's
steps route by ``decode_attention.covers`` (JAX's ``covers``): the
kernels at dh 8 and 96, ``_attend`` at dh 160; the chunked and Tq=1
steps on both layouts and ``lm_prefill`` are held against JAX's, whose
kernels run in interpret mode where its rule takes them
(``forced_mode("always")``, ``forced_prefill_quant_mode("always")``).

Tolerances: attention over identical inputs 1e-5 (float32 on both sides,
blocked online softmax vs a materialized one); trunk logits 1e-4 (float32
K/V differ by ulps between the frameworks); int8 caches as
``test_torch_quant``: codes within 1, scales rtol 1e-5, dequantized K/V
within one quantization step; the int8 prefill's logits within
``quant/kv.LOGIT_ERR_BUDGET`` of JAX's.
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu.quant import kv as jax_kvq
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.ops.kernels import flash_attention as fk
from paddle_tpu_torch.quant import kv as kvq
from test_torch_quant import _int8_close

# the ops.pallas package re-exports the flash_attention function under
# the submodule's name
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

KTOL = 1e-5
TOL = 1e-4
VOCAB, MAX_LEN, BS, K = 50, 32, 8, 4


def _quant(rng, shape, hkv):
    """(codes, scales) of a seeded N(0, 1) K/V, quantized by JAX."""
    q, s = jax_kvq.quantize_heads(
        jnp.asarray(rng.standard_normal(shape).astype(np.float32)), hkv)
    return np.array(q), np.array(s)


def _kernel_inputs(rng, dh, int8, h=4, hkv=2):
    """q [S, K, H dh]; the slab k/v [S, T, Hkv dh] and a pool [NB, BS,
    Hkv dh] (float32, or int8 codes with their scales); qpos [S, K] with
    a decode row, full and ragged chunks and a free row at 0; tables of
    distinct blocks, rows 1 and 2 sharing their leading ones."""
    rows = [(1, 9), (4, 8), (2, 17), (1, 0)]
    qpos = np.asarray([start + np.minimum(np.arange(K), live - 1)
                       for live, start in rows], np.int32)
    nb_row = int(qpos.max()) // BS + 2
    num_blocks = len(rows) * nb_row + 1
    tables = rng.permutation(np.arange(1, num_blocks)).reshape(
        len(rows), nb_row).astype(np.int32)
    tables[2, :2] = tables[1, :2]
    q = rng.standard_normal((len(rows), K, h * dh)).astype(np.float32)
    shapes = ((len(rows), nb_row * BS, hkv * dh),) * 2 \
        + ((num_blocks, BS, hkv * dh),) * 2
    if int8:
        kv = [_quant(rng, s, hkv) for s in shapes]
    else:
        kv = [(rng.standard_normal(s).astype(np.float32), None)
              for s in shapes]
    return q, kv, qpos, tables, h


def _scales(pair, to):
    (_, ks), (_, vs) = pair
    return {} if ks is None else dict(kscale=to(ks), vscale=to(vs))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dh", [8, 96])
def test_decode_kernels_match_jax_at_other_head_dims(np_rng, dh, int8):
    """The four decode kernels' plain versions (what the CPU wrappers
    take) against JAX's Pallas kernels in interpret mode."""
    q, kv, qpos, tables, h = _kernel_inputs(np_rng, dh, int8)
    slab, pool = kv[:2], kv[2:]
    q1, pos = np.ascontiguousarray(q[:, 0]), qpos[:, 0].copy()
    jx, tt = jnp.asarray, torch.tensor
    calls = (
        ("decode_attention_slab_chunk", (q, qpos), slab, ()),
        ("decode_attention_slab", (q1, pos), slab, ()),
        ("decode_attention_paged_chunk", (q, qpos), pool, (tables,)),
        ("decode_attention_paged", (q1, pos), pool, (tables,)))
    for name, (qq, pp), ((kc, _), (vc, _)), extra in calls:
        want = np.asarray(getattr(jax_dk, name)(
            jx(qq), jx(kc), jx(vc), jx(pp), *map(jx, extra), h,
            interpret=True, **_scales(pool if extra else slab, jx)))
        got = getattr(dk, name)(tt(qq), tt(kc), tt(vc), tt(pp),
                                *map(tt, extra), h,
                                **_scales(pool if extra else slab, tt))
        assert got.shape == want.shape and np.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want, atol=KTOL, rtol=KTOL,
                                   err_msg=name)


@pytest.mark.parametrize("dh", [1, 6, 8, 24, 96, 128, 160, 200, 256, 384,
                                512])
def test_covers_is_jax_rule(dh):
    """The port's route rule takes a head dim exactly where JAX's
    (``_head_split`` and ``_mosaic_ok`` in interpret mode) does, on the
    slab and on a pool of lane-tileable and of ragged blocks; GQA and
    non-dividing widths alike."""
    for h, hkv in ((4, 2), (2, 2), (3, 1)):
        d, dkv = h * dh, hkv * dh
        for bs in (None, 16, 136):
            split = jax_dk._head_split(d, dkv, h)
            want = split is not None and jax_dk._mosaic_ok(
                8 if bs is None else bs, dkv, split[0], interpret=True)
            assert dk.covers(h, d, dkv, bs) == want, (dh, h, hkv, bs)
    assert not dk.covers(3, 32, 32, None)           # 3 heads do not divide


def _trunk(dh, kv_heads):
    heads = 2
    jp = jax_tf.init(jax.random.PRNGKey(dh), src_vocab=VOCAB, trg_vocab=1,
                     d_model=heads * dh, num_heads=heads,
                     num_kv_heads=kv_heads, dff=32, enc_layers=2,
                     dec_layers=0, max_len=MAX_LEN)
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    return heads, jp, tp


def _tables():
    tables = np.zeros((4, 4), np.int32)
    tables[0] = [5, 9, 2, 11]
    tables[1] = [3, 7, 1, 4]
    tables[2, :2] = tables[1, :2]
    tables[2, 2:] = [13, 6]
    return tables


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("dh, kv_heads", [(8, 1), (96, 2), (160, 2)])
def test_steps_match_jax_at_head_dim(dh, kv_heads, kv_dtype):
    """Two chunked steps and a Tq=1 step on the slab and on the pool
    against JAX's, its decode kernels forced on (dh 8 and 96: the
    kernels on both sides; dh 160: both take ``_attend``)."""
    heads, jp, tp = _trunk(dh, kv_heads)
    assert dk.covers(heads, heads * dh, kv_heads * dh, BS) == (dh != 160)
    tables = _tables()
    q8 = dict(kv_dtype=kv_dtype, num_heads=heads)
    caches = {
        "slab": (jax_tf.init_lm_cache(jp, 4, MAX_LEN, **q8),
                 torch_tf.init_lm_cache(tp, 4, MAX_LEN, **q8)),
        "paged": (jax_tf.init_lm_cache_paged(jp, 16, BS, max_len=MAX_LEN,
                                             **q8),
                  torch_tf.init_lm_cache_paged(tp, 16, BS, max_len=MAX_LEN,
                                               **q8))}
    rng = np.random.RandomState(dh)
    for layout, (jc, tc) in caches.items():
        paged = layout == "paged"
        extra_j = (jnp.asarray(tables),) if paged else ()
        extra_t = (tables,) if paged else ()
        suffix = "paged" if paged else "slots"
        chunk_j = getattr(jax_tf, f"lm_decode_chunk_{suffix}")
        chunk_t = getattr(torch_tf, f"lm_decode_chunk_{suffix}")
        step_j = getattr(jax_tf, f"lm_decode_step_{suffix}")
        step_t = getattr(torch_tf, f"lm_decode_step_{suffix}")
        pos = np.asarray([0, 2, 8, 0], np.int32)
        with jax_dk.forced_mode("always"):
            for lens in ([4, 3, 2, 1], [4, 1, 4, 1]):
                lens = np.asarray(lens, np.int32)
                toks = rng.randint(1, VOCAB, (4, K)).astype(np.int32)
                jl, jc = chunk_j(jp, *map(jnp.asarray, (toks, pos, lens)),
                                 jc, *extra_j, heads)
                tl, tc = chunk_t(tp, toks, pos, lens, tc, *extra_t, heads)
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           atol=TOL, rtol=TOL)
                pos = pos + lens
            pos[3] = 0                            # the free row
            toks = rng.randint(1, VOCAB, 4).astype(np.int32)
            jl, jc = step_j(jp, *map(jnp.asarray, (toks, pos)), jc,
                            *extra_j, heads)
            tl, tc = step_t(tp, toks, pos, tc, *extra_t, heads)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        # block 0 / free rows are scratch, written in either order
        sl = slice(1, None) if paged else slice(0, 3)
        for g, w in zip(tc, jc):
            if kv_dtype == "int8":
                _int8_close(g, w, sl)
            else:
                for key in ("k", "v"):
                    np.testing.assert_allclose(
                        g[key][sl].numpy(), np.asarray(w[key])[sl],
                        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("dh", [96, 160])
def test_prefill_matches_jax_at_head_dim(np_rng, dh, kv_dtype):
    """lm_prefill at dh 96 (the flash kernels, padded to 128; int8:
    flash_attention_quant, padded) and dh 160 (the dense path; int8: the
    dequantized codes on it) against JAX's, its int8 kernel forced on
    where its rule takes it."""
    heads, jp, tp = _trunk(dh, 1)
    assert fk.prefill_quant_covers(heads * dh, dh, heads) == (dh != 160)
    prompt = np_rng.randint(1, VOCAB, (2, 16)).astype(np.int32)
    with jax_fa.forced_prefill_quant_mode("always"):
        jh, jc = jax_tf.lm_prefill(jp, jnp.asarray(prompt), MAX_LEN, heads,
                                   kv_dtype=kv_dtype)
    th, tc = torch_tf.lm_prefill(tp, prompt, MAX_LEN, heads,
                                 kv_dtype=kv_dtype)
    want = np.asarray(jax_tf._lm_project(jp, jh))
    got = torch_tf._lm_project(tp, th)
    if kv_dtype is None:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
        for g, w in zip(tc, jc):
            np.testing.assert_allclose(g["k"].numpy(), np.asarray(w["k"]),
                                       atol=TOL, rtol=TOL)
        return
    err = kvq.logit_err(torch.tensor(want), got)
    assert (err <= kvq.LOGIT_ERR_BUDGET).all()
    for g, w in zip(tc, jc):
        _int8_close(g, w)
    # against the float32 twin: inside the committed logit budget
    fh, _ = torch_tf.lm_prefill(tp, prompt, MAX_LEN, heads)
    err = kvq.logit_err(torch_tf._lm_project(tp, fh), got)
    assert (err <= kvq.LOGIT_ERR_BUDGET).all() and err.max() > 0


@pytest.mark.parametrize("dh", [8, 96])
def test_flash_quant_pads_to_the_float32_route(np_rng, dh):
    """flash_attention_quant at a head dim between the compiled ones
    equals the float32 flash route on the dequantized, repeated heads
    (both pad to the same compiled width) and JAX's interpret kernel."""
    b, t, h, hkv = 2, 16, 4, 2
    q = np_rng.standard_normal((b, t, h * dh)).astype(np.float32)
    (kc, ksc), (vc, vsc) = (_quant(np_rng, (b, t, hkv * dh), hkv)
                            for _ in range(2))
    tt = torch.tensor
    got = fk.flash_attention_quant(tt(q), tt(kc), tt(vc), tt(ksc), tt(vsc),
                                   h)
    assert got.shape == (b, h, t, dh)

    def heads(x, n):
        return x.reshape(b, t, n, dh).transpose(1, 2)

    kw = kvq.dequantize_heads(tt(kc), tt(ksc))
    vw = kvq.dequantize_heads(tt(vc), tt(vsc))
    rep = h // hkv
    f32 = fk.flash_attention(
        heads(tt(q), h).contiguous(),
        heads(kw, hkv).repeat_interleave(rep, 1).contiguous(),
        heads(vw, hkv).repeat_interleave(rep, 1).contiguous(), causal=True)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=KTOL,
                               rtol=KTOL)
    want = np.asarray(jax_fa.flash_attention_quant(
        *map(jnp.asarray, (q, kc, vc, ksc, vsc)), h, causal=True,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=KTOL, rtol=KTOL)
