"""The port's int8 KV cache on the CPU: ``paddle_tpu_torch/quant/kv.py``,
the int8 operands of the four decode-attention kernels'
plain versions and ``flash_attention_quant_plain`` against the JAX
Pallas kernels in interpret mode, the int8 trunk steps against their JAX
twins, and the int8 engine (both layouts, chunked and ladder, prefix
cache and copy-on-write) against the port's int8 ``lm_generate``.

Tolerances, each with its reason:
* Quantization codes equal JAX's exactly on identical inputs; scales
  ``amax / 127`` in float32 agree to rtol 1e-6 (a 1-ulp divide drift is
  possible under XLA fusion).
* Attention over identical int8 inputs: 1e-5 (float32 on both sides,
  blocked online softmax vs a materialized one, as
  ``tests/test_torch_decode_attention.py``).
* Trunk parity with JAX: float32 K/V through the trunk differ by ulps
  between the frameworks, so a code can sit on the other side of a
  rounding boundary: codes within 1, dequantized K/V within one
  quantization step (the head's scale), scales rtol 1e-5, logits 1e-4.
* Engine streams vs ``lm_generate``: compared while the reference's
  top-1/top-2 logit margin exceeds MARGIN (the chunked step and prefill +
  decode step round differently, ~1e-7); most tokens must be compared.
"""

import importlib
import json
import math
import threading
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops.attention import dot_product_attention as jax_dpa
from paddle_tpu.ops.attention import repeat_kv_heads as jax_repeat
from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu.quant import kv as jax_kvq
from paddle_tpu.serving import kv_pool as jax_pool
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.ops import linear
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.ops.kernels import flash_attention as fk
from paddle_tpu_torch.quant import kv as kvq
from paddle_tpu_torch.serving import (DecodeEngine, GenerationBatcher,
                                      make_server)
from paddle_tpu_torch.serving import kv_pool
from paddle_tpu_torch.serving import server as torch_server
from paddle_tpu_torch.utils.error import ConfigError

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

KTOL = 1e-5
TOL = 1e-4
MARGIN = 1e-5
VOCAB, D_MODEL, LAYERS, HEADS, DFF = 64, 32, 2, 2, 64
MAX_LEN, SLOTS, K, BS = 48, 4, 4, 4


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _quant(rng, shape, hkv):
    """Seeded float32 K/V quantized by the JAX package: (codes, scales)
    as numpy arrays — identical int8 inputs for both sides."""
    q, s = jax_kvq.quantize_heads(
        jnp.asarray(rng.standard_normal(shape).astype(np.float32)), hkv)
    return np.array(q), np.array(s)


# ------------------------------------------------------------ quant/kv

@pytest.mark.parametrize("shape, hkv", [((5, 7, 64), 2), ((3, 16), 1),
                                        ((2, 4, 9, 32), 4)])
def test_quantize_heads_matches_jax(np_rng, shape, hkv):
    x = (np_rng.standard_normal(shape) * 3).astype(np.float32)
    xh = x.reshape(-1, hkv, shape[-1] // hkv)
    xh[1, 0] = 0.0                                  # a zero head
    xh[0, 0, :3] = (127.0, 2.5, -3.5)               # scale 1: ties round
    #                                                 half to even
    qj, sj = jax_kvq.quantize_heads(jnp.asarray(x), hkv)
    qt, st = kvq.quantize_heads(torch.tensor(x), hkv)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        kvq.dequantize_heads(qt, st).numpy(),
        np.asarray(jax_kvq.dequantize_heads(qj, sj)), rtol=1e-6, atol=0)


def test_identity_scale_round_trip_and_zero_head_bit_exact():
    rng = np.random.RandomState(0)
    x = rng.randint(-126, 127, (4, 6, 2, 16)).astype(np.float32)
    x[..., 0] = 127.0                     # per-head amax 127 -> scale 1
    x = x.reshape(4, 6, 32)
    q, s = kvq.quantize_heads(torch.tensor(x), 2)
    np.testing.assert_array_equal(s.numpy(), np.ones((4, 6, 2)))
    np.testing.assert_array_equal(kvq.dequantize_heads(q, s).numpy(), x)
    q, s = kvq.quantize_heads(torch.zeros(3, 5, 32), 2)
    assert q.shape == (3, 5, 32) and s.shape == (3, 5, 2)
    assert not s.any() and not kvq.dequantize_heads(q, s).any()
    with pytest.raises(ValueError, match="Hkv"):
        kvq.quantize_heads(torch.zeros(2, 30), 4)


def test_budget_helpers_match_jax(np_rng):
    assert (kvq.GREEDY_PREFIX_MIN, kvq.GREEDY_PREFIX_MIN_FULL,
            kvq.LOGIT_ERR_BUDGET, kvq.KV_DTYPES) == (
        jax_kvq.GREEDY_PREFIX_MIN, jax_kvq.GREEDY_PREFIX_MIN_FULL,
        jax_kvq.LOGIT_ERR_BUDGET, jax_kvq.KV_DTYPES)
    for a, b in (([1, 2, 3], [1, 2, 4]), ([5], [5, 6]), (None, [1])):
        assert kvq.greedy_prefix_len(a, b) == jax_kvq.greedy_prefix_len(a, b)
    ref = np_rng.standard_normal((3, 5, 8)).astype(np.float32)
    got = ref + np_rng.standard_normal((3, 5, 8)).astype(np.float32) * 1e-2
    lens = np.asarray([5, 2, 1])
    np.testing.assert_array_equal(
        kvq.logit_err(torch.tensor(ref), torch.tensor(got), lens),
        jax_kvq.logit_err(ref, got, lens))
    for dkv, hkv in ((512, 8), (128, 2)):
        for kd in kvq.KV_DTYPES:
            assert kvq.kv_bytes_per_position(dkv, hkv, kd) \
                == jax_kvq.kv_bytes_per_position(dkv, hkv, kd)


# ------------------------------------------------------------ decode kernels

# name: (rows as (live lanes, lane-0 position), K, block size, H, Hkv,
#        dh).  The last row is a free row (position 0, table all scratch);
#        rows 1 and 2 share their leading blocks.
CASES = {
    "mixed": ([(1, 9), (4, 8), (2, 17), (4, 20), (1, 0)], 4, 8, 2, 2, 16),
    "gqa": ([(1, 15), (3, 13), (4, 28), (2, 7), (1, 0)], 4, 8, 4, 2, 16),
    "mqa_dh32": ([(5, 0), (8, 11), (3, 30), (1, 0)], 8, 8, 2, 1, 32),
}


def _int8_inputs(name, rng):
    """(q [S, K, D], slab codes/scales [S, T, .], pool codes/scales
    [NB, bs, .], qpos [S, K], tables [S, nb], H).  The stale block that
    table entries past a row's furthest block point at has NaN scales:
    no row may read it."""
    rows, kk, bs, h, hkv, dh = CASES[name]
    s = len(rows)
    qpos = np.asarray([start + np.minimum(np.arange(kk), live - 1)
                       for live, start in rows], np.int32)
    span = qpos[:, -1] // bs + 1
    nb_row = int(span.max()) + 1
    num_blocks = int(span.sum()) + 2
    ids = rng.permutation(np.arange(1, num_blocks))
    stale, ids = int(ids[0]), list(ids[1:])
    tables = np.full((s, nb_row), stale, np.int32)
    for r in range(s - 1):
        tables[r, :span[r]] = [ids.pop() for _ in range(span[r])]
    share = int(min(span[1], span[2]))
    tables[2, :share] = tables[1, :share]
    tables[s - 1] = kv_pool.SCRATCH_BLOCK
    q = rng.standard_normal((s, kk, h * dh)).astype(np.float32)
    t = nb_row * bs
    slab = [_quant(rng, (s, t, hkv * dh), hkv) for _ in range(2)]
    pool = [_quant(rng, (num_blocks, bs, hkv * dh), hkv) for _ in range(2)]
    for _codes, scales in pool:
        scales[stale] = np.nan
    return q, slab, pool, qpos, tables, h


def _jx(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_slab_plain_versions_match_jax_kernels(np_rng, name):
    q, ((kc, ksc), (vc, vsc)), _pool, qpos, _tables, h = _int8_inputs(
        name, np_rng)
    want = np.asarray(jax_dk.decode_attention_slab_chunk(
        *_jx(q, kc, vc, qpos), h, interpret=True, kscale=jnp.asarray(ksc),
        vscale=jnp.asarray(vsc)))
    tq, tk, tv, tqp, tks, tvs = _t(q, kc, vc, qpos, ksc, vsc)
    got = dk.decode_attention_slab_chunk_plain(tq, tk, tv, tqp, h,
                                               kscale=tks, vscale=tvs)
    np.testing.assert_allclose(got.numpy(), want, atol=KTOL, rtol=KTOL)
    decode = qpos[:, -1] == qpos[:, 0]
    assert not got.numpy()[decode, 1:].any()
    # the plain version is the float32 one over dequantize_heads(cache)
    np.testing.assert_array_equal(
        got.numpy(), dk.decode_attention_slab_chunk_plain(
            tq, kvq.dequantize_heads(tk, tks),
            kvq.dequantize_heads(tv, tvs), tqp, h).numpy())
    q1, pos = np.ascontiguousarray(q[:, 0]), qpos[:, 0].copy()
    want1 = np.asarray(jax_dk.decode_attention_slab(
        *_jx(q1, kc, vc, pos), h, interpret=True, kscale=jnp.asarray(ksc),
        vscale=jnp.asarray(vsc)))
    before = (dk.launches_i8, dk.launches_slab_i8)
    got1 = dk.decode_attention_slab(*_t(q1, kc, vc, pos), h, kscale=tks,
                                    vscale=tvs)
    np.testing.assert_allclose(got1.numpy(), want1, atol=KTOL, rtol=KTOL)
    dk.decode_attention_slab_chunk(tq, tk, tv, tqp, h, kscale=tks,
                                   vscale=tvs)
    # CPU tensors take the plain versions: no launch is counted
    assert (dk.launches_i8, dk.launches_slab_i8) == before


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_paged_plain_versions_match_jax_kernels(np_rng, name):
    q, _slab, ((kc, ksc), (vc, vsc)), qpos, tables, h = _int8_inputs(
        name, np_rng)
    scales = dict(kscale=jnp.asarray(ksc), vscale=jnp.asarray(vsc))
    tscales = dict(zip(("kscale", "vscale"), _t(ksc, vsc)))
    want = np.asarray(jax_dk.decode_attention_paged_chunk(
        *_jx(q, kc, vc, qpos, tables), h, interpret=True, **scales))
    got = dk.decode_attention_paged_chunk(*_t(q, kc, vc, qpos, tables), h,
                                          **tscales).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=KTOL, rtol=KTOL)
    q1, pos = np.ascontiguousarray(q[:, 0]), qpos[:, 0].copy()
    want1 = np.asarray(jax_dk.decode_attention_paged(
        *_jx(q1, kc, vc, pos, tables), h, interpret=True, **scales))
    got1 = dk.decode_attention_paged_plain(*_t(q1, kc, vc, pos, tables), h,
                                           **tscales).numpy()
    assert np.isfinite(got1).all()
    np.testing.assert_allclose(got1, want1, atol=KTOL, rtol=KTOL)


def _good_int8(np_rng):
    q, ((kc, ksc), (vc, vsc)), _pool, qpos, _tables, h = _int8_inputs(
        "mixed", np_rng)
    return dict(zip(("q", "k", "v", "qpos", "kscale", "vscale"),
                    _t(q, kc, vc, qpos, ksc, vsc)), num_heads=h)


@pytest.mark.parametrize("bad, match", [
    (lambda a: dict(a, vscale=None), "come together"),
    (lambda a: dict(a, kscale=None), "come together"),
    (lambda a: dict(a, kscale=a["kscale"][:, :-1].contiguous()),
     "sidecars must be"),
    (lambda a: dict(a, vscale=a["vscale"].repeat(1, 1, 2)),
     "sidecars must be"),
    (lambda a: dict(a, k=a["k"].float(), v=a["v"].float()), "int8"),
])
def test_check_scales_errors(np_rng, bad, match):
    args = bad(_good_int8(np_rng))
    with pytest.raises(ValueError, match=match):
        dk.decode_attention_slab_chunk(**args)
    with pytest.raises(ValueError, match=match):
        dk.decode_attention_slab_chunk_plain(**args)
    one = dict(args, q=args["q"][:, 0].contiguous(),
               positions=args.pop("qpos")[:, 0].contiguous())
    with pytest.raises(ValueError, match=match):
        dk.decode_attention_slab(**one)
    # int8 codes without their scales are not a float32 cache
    with pytest.raises(TypeError):
        dk.decode_attention_slab_chunk(**dict(_good_int8(np_rng),
                                              kscale=None, vscale=None))


# ------------------------------------------------------------ flash quant

@pytest.mark.parametrize("b, h, hkv, t, dh", [(2, 2, 2, 16, 16),
                                              (1, 4, 2, 24, 16),
                                              (2, 4, 1, 8, 32)])
def test_flash_quant_plain_matches_jax_kernel(np_rng, b, h, hkv, t, dh):
    q = np_rng.standard_normal((b, t, h * dh)).astype(np.float32)
    (kc, ksc), (vc, vsc) = (_quant(np_rng, (b, t, hkv * dh), hkv)
                            for _ in range(2))
    want = np.asarray(jax_fa.flash_attention_quant(
        *_jx(q, kc, vc, ksc, vsc), h, interpret=True))
    before = fk.launches_quant
    got = fk.flash_attention_quant(*_t(q, kc, vc, ksc, vsc), h).numpy()
    assert got.shape == (b, h, t, dh) and fk.launches_quant == before
    np.testing.assert_allclose(got, want, atol=KTOL, rtol=KTOL)


def test_flash_quant_plain_ragged_t_matches_jax_reference(np_rng):
    """T = 13, which the Pallas kernel's blocking does not cover: the
    port takes it (the CUDA kernel masks ragged edges), held against the
    JAX masked path over the dequantized, head-repeated K/V."""
    b, h, hkv, t, dh = 2, 4, 2, 13, 16
    q = np_rng.standard_normal((b, t, h * dh)).astype(np.float32)
    (kc, ksc), (vc, vsc) = (_quant(np_rng, (b, t, hkv * dh), hkv)
                            for _ in range(2))

    def split(a, hh):
        return jnp.asarray(a).reshape(b, t, hh, dh).transpose(0, 2, 1, 3)

    kw = jax_kvq.dequantize_heads(jnp.asarray(kc), jnp.asarray(ksc))
    vw = jax_kvq.dequantize_heads(jnp.asarray(vc), jnp.asarray(vsc))
    want = np.asarray(jax_dpa(split(q, h), jax_repeat(split(kw, hkv), h),
                              jax_repeat(split(vw, hkv), h), causal=True))
    got = fk.flash_attention_quant_plain(*_t(q, kc, vc, ksc, vsc), h)
    np.testing.assert_allclose(got.numpy(), want, atol=KTOL, rtol=KTOL)


def test_flash_quant_validation(np_rng):
    q = torch.tensor(np_rng.standard_normal((1, 8, 32)).astype(np.float32))
    (kc, ksc), (vc, vsc) = (_t(*_quant(np_rng, (1, 8, 16), 1))
                            for _ in range(2))
    fk.flash_attention_quant(q, kc, vc, ksc, vsc, 2)          # dh 16, GQA
    with pytest.raises(ValueError, match="sidecars required"):
        fk.flash_attention_quant(q, kc, vc, None, vsc, 2)
    with pytest.raises(ValueError, match="sidecars must be"):
        fk.flash_attention_quant(q, kc, vc, ksc[:, :4].contiguous(), vsc, 2)
    with pytest.raises(ValueError, match="int8"):
        fk.flash_attention_quant(q, kc.float(), vc.float(), ksc, vsc, 2)
    (k160, ks160), (v160, vs160) = (_t(*_quant(np_rng, (1, 8, 160), 1))
                                    for _ in range(2))
    with pytest.raises(ValueError, match="head dim"):          # dh 160
        fk.flash_attention_quant(torch.zeros(1, 8, 160), k160, v160, ks160,
                                 vs160, 1)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fk.flash_attention_quant(q[:, :5].contiguous(), kc, vc, ksc, vsc, 2)


# ------------------------------------------------------------ trunk

@pytest.fixture(scope="module", params=["learned", "gqa_rope"])
def pair(request):
    cfg = (dict(d_model=D_MODEL, num_heads=HEADS)
           if request.param == "learned"
           else dict(d_model=64, num_heads=4, num_kv_heads=2,
                     pos_type="rope"))
    jp = jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                     dff=DFF, enc_layers=LAYERS, dec_layers=0,
                     max_len=MAX_LEN, **cfg)
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    return cfg["num_heads"], cfg.get("pos_type", "learned"), jp, tp


def _int8_close(got, want, sl=slice(None)):
    """One layer's int8 caches agree: codes within 1, scales rtol 1e-5,
    the dequantized K/V within one quantization step of the head."""
    for key, skey in (("k", "ks"), ("v", "vs")):
        gc, gs = got[key][sl], got[skey][sl]
        wc = torch.tensor(np.asarray(want[key])[sl])
        ws = torch.tensor(np.asarray(want[skey])[sl])
        assert gc.dtype == torch.int8 and wc.dtype == torch.int8
        assert (gc.int() - wc.int()).abs().max() <= 1
        np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=1e-5,
                                   atol=0)
        step = torch.repeat_interleave(ws, gc.shape[-1] // ws.shape[-1], -1)
        err = (kvq.dequantize_heads(gc, gs)
               - kvq.dequantize_heads(wc, ws)).abs()
        assert bool((err <= step * 1.001 + 1e-12).all())


def test_int8_prefill_matches_jax(pair, np_rng):
    heads, pos_type, jp, tp = pair
    prompt = np_rng.randint(1, VOCAB, (2, 16)).astype(np.int32)
    with jax_fa.forced_prefill_quant_mode("always"):
        jh, jc = jax_tf.lm_prefill(jp, jnp.asarray(prompt), MAX_LEN, heads,
                                   pos_type=pos_type, kv_dtype="int8")
    th, tc = torch_tf.lm_prefill(tp, prompt, MAX_LEN, heads,
                                 pos_type=pos_type, kv_dtype="int8")
    np.testing.assert_allclose(
        torch_tf._lm_project(tp, th).numpy(),
        np.asarray(jax_tf._lm_project(jp, jh)), atol=TOL, rtol=TOL)
    for g, w in zip(tc, jc):
        assert set(g) == {"k", "v", "ks", "vs"}
        _int8_close(g, w)
    # against the float32 twin: inside the committed logit budget
    fh, _ = torch_tf.lm_prefill(tp, prompt, MAX_LEN, heads,
                                pos_type=pos_type)
    err = kvq.logit_err(torch_tf._lm_project(tp, fh),
                        torch_tf._lm_project(tp, th))
    assert (err <= kvq.LOGIT_ERR_BUDGET).all() and err.max() > 0


def _layer0_kv(tp, prompt, heads, pos_type):
    """Layer 0's float32 K/V of ``lm_prefill`` over the whole prompt, as
    it computes them: one product over every position."""
    ids = torch_tf._ids(prompt, torch.device("cpu"))
    x = torch_tf._lm_embed(tp, ids)
    x = x * math.sqrt(x.shape[-1])
    if pos_type == "learned":
        x = x + tp["pos"][:ids.shape[1]][None]
    blk = tp["enc"][0]
    h = torch_tf._ln(blk["ln1"], x)
    k = linear.matmul(h, blk["attn"]["wk"])
    v = linear.matmul(h, blk["attn"]["wv"])
    if pos_type == "rope":
        dh = x.shape[-1] // heads
        k = torch_tf._rope_flat(k, torch.arange(ids.shape[1]), dh)
    return k, v


def test_int8_prefill_cache_equals_sequential_steps(pair, np_rng):
    """lm_prefill's int8 cache against Tp sequential lm_decode_step calls
    in the port.  Layer 0's codes are bit for bit and its scales within
    rtol 1e-6: its K/V come from one product over the prompt's 24 rows
    in the prefill and from 12 two-row products in the steps, and the
    CPU's GEMM may round the two 1 ulp apart (seen on some CPUs, not on
    others), which moves amax / 127 by as much.  Layer 0's cache is then
    held bit for bit, codes and scales alike, to the prefill's own K/V
    re-quantized one position at a time through quant/kv.py: the
    quantization is a function of the written K/V alone.  Later layers'
    K/V come through attention summed in another order, so their codes
    are held equal and their scales to rtol 1e-6 (the 1-ulp amax / 127
    drift the JAX package's tests allow)."""
    heads, pos_type, _jp, tp = pair
    tpn = 12
    prompt = np_rng.randint(1, VOCAB, (2, tpn)).astype(np.int32)
    _h, cache = torch_tf.lm_prefill(tp, prompt, MAX_LEN, heads,
                                    pos_type=pos_type, kv_dtype="int8")
    seq = torch_tf.init_lm_cache(tp, 2, MAX_LEN, kv_dtype="int8",
                                 num_heads=heads)
    for t in range(tpn):
        _l, seq = torch_tf.lm_decode_step(tp, prompt[:, t], t, seq, heads,
                                          pos_type=pos_type)
    for g, w in zip(cache, seq):
        for key in ("k", "v"):
            assert torch.equal(g[key][:, :tpn], w[key][:, :tpn])
        for key in ("ks", "vs"):
            np.testing.assert_allclose(g[key][:, :tpn].numpy(),
                                       w[key][:, :tpn].numpy(), rtol=1e-6)
    k, v = _layer0_kv(tp, prompt, heads, pos_type)
    hkv = cache[0]["ks"].shape[-1]
    for t in range(tpn):
        for x, key, skey in ((k, "k", "ks"), (v, "v", "vs")):
            codes, scales = kvq.quantize_heads(x[:, t:t + 1], hkv)
            assert torch.equal(cache[0][key][:, t:t + 1], codes)
            assert torch.equal(cache[0][skey][:, t:t + 1], scales)


def _tables(rng, nb_row=12, num_blocks=40):
    perm = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((4, nb_row), np.int32)
    tables[0, :6] = perm[:6]
    tables[1, :4] = perm[6:10]
    tables[2, :2] = tables[0, :2]
    tables[2, 2:6] = perm[10:14]
    return tables


def test_int8_steps_match_jax(pair, np_rng):
    """lm_decode_chunk_slots / _paged and lm_decode_step_slots / _paged
    over int8 caches against their JAX twins."""
    heads, pos_type, jp, tp = pair
    tables = _tables(np_rng)
    q8 = dict(kv_dtype="int8", num_heads=heads)
    caches = {
        "slab": (jax_tf.init_lm_cache(jp, 4, MAX_LEN, **q8),
                 torch_tf.init_lm_cache(tp, 4, MAX_LEN, **q8)),
        "paged": (jax_tf.init_lm_cache_paged(jp, 40, BS, max_len=MAX_LEN,
                                             **q8),
                  torch_tf.init_lm_cache_paged(tp, 40, BS, max_len=MAX_LEN,
                                               **q8))}
    for layout, (jc, tc) in caches.items():
        extra_j = (jnp.asarray(tables),) if layout == "paged" else ()
        extra_t = (tables,) if layout == "paged" else ()
        chunk_j = (jax_tf.lm_decode_chunk_paged if layout == "paged"
                   else jax_tf.lm_decode_chunk_slots)
        chunk_t = (torch_tf.lm_decode_chunk_paged if layout == "paged"
                   else torch_tf.lm_decode_chunk_slots)
        step_j = (jax_tf.lm_decode_step_paged if layout == "paged"
                  else jax_tf.lm_decode_step_slots)
        step_t = (torch_tf.lm_decode_step_paged if layout == "paged"
                  else torch_tf.lm_decode_step_slots)
        pos = np.asarray([0, 2, 8, 0], np.int32)
        rng = np.random.RandomState(7)
        for lens in ([4, 3, 2, 1], [4, 1, 4, 1]):
            lens = np.asarray(lens, np.int32)
            toks = rng.randint(1, VOCAB, (4, K)).astype(np.int32)
            jl, jc = chunk_j(jp, *_jx(toks, pos, lens), jc, *extra_j, heads,
                             pos_type=pos_type)
            tl, tc = chunk_t(tp, toks, pos, lens, tc, *extra_t, heads,
                             pos_type=pos_type)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                       rtol=TOL)
            pos = pos + lens
        pos[3] = 0                                # the free row
        toks = rng.randint(1, VOCAB, 4).astype(np.int32)
        jl, jc = step_j(jp, *_jx(toks, pos), jc, *extra_j, heads,
                        pos_type=pos_type)
        tl, tc = step_t(tp, toks, pos, tc, *extra_t, heads,
                        pos_type=pos_type)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        # block 0 / free rows are scratch, written in either order
        sl = slice(1, None) if layout == "paged" else slice(0, 3)
        for g, w in zip(tc, jc):
            _int8_close(g, w, sl)


def test_int8_chunk_fed_cache_matches_own_prefill(pair, np_rng):
    """A prompt fed K lanes at a time through the int8 chunk step leaves
    the int8 cache the port's own lm_prefill writes (codes equal,
    scales rtol 1e-6, as the sequential steps), and its last logits."""
    heads, pos_type, _jp, tp = pair
    n = 15
    prompt = np_rng.randint(1, VOCAB, n).astype(np.int32)
    hidden, want = torch_tf.lm_prefill(tp, prompt[None], MAX_LEN, heads,
                                       pos_type=pos_type, kv_dtype="int8")
    cache = torch_tf.init_lm_cache(tp, 1, MAX_LEN, kv_dtype="int8",
                                   num_heads=heads)
    for start in range(0, n, K):
        piece = prompt[start:start + K]
        toks = np.zeros((1, K), np.int32)
        toks[0, :piece.size] = piece
        logits, cache = torch_tf.lm_decode_chunk_slots(
            tp, toks, [start], [piece.size], cache, heads, pos_type=pos_type)
    for g, w in zip(cache, want):
        for key in ("k", "v"):
            assert torch.equal(g[key][:, :n], w[key][:, :n])
        for key in ("ks", "vs"):
            np.testing.assert_allclose(g[key][:, :n].numpy(),
                                       w[key][:, :n].numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        logits.numpy(), torch_tf._lm_project(tp, hidden[:, -1]).numpy(),
        atol=TOL, rtol=TOL)


def test_int8_cache_buffers_and_validation():
    p = torch_tf.init_lm(torch.Generator().manual_seed(0), VOCAB, 64, 4, DFF,
                         LAYERS, MAX_LEN, num_kv_heads=2, device="cpu")
    slab = torch_tf.init_lm_cache(p, 3, MAX_LEN, kv_dtype="int8", num_heads=4)
    assert slab[0]["k"].dtype == torch.int8 and slab[0]["k"].shape == (
        3, MAX_LEN, 32)
    assert slab[0]["ks"].dtype == torch.float32 and slab[0]["vs"].shape == (
        3, MAX_LEN, 2)
    pool = torch_tf.init_lm_cache_paged(p, 9, BS, kv_dtype="int8",
                                        num_heads=4)
    assert pool[1]["ks"].shape == (9, BS, 2) and len(pool) == LAYERS
    assert set(torch_tf.init_lm_cache(p, 1, 8)[0]) == {"k", "v"}
    with pytest.raises(ValueError, match="num_heads"):
        torch_tf.init_lm_cache(p, 1, 8, kv_dtype="int8")
    with pytest.raises(ValueError, match="does not divide"):
        torch_tf.init_lm_cache_paged(p, 4, BS, kv_dtype="int8", num_heads=3)
    with pytest.raises(ValueError, match="kv_dtype"):
        torch_tf.init_lm_cache_paged(p, 4, BS, kv_dtype="fp8", num_heads=4)


# ------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def params():
    return torch_tf.init_lm(torch.Generator().manual_seed(0), VOCAB,
                            D_MODEL, HEADS, DFF, LAYERS, MAX_LEN,
                            device="cpu")


def _engine(params, **kw):
    kw.setdefault("prefill_chunk", K)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("kv_dtype", "int8")
    return DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                        max_len=MAX_LEN, device="cpu", **kw)


def _reference(params, prompt, n_tok):
    """The int8 lm_generate continuation and its top-1/top-2 margins."""
    ids = torch_tf.lm_generate(params, np.asarray([prompt]),
                               len(prompt) + n_tok, HEADS, kv_dtype="int8")
    hidden, _ = torch_tf.lm_prefill(params, ids, ids.shape[1], HEADS,
                                    kv_dtype="int8")
    top2 = torch.topk(torch_tf._lm_project(params, hidden), 2, dim=-1)
    margin = (top2.values[0, :, 0] - top2.values[0, :, 1]).numpy()
    return ids[0, len(prompt):].tolist(), margin[len(prompt) - 1:]


def check_streams(params, cases, outs):
    checked = total = 0
    for (prompt, n_tok), toks in zip(cases, outs):
        ref, margin = _reference(params, prompt, n_tok)
        assert len(toks) == n_tok
        for t, tok in enumerate(toks):
            if margin[t] < MARGIN:
                break
            assert tok == ref[t], (len(prompt), t, toks, ref)
            checked += 1
        total += n_tok
    assert checked >= 0.9 * total


def _watch_cow_forks(eng):
    """Record every copy-on-write fork ``prepare_step`` makes and check,
    right after it, that the private copy holds every leaf of the
    source block — codes and scales — before the step writes into it."""
    forks = []
    plan_fn, prepare = eng._paged.write_plan, eng.prepare_step

    def write_plan(slot, p):
        plan = plan_fn(slot, p)
        if plan is not None and plan[0] == "cow":
            forks.append(plan[2:])
        return plan

    def prepare_step():
        n0 = len(forks)
        victims = prepare()
        for src, dst in forks[n0:]:
            for c in eng._cache:
                assert set(c) == {"k", "v", "ks", "vs"}
                for buf in c.values():
                    assert torch.equal(buf[dst], buf[src])
                assert c["ks"][src].any()
        return victims

    eng._paged.write_plan = write_plan
    eng.prepare_step = prepare_step
    return forks


@pytest.mark.parametrize("layout, chunk", [("slab", K), ("paged", K),
                                           ("slab", 0), ("paged", 0)])
def test_int8_engine_streams_match_int8_lm_generate(params, layout, chunk):
    """Both layouts, chunked and on the ladder: staggered requests (a
    duplicate of a resident prompt among them, so the paged layout seats
    it by reference and forks the shared tail block) each equal the
    port's int8 lm_generate."""
    rng = np.random.RandomState(5)
    lead = rng.randint(1, VOCAB, 10).tolist()           # 2.5 blocks
    rest = [(lead, 6)] + [(rng.randint(1, VOCAB, n).tolist(), 6)
                          for n in (3, 17, 9)]
    eng = _engine(params, kv_layout=layout, prefill_chunk=chunk,
                  prefill_buckets=(8, 24))
    forks = _watch_cow_forks(eng) if layout == "paged" else None
    with GenerationBatcher(eng) as gen:
        outs = [gen.generate(lead, max_tokens=6, timeout=60)["tokens"]]
        futs = [gen.submit(p, max_tokens=n) for p, n in rest]
        outs += [f.result(timeout=120)["tokens"] for f in futs]
    assert outs[1] == outs[0]
    check_streams(params, [(lead, 6)] + rest, outs)
    snap = eng.metrics.snapshot()
    assert snap["kv_dtype"] == "int8"
    if layout == "paged":
        assert snap["prefix_cache_hits_total"] >= 1
        assert snap["cow_forks_total"] >= 1 and forks
        eng._paged.check()


def test_int8_paged_auto_pool_doubles_blocks_at_equal_bytes(params):
    per_row = MAX_LEN // BS
    f32 = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                       max_len=MAX_LEN, prefill_chunk=K, device="cpu",
                       warm=False)
    eng = _engine(params, kv_layout="paged", warm=False)
    assert eng._paged.pool.num_blocks == 2 * SLOTS * per_row + 1
    assert kv_pool.slab_equivalent_blocks(SLOTS, MAX_LEN, BS, "int8") \
        == jax_pool.slab_equivalent_blocks(SLOTS, MAX_LEN, BS, "int8")
    assert kv_pool.slab_equivalent_blocks(SLOTS, MAX_LEN, BS) \
        == jax_pool.slab_equivalent_blocks(SLOTS, MAX_LEN, BS)

    def kv_bytes(cache):
        return sum(t.numel() * t.element_size() for c in cache
                   for t in c.values())

    # the pool (scratch block aside) fits inside the float32 slab's bytes
    scratch = sum(t[0].numel() * t.element_size() for c in eng._cache
                  for t in c.values())
    assert kv_bytes(eng._cache) - scratch <= kv_bytes(f32._cache)
    assert eng._cache[0]["k"].dtype == torch.int8


def test_kv_dtype_validation(params):
    with pytest.raises(ConfigError, match="kv_dtype"):
        _engine(params, kv_dtype="bf16", warm=False)
    with pytest.raises(ConfigError, match="kv_dtype"):
        _engine(params, kv_dtype="fp8", kv_layout="paged", warm=False)
    assert _engine(params, kv_dtype="float32", warm=False).kv_dtype \
        == "float32"


def test_http_int8_server_and_metrics():
    """``build_gen_batcher(kv_dtype="int8")`` (the CLI's ``--kv-dtype
    int8``) serves plain and streamed requests, equal to the int8
    lm_generate, and /metrics reports ``kv_cache_int8 1``."""
    gen = torch_server.build_gen_batcher(
        slots=SLOTS, max_len=MAX_LEN, prefill_chunk=K, device="cpu",
        kv_dtype="int8", vocab=VOCAB, d_model=D_MODEL, num_heads=HEADS,
        dff=DFF, layers=LAYERS)
    eng = gen.engine
    assert eng.kv_dtype == "int8" and eng._cache[0]["k"].dtype == torch.int8
    httpd = make_server(gen_batcher=gen)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.port}"
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    outs = []
    try:
        for stream in (False, True):
            req = urllib.request.Request(
                f"{base}/v1/generate",
                data=json.dumps({"prompt": prompt, "max_tokens": 6,
                                 "stream": stream}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                raw = r.read().decode()
            outs.append([json.loads(ln) for ln in raw.splitlines()][-1]
                        ["tokens"])
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        gen.close()
    assert outs[0] == outs[1]
    check_streams(eng.params, [(prompt, 6)], outs[:1])
    assert f"{eng.metrics.name}_kv_cache_int8 1" in text
    f32 = DecodeEngine(eng.params, num_heads=HEADS, num_slots=SLOTS,
                       max_len=MAX_LEN, device="cpu", warm=False)
    assert f"{f32.metrics.name}_kv_cache_int8 0" \
        in f32.metrics.render_prometheus()
    assert f32.metrics.snapshot()["kv_dtype"] == "float32"


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged"),
                                dict(prefill_chunk=0)])
def test_no_card_refuses_int8_without_device_cpu(params, kw):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                     max_len=MAX_LEN, kv_dtype="int8", **kw)
    argv = ["--kv-dtype", "int8", "--kv-layout", kw.get("kv_layout", "slab"),
            "--prefill-chunk", str(kw.get("prefill_chunk", 8))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_server.main(argv)
