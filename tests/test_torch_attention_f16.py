"""float16 operands of the attention kernels (B1-B8) on the CPU: the
plain versions the port's CUDA kernels are held to on the card, against
the JAX package's Pallas kernels in interpret mode, which widen a
float16 operand on load as they widen bf16 -- the flash forward and its
vjp (the dK/dV and dQ kernels) at a compiled head dim and at one the
wrappers pad, for every combination of float32 and float16 q, k and v
and two that mix float16 with bf16; ``flash_attention_quant`` with
float16 q over the int8 cache; the four decode kernels (slab and paged,
chunked and Tq=1) over a float32, float16, mixed or int8 cache -- plus
the wrappers' admission of float16 and its dtype bits.

Tolerances, as tests/test_torch_attention_bf16.py states them: both
sides widen every operand on load and compute in float32 in other
summation orders (1e-5 absolute and relative, 2e-5 through the
backward's three products), and round each output once to its
operand's dtype, so a float16 output may also lie one float16 step
(2^-10 of its power of two) apart, a bf16 one one bf16 step (2^-7).
"""

import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu.quant import kv as jax_kvq
from paddle_tpu_torch.ops.kernels import _check
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.ops.kernels import flash_attention as fk

import importlib

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

F32, BF, F16 = torch.float32, torch.bfloat16, torch.float16
JDT = {F32: jnp.float32, BF: jnp.bfloat16, F16: jnp.float16}
STEP_BITS = {BF: 7, F16: 10}
COMBOS = [c for c in itertools.product((F32, F16), repeat=3)
          if c != (F32, F32, F32)] + [(F16, BF, F32), (BF, F16, F16)]
SHORT = {F32: "32", BF: "bf", F16: "h"}
IDS = ["".join(n + SHORT[d] for n, d in zip("qkv", c)) for c in COMBOS]
TOL = 1e-5


def _both(a, dt):
    """(jax array, torch tensor) of ``a`` rounded to ``dt``."""
    r = np.asarray(jnp.asarray(a, jnp.float32).astype(JDT[dt])
                   .astype(jnp.float32))
    return jnp.asarray(r).astype(JDT[dt]), torch.tensor(r).to(dt)


def _close(got, want, what, tol=TOL):
    """``got`` in ``want``'s dtype and within the module's tolerance."""
    want_dt = {jnp.dtype(v): k for k, v in JDT.items()}[
        jnp.asarray(want).dtype]
    assert got.dtype == want_dt, (what, got.dtype, want_dt)
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    bound = tol + tol * np.abs(w)
    if want_dt in STEP_BITS:
        with np.errstate(divide="ignore"):
            bound = bound + np.exp2(np.floor(np.log2(np.abs(w)))
                                    - STEP_BITS[want_dt])
    bad = np.abs(g - w) > bound
    assert not bad.any(), (what, float(np.abs(g - w).max()), int(bad.sum()))


# ------------------------------------------------------------------ flash

@pytest.mark.parametrize("dts,dh", [(c, 16) for c in COMBOS]
                         + [((F16, F16, F16), 24)],
                         ids=IDS + ["qhkhvh-24"])
def test_flash_plain_matches_the_kernels(dts, dh):
    """The causal forward and its vjp (dq, dk, dv from the dQ and dK/dV
    kernels in interpret mode) against ``FlashAttention`` on the CPU
    (the plain forward and backward; dh 24, all float16, through the
    wrappers' padding)."""
    rng = np.random.RandomState(17)
    b, h, t = 1, 2, 32
    js, ts = zip(*(_both(rng.standard_normal((b, h, t, dh)), d)
                   for d in dts))
    jo, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(
        q, k, v, causal=True, block_q=16, block_k=16, interpret=True), *js)
    jg, tg = _both(rng.standard_normal((b, h, t, dh)), dts[0])
    jgrads = vjp(jg)
    leaves = [x.clone().requires_grad_(True) for x in ts]
    o = fk.FlashAttention.apply(*leaves, None, True)
    _close(o.detach(), jo, "o")
    o.backward(tg)
    for name, leaf, want in zip("qkv", leaves, jgrads):
        _close(leaf.grad, want, f"d{name}", 2 * TOL)


def test_flash_quant_takes_f16_q():
    """float16 q over the int8 cache (grouped KV heads), o in float16."""
    rng = np.random.RandomState(18)
    b, t, h, hkv, dh = 1, 32, 4, 2, 16
    jq, tq = _both(rng.standard_normal((b, t, h * dh)), F16)
    k = rng.standard_normal((b, t, hkv * dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv * dh)).astype(np.float32)
    (kc, ks), (vc, vs) = (jax_kvq.quantize_heads(jnp.asarray(x), hkv)
                          for x in (k, v))
    want = jax_fa.flash_attention_quant(jq, kc, vc, ks, vs, h, causal=True,
                                        block_q=16, block_k=16,
                                        interpret=True)
    got = fk.flash_attention_quant(
        tq, *(torch.tensor(np.asarray(x)) for x in (kc, vc, ks, vs)), h)
    _close(got, want, "o")


# ----------------------------------------------------------------- decode

S, KK, T, H, HKV, DH, BS = 3, 4, 24, 4, 2, 16, 8
QPOS = np.asarray([[9, 9, 9, 9], [0, 1, 2, 3], [17, 18, 19, 19]], np.int32)


def _pool(rng, k, v):
    """The slab rows laid into a shuffled pool of BS-blocks plus tables
    (each row's chain of T / BS blocks)."""
    nb_row = T // BS
    ids = rng.permutation(S * nb_row + 2)[:S * nb_row].reshape(S, nb_row)
    pool = [np.zeros((S * nb_row + 2, BS, x.shape[-1]), x.dtype)
            for x in (k, v)]
    for r in range(S):
        for j in range(nb_row):
            for p, x in zip(pool, (k, v)):
                p[ids[r, j]] = x[r, j * BS:(j + 1) * BS]
    return pool[0], pool[1], ids.astype(np.int32)


def _cache(rng, dts):
    """((jax, torch) k, v, pool k, pool v) in ``dts[1:]``'s dtypes, or an
    int8 cache with its scales where ``dts[1]`` is int8, plus the
    tables."""
    k = rng.standard_normal((S, T, HKV * DH)).astype(np.float32)
    v = rng.standard_normal((S, T, HKV * DH)).astype(np.float32)
    pk, pv, tables = _pool(rng, k, v)
    if dts[1] == torch.int8:
        out = []
        for x in (k, v, pk, pv):
            c, s = jax_kvq.quantize_heads(jnp.asarray(x), HKV)
            out.append(((c, s), tuple(torch.tensor(np.asarray(a))
                                      for a in (c, s))))
        return out, tables
    return [_both(x, d) for x, d in zip((k, v, pk, pv), dts[1:] * 2)], \
        tables


# the decode kernels read each operand's dtype the same way at every
# position of the combination: all float16, each operand float16 alone
# beside float32 ones, float16 beside bf16, and float16 q over int8
DECODE = [(F16, F16, F16), (F16, F32, F32), (F32, F16, F32),
          (F32, F32, F16), (F16, BF, F32), (F16, torch.int8, torch.int8)]


@pytest.mark.parametrize("dts", DECODE, ids=["qhkhvh", "qhk32v32",
                                             "q32khv32", "q32k32vh",
                                             "qhkbfv32", "qh_int8"])
def test_decode_plain_versions_match_the_kernels(dts):
    """The four decode kernels' plain versions at (q, k, v) dtypes
    against JAX's Pallas kernels in interpret mode, grouped KV heads;
    the last case float16 q over an int8 cache."""
    rng = np.random.RandomState(19)
    q = rng.standard_normal((S, KK, H * DH))
    jq, tq = _both(q, dts[0])
    jq1, tq1 = _both(q[:, 0], dts[0])
    cache, tables = _cache(rng, dts)
    (jk, tk), (jv, tv), (jpk, tpk), (jpv, tpv) = cache
    jkw = tkw = jpw = tpw = {}
    if dts[1] == torch.int8:
        (jk, jks), (jv, jvs), (jpk, jpks), (jpv, jpvs) = jk, jv, jpk, jpv
        (tk, tks), (tv, tvs), (tpk, tpks), (tpv, tpvs) = tk, tv, tpk, tpv
        jkw, tkw = dict(kscale=jks, vscale=jvs), dict(kscale=tks, vscale=tvs)
        jpw, tpw = (dict(kscale=jpks, vscale=jpvs),
                    dict(kscale=tpks, vscale=tpvs))
    qpos, pos = torch.tensor(QPOS), torch.tensor(QPOS[:, -1].copy())
    tbl = torch.tensor(tables)
    jqpos, jpos, jtbl = (jnp.asarray(QPOS), jnp.asarray(QPOS[:, -1]),
                         jnp.asarray(tables))
    for name, got, want in (
            ("slab_chunk", dk.decode_attention_slab_chunk(
                tq, tk, tv, qpos, H, **tkw),
             jax_dk.decode_attention_slab_chunk(jq, jk, jv, jqpos, H,
                                                interpret=True, **jkw)),
            ("slab", dk.decode_attention_slab(tq1, tk, tv, pos, H, **tkw),
             jax_dk.decode_attention_slab(jq1, jk, jv, jpos, H,
                                          interpret=True, **jkw)),
            ("paged_chunk", dk.decode_attention_paged_chunk(
                tq, tpk, tpv, qpos, tbl, H, **tpw),
             jax_dk.decode_attention_paged_chunk(
                 jq, jpk, jpv, jqpos, jtbl, H, interpret=True, **jpw)),
            ("paged", dk.decode_attention_paged(tq1, tpk, tpv, pos, tbl, H,
                                                **tpw),
             jax_dk.decode_attention_paged(jq1, jpk, jpv, jpos, jtbl, H,
                                           interpret=True, **jpw))):
        _close(got, want, name)


# -------------------------------------------------------------- admission

def test_wrappers_admit_float16_with_its_own_bits():
    """float16 q, k, v pass ``_check.tensors`` with float32 and bf16 ones
    on the CPU; each operand's float16 bit is its bf16 bit shifted by
    ``LOW_HALF_SHIFT``, so the one low-precision instance tells the two
    apart, and ``operand_suffix`` names float16 rows ``f16``."""
    x = torch.zeros(1, 1, 16, 16)
    o, lse = fk.flash_attention_fwd(x.half(), x.to(BF), x)
    assert o.dtype == F16
    dq, dk_, dv = fk.flash_attention_bwd(x.half(), x.to(BF), x, o, lse,
                                         x.half())
    assert (dq.dtype, dk_.dtype, dv.dtype) == (F16, BF, F32)
    q, kv = torch.zeros(2, 1, 32), torch.zeros(2, 8, 32)
    pos = torch.zeros(2, 1, dtype=torch.int32)
    assert dk.decode_attention_slab_chunk(q.half(), kv.half(), kv.to(BF),
                                          pos, 2).dtype == F16
    shift = _check.LOW_HALF_SHIFT
    assert _check.dtype_bits(x.half(), x, x) == 1 << shift
    assert _check.dtype_bits(x.to(BF), x.half(), x.half()) \
        == 1 | (2 << shift) | (4 << shift)
    assert _check.dtype_bits(x.half(), x.to(torch.int8), None) == 1 << shift
    assert _check.dtype_bits(x, x, x) == 0
    assert _check.operand_suffix(q=q.half(), k=kv.to(BF), v=kv) \
        == "qf16_kbf16_vf32"
