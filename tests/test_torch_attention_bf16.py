"""bf16 operands of the attention kernels (B1-B8) on the CPU: the plain
versions the port's CUDA kernels are held to on the card, against the
JAX package's Pallas kernels in interpret mode, at every combination of
float32 and bf16 q, k and v that JAX's functions take -- the flash
forward and its vjp (the dK/dV and dQ kernels), at a compiled head dim
and at one the wrappers pad; ``flash_attention_quant`` with bf16 q over
the int8 cache; the four decode kernels (slab and paged, chunked and
Tq=1) over a float32, bf16 or int8 cache -- plus the wrappers' dtype
admission and the refusal of a trunk cast to bf16 that JAX's
``lm_generate`` refuses too.

Tolerances, as tests/test_torch_rnn_bf16.py states them: both sides
widen every operand on load, compute in float32 in other summation
orders (1e-5 absolute and relative between them, the float32 decode
tests' tolerance; 2e-5 through the backward's three products), and
round each output once to its operand's dtype, so a bf16 output may
also lie one bf16 step (2^-7 of its power of two) apart where the
float32 values straddle a rounding boundary.
"""

import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu.quant import kv as jax_kvq
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.kernels import _check
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.ops.kernels import flash_attention as fk
from paddle_tpu_torch.utils.tree import tree_map

import importlib

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

F32, BF = torch.float32, torch.bfloat16
JDT = {F32: jnp.float32, BF: jnp.bfloat16}
COMBOS = [c for c in itertools.product((F32, BF), repeat=3)
          if c != (F32, F32, F32)]
IDS = ["".join(("q", "k", "v")[i] + ("bf" if d == BF else "32")
               for i, d in enumerate(c)) for c in COMBOS]
TOL = 1e-5


def _both(a, dt):
    """(jax array, torch tensor) of ``a`` rounded to ``dt``."""
    r = np.asarray(jnp.asarray(a, jnp.float32).astype(JDT[dt])
                   .astype(jnp.float32))
    return jnp.asarray(r).astype(JDT[dt]), torch.tensor(r).to(dt)


def _close(got, want, what, tol=TOL):
    """``got`` in ``want``'s dtype and within the module's tolerance."""
    want_dt = {jnp.dtype(jnp.bfloat16): BF,
               jnp.dtype(jnp.float32): F32}[jnp.asarray(want).dtype]
    assert got.dtype == want_dt, (what, got.dtype, want_dt)
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    bound = tol + tol * np.abs(w)
    if want_dt == BF:
        with np.errstate(divide="ignore"):
            bound = bound + np.exp2(np.floor(np.log2(np.abs(w))) - 7)
    bad = np.abs(g - w) > bound
    assert not bad.any(), (what, float(np.abs(g - w).max()), int(bad.sum()))


# ------------------------------------------------------------------ flash

@pytest.mark.parametrize("dh", [16, 24])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dts", COMBOS, ids=IDS)
def test_flash_plain_matches_the_kernels(dts, causal, dh):
    """The forward and its vjp (dq, dk, dv from the dQ and dK/dV kernels
    in interpret mode) against ``FlashAttention`` on the CPU (the plain
    forward and backward; dh 24 through the wrappers' padding)."""
    rng = np.random.RandomState(7)
    b, h, t = 1, 2, 32
    js, ts = zip(*(_both(rng.standard_normal((b, h, t, dh)), d)
                   for d in dts))
    jo, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(
        q, k, v, causal=causal, block_q=16, block_k=16, interpret=True),
        *js)
    g = rng.standard_normal((b, h, t, dh))
    jg, tg = _both(g, dts[0])
    jgrads = vjp(jg)
    leaves = [x.clone().requires_grad_(True) for x in ts]
    o = fk.FlashAttention.apply(*leaves, None, causal)
    _close(o.detach(), jo, "o")
    o.backward(tg)
    for name, leaf, want in zip("qkv", leaves, jgrads):
        _close(leaf.grad, want, f"d{name}", 2 * TOL)


def test_flash_quant_takes_bf16_q():
    """bf16 q over the int8 cache (grouped KV heads), o in bf16."""
    rng = np.random.RandomState(8)
    b, t, h, hkv, dh = 1, 32, 4, 2, 16
    jq, tq = _both(rng.standard_normal((b, t, h * dh)), BF)
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


@pytest.mark.parametrize("dts", COMBOS, ids=IDS)
def test_decode_plain_versions_match_the_kernels(dts):
    """The four decode kernels' plain versions at (q, k, v) dtypes
    against JAX's Pallas kernels in interpret mode, grouped KV heads."""
    rng = np.random.RandomState(9)
    q = rng.standard_normal((S, KK, H * DH))
    k = rng.standard_normal((S, T, HKV * DH)).astype(np.float32)
    v = rng.standard_normal((S, T, HKV * DH)).astype(np.float32)
    pk, pv, tables = _pool(rng, k, v)
    jq, tq = _both(q, dts[0])
    jq1, tq1 = _both(q[:, 0], dts[0])
    (jk, tk), (jv, tv) = _both(k, dts[1]), _both(v, dts[2])
    (jpk, tpk), (jpv, tpv) = _both(pk, dts[1]), _both(pv, dts[2])
    qpos, pos = torch.tensor(QPOS), torch.tensor(QPOS[:, -1].copy())
    tbl = torch.tensor(tables)
    jqpos, jpos = jnp.asarray(QPOS), jnp.asarray(QPOS[:, -1])
    for name, got, want in (
            ("slab_chunk", dk.decode_attention_slab_chunk(tq, tk, tv, qpos, H),
             jax_dk.decode_attention_slab_chunk(jq, jk, jv, jqpos, H,
                                                interpret=True)),
            ("slab", dk.decode_attention_slab(tq1, tk, tv, pos, H),
             jax_dk.decode_attention_slab(jq1, jk, jv, jpos, H,
                                          interpret=True)),
            ("paged_chunk", dk.decode_attention_paged_chunk(
                tq, tpk, tpv, qpos, tbl, H),
             jax_dk.decode_attention_paged_chunk(
                 jq, jpk, jpv, jqpos, jnp.asarray(tables), H,
                 interpret=True)),
            ("paged", dk.decode_attention_paged(tq1, tpk, tpv, pos, tbl, H),
             jax_dk.decode_attention_paged(jq1, jpk, jpv, jpos,
                                           jnp.asarray(tables), H,
                                           interpret=True))):
        _close(got, want, name)


def test_decode_takes_bf16_q_over_an_int8_cache():
    rng = np.random.RandomState(10)
    q = rng.standard_normal((S, KK, H * DH))
    k = rng.standard_normal((S, T, HKV * DH)).astype(np.float32)
    v = rng.standard_normal((S, T, HKV * DH)).astype(np.float32)
    (kc, ks), (vc, vs) = (jax_kvq.quantize_heads(jnp.asarray(x), HKV)
                          for x in (k, v))
    jq, tq = _both(q, BF)
    tk, tv, tks, tvs = (torch.tensor(np.asarray(x)) for x in (kc, vc, ks,
                                                             vs))
    qpos = torch.tensor(QPOS)
    got = dk.decode_attention_slab_chunk(tq, tk, tv, qpos, H, kscale=tks,
                                         vscale=tvs)
    want = jax_dk.decode_attention_slab_chunk(
        jq, kc, vc, jnp.asarray(QPOS), H, kscale=ks, vscale=vs,
        interpret=True)
    _close(got, want, "slab_chunk int8")
    got1 = dk.decode_attention_slab(tq[:, 0].contiguous(), tk, tv,
                                    qpos[:, -1].contiguous(), H, kscale=tks,
                                    vscale=tvs)
    want1 = jax_dk.decode_attention_slab(
        jq[:, 0], kc, vc, jnp.asarray(QPOS[:, -1]), H, kscale=ks, vscale=vs,
        interpret=True)
    _close(got1, want1, "slab int8")


# -------------------------------------------------------------- admission

def test_wrappers_admit_float32_and_bf16_only():
    """``_check.tensors`` admits float32 and bf16 q, k, v (and int8 K/V
    beside scales) on both devices (float16 too: test_torch_attention_f16)
    and refuses complex64, which JAX's kernels refuse as well
    (NotImplementedError); the backward's o and do must carry q's
    dtype."""
    x = torch.zeros(1, 1, 16, 16)
    for dt in (F32, BF):
        fk.flash_attention_fwd(x.to(dt), x, x.to(BF))
    with pytest.raises(TypeError, match="q must be"):
        fk.flash_attention_fwd(x.to(torch.complex64), x, x)
    o, lse = fk.flash_attention_fwd(x.to(BF), x, x)
    with pytest.raises(TypeError, match="do must be q's dtype"):
        fk.flash_attention_bwd(x.to(BF), x, x, o, lse, x)
    q, kv = torch.zeros(2, 1, 32), torch.zeros(2, 8, 32)
    pos = torch.zeros(2, 1, dtype=torch.int32)
    assert dk.decode_attention_slab_chunk(q.to(BF), kv, kv.to(BF), pos,
                                          2).dtype == BF
    with pytest.raises(TypeError, match="k must be"):
        dk.decode_attention_slab_chunk(q, kv.to(torch.complex64), kv, pos,
                                       2)
    assert _check.operand_suffix(q=q.to(BF), k=kv, v=kv) == "qbf16_kf32_vf32"
    assert _check.operand_suffix(q=q, k=kv, v=kv) == "f32"


def test_a_bf16_trunk_is_refused_as_in_jax():
    """``lm_generate`` over a trunk cast to bf16 raises TypeError in both
    packages: the cache takes the embedding's dtype, ``matmul`` returns
    float32 K/V, and the cache write refuses the mismatch (JAX's
    ``dynamic_update_slice``, the port's ``_kv_commit``)."""
    jp = jax_tf.init(jax.random.PRNGKey(0), src_vocab=50, trg_vocab=50,
                     d_model=32, num_heads=2, dff=64, enc_layers=2,
                     dec_layers=0, max_len=16)
    prompt = np.random.RandomState(0).randint(2, 50, (2, 5)).astype(np.int32)
    with pytest.raises(TypeError, match="same dtypes"):
        jax_tf.lm_generate(jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16), jp), jnp.asarray(prompt), 10,
            num_heads=2)
    tp = transformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    with pytest.raises(TypeError, match="KV cache write"):
        transformer.lm_generate(tree_map(lambda a: a.to(BF), tp),
                                torch.tensor(prompt), 10, num_heads=2)
    # the float32 trunk generates
    assert transformer.lm_generate(tp, torch.tensor(prompt), 10,
                                   num_heads=2).shape == (2, 10)
