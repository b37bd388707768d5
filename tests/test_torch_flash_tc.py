"""The arithmetic of the tensor-core flash kernels (``csrc/flash_attention.cu``:
the forward and the dK/dV kernel), emulated in plain torch on the CPU.

The kernels compute each float32 product in the 3xTF32 split: an operand
x is split into big = tf32(x), which rounds the bit pattern to a 10-bit
mantissa (nearest, ties away from zero: what ``cvt.rna.tf32.f32``
gives), and small = x - big truncated to TF32 (the tensor cores drop
the low 13 bits), and a b = a_small b_big + a_big b_small + a_big b_big
(on the card each k-step's three in a fresh tile, added to the float32
sum).  The forward walks 64-column K/V tiles with a
running max and sum; the dK/dV kernel walks q tiles of 32 rows.  The
emulation below does the same, tile order and all, and is held within
1e-5 of JAX's ``flash_attention`` (run as the JAX tests run
it on the CPU: the Pallas kernel in interpret mode, or its masked path
where the shape leaves it) and of ``flash_attention_plain`` /
``flash_attention_bwd_plain``, for o, lse, dk and dv.  Single-pass TF32
on the same inputs misses 1e-4 on o, so the tolerance the card's checks
use (1e-4) tells the two apart.

Tolerance 1e-5 absolute and relative: float32 sums in other orders over
at most 128 terms of O(1) products, plus the split's ~2^-22 of each
product.
"""

import importlib
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fk

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = 1e-5
TF32_GAP = 1e-4
KV_TILE = 64
_NEG = -1e30
# (B, H, Tq, Tk, dh, causal)
CASES = [(1, 2, 45, 45, 16, True), (2, 2, 77, 77, 64, True),
         (2, 2, 45, 77, 64, False), (1, 2, 128, 128, 64, True),
         (1, 2, 128, 128, 128, False)]


# ------------------------------------------------ the kernels' arithmetic

def tf32(x):
    """x rounded to TF32 as its bit pattern: + 0x1000, low 13 bits
    cleared (round to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncated(x):
    """x truncated to TF32: its low 13 bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, truncated(x - big)


def mm3(a, b):
    """a @ b in 3xTF32: a_small b_big + a_big b_small + a_big b_big."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm1(a, b):
    """a @ b in one TF32 pass (the control)."""
    return tf32(a) @ tf32(b)


Q_ROWS = 32      # the dK/dV kernel's q-tile height (``bwd_q_rows``)


def fwd_emulated(q, k, v, scale, causal, mm=mm3):
    """(o, lse) as the forward kernel computes them: 64-column K/V tiles,
    a running max and sum, o rescaled by exp(m_old - m_new) before each
    P V, finalized as o / max(l, 1e-30) and m + log(max(l, 1e-30))."""
    tq, tk = q.shape[-2], k.shape[-2]
    rows = torch.arange(tq)[:, None]
    m = torch.full(q.shape[:-1], _NEG)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for t0 in range(0, tk, KV_TILE):
        kt, vt = k[..., t0:t0 + KV_TILE, :], v[..., t0:t0 + KV_TILE, :]
        s = mm(q, kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(t0, t0 + kt.shape[-2])[None]
            s = torch.where(cols > rows, torch.tensor(_NEG), s)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(p, vt)
        m = m_new
    den = torch.clamp(l, min=1e-30)
    return acc / den[..., None], m + torch.log(den)


def dkv_emulated(q, k, v, do, lse, delta, scale, causal, mm=mm3):
    """(dk, dv) as the dK/dV kernel computes them: S^T = K Q^T and dP^T =
    V dO^T per q tile, P^T = exp(S^T scale - lse) (0 above the diagonal
    when causal), dS^T = P^T (dP^T - delta) scale, then dV += P^T dO and
    dK += dS^T Q."""
    tq, tk = q.shape[-2], k.shape[-2]
    kv_rows = torch.arange(tk)[:, None]
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, tq, Q_ROWS):
        sl = slice(q0, q0 + Q_ROWS)
        qt, dot = q[..., sl, :], do[..., sl, :]
        st = mm(k, qt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(q0, q0 + qt.shape[-2])[None]
            st = torch.where(kv_rows > cols, torch.tensor(_NEG), st)
        p = torch.exp(st - lse[..., None, sl])
        dpt = mm(v, dot.transpose(-1, -2))
        ds = p * (dpt - delta[..., None, sl]) * scale
        dv = dv + mm(p, dot)
        dk = dk + mm(ds, qt)
    return dk, dv


# ------------------------------------------------------------ references

def _inputs(seed, b, h, tq, tk, dh):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, tq, dh), (b, h, tk, dh), (b, h, tk, dh),
                          (b, h, tq, dh))]


def _jax(q, k, v, do, causal):
    """(o, dk, dv) of JAX's flash_attention on the CPU: the Pallas kernels
    in interpret mode (64-row blocks) where the shape takes them."""
    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, causal=causal, block_q=64,
                                      block_k=64, interpret=True)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    _, dk, dv = vjp(jnp.asarray(do))
    return [np.asarray(x) for x in (o, dk, dv)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b, h, tq, tk, dh, causal", CASES)
def test_3xtf32_emulation_matches_jax_and_plain(b, h, tq, tk, dh, causal):
    q, k, v, do = _inputs(tq * dh + tk, b, h, tq, tk, dh)
    tq_, tk_, tv_, tdo = (torch.tensor(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(dh)
    o, lse = fwd_emulated(tq_, tk_, tv_, scale, causal)
    o_plain, lse_plain = fk.flash_attention_plain(tq_, tk_, tv_, scale,
                                                  causal)
    delta = (tdo * o).sum(-1)
    dk, dv = dkv_emulated(tq_, tk_, tv_, tdo, lse, delta, scale, causal)
    _, dk_plain, dv_plain = fk.flash_attention_bwd_plain(
        tq_, tk_, tv_, o_plain, lse_plain, tdo, scale, causal)
    o_jax, dk_jax, dv_jax = _jax(q, k, v, do, causal)
    for got, plain, ref in ((o, o_plain, o_jax), (dk, dk_plain, dk_jax),
                            (dv, dv_plain, dv_jax)):
        _close(got, plain)
        _close(got, ref)
    _close(lse, lse_plain)


def test_tf32_split_is_exact_to_float32_order():
    """big + small recovers x to ~2^-22 relative (one TF32 pass: 2^-11),
    each part has a 10-bit mantissa, and big's rounding is to nearest
    with ties away from zero."""
    x = torch.tensor(np.random.RandomState(1).standard_normal(4096)
                     .astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel < 2.0 ** -21
    assert ((big.double() - x.double()).abs() / x.double().abs()).max() \
        <= 2.0 ** -11
    one = torch.tensor([1.0, -1.0])
    half_ulp = one * (1 + 2.0 ** -11)          # a tie: away from zero
    assert tf32(half_ulp).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def test_single_pass_tf32_misses_the_gate():
    """On the dh-64 cases' inputs one TF32 pass is off by more than 1e-4
    in o, where 3xTF32 stays within 1e-5: the card's 1e-4 gate separates
    them."""
    for b, h, tq, tk, dh, causal in CASES:
        if dh != 64:
            continue
        q, k, v, _ = (torch.tensor(x)
                      for x in _inputs(tq * dh + tk, b, h, tq, tk, dh))
        scale = 1.0 / math.sqrt(dh)
        ref = fk.flash_attention_plain(q, k, v, scale, causal)[0]
        one = fwd_emulated(q, k, v, scale, causal, mm=mm1)[0]
        three = fwd_emulated(q, k, v, scale, causal)[0]
        assert float((one - ref).abs().max()) > TF32_GAP
        assert float((three - ref).abs().max()) < TOL
