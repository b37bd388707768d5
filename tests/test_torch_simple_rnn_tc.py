"""The arithmetic of the tensor-core vanilla-RNN kernels
(``csrc/simple_rnn.cu``: forward, BPTT and dW), emulated in plain torch
on the CPU.

Every product runs on the card as 3xTF32 ``mma.sync`` tiles: each
operand split into big = tf32(x) and small = x - big (truncated), and
each k-step of 8 summed as (a_small b_big + a_big b_small) + a_big b_big,
each product in a fresh tile, the three added in float32 and then to the
float32 accumulator (``mm3``, the split helpers of
``test_torch_flash_tc``).  Both recurrences' step products,
h_{t-1} @ W forward and dg_t @ W^T backward, run in 8 k-groups, k-group
q walking k-steps [2q, 2q + 2) of every 128-column chunk, the groups'
sums meeting as ((acc_0 + acc_1) + ...) + acc_7 (``product`` of
``test_torch_lstm_tc``).  The BPTT forms the carry into step t - 1 as
m_t (dg_t W^T) + (1 - m_t) dh_t and adds dh_out[t - 1] to it.  dW = sum_t
h_{t-1}^T dg_t walks its (T - 1) B rows in 32-row chunks of 4 k-steps,
the chunks split into KS contiguous runs (split s takes chunks
[s nk / KS, (s + 1) nk / KS)), each run summed in order into its own
tile, and the tiles added in split order.  The cells stay float32, as
the plain versions compute them.  The emulation is held within 1e-5 of
JAX's ``simple_rnn._fwd`` / ``_bwd`` (the Pallas kernels in interpret
mode, as the JAX tests run them on the CPU) and of
``simple_rnn_fwd_plain`` / ``simple_rnn_bwd_plain``, the kernels' plain
versions, at D 128 (B 8) and D 256 (B 24), T 9, on full rows and on a
ragged mask with an empty row.  A single TF32 pass on the same inputs
misses that gate.

Tolerance 1e-5: absolute on hs (|h| < 1); dxs and dW relative to their
largest entry, as chip_smoke.py holds them (dxs reaches ~10 at the
train shape, where its absolute error is a few 1e-6): float32 sums over
D products in other orders, plus the split's ~2^-22 of each product,
carried for 9 steps through a recurrence of gain ~1 (W at the layer's
std 1/sqrt(D)).
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import simple_rnn as pl_rnn
from paddle_tpu_torch.ops.kernels.simple_rnn import (simple_rnn_bwd_plain,
                                                     simple_rnn_fwd_plain)
from test_torch_flash_tc import mm1, mm3
from test_torch_lstm_tc import product

TOL = 1e-5
T = 9
STEP = (128, 8)     # (chunk columns, k-groups) of a step's product
DW_CHUNK = 32       # k rows of a dW chunk: 4 k-steps
DW_RESIDENT = 132    # dW CTAs resident at once on an H100: one an SM


def dw_splits(d, k):
    """The K-splits a dW tile takes on the card: min(8, resident CTAs //
    tiles, chunks), the tiles 128 x 64 (``dw_product``)."""
    return max(1, min(8, DW_RESIDENT // ((d // 128) * (d // 64)),
                      -(-k // DW_CHUNK)))
CASES = [(128, 8), (256, 24)]      # (D, B)


def fwd_emulated(xs, mask, w, mm=mm3):
    """hs of the forward kernel: step 0 adds no product (h_{-1} = 0)."""
    h = torch.zeros(xs.shape[1:])
    hs = []
    for t in range(xs.shape[0]):
        pre = xs[t] + product(h, w, *STEP, mm=mm) if t else xs[t]
        m = mask[t][:, None]
        h = m * torch.tanh(pre) + (1.0 - m) * h
        hs.append(h)
    return torch.stack(hs)


def dw_emulated(h, g, splits, mm=mm3):
    """h^T g over K = h.shape[0] rows: KS contiguous runs of 32-row
    chunks, each run's k-steps summed in order into its own tile, the
    tiles added in split order."""
    k = h.shape[0]
    nk = -(-k // DW_CHUNK)
    out = None
    for s in range(splits):
        r0 = s * nk // splits * DW_CHUNK
        r1 = min((s + 1) * nk // splits * DW_CHUNK, k)
        acc = product(h[r0:r1].T, g[r0:r1], 8, 1, mm=mm) if r1 > r0 \
            else torch.zeros(h.shape[1], g.shape[1])
        out = acc if out is None else out + acc
    return out


def bwd_emulated(hs, w, mask, dh_out, splits, mm=mm3):
    """(dxs, dW) of the BPTT kernel and the dW product."""
    t_len, _, d = dh_out.shape
    dxs = [None] * t_len
    dh = dh_out[-1]
    dxs[-1] = dh * (1.0 - hs[-1] * hs[-1]) * mask[-1][:, None]
    for t in range(t_len - 1, 0, -1):
        m = mask[t][:, None]
        carry = m * product(dxs[t], w.T, *STEP, mm=mm) + (1.0 - m) * dh
        dh = carry + dh_out[t - 1]
        dxs[t - 1] = dh * (1.0 - hs[t - 1] * hs[t - 1]) * mask[t - 1][:, None]
    dxs = torch.stack(dxs)
    dw = dw_emulated(hs[:-1].reshape(-1, d), dxs[1:].reshape(-1, d), splits,
                     mm)
    return dxs, dw


def _inputs(d, b, kind):
    """x * 0.3, W at std 1/sqrt(D), dh_out N(0, 1); ragged: random
    lengths with an empty row and a full row."""
    rng = np.random.RandomState(d + b)
    xs = (rng.randn(T, b, d) * 0.3).astype(np.float32)
    w = (rng.randn(d, d) / np.sqrt(d)).astype(np.float32)
    dh_out = rng.randn(T, b, d).astype(np.float32)
    lengths = np.full(b, T)
    if kind == "ragged":
        lengths = rng.randint(1, T + 1, b)
        lengths[0], lengths[-1] = 0, T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return xs, mask, w, dh_out


@functools.lru_cache(maxsize=None)
def _case(d, b, kind):
    """The inputs as tensors, and JAX's hs, dxs, dW on them (the Pallas
    kernels in interpret mode), once per case for the module."""
    xs, mask, w, dh_out = _inputs(d, b, kind)
    lanes = jnp.broadcast_to(jnp.asarray(mask)[:, :, None], (T, b, 128))
    hs = pl_rnn._fwd(jnp.asarray(xs), jnp.asarray(w), lanes, True)
    dxs, dw, _ = pl_rnn._bwd(True, (jnp.asarray(w), lanes, hs),
                             jnp.asarray(dh_out))
    args = tuple(torch.tensor(a) for a in (xs, mask, w, dh_out))
    return args, tuple(torch.tensor(np.asarray(a)) for a in (hs, dxs, dw))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _errors(hs, bwd, want_hs, want_bwd):
    """hs absolute; dxs and dW relative to their largest entry."""
    return {"hs": float((hs - want_hs).abs().max()),
            "dxs": _rel(bwd[0], want_bwd[0]), "dW": _rel(bwd[1], want_bwd[1])}


@pytest.mark.parametrize("kind", ["full", "ragged"])
@pytest.mark.parametrize("d, b", CASES)
def test_3xtf32_emulation_matches_jax_and_plain(d, b, kind):
    (xs, mask, w, dh_out), (j_hs, j_dxs, j_dw) = _case(d, b, kind)
    hs = fwd_emulated(xs, mask, w)
    # the backward on JAX's hs, so that each side's check stands alone
    bwd = bwd_emulated(j_hs, w, mask, dh_out,
                       dw_splits(d, (T - 1) * b))
    plain_hs = simple_rnn_fwd_plain(xs, mask, w)
    plain_bwd = simple_rnn_bwd_plain(j_hs, w, mask, dh_out)
    for want in (_errors(hs, bwd, plain_hs, plain_bwd),
                 _errors(hs, bwd, j_hs, (j_dxs, j_dw))):
        assert max(want.values()) < TOL, want
    if kind == "ragged":      # the empty row's h and dg stay exactly 0
        assert not hs[:, 0].any() and not bwd[0][:, 0].any()


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_dw_split_order_stays_within_the_gate(splits):
    """Any split count the kernel may pick (it depends on the CTAs that
    stay co-resident) sums dW within the gate of the plain version."""
    (_, mask, w, dh_out), (j_hs, _, _) = _case(256, 24, "ragged")
    plain = simple_rnn_bwd_plain(j_hs, w, mask, dh_out)
    assert _rel(bwd_emulated(j_hs, w, mask, dh_out, splits)[1],
                plain[1]) < TOL


@pytest.mark.parametrize("d, b", CASES)
def test_single_pass_tf32_misses_the_gate(d, b):
    """One TF32 product a k-step drifts past 1e-5 from the plain versions
    (forward and backward alike) where 3xTF32 stays within it."""
    (xs, mask, w, dh_out), (j_hs, _, _) = _case(d, b, "full")
    plain_hs = simple_rnn_fwd_plain(xs, mask, w)
    plain_bwd = simple_rnn_bwd_plain(j_hs, w, mask, dh_out)
    one = _errors(fwd_emulated(xs, mask, w, mm=mm1),
                  bwd_emulated(j_hs, w, mask, dh_out,
                               dw_splits(d, (T - 1) * b), mm=mm1),
                  plain_hs, plain_bwd)
    assert min(one.values()) > TOL, one
