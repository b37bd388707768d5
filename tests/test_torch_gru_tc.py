"""The arithmetic of the tensor-core GRU kernels (``csrc/gru.cu``:
forward, BPTT and the dW_gate / dW_state product), emulated in plain
torch on the CPU.

Every product runs on the card as 3xTF32 ``mma.sync`` tiles: each
operand split into big = tf32(x) and small = x - big (truncated), and
each k-step of 8 summed as (a_small b_big + a_big b_small) + a_big b_big,
each product in a fresh tile, the three added in float32 and then to the
float32 accumulator (``mm3``, the split helpers of
``test_torch_flash_tc``).  The forward's two step products, h_{t-1} @
W_gate and (r h_{t-1}) @ W_state, and the BPTT's two, dccg_m @ W_state^T
and dgates @ W_gate^T (K = 2D over [dug m | drg m]), run in 8 k-groups,
k-group q walking k-steps [2q, 2q + 2) of every 128-column chunk, the
groups' sums meeting as ((acc_0 + acc_1) + ...) + acc_7 (``product`` of
``test_torch_lstm_tc``).  The BPTT forms part = dh (1 - u) + ds r before
the second product and dh_prev = part + dgates W_gate^T.  dW_gate =
sum_t h_{t-1}^T dgates_t and dW_state = sum_t (r_t h_{t-1})^T dccg_m,t
walk their (T - 1) B rows in 32-row chunks of 4 k-steps, split into KS
contiguous runs summed in split order (``dw_emulated`` of
``test_torch_simple_rnn_tc``).  The cells stay float32, as the plain
versions compute them.  The emulation is held within 1e-5 of JAX's
``gru._fwd`` / ``_bwd`` (the Pallas kernels in interpret mode, as the
JAX tests run them on the CPU) and of ``gru_fwd_plain`` /
``gru_bwd_plain``, the kernels' plain versions, at D 128 (B 8, half an
m16 tile) and D 256 (B 24), T 9, on full rows and on a ragged mask with
an empty row.  A single TF32 pass on the same inputs misses that gate.

Tolerance 1e-5: absolute on hs and acts (|h| < 1, the gates in (0, 1));
dxs, dW_gate and dW_state relative to their largest entry, as
chip_smoke.py holds them: float32 sums over D products in other orders,
plus the split's ~2^-22 of each product, carried for 9 steps through the
recurrence (x * 0.3, W_gate and W_state * 0.1, as the JAX tests draw
them).
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import gru as pl_gru
from paddle_tpu_torch.ops.kernels.gru import gru_bwd_plain, gru_fwd_plain
from test_torch_flash_tc import mm1, mm3
from test_torch_lstm_tc import product
from test_torch_simple_rnn_tc import DW_CHUNK, DW_RESIDENT, dw_emulated

TOL = 1e-5
T = 9
STEP = (128, 8)     # (chunk columns, k-groups) of a step's product
CASES = [(128, 8), (256, 24)]      # (D, B)


def dw_splits(d, k):
    """The K-splits a dW tile takes on the card: min(8, resident CTAs //
    tiles, chunks), the 128 x 64 tiles of dW_gate [D, 2D] and dW_state
    [D, D] in one grid (``dw_product``)."""
    tiles = (d // 128) * (2 * d // 64) + (d // 128) * (d // 64)
    return max(1, min(8, DW_RESIDENT // tiles, -(-k // DW_CHUNK)))


def fwd_emulated(xs, mask, w_gate, w_state, mm=mm3):
    """(hs, acts) of the forward kernel: step 0 adds no product
    (h_{-1} = 0)."""
    t_len, b, g = xs.shape
    d = g // 3
    h = torch.zeros(b, d)
    hs, acts = [], []
    for t in range(t_len):
        x3 = xs[t]
        ru = product(h, w_gate, *STEP, mm=mm) if t else torch.zeros(b, 2 * d)
        u = torch.sigmoid(x3[:, :d] + ru[:, :d])
        r = torch.sigmoid(x3[:, d:2 * d] + ru[:, d:])
        s = r * h
        cs = product(s, w_state, *STEP, mm=mm) if t else torch.zeros(b, d)
        cc = torch.tanh(x3[:, 2 * d:] + cs)
        h_new = h + u * (cc - h)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        hs.append(h)
        acts.append(torch.cat([u, r, cc], dim=1))
    return torch.stack(hs), torch.stack(acts)


def bwd_emulated(acts, hs, w_gate, w_state, mask, dh_out, splits, mm=mm3):
    """(dxs, dW_gate, dW_state) of the BPTT kernel and the dW product."""
    t_len, b, d = dh_out.shape
    dxs, s_all = [None] * t_len, [None] * t_len
    dh_c = torch.zeros(b, d)
    for t in reversed(range(t_len)):
        u, r, cc = acts[t, :, :d], acts[t, :, d:2 * d], acts[t, :, 2 * d:]
        h_prev = hs[t - 1] if t else torch.zeros(b, d)
        m = mask[t][:, None]
        dh = dh_c + dh_out[t]
        dug_m = dh * (cc - h_prev) * u * (1.0 - u) * m
        dccg_m = dh * u * (1.0 - cc * cc) * m
        if t == 0:                    # h_{-1} = 0: drg = 0, no dh_{-1}
            dxs[0] = torch.cat([dug_m, torch.zeros(b, d), dccg_m], dim=1)
            break
        ds = product(dccg_m, w_state.T, *STEP, mm=mm)
        drg_m = ds * h_prev * r * (1.0 - r) * m
        part = dh * (1.0 - u) + ds * r
        dgates = torch.cat([dug_m, drg_m], dim=1)
        dh_prev = part + product(dgates, w_gate.T, *STEP, mm=mm)
        dh_c = m * dh_prev + (1.0 - m) * dh
        dxs[t] = torch.cat([dgates, dccg_m], dim=1)
        s_all[t] = r * h_prev
    dxs = torch.stack(dxs)
    g = dxs[1:].reshape(-1, 3 * d)
    dwg = dw_emulated(hs[:-1].reshape(-1, d), g[:, :2 * d], splits, mm)
    dws = dw_emulated(torch.stack(s_all[1:]).reshape(-1, d), g[:, 2 * d:],
                      splits, mm)
    return dxs, dwg, dws


def _inputs(d, b, kind):
    """x * 0.3, W_gate and W_state * 0.1, dh_out N(0, 1); ragged: random
    lengths with an empty row and a full row."""
    rng = np.random.RandomState(d + b)
    xs = (rng.randn(T, b, 3 * d) * 0.3).astype(np.float32)
    w_gate = (rng.randn(d, 2 * d) * 0.1).astype(np.float32)
    w_state = (rng.randn(d, d) * 0.1).astype(np.float32)
    dh_out = rng.randn(T, b, d).astype(np.float32)
    lengths = np.full(b, T)
    if kind == "ragged":
        lengths = rng.randint(1, T + 1, b)
        lengths[0], lengths[-1] = 0, T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return xs, mask, w_gate, w_state, dh_out


@functools.lru_cache(maxsize=None)
def _case(d, b, kind):
    """The inputs as tensors, and JAX's hs, acts, dxs, dW_gate, dW_state
    on them (the Pallas kernels in interpret mode), once per case for the
    module."""
    xs, mask, w_gate, w_state, dh_out = _inputs(d, b, kind)
    lanes = jnp.broadcast_to(jnp.asarray(mask)[:, :, None], (T, b, 128))
    wg, ws = jnp.asarray(w_gate), jnp.asarray(w_state)
    hs, acts = pl_gru._fwd(jnp.asarray(xs), wg, ws, lanes, True, True)
    dxs, dwg, dws, _ = pl_gru._bwd(True, (wg, ws, lanes, hs, acts),
                                   jnp.asarray(dh_out))
    args = tuple(torch.tensor(a) for a in (xs, mask, w_gate, w_state, dh_out))
    return args, tuple(torch.tensor(np.asarray(a))
                       for a in (hs, acts, dxs, dwg, dws))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _errors(fwd, bwd, want_fwd, want_bwd):
    """hs and acts absolute; dxs, dW_gate and dW_state relative to their
    largest entry."""
    return {"hs": float((fwd[0] - want_fwd[0]).abs().max()),
            "acts": float((fwd[1] - want_fwd[1]).abs().max()),
            "dxs": _rel(bwd[0], want_bwd[0]),
            "dW_gate": _rel(bwd[1], want_bwd[1]),
            "dW_state": _rel(bwd[2], want_bwd[2])}


def _emulated(d, b, kind, mm=mm3, splits=None):
    """The emulated forward on the inputs, and the emulated backward on
    JAX's residuals (so that each side's check stands alone), with the
    plain versions and JAX's results beside them."""
    (xs, mask, w_gate, w_state, dh_out), (j_hs, j_acts, *j_bwd) = \
        _case(d, b, kind)
    if splits is None:
        splits = dw_splits(d, (T - 1) * b)
    fwd = fwd_emulated(xs, mask, w_gate, w_state, mm)
    bwd = bwd_emulated(j_acts, j_hs, w_gate, w_state, mask, dh_out, splits,
                       mm)
    plain_fwd = gru_fwd_plain(xs, mask, w_gate, w_state, True)
    plain_bwd = gru_bwd_plain(j_acts, j_hs, w_gate, w_state, mask, dh_out)
    return fwd, bwd, {"plain": (plain_fwd, plain_bwd),
                      "jax": ((j_hs, j_acts), j_bwd)}


@pytest.mark.parametrize("kind", ["full", "ragged"])
@pytest.mark.parametrize("d, b", CASES)
def test_3xtf32_emulation_matches_jax_and_plain(d, b, kind):
    fwd, bwd, refs = _emulated(d, b, kind)
    for name, (want_fwd, want_bwd) in refs.items():
        errs = _errors(fwd, bwd, want_fwd, want_bwd)
        assert max(errs.values()) < TOL, (name, errs)
    if kind == "ragged":      # the empty row's h and dxs stay exactly 0
        assert not fwd[0][:, 0].any() and not bwd[0][:, 0].any()


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_dw_split_order_stays_within_the_gate(splits):
    """Any split count the kernel may pick (it depends on the CTAs that
    stay co-resident) sums dW_gate and dW_state within the gate of the
    plain version."""
    _, bwd, refs = _emulated(256, 24, "ragged", splits=splits)
    plain_bwd = refs["plain"][1]
    assert _rel(bwd[1], plain_bwd[1]) < TOL
    assert _rel(bwd[2], plain_bwd[2]) < TOL


@pytest.mark.parametrize("d, b", CASES)
def test_single_pass_tf32_misses_the_gate(d, b):
    """One TF32 product a k-step drifts past 1e-5 from the plain versions
    (forward and backward alike) where 3xTF32 stays within it."""
    fwd, bwd, refs = _emulated(d, b, "full", mm=mm1)
    one = _errors(fwd, bwd, *refs["plain"])
    assert min(one.values()) > TOL, one
