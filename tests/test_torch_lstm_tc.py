"""The arithmetic of the tensor-core resident LSTM kernels
(``csrc/lstm.cu``: forward, BPTT and dW_r), emulated in plain torch on
the CPU.

Every recurrent product runs on the card as 3xTF32 ``mma.sync`` tiles:
each operand split into big = tf32(x) and small = x - big (truncated),
and each k-step of 8 summed as a_small b_big + a_big b_small + a_big
b_big in a fresh tile that is then added to the float32 accumulator (the
split helpers of ``test_torch_flash_tc``).  The forward's product
h_{t-1} @ W_r runs in 4 k-groups, k-group q walking k-steps [4q, 4q + 4)
of every 128-column chunk, the groups' sums meeting as ((acc_0 + acc_1)
+ acc_2) + acc_3.  The backward's dgates_t @ W_r^T is split by the
kernel's 16-unit blocks: block u multiplies its own 64 gate columns
(gate-major, [a, i, f, o] x 16 units) in 8 k-steps into a partial, and
the D / 16 partials are summed in block order.  dW_r = sum_t h_{t-1}^T
dgates_t walks its (T - 1) B rows in k-steps of 8, in order, into one
accumulator.  The cells stay float32, as the plain versions compute
them.  The emulation is held within 1e-5 of JAX's ``lstm._fwd`` /
``_bwd`` (the Pallas kernels in interpret mode, as the JAX tests run
them on the CPU) and of ``lstm_fwd_plain`` / ``lstm_bwd_plain``, the
kernels' plain versions, at D 128 and 384 (the width the SIMT kernel
could not take), on full rows and on a ragged mask with an empty row.
A single TF32 pass on the same inputs misses that gate.

Tolerance 1e-5: absolute on hs, c_fin, cs, acts and dxs (float32 sums
over up to 4D = 1536 products in other orders, plus the split's ~2^-22
of each product, carried for 7 steps through a recurrence of gain ~1-2
at W_r's 0.1); dW_r and dchecks, sums over (T - 1) B rows, relative to
their largest entry (as chip_smoke.py holds them).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import lstm as pl_lstm
from paddle_tpu_torch.ops.kernels.lstm import lstm_bwd_plain, lstm_fwd_plain
from test_torch_flash_tc import mm1, mm3

TOL = 1e-5
B, T = 8, 7
FWD = (128, 4)      # (chunk columns, k-groups) of the forward's product
DWR = (8, 1)        # dW_r: one k-step a chunk, one accumulator
UNITS = 16          # hidden units of a CTA: the backward's partial blocks


def product(a, b, chunk, groups, mm=mm3):
    """a @ b as a kernel's product sums it: k-group q walks k-steps
    [q s, q s + s), s = chunk / 8 / groups, of every chunk, one tile a
    k-step added to its accumulator; the groups' sums first to last."""
    steps = chunk // 8 // groups
    sums = []
    for q in range(groups):
        acc = torch.zeros(a.shape[0], b.shape[1])
        for c0 in range(0, a.shape[1], chunk):
            for k8 in range(steps):
                k0 = c0 + (q * steps + k8) * 8
                acc = acc + mm(a[:, k0:k0 + 8], b[k0:k0 + 8])
        sums.append(acc)
    out = sums[0]
    for acc in sums[1:]:
        out = out + acc
    return out


def dh_prev_product(dgates, w_r, mm=mm3):
    """dgates @ W_r^T as the backward kernel sums it: one partial per
    16-unit block over its own gate columns, the partials in order."""
    d = w_r.shape[0]
    out = None
    for u in range(0, d, UNITS):
        cols = torch.cat([torch.arange(gate * d + u, gate * d + u + UNITS)
                          for gate in range(4)])
        acc = product(dgates[:, cols], w_r[:, cols].T, 8, 1, mm)
        out = acc if out is None else out + acc
    return out


def fwd_emulated(xs, mask, w_r, checks, mm=mm3):
    """(hs, c_fin, cs, acts) of the forward kernel: step 0 adds no
    product (h_{-1} = 0); the cell and the masked carry as
    ``lstm_fwd_plain``."""
    t_len, b, g = xs.shape
    d = g // 4
    h, c = torch.zeros(b, d), torch.zeros(b, d)
    ci, cf, co = checks[0:1], checks[1:2], checks[2:3]
    hs, cs, acts = [], [], []
    for t in range(t_len):
        gates = xs[t] + product(h, w_r, *FWD, mm=mm) if t else xs[t]
        a = torch.tanh(gates[:, :d])
        i = torch.sigmoid(gates[:, d:2 * d] + c * ci)
        f = torch.sigmoid(gates[:, 2 * d:3 * d] + c * cf)
        c_new = a * i + c * f
        o = torch.sigmoid(gates[:, 3 * d:] + c_new * co)
        m = mask[t][:, None]
        h = m * (o * torch.tanh(c_new)) + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h)
        cs.append(c)
        acts.append(torch.cat([a, i, f, o], dim=1))
    return torch.stack(hs), c, torch.stack(cs), torch.stack(acts)


def bwd_emulated(acts, cs, hs, w_r, checks, mask, dh_out, dcfin, mm=mm3):
    """(dxs, dW_r, dchecks) of the BPTT kernel and the dW_r product: the
    cell's backward as ``lstm_bwd_plain``, dh_prev through the
    backward's product, dW_r after the loop."""
    t_len, b, d = dh_out.shape
    ci, cf, co = checks[0:1], checks[1:2], checks[2:3]
    dh_c, dc_c = torch.zeros(b, d), dcfin
    dchk = torch.zeros(b, 3 * d)
    dxs = [None] * t_len
    for t in reversed(range(t_len)):
        a, i = acts[t, :, :d], acts[t, :, d:2 * d]
        f, o = acts[t, :, 2 * d:3 * d], acts[t, :, 3 * d:]
        c_t = cs[t]
        c_prev = cs[t - 1] if t else torch.zeros_like(c_t)
        m = mask[t][:, None]
        dh = dh_c + dh_out[t]
        tc = torch.tanh(c_t)
        dog = dh * tc * o * (1.0 - o)
        dc = dh * o * (1.0 - tc * tc) + dc_c + dog * co
        dag = dc * i * (1.0 - a * a)
        dig = dc * a * i * (1.0 - i)
        dfg = dc * c_prev * f * (1.0 - f)
        dgates = torch.cat([dag, dig, dfg, dog], dim=1) * m
        dc_prev = dc * f + dig * ci + dfg * cf
        if t:
            dh_c = m * dh_prev_product(dgates, w_r, mm) + (1.0 - m) * dh
        dc_c = m * dc_prev + (1.0 - m) * dc_c
        dchk = dchk + torch.cat([m * dig * c_prev, m * dfg * c_prev,
                                 m * dog * c_t], dim=1)
        dxs[t] = dgates
    dxs = torch.stack(dxs)
    dwr = product(hs[:-1].reshape(-1, d).T, dxs[1:].reshape(-1, 4 * d),
                  *DWR, mm=mm)
    return dxs, dwr, dchk.sum(0).reshape(3, d)


def _inputs(d, kind, seed):
    """x * 0.3, W_r * 0.1, checks * 0.1 (the JAX tests' scale); ragged:
    random lengths with an empty row and a full row."""
    rng = np.random.RandomState(seed)
    xs = (rng.randn(T, B, 4 * d) * 0.3).astype(np.float32)
    w_r = (rng.randn(d, 4 * d) * 0.1).astype(np.float32)
    checks = (rng.randn(3, d) * 0.1).astype(np.float32)
    lengths = np.full(B, T)
    if kind == "ragged":
        lengths = rng.randint(1, T + 1, B)
        lengths[0], lengths[-1] = 0, T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return xs, mask, w_r, checks, rng


def _lanes(mask):
    return jnp.broadcast_to(jnp.asarray(mask)[:, :, None], mask.shape + (128,))


def _err(got, want):
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(got, want))


def _bwd_err(got, want):
    """dxs absolute; dW_r and dchecks relative to their largest entry."""
    return max([_err(got[:1], want[:1])]
               + [_err([g], [w]) / float(np.abs(np.asarray(w)).max())
                  for g, w in zip(got[1:], want[1:])])


@pytest.mark.parametrize("kind", ["full", "ragged"])
@pytest.mark.parametrize("d", [128, 384])
def test_3xtf32_emulation_matches_jax_and_plain(d, kind):
    xs, mask, w_r, checks, rng = _inputs(d, kind, seed=d)
    args = [torch.tensor(a) for a in (xs, mask, w_r, checks)]
    got = fwd_emulated(*args)
    assert _err(got, lstm_fwd_plain(*args, True)) < TOL
    want = pl_lstm._fwd(jnp.asarray(xs), jnp.asarray(w_r),
                        jnp.asarray(checks), _lanes(mask), True, True)
    assert _err(got, (want[0], want[1][0], want[2], want[3])) < TOL
    if kind == "ragged":
        assert not got[0][:, 0].any()        # the empty row's h stays 0

    dh_out = rng.randn(T, B, d).astype(np.float32)
    dcfin = rng.randn(B, d).astype(np.float32)
    hs, _, cs, acts = (torch.tensor(np.asarray(a)) for a in want)
    bwd_args = (acts, cs, hs, args[2], args[3], args[1],
                torch.tensor(dh_out), torch.tensor(dcfin))
    gb = bwd_emulated(*bwd_args)
    assert _bwd_err(gb, lstm_bwd_plain(*bwd_args)) < TOL
    res = (jnp.asarray(w_r), jnp.asarray(checks), _lanes(mask), *want[:1],
           want[2], want[3])
    wb = pl_lstm._bwd(True, res, (jnp.asarray(dh_out),
                                  jnp.asarray(dcfin)[None]))
    assert _bwd_err(gb, wb[:3]) < TOL


@pytest.mark.parametrize("d", [128, 384])
def test_single_pass_tf32_misses_the_gate(d):
    """One TF32 product a k-step drifts past 1e-5 from the plain versions
    (forward and backward alike) where 3xTF32 stays within it."""
    xs, mask, w_r, checks, rng = _inputs(d, "full", seed=3)
    args = [torch.tensor(a) for a in (xs, mask, w_r, checks)]
    ref = lstm_fwd_plain(*args, True)
    assert _err(fwd_emulated(*args, mm=mm1), ref) > TOL
    _, _, cs, acts = ref
    bwd_args = (acts, cs, ref[0], args[2], args[3], args[1],
                torch.tensor(rng.randn(T, B, d).astype(np.float32)),
                torch.tensor(rng.randn(B, d).astype(np.float32)))
    want = lstm_bwd_plain(*bwd_args)
    assert _bwd_err(bwd_emulated(*bwd_args, mm=mm1), want) > TOL
    assert _bwd_err(bwd_emulated(*bwd_args), want) < TOL
