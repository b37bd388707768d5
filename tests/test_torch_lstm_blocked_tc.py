"""The arithmetic of the tensor-core gate-blocked LSTM forward
(``csrc/lstm_blocked.cu``), emulated in plain torch on the CPU.

Each step's recurrent product h_{t-1} @ W_r runs on the card as 3xTF32
``mma.sync`` tiles: every operand split into big = tf32(x) and small =
x - big (truncated), and each k-step of 8 summed as a_small b_big +
a_big b_small + a_big b_big in a fresh tile that is then added to the
float32 accumulator (the split helpers of ``test_torch_flash_tc``).  The
kernel's four k-groups each walk k-steps [4q, 4q + 4) of every 128-row
chunk into their own accumulator, and the four sums meet as acc_0 +
(acc_1 + (acc_2 + acc_3)); the emulation below sums in that order.  The
cell stays float32.  It is held within 1e-5 of JAX's
``lstm_blocked._fwd`` (the Pallas kernel in interpret mode, as the JAX
tests run it on the CPU) and of ``lstm.lstm_fwd_plain``, the kernel's
plain version, at B 8, D 256, T 6 and 7, on full rows and on a ragged
mask with an empty row.  A single TF32 pass on the same inputs misses
1e-4 here; at the train shapes (T 100, B 64, D 1280 / 2048) it lands
under 1e-4, so ``chip_smoke.py`` also holds the card's blocked forward
to the 3xTF32 gate BLK_TC_TOL (1e-5).

Tolerance 1e-5 absolute: float32 sums over 256 products in other
orders, plus the split's ~2^-22 of each product, carried for 7 steps
through a recurrence of gain ~1.6 (W_r at the JAX tests' 0.1).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels.lstm import lstm_fwd_plain
from test_torch_flash_tc import mm1, split
from test_torch_lstm_blocked import _jax_fwd, _kernel_inputs

TOL = 1e-5
GATE = 1e-4
K_STEP = 8
KC = 128        # k rows of a chunk
K_SPLIT = 4     # k-groups


def step_product_3x(h, w_r):
    """h @ w_r as the kernel sums it: per k-step of 8, the three TF32
    products summed (a fresh tile), then added in float32 to the
    k-group's accumulator; the k-groups' sums added last to first."""
    hb, hs = split(h)
    wb, ws = split(w_r)
    steps = KC // K_STEP // K_SPLIT
    sums = []
    for q in range(K_SPLIT):
        acc = torch.zeros(h.shape[0], w_r.shape[1])
        for c0 in range(0, h.shape[1], KC):
            for k8 in range(steps):
                k0 = c0 + (q * steps + k8) * K_STEP
                ks = slice(k0, k0 + K_STEP)
                acc = acc + (hs[:, ks] @ wb[ks] + hb[:, ks] @ ws[ks]
                             + hb[:, ks] @ wb[ks])
        sums.append(acc)
    out = sums[-1]
    for acc in sums[-2::-1]:
        out = acc + out
    return out


def blocked_emulated(xs, mask, w_r, checks, product=step_product_3x):
    """(hs, c_fin, cs, acts) of the kernel: step 0 adds no product
    (h_{-1} = 0), the cell and the masked carry as ``lstm_fwd_plain``."""
    t_len, b, g = xs.shape
    d = g // 4
    h, c = torch.zeros(b, d), torch.zeros(b, d)
    ci, cf, co = checks[0:1], checks[1:2], checks[2:3]
    hs, cs, acts = [], [], []
    for t in range(t_len):
        gates = xs[t] + product(h, w_r) if t else xs[t]
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


def _err(got, want):
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("t", [6, 7])
@pytest.mark.parametrize("kind", ["full", "ragged", "zero"])
def test_3xtf32_emulation_matches_jax_and_plain(t, kind):
    xs, w_r, checks, mask = _kernel_inputs(t, kind, seed=t)
    args = [torch.tensor(a) for a in (xs, mask, w_r, checks)]
    got = blocked_emulated(*args)
    assert _err(got, lstm_fwd_plain(*args, True)) < TOL
    assert _err(got, _jax_fwd(xs, w_r, checks, mask)) < TOL
    if kind == "zero":
        assert not got[0][:, 0].any()


def test_single_pass_tf32_misses_the_gate():
    """One TF32 product a step drifts past 1e-4 from the plain version
    within 7 steps, where 3xTF32 stays within 1e-5."""
    xs, w_r, checks, mask = _kernel_inputs(7, "full", seed=3)
    args = [torch.tensor(a) for a in (xs, mask, w_r, checks)]
    ref = lstm_fwd_plain(*args, True)
    assert _err(blocked_emulated(*args, product=mm1), ref) > GATE
    assert _err(blocked_emulated(*args), ref) < TOL
