"""The port's fused LSTM (paddle_tpu_torch.ops.kernels.lstm and
ops/rnn.lstm) against the JAX package's, on the CPU.

The plain versions of the CUDA kernels are held against the Pallas
kernels themselves (``paddle_tpu.ops.pallas.lstm._fwd`` / ``_bwd`` in
interpret mode, B=8, T=7, D=128 as tests/test_pallas_lstm.py uses), and
``rnn.lstm`` forward and gradients through ``LstmFused`` against the JAX
``rnn.lstm`` with its fused route forced on.

Tolerances: as tests/test_pallas_lstm.py:71, rtol 2e-4 and atol 2e-5 —
both sides compute in float32 but sum the recurrent products in
different orders (XLA vs PyTorch), which moves values by a few ulps per
step and compounds over the recurrence.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.ops.pallas import lstm as pl_lstm
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops.kernels import lstm as klstm
from paddle_tpu_torch.utils.error import ConfigError

B, T, D = 8, 7, 128
RTOL, ATOL = 2e-4, 2e-5


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _lengths(np_rng, kind):
    if kind == "full":
        return np.full((B,), T, np.int32)
    lengths = np_rng.randint(1, T + 1, (B,)).astype(np.int32)
    if kind == "zero":
        lengths[0] = 0
    return lengths


def _kernel_inputs(np_rng, kind):
    """Inputs at the JAX tests' scale (x*0.3, W_r*0.1, checks*0.1)."""
    xs = (np_rng.randn(T, B, 4 * D) * 0.3).astype(np.float32)
    w_r = (np_rng.randn(D, 4 * D) * 0.1).astype(np.float32)
    checks = (np_rng.randn(3, D) * 0.1).astype(np.float32)
    lengths = _lengths(np_rng, kind)
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return xs, w_r, checks, mask


def _lanes(mask):
    return jnp.broadcast_to(jnp.asarray(mask)[:, :, None], mask.shape + (128,))


@pytest.mark.parametrize("kind", ["full", "ragged", "zero"])
def test_plain_forward_matches_pallas_kernel(np_rng, kind):
    xs, w_r, checks, mask = _kernel_inputs(np_rng, kind)
    want = pl_lstm._fwd(jnp.asarray(xs), jnp.asarray(w_r),
                        jnp.asarray(checks), _lanes(mask), True, True)
    hs, cfin, cs, acts = klstm.lstm_fwd(
        torch.tensor(xs), torch.tensor(mask), torch.tensor(w_r),
        torch.tensor(checks), save_residuals=True)
    for name, got, w in (("hs", hs, want[0]), ("c_fin", cfin, want[1][0]),
                         ("cs", cs, want[2]), ("acts", acts, want[3])):
        _close(got, w, name)
    lean = klstm.lstm_fwd(torch.tensor(xs), torch.tensor(mask),
                          torch.tensor(w_r), torch.tensor(checks),
                          save_residuals=False)
    assert lean[2] is None and lean[3] is None
    torch.testing.assert_close(lean[0], hs, rtol=0, atol=0)
    torch.testing.assert_close(lean[1], cfin, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["ragged", "zero"])
def test_plain_backward_matches_pallas_kernel(np_rng, kind):
    xs, w_r, checks, mask = _kernel_inputs(np_rng, kind)
    hs, cfin, cs, acts = pl_lstm._fwd(jnp.asarray(xs), jnp.asarray(w_r),
                                      jnp.asarray(checks), _lanes(mask),
                                      True, True)
    dh_out = np_rng.randn(T, B, D).astype(np.float32)
    dcfin = np_rng.randn(B, D).astype(np.float32)
    res = (jnp.asarray(w_r), jnp.asarray(checks), _lanes(mask), hs, cs, acts)
    want = pl_lstm._bwd(True, res, (jnp.asarray(dh_out),
                                    jnp.asarray(dcfin)[None]))
    got = klstm.lstm_bwd(*(torch.tensor(np.asarray(a)) for a in (
        acts, cs, hs, w_r, checks, mask, dh_out, dcfin)))
    for name, g, w in zip(("dxs", "dW_r", "dchecks"), got, want[:3]):
        _close(g, w, name)


def _seq_inputs(np_rng, kind):
    x = (np_rng.randn(B, T, 4 * D) * 0.3).astype(np.float32)
    w_r = (np_rng.randn(D, 4 * D) * 0.1).astype(np.float32)
    checks = [(np_rng.randn(D) * 0.1).astype(np.float32) for _ in range(3)]
    bias = (np_rng.randn(4 * D) * 0.1).astype(np.float32)
    return x, _lengths(np_rng, kind), w_r, checks, bias


def _jax_lstm(x, lengths, w_r, checks, bias, reverse, peephole,
              fused="always", **kw):
    """loss and grads (x, w_r, checks, bias) of the JAX rnn.lstm with its
    fused route forced on (as tests/test_pallas_lstm.py does) or off."""
    def loss(x, w_r, checks, bias):
        ci, cf, co = checks if peephole else (None, None, None)
        out, final = jax_rnn.lstm(JaxSeq(x, jnp.asarray(lengths)), w_r,
                                  bias=bias, check_i=ci, check_f=cf,
                                  check_o=co, reverse=reverse, **kw)
        return (jnp.sum(out.data ** 2) + jnp.sum(final.c ** 2)
                + jnp.sum(final.h))
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = fused
    try:
        return jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
            jnp.asarray(x), jnp.asarray(w_r), [jnp.asarray(c) for c in checks],
            jnp.asarray(bias))
    finally:
        jax_rnn.FUSED_LSTM = prior


def _torch_lstm(x, lengths, w_r, checks, bias, reverse, peephole, **kw):
    args = [torch.tensor(a, requires_grad=True)
            for a in (x, w_r, *checks, bias)]
    xt, wt, ci, cf, co, bt = args
    if not peephole:
        ci = cf = co = None
    out, final = rnn.lstm(SequenceBatch(xt, torch.tensor(lengths)), wt,
                          bias=bt, check_i=ci, check_f=cf, check_o=co,
                          reverse=reverse, **kw)
    loss = (out.data ** 2).sum() + (final.c ** 2).sum() + final.h.sum()
    loss.backward()
    return loss.detach(), [a.grad for a in args]


@pytest.mark.parametrize("kind, reverse, peephole", [
    ("full", False, True), ("ragged", False, True), ("ragged", False, False),
    ("zero", False, True), ("ragged", True, True), ("zero", True, False)])
def test_rnn_lstm_matches_jax_fused(np_rng, kind, reverse, peephole):
    inputs = _seq_inputs(np_rng, kind)
    want_loss, (gx, gw, gc, gb) = _jax_lstm(*inputs, reverse, peephole)
    loss, grads = _torch_lstm(*inputs, reverse, peephole)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5)
    labels = ["dx", "dw_r", "dcheck_i", "dcheck_f", "dcheck_o", "dbias"]
    for name, g, w in zip(labels, grads, [gx, gw, *gc, gb]):
        if not peephole and name.startswith("dcheck"):
            assert g is None
            continue
        _close(g, w, name)


@pytest.mark.parametrize("b, d", [(64, 384), (32, 640)])
def test_wide_resident_sizes_match_jax(np_rng, b, d):
    """The resident route's widest sizes, which the CUDA kernels take
    since their redesign (D 384 at B 64, D 640 at B 32, the largest B the
    rule admits there): the plain versions against the Pallas kernels in
    interpret mode, and rnn.lstm's loss and gradients against JAX's fused
    route, on a ragged batch with an empty row (T 3)."""
    t = 3
    assert klstm.supported(b, d, "tanh", "sigmoid", "tanh", None)
    assert pl_lstm.supported(b, d, "tanh", "sigmoid", "tanh", None)
    lengths = np_rng.randint(1, t + 1, (b,)).astype(np.int32)
    lengths[0] = 0
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    xs = (np_rng.randn(t, b, 4 * d) * 0.3).astype(np.float32)
    w_r = (np_rng.randn(d, 4 * d) * 0.1).astype(np.float32)
    checks = (np_rng.randn(3, d) * 0.1).astype(np.float32)
    want = pl_lstm._fwd(jnp.asarray(xs), jnp.asarray(w_r),
                        jnp.asarray(checks), _lanes(mask), True, True)
    got = klstm.lstm_fwd(*(torch.tensor(a) for a in (xs, mask, w_r,
                                                     checks)), True)
    for name, g, w in zip(("hs", "c_fin", "cs", "acts"), got,
                          (want[0], want[1][0], want[2], want[3])):
        _close(g, w, name)
    dh_out = np_rng.randn(t, b, d).astype(np.float32)
    dcfin = np_rng.randn(b, d).astype(np.float32)
    res = (jnp.asarray(w_r), jnp.asarray(checks), _lanes(mask), want[0],
           want[2], want[3])
    want_b = pl_lstm._bwd(True, res, (jnp.asarray(dh_out),
                                      jnp.asarray(dcfin)[None]))
    got_b = klstm.lstm_bwd(*(torch.tensor(np.asarray(a)) for a in (
        want[3], want[2], want[0], w_r, checks, mask, dh_out, dcfin)))
    for name, g, w in zip(("dxs", "dW_r", "dchecks"), got_b, want_b[:3]):
        _close(g, w, name)

    x = np.ascontiguousarray(xs.transpose(1, 0, 2))
    peep = [checks[i] for i in range(3)]
    bias = (np_rng.randn(4 * d) * 0.1).astype(np.float32)
    want_loss, (gx, gw, gc, gb) = _jax_lstm(x, lengths, w_r, peep, bias,
                                            False, True)
    loss, grads = _torch_lstm(x, lengths, w_r, peep, bias, False, True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5)
    for name, g, w in zip(["dx", "dw_r", "dcheck_i", "dcheck_f", "dcheck_o",
                           "dbias"], grads, [gx, gw, *gc, gb]):
        _close(g, w, name)


@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_lstm_fused_matches_port_scan(np_rng, reverse):
    """The fused route against the port's own scan (a callable activation
    is not the default tanh, so it takes the scan on the CPU)."""
    inputs = _seq_inputs(np_rng, "zero")
    loss, grads = _torch_lstm(*inputs, reverse, True)
    loss_s, grads_s = _torch_lstm(*inputs, reverse, True, act=torch.tanh)
    np.testing.assert_allclose(float(loss), float(loss_s), rtol=2e-5)
    for g, w in zip(grads, grads_s):
        _close(g, w, "grad")


@pytest.mark.parametrize("acts", [
    dict(act="relu"), dict(gate_act="tanh", state_act="stanh")])
def test_rnn_lstm_scan_matches_jax_scan(np_rng, acts):
    """Non-default activations take the scan on both sides."""
    inputs = _seq_inputs(np_rng, "zero")
    want_loss, (gx, gw, gc, gb) = _jax_lstm(*inputs, True, True, fused="0",
                                            **acts)
    loss, grads = _torch_lstm(*inputs, True, True, **acts)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5)
    for g, w in zip(grads, [gx, gw, *gc, gb]):
        _close(g, w, "grad")


def test_bidirectional_matches_jax(np_rng):
    x, lengths, w_r, checks, bias = _seq_inputs(np_rng, "ragged")
    jseq = JaxSeq(jnp.asarray(x), jnp.asarray(lengths))
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always"
    try:
        want = jax_rnn.bidirectional(
            *(jax_rnn.lstm(jseq, jnp.asarray(w_r), bias=jnp.asarray(bias),
                           reverse=r)[0] for r in (False, True)))
    finally:
        jax_rnn.FUSED_LSTM = prior
    seq = SequenceBatch(torch.tensor(x), torch.tensor(lengths))
    got = rnn.bidirectional(*(rnn.lstm(seq, torch.tensor(w_r),
                                       bias=torch.tensor(bias),
                                       reverse=r)[0] for r in (False, True)))
    assert got.data.shape == (B, T, 2 * D) and got.lengths is seq.lengths
    _close(got.data, want.data, "bidirectional")


def test_route_by_device_and_config():
    """The route follows the JAX package's rules on (B, D, activations,
    initial state), whatever the device: the resident kernels' route at
    B=8, D=128 on the CPU (plain versions) and on "meta" (where its
    wrapper raises: no kernel takes meta tensors); the scan for other
    activations, an initial state or B % 8 != 0, on both devices."""
    def run(dev, b, **kw):
        seq = SequenceBatch(torch.zeros(b, 2, 4 * D, device=dev),
                            torch.full((b,), 2, dtype=torch.int32,
                                       device=dev))
        if kw.pop("init", False):
            kw["init_state"] = rnn.LstmState(
                h=torch.zeros(b, D, device=dev),
                c=torch.zeros(b, D, device=dev))
        out, _ = rnn.lstm(seq, torch.zeros(D, 4 * D, device=dev), **kw)
        return out.data.shape

    assert klstm.supported(8, D, "tanh", "sigmoid", "tanh", None)
    assert run("cpu", 8) == (8, 2, D)
    with pytest.raises(ValueError, match="lstm_fwd: tensors on meta"):
        run("meta", 8)
    for b, kw in ((8, dict(act="relu")), (8, dict(gate_act="relu")),
                  (8, dict(init=True)), (5, {})):
        for dev in ("cpu", "meta"):
            assert run(dev, b, **dict(kw)) == (b, 2, D), (b, kw, dev)


def test_small_hidden_takes_the_scan_on_cpu(np_rng):
    """A hidden size no fused route takes (16, at B=3) runs the scan, on
    the CPU as on the card, and gives what the port's scan gives with a
    callable activation."""
    d = 16
    x = torch.tensor(np_rng.randn(3, 5, 4 * d).astype(np.float32))
    w_r = torch.tensor(np_rng.randn(d, 4 * d).astype(np.float32) * 0.1)
    seq = SequenceBatch(x, torch.tensor([5, 2, 0]))
    out, final = rnn.lstm(seq, w_r)
    assert out.data.shape == (3, 5, d) and not out.data[2].any()
    assert not out.data[1, 2:].any()
    # the final state is each row's last live step (zeros when empty)
    torch.testing.assert_close(final.h, torch.stack(
        [out.data[0, 4], out.data[1, 1], torch.zeros(d)]))
    # a callable tanh is not the default name, so it takes the scan
    out_s, final_s = rnn.lstm(seq, w_r, act=torch.tanh)
    torch.testing.assert_close(out.data, out_s.data, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(final.c, final_s.c, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b, d, exc, match", [
    (40, 640, ConfigError, r"\(B, D\) = \(40, 640\)"),
    (8, 64, ConfigError, r"\(B, D\) = \(8, 64\)")])
def test_wrapper_refuses_uncovered_hidden_sizes(b, d, exc, match):
    """On CUDA the kernels take exactly the (B, D) the route's rule
    admits: the wrapper's shape check refuses any other for a CUDA tensor
    (checked here without a card on the shapes alone) -- D 640 at B 40,
    past the VMEM guard, which the reference also keeps off this kernel,
    and D 64, not a lane multiple -- and lets the plain versions take it
    on the CPU."""
    assert not klstm.shape_supported(b, d)
    assert not pl_lstm.supported(b, d, "tanh", "sigmoid", "tanh", None)
    xs, mask = torch.zeros(2, b, 4 * d), torch.ones(2, b)
    w_r, chk = torch.zeros(d, 4 * d), torch.zeros(3, d)
    with pytest.raises(exc, match=match):
        klstm._shapes(klstm.NAME_FWD, xs, mask, w_r, chk,
                      torch.device("cuda"))
    hs, cfin, _, _ = klstm.lstm_fwd(xs, mask, w_r, chk, False)
    assert hs.shape == (2, b, d) and not cfin.any()


def test_wrapper_checks_dtype_and_shapes():
    xs, mask = torch.zeros(2, 3, 512), torch.ones(2, 3)
    w_r, chk = torch.zeros(128, 512), torch.zeros(3, 128)
    with pytest.raises(TypeError, match="float32"):
        klstm.lstm_fwd(xs.double(), mask, w_r, chk, False)
    with pytest.raises(ValueError, match="mask"):
        klstm.lstm_fwd(xs, torch.ones(3, 2), w_r, chk, False)
    with pytest.raises(ValueError, match="empty"):
        klstm.lstm_fwd(torch.zeros(0, 3, 512), torch.ones(0, 3), w_r, chk,
                       False)


def test_cpu_takes_plain_versions_and_counts_no_launch(np_rng):
    klstm.launches_fwd = klstm.launches_bwd = 0
    inputs = _seq_inputs(np_rng, "ragged")
    _torch_lstm(*inputs, False, True)
    with torch.no_grad():   # the lean forward
        out, _ = rnn.lstm(SequenceBatch(torch.tensor(inputs[0]),
                                        torch.tensor(inputs[1])),
                          torch.tensor(inputs[2]))
    assert out.data.shape == (B, T, D)
    assert (klstm.launches_fwd, klstm.launches_bwd) == (0, 0)
