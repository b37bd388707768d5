"""The port's gate-blocked LSTM (paddle_tpu_torch.ops.kernels.lstm_blocked
and the LSTM route of ops/rnn.lstm) against the JAX package's, on the CPU.

The plain forward (``lstm.lstm_fwd_plain``, the kernel's plain version)
is held against the Pallas kernel itself (``paddle_tpu.ops.pallas.
lstm_blocked._fwd`` in interpret mode, B=8, D=256, T 6 and 7; odd T
against JAX's even-padded run), ``lstm_blocked_bwd_plain`` against
``_bwd_scan`` on the same residuals, ``rnn.lstm`` through the blocked
route against the JAX ``rnn.lstm`` through its own (B=8, D=768), the
route rules against JAX's over a grid of (B, D) and configurations, and
three ``bench_lstm`` steps at h=768 against the jitted JAX step.

Tolerances: values atol 2e-5 as tests/test_pallas_lstm_blocked.py holds
the Pallas kernel to its scan; gradients rtol 2e-4, atol 2e-5 as
tests/test_torch_lstm.py — both sides compute in float32 but sum the
recurrent products (and the backward's dW_r over T B rows, which the
port forms as one product where the JAX scan accumulates per step) in
different orders.  Optimizer state after three Momentum steps within
1e-4 of each leaf's largest entry, as tests/test_torch_train.py.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.models import text_lstm as jax_text_lstm
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.ops.pallas import lstm as pl_lstm
from paddle_tpu.ops.pallas import lstm_blocked as pl_blk
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops.kernels import lstm as klstm
from paddle_tpu_torch.ops.kernels import lstm_blocked as kblk
from paddle_tpu_torch.scripts import bench
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

B, D = 8, 256
ATOL = 2e-5
RTOL = 2e-4
DEFAULT = ("tanh", "sigmoid", "tanh")


def _close(got, want, what, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _mask(rng, t, b, kind):
    lengths = np.full((b,), t, np.int32)
    if kind != "full":
        lengths = rng.randint(1, t + 1, (b,)).astype(np.int32)
        if kind == "zero":
            lengths[0] = 0
    return lengths, (np.arange(t)[:, None] < lengths[None, :]).astype(
        np.float32)


def _kernel_inputs(t, kind, seed=0):
    """Inputs at the JAX tests' scale (x*0.3, W_r*0.1, checks*0.1)."""
    rng = np.random.RandomState(seed)
    xs = (rng.randn(t, B, 4 * D) * 0.3).astype(np.float32)
    w_r = (rng.randn(D, 4 * D) * 0.1).astype(np.float32)
    checks = (rng.randn(3, D) * 0.1).astype(np.float32)
    return xs, w_r, checks, _mask(rng, t, B, kind)[1]


def _jax_fwd(xs, w_r, checks, mask):
    """The Pallas forward with residuals, T padded to even with a mask-0
    step as ``lstm_fused_blocked`` pads it; the first T steps."""
    t = xs.shape[0]
    pad = t % 2
    xs_p = np.concatenate([xs, np.zeros_like(xs[:1])]) if pad else xs
    mask_p = np.concatenate([mask, np.zeros_like(mask[:1])]) if pad else mask
    hs, cfin, cs, acts = pl_blk._fwd(
        jnp.asarray(xs_p.reshape(t + pad, B, 4, D)),
        jnp.asarray(w_r.reshape(D, 4, D)), jnp.asarray(checks),
        jnp.broadcast_to(jnp.asarray(mask_p)[:, :, None], mask_p.shape
                         + (128,)), True, True)
    return (np.asarray(hs)[:t], np.asarray(cfin)[0], np.asarray(cs)[:t],
            np.asarray(acts).reshape(t + pad, B, 4 * D)[:t])


@pytest.mark.parametrize("t", [6, 7])
@pytest.mark.parametrize("kind", ["full", "ragged", "zero"])
def test_plain_forward_matches_pallas_kernel(t, kind):
    xs, w_r, checks, mask = _kernel_inputs(t, kind)
    want = _jax_fwd(xs, w_r, checks, mask)
    args = [torch.tensor(a) for a in (xs, mask, w_r, checks)]
    got = kblk.lstm_blocked_fwd(*args, save_residuals=True)
    for name, g, w in zip(("hs", "c_fin", "cs", "acts"), got, want):
        _close(g, w, name)
    lean = kblk.lstm_blocked_fwd(*args, save_residuals=False)
    assert lean[2] is None and lean[3] is None
    torch.testing.assert_close(lean[0], got[0], rtol=0, atol=0)
    torch.testing.assert_close(lean[1], got[1], rtol=0, atol=0)


@pytest.mark.parametrize("t", [6, 7])
@pytest.mark.parametrize("kind", ["ragged", "zero"])
def test_plain_backward_matches_bwd_scan(t, kind):
    xs, w_r, checks, mask = _kernel_inputs(t, kind, seed=1)
    hs, cfin, cs, acts = kblk.lstm_blocked_fwd(
        *(torch.tensor(a) for a in (xs, mask, w_r, checks)), True)
    rng = np.random.RandomState(2)
    dh_out = rng.randn(t, B, D).astype(np.float32)
    dcfin = rng.randn(B, D).astype(np.float32)
    res = (jnp.asarray(w_r), jnp.asarray(checks),
           jnp.broadcast_to(jnp.asarray(mask)[:, :, None], mask.shape
                            + (128,)),
           *(jnp.asarray(x.numpy()) for x in (hs, cs, acts)))
    want = pl_blk._bwd_scan(res, (jnp.asarray(dh_out),
                                  jnp.asarray(dcfin)[None]))
    got = kblk.lstm_blocked_bwd_plain(
        torch.tensor(w_r), torch.tensor(checks), torch.tensor(mask), hs, cs,
        acts, torch.tensor(dh_out), torch.tensor(dcfin))
    for name, g, w in zip(("dxs", "dW_r", "dchecks"), got, want[:3]):
        _close(g, w, name, rtol=RTOL)


def _seq_inputs(seed, b, t, d, kind):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, 4 * d) * 0.3).astype(np.float32)
    w_r = (rng.randn(d, 4 * d) * 0.1).astype(np.float32)
    checks = [(rng.randn(d) * 0.1).astype(np.float32) for _ in range(3)]
    bias = (rng.randn(4 * d) * 0.1).astype(np.float32)
    return x, _mask(rng, t, b, kind)[0], w_r, checks, bias


def _jax_lstm(x, lengths, w_r, checks, bias, reverse, fused="always", **kw):
    """loss and grads (x, w_r, checks, bias) of the JAX rnn.lstm with its
    fused routes forced on (the kernels in interpret mode) or off, and
    the number of fused dispatches it made."""
    def loss(x, w_r, checks, bias):
        ci, cf, co = checks
        out, final = jax_rnn.lstm(JaxSeq(x, jnp.asarray(lengths)), w_r,
                                  bias=bias, check_i=ci, check_f=cf,
                                  check_o=co, reverse=reverse, **kw)
        return (jnp.sum(out.data ** 2) + jnp.sum(final.c ** 2)
                + jnp.sum(final.h))
    prior, count = jax_rnn.FUSED_LSTM, jax_rnn.FUSED_DISPATCH_COUNT
    jax_rnn.FUSED_LSTM = fused
    try:
        out = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
            jnp.asarray(x), jnp.asarray(w_r),
            [jnp.asarray(c) for c in checks], jnp.asarray(bias))
        return out, jax_rnn.FUSED_DISPATCH_COUNT - count
    finally:
        jax_rnn.FUSED_LSTM = prior


def _torch_lstm(x, lengths, w_r, checks, bias, reverse, **kw):
    args = [torch.tensor(a, requires_grad=True)
            for a in (x, w_r, *checks, bias)]
    xt, wt, ci, cf, co, bt = args
    out, final = rnn.lstm(SequenceBatch(xt, torch.tensor(lengths)), wt,
                          bias=bt, check_i=ci, check_f=cf, check_o=co,
                          reverse=reverse, **kw)
    loss = (out.data ** 2).sum() + (final.c ** 2).sum() + final.h.sum()
    loss.backward()
    return loss.detach(), [a.grad for a in args]


class _Spy:
    """Counts the calls of a kernel wrapper and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("kind, reverse", [
    ("ragged", False), ("zero", True)])
def test_rnn_lstm_blocked_route_matches_jax(monkeypatch, kind, reverse):
    """B=8, D=768, odd T: both packages' rules send it to the blocked
    route (the resident kernel's VMEM guard fails), the JAX one through
    the Pallas kernel in interpret mode and ``_bwd_scan``."""
    b, t, d = 8, 5, 768
    assert not pl_lstm.supported(b, d, *DEFAULT, None)
    assert pl_blk.supported(b, d, *DEFAULT, None)
    inputs = _seq_inputs(3, b, t, d, kind)
    (want_loss, want), dispatched = _jax_lstm(*inputs, reverse)
    assert dispatched == 1
    spy = _Spy(kblk.lstm_blocked_fwd)
    monkeypatch.setattr(kblk, "lstm_blocked_fwd", spy)
    loss, grads = _torch_lstm(*inputs, reverse)
    assert spy.calls == 1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5)
    gx, gw, gc, gb = want
    for name, g, w in zip(("dx", "dw_r", "dcheck_i", "dcheck_f", "dcheck_o",
                           "dbias"), grads, [gx, gw, *gc, gb]):
        _close(g, w, name, rtol=RTOL)


def _route(b, d, act="tanh", gate_act="sigmoid", state_act="tanh",
           init=None):
    """The route the JAX package's rules give."""
    if pl_lstm.supported(b, d, act, gate_act, state_act, init):
        return "resident"
    if pl_blk.supported(b, d, act, gate_act, state_act, init):
        return "blocked"
    return "scan"


def _meta_route(b, d, act="tanh", gate_act="sigmoid", state_act="tanh",
                init=None):
    """The route ``rnn.lstm`` takes on a device that no kernel wrapper
    takes ("meta"): a fused route raises in its wrapper, naming it; the
    scan runs."""
    meta = torch.device("meta")
    seq = SequenceBatch(torch.zeros(b, 1, 4 * d, device=meta),
                        torch.zeros(b, dtype=torch.int32, device=meta))
    state = None if init is None else rnn.LstmState(
        h=torch.zeros(b, d, device=meta), c=torch.zeros(b, d, device=meta))
    try:
        out, _ = rnn.lstm(seq, torch.zeros(d, 4 * d, device=meta), act=act,
                          gate_act=gate_act, state_act=state_act,
                          init_state=state)
    except ValueError as e:
        assert "on meta" in str(e), e
        return {klstm.NAME_FWD: "resident",
                kblk.NAME_FWD: "blocked"}[str(e).split(":")[0]]
    assert out.data.shape == (b, 1, d)
    return "scan"


GRID = [(b, d) for b in (8, 12, 64, 256) for d in range(128, 3457, 128)]


def test_route_rule_matches_jax_over_the_grid():
    """Both rules equal JAX's over B 8/12/64/256 and D 128..3456, and
    ``rnn.lstm`` takes the route they give (seen on "meta"); every (B, D)
    the blocked rule admits is one the kernel takes."""
    routes = {}
    for b, d in GRID:
        want = _route(b, d)
        assert klstm.supported(b, d, *DEFAULT, None) \
            == pl_lstm.supported(b, d, *DEFAULT, None), (b, d)
        assert kblk.supported(b, d, *DEFAULT, None) \
            == pl_blk.supported(b, d, *DEFAULT, None), (b, d)
        assert klstm.vmem_bytes(b, d) == pl_lstm.vmem_bytes(b, d)
        assert kblk.vmem_bytes(b, d) == pl_blk.vmem_bytes(b, d)
        assert _meta_route(b, d) == want, (b, d)
        if want == "blocked":
            kblk._shapes(torch.zeros(1, b, 4 * d), torch.zeros(1, b),
                         torch.zeros(d, 4 * d), torch.zeros(3, d),
                         torch.device("cuda"))
        routes[b, d] = want
    assert routes[64, 384] == "resident" and routes[8, 640] == "resident"
    assert all(routes[64, d] == "blocked" for d in (640, 1280, 2048))
    assert routes[64, 2944] == "scan" and routes[256, 512] == "blocked"
    assert routes[8, 3456] == "blocked" and routes[12, 1280] == "scan"
    # every (B, D) the resident route admits is one its kernels take on
    # the card (D 384 and 640 included), and no other
    for (b, d), r in routes.items():
        args = (torch.zeros(1, b, 4 * d), torch.zeros(1, b),
                torch.zeros(d, 4 * d), torch.zeros(3, d))
        if r == "resident":
            klstm._shapes(klstm.NAME_FWD, *args, torch.device("cuda"))
        elif not klstm.shape_supported(b, d):
            with pytest.raises(ConfigError):
                klstm._shapes(klstm.NAME_FWD, *args, torch.device("cuda"))
    assert {d for (b, d), r in routes.items() if r == "resident"} \
        >= {384, 640}


@pytest.mark.parametrize("act, gate_act, state_act, init", [
    ("relu", "sigmoid", "tanh", None), ("tanh", "tanh", "tanh", None),
    ("tanh", "sigmoid", "relu", None), ("tanh", "sigmoid", "tanh", "given")])
def test_route_rule_matches_jax_off_the_defaults(act, gate_act, state_act,
                                                 init):
    """Other activations or an initial state take the scan in both
    packages, the train shapes included."""
    cfg = (act, gate_act, state_act, init)
    for b, d in ((8, 128), (64, 512), (64, 1280), (64, 2048)):
        assert _route(b, d, *cfg) == "scan"
        assert not klstm.supported(b, d, *cfg)
        assert not kblk.supported(b, d, *cfg)
        assert _meta_route(b, d, *cfg) == "scan"


@pytest.mark.parametrize("mb", ["0.5", "64"])
def test_route_ignores_the_tpu_vmem_override(monkeypatch, mb):
    """The budget is the JAX package's default, a constant: the TPU's
    PADDLE_TPU_KERNEL_VMEM_MB override moves no train shape to another
    route on the port's side."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_VMEM_MB", mb)
    assert klstm.supported(64, 512, *DEFAULT, None)
    assert not klstm.supported(64, 640, *DEFAULT, None)
    assert kblk.supported(64, 1280, *DEFAULT, None)
    assert kblk.supported(64, 2048, *DEFAULT, None)
    assert not kblk.supported(64, 2944, *DEFAULT, None)
    assert _meta_route(64, 1280) == "blocked"


@pytest.mark.parametrize("b, d, kw", [
    (12, 128, {}), (8, 128, {"act": "relu"}),
    (8, 128, {"init_state": "given"}), (64, 2944, {})])
def test_scan_configs_run_on_either_device(b, d, kw):
    """Where JAX's rules send ``lstm`` to the masked scan, the port scans
    too, whatever the device: on the CPU it matches the JAX scan (small
    D), and on "meta", where every kernel wrapper raises, it runs."""
    t = 6
    if d <= 128:
        x, lengths, w_r, checks, bias = _seq_inputs(4, b, t, d, "zero")
        rng = np.random.RandomState(5)
        h0, c0 = (rng.randn(2, b, d) * 0.5).astype(np.float32)
        jkw = dict(kw, init_state=jax_rnn.LstmState(
            jnp.asarray(h0), jnp.asarray(c0))) if "init_state" in kw else kw
        tkw = dict(kw, init_state=rnn.LstmState(
            torch.tensor(h0), torch.tensor(c0))) if "init_state" in kw \
            else kw
        want, want_final = jax_rnn.lstm(
            JaxSeq(jnp.asarray(x), jnp.asarray(lengths)), jnp.asarray(w_r),
            bias=jnp.asarray(bias), check_i=jnp.asarray(checks[0]),
            reverse=True, **jkw)
        klstm.launches_fwd = kblk.launches_fwd = 0
        got, final = rnn.lstm(
            SequenceBatch(torch.tensor(x), torch.tensor(lengths)),
            torch.tensor(w_r), bias=torch.tensor(bias),
            check_i=torch.tensor(checks[0]), reverse=True, **tkw)
        _close(got.data, want.data, "out", rtol=RTOL)
        _close(final.h, want_final.h, "h", rtol=RTOL)
        _close(final.c, want_final.c, "c", rtol=RTOL)
        assert (klstm.launches_fwd, kblk.launches_fwd) == (0, 0)
    assert _meta_route(b, d, act=kw.get("act", "tanh"),
                       init=kw.get("init_state")) == "scan"


def test_bench_steps_match_jax_bench_step_over_three_steps():
    """bench_lstm at h=768 (the blocked route on both sides at B=8): the
    port's train step (autograd + in-place Momentum) against
    bench.py:335-340's jitted JAX step through the Pallas kernel in
    interpret mode, from the same params and batch, three steps."""
    hidden = 768
    port = bench.bench_lstm(batch=8, seq_len=5, hidden=hidden, vocab=50,
                            device="cpu")
    assert kblk.supported(8, hidden, *DEFAULT, None)
    assert not klstm.supported(8, hidden, *DEFAULT, None)
    jp = tree_map(lambda x: jnp.asarray(x.detach().numpy().copy()),
                  port.params)
    opt = jax_optim.Momentum(learning_rate=0.01, momentum=0.9)
    js = opt.init(jp)
    jids = JaxSeq(jnp.asarray(port.ids.data.numpy()),
                  jnp.asarray(port.ids.lengths.numpy()))
    jlabels = jnp.asarray(port.labels.numpy())

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, ids, labels):
        loss, grads = jax.value_and_grad(jax_text_lstm.loss)(
            params, ids, labels, 2, hidden)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss

    prior, count = jax_rnn.FUSED_LSTM, jax_rnn.FUSED_DISPATCH_COUNT
    jax_rnn.FUSED_LSTM = "always"
    try:
        for _ in range(3):
            jp, js, jloss = step(jp, js, jids, jlabels)
            loss = port.train_step()
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    finally:
        jax_rnn.FUSED_LSTM = prior
    assert jax_rnn.FUSED_DISPATCH_COUNT - count == 2   # traced once
    for got, want in zip(tree_leaves(port.params)
                         + tree_leaves(port.opt_state["slots"]["mom"]),
                         jax.tree_util.tree_leaves(jp)
                         + jax.tree_util.tree_leaves(js["slots"]["mom"])):
        got, want = got.detach().numpy(), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_cpu_takes_plain_versions_and_counts_no_launch():
    kblk.launches_fwd = klstm.launches_fwd = klstm.launches_bwd = 0
    inputs = _seq_inputs(6, 8, 4, 768, "zero")
    loss, grads = _torch_lstm(*inputs, False)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    with torch.no_grad():   # the lean forward
        out, _ = rnn.lstm(SequenceBatch(torch.tensor(inputs[0]),
                                        torch.tensor(inputs[1])),
                          torch.tensor(inputs[2]))
    assert out.data.shape == (8, 4, 768)
    assert (kblk.launches_fwd, klstm.launches_fwd, klstm.launches_bwd) \
        == (0, 0, 0)


@pytest.mark.parametrize("d, match", [(4224, "hidden size 4224"),
                                      (1000, "hidden size 1000")])
def test_wrapper_refuses_hidden_sizes_the_kernel_lacks(d, match):
    """A CUDA tensor of a hidden size the kernel does not take raises in
    the wrapper's shape check (checked here on the shapes alone); the
    plain version takes it on the CPU."""
    from paddle_tpu_torch.utils.error import ConfigError
    xs, mask = torch.zeros(2, 8, 4 * d), torch.ones(2, 8)
    w_r, chk = torch.zeros(d, 4 * d), torch.zeros(3, d)
    with pytest.raises(ConfigError, match=match):
        kblk._shapes(xs, mask, w_r, chk, torch.device("cuda"))
    hs, cfin, _, _ = kblk.lstm_blocked_fwd(xs, mask, w_r, chk, False)
    assert hs.shape == (2, 8, d) and not cfin.any()


def test_wrapper_checks_dtype_and_shapes():
    xs, mask = torch.zeros(2, 8, 512), torch.ones(2, 8)
    w_r, chk = torch.zeros(128, 512), torch.zeros(3, 128)
    with pytest.raises(TypeError, match="float32"):
        kblk.lstm_blocked_fwd(xs.double(), mask, w_r, chk, False)
    with pytest.raises(ValueError, match="mask"):
        kblk.lstm_blocked_fwd(xs, torch.ones(8, 2), w_r, chk, False)
    with pytest.raises(ValueError, match="empty"):
        kblk.lstm_blocked_fwd(torch.zeros(0, 8, 512), torch.ones(0, 8), w_r,
                              chk, False)

