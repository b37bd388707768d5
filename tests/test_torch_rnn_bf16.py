"""bf16 operands on the port's recurrent path against the JAX package's,
on the CPU: the plain versions of the four recurrent kernel families
(B11 simple RNN, B9 LSTM, B10 GRU, B12 gate-blocked LSTM forward and
its plain backward) at every (xs, W) dtype pair against the Pallas
kernels in interpret mode (B 8, T 7, D 128; the blocked one at D 256),
the scan route against JAX's scan under the bf16 policy, one
``SGD(compute_dtype=torch.bfloat16)`` step of each ``text_rnn`` cell
against JAX's ``SGD(compute_dtype=jnp.bfloat16)`` under the bf16 policy
(its fused routes forced, the kernels in interpret mode), and the CLI's
``--dtype bfloat16`` end to end.

Tolerances.  Both packages widen each operand to float32 on load and
compute in float32, in other summation orders, then round each output
once to its dtype.  A float32 output is held as the float32 kernels'
are (2e-5 absolute plus 2e-4 relative, tests/test_torch_lstm.py); a bf16
output may round one bf16 step (2^-7 of its magnitude's power of two)
further apart where the float32 values straddle a rounding boundary,
plus the same float32 tolerance for values near zero.  Through the DSL
step every product rounds its operands to bf16 (the policy), so an
ulp-level difference in a carried h can round a product operand one
bf16 step apart: the loss is held at 1e-4 relative and each gradient
leaf within 2^-7 of its largest entry (one bf16 step at that scale).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.core import dtypes as jax_dtypes
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.data import integer_value as jax_integer_value
from paddle_tpu.data import \
    integer_value_sequence as jax_integer_value_sequence
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.ops.pallas import gru as pl_gru
from paddle_tpu.ops.pallas import lstm as pl_lstm
from paddle_tpu.ops.pallas import lstm_blocked as pl_blk
from paddle_tpu.ops.pallas import simple_rnn as pl_rnn
from paddle_tpu.trainer import SGD as JaxSGD
from paddle_tpu_torch import optim
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data import (DataFeeder, integer_value,
                                   integer_value_sequence)
from paddle_tpu_torch.models import text_rnn
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops.kernels import _check
from paddle_tpu_torch.ops.kernels import gru as kgru
from paddle_tpu_torch.ops.kernels import lstm as klstm
from paddle_tpu_torch.ops.kernels import lstm_blocked as kblk
from paddle_tpu_torch.ops.kernels import simple_rnn as krnn
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.trainer.checkpoint import load_checkpoint
from paddle_tpu_torch.utils.tree import tree_leaves

B, T, D, D_BLK = 8, 7, 128, 256
RTOL, ATOL = 2e-4, 2e-5
STEP = 2.0 ** -7          # one bf16 step, relative
F32, BF = torch.float32, torch.bfloat16
JAX_DT = {F32: jnp.float32, BF: jnp.bfloat16}
# the (xs, W) dtype pairs with a bf16 operand; float32 with float32 is
# the float32 kernels' own tests
PAIRS = [(F32, BF), (BF, BF), (BF, F32)]
PAIR_IDS = ["xf32_wbf16", "xbf16_wbf16", "xbf16_wf32"]


def _both(a, dt):
    """(jax array, torch tensor) of ``a`` rounded to ``dt``: the same
    values in both."""
    r = np.asarray(jnp.asarray(a, jnp.float32).astype(JAX_DT[dt])
                   .astype(jnp.float32))
    return jnp.asarray(r).astype(JAX_DT[dt]), torch.tensor(r).to(dt)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def _close(got, want, dtype, what):
    """got in ``dtype`` and within the module's tolerance of want."""
    assert got.dtype == dtype, (what, got.dtype)
    g, w = _np(got), _np(want)
    tol = ATOL + RTOL * np.abs(w)
    if dtype == BF:
        with np.errstate(divide="ignore"):
            tol = tol + np.exp2(np.floor(np.log2(np.abs(w))) - 7)
    bad = np.abs(g - w) > tol
    assert not bad.any(), (what, float(np.abs(g - w).max()), int(bad.sum()))


def _lanes(mask):
    return jnp.broadcast_to(jnp.asarray(mask)[:, :, None], mask.shape + (128,))


def _mask(rng, t=T, b=B):
    lengths = rng.randint(1, t + 1, (b,))
    lengths[0] = 0
    lengths[-1] = t
    return (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)


# ---------------------------------------------------------- simple RNN

@pytest.mark.parametrize("xd, wd", PAIRS, ids=PAIR_IDS)
def test_simple_rnn_plain_versions_match_the_kernels(xd, wd):
    rng = np.random.RandomState(0)
    xs_j, xs_t = _both(rng.randn(T, B, D) * 0.3, xd)
    w_j, w_t = _both(rng.randn(D, D) / np.sqrt(D), wd)
    mask = _mask(rng)
    dho_j, dho_t = _both(rng.randn(T, B, D), xd)
    hs = pl_rnn._fwd(xs_j, w_j, _lanes(mask), True)
    dxs, dw, _ = pl_rnn._bwd(True, (w_j, _lanes(mask), hs), dho_j)
    got = krnn.simple_rnn_fwd(xs_t, torch.tensor(mask), w_t)
    _close(got, hs, xd, "hs")
    hs_t = _both(_np(hs), xd)[1]
    gdxs, gdw = krnn.simple_rnn_bwd(hs_t, w_t, torch.tensor(mask), dho_t)
    _close(gdxs, dxs, xd, "dxs")
    _close(gdw, dw, wd, "dW")


# ---------------------------------------------------------------- LSTM

@pytest.mark.parametrize("xd, wd", PAIRS, ids=PAIR_IDS)
def test_lstm_plain_versions_match_the_kernels(xd, wd):
    rng = np.random.RandomState(1)
    xs_j, xs_t = _both(rng.randn(T, B, 4 * D) * 0.3, xd)
    w_j, w_t = _both(rng.randn(D, 4 * D) * 0.1, wd)
    checks = (rng.randn(3, D) * 0.1).astype(np.float32)
    mask = _mask(rng)
    dho_j, dho_t = _both(rng.randn(T, B, D), xd)
    dcfin = rng.randn(B, D).astype(np.float32)
    hs, cfin, cs, acts = pl_lstm._fwd(xs_j, w_j, jnp.asarray(checks),
                                      _lanes(mask), True, True)
    res = (w_j, jnp.asarray(checks), _lanes(mask), hs, cs, acts)
    want_b = pl_lstm._bwd(True, res, (dho_j, jnp.asarray(dcfin)[None]))
    got = klstm.lstm_fwd(xs_t, torch.tensor(mask), w_t,
                         torch.tensor(checks), save_residuals=True)
    for name, g, w, dt in (("hs", got[0], hs, xd), ("c_fin", got[1],
                                                    cfin[0], F32),
                           ("cs", got[2], cs, F32), ("acts", got[3], acts,
                                                     F32)):
        _close(g, w, dt, name)
    got_b = klstm.lstm_bwd(
        torch.tensor(_np(acts)), torch.tensor(_np(cs)), _both(_np(hs), xd)[1],
        w_t, torch.tensor(checks), torch.tensor(mask), dho_t,
        torch.tensor(dcfin))
    for name, g, w, dt in zip(("dxs", "dW_r", "dchecks"), got_b, want_b,
                              (xd, wd, F32)):
        _close(g, w, dt, name)


# ----------------------------------------------------------------- GRU

@pytest.mark.parametrize("xd, wd", PAIRS, ids=PAIR_IDS)
def test_gru_plain_versions_match_the_kernels(xd, wd):
    rng = np.random.RandomState(2)
    xs_j, xs_t = _both(rng.randn(T, B, 3 * D) * 0.3, xd)
    wg_j, wg_t = _both(rng.randn(D, 2 * D) * 0.1, wd)
    ws_j, ws_t = _both(rng.randn(D, D) * 0.1, wd)
    mask = _mask(rng)
    dho_j, dho_t = _both(rng.randn(T, B, D), xd)
    hs, acts = pl_gru._fwd(xs_j, wg_j, ws_j, _lanes(mask), True, True)
    want_b = pl_gru._bwd(True, (wg_j, ws_j, _lanes(mask), hs, acts), dho_j)
    ghs, gacts = kgru.gru_fwd(xs_t, torch.tensor(mask), wg_t, ws_t,
                              save_residuals=True)
    _close(ghs, hs, xd, "hs")
    _close(gacts, acts, F32, "acts")
    got_b = kgru.gru_bwd(torch.tensor(_np(acts)), _both(_np(hs), xd)[1],
                         wg_t, ws_t, torch.tensor(mask), dho_t)
    for name, g, w, dt in zip(("dxs", "dW_gate", "dW_state"), got_b,
                              want_b, (xd, wd, wd)):
        _close(g, w, dt, name)


# ----------------------------------------------------- gate-blocked LSTM

@pytest.mark.parametrize("xd, wd", PAIRS, ids=PAIR_IDS)
def test_lstm_blocked_plain_versions_match_the_kernel(xd, wd):
    """The forward against ``lstm_blocked._fwd`` (T 7 padded to 8 with a
    mask-0 step, as ``lstm_fused_blocked`` pads it), the plain backward
    against ``_bwd_scan``."""
    rng = np.random.RandomState(3)
    d = D_BLK
    xs_j, xs_t = _both(rng.randn(T, B, 4 * d) * 0.3, xd)
    w_j, w_t = _both(rng.randn(d, 4 * d) * 0.1, wd)
    checks = (rng.randn(3, d) * 0.1).astype(np.float32)
    mask = _mask(rng)
    dho_j, dho_t = _both(rng.randn(T, B, d), xd)
    dcfin = rng.randn(B, d).astype(np.float32)
    pad = jnp.zeros_like(xs_j[:1])
    mask_p = np.concatenate([mask, np.zeros_like(mask[:1])])
    hs, cfin, cs, acts = pl_blk._fwd(
        jnp.concatenate([xs_j, pad]).reshape(T + 1, B, 4, d),
        w_j.reshape(d, 4, d), jnp.asarray(checks), _lanes(mask_p), True,
        True)
    hs, cs = hs[:T], cs[:T]
    acts = acts.reshape(T + 1, B, 4 * d)[:T]
    got = kblk.lstm_blocked_fwd(xs_t, torch.tensor(mask), w_t,
                                torch.tensor(checks), save_residuals=True)
    for name, g, w, dt in (("hs", got[0], hs, xd), ("c_fin", got[1],
                                                    cfin[0], F32),
                           ("cs", got[2], cs, F32), ("acts", got[3], acts,
                                                     F32)):
        _close(g, w, dt, name)
    res = (w_j, jnp.asarray(checks), _lanes(mask), hs, cs, acts)
    want_b = pl_blk._bwd_scan(res, (dho_j, jnp.asarray(dcfin)[None]))
    got_b = kblk.lstm_blocked_bwd_plain(
        w_t, torch.tensor(checks), torch.tensor(mask), _both(_np(hs), xd)[1],
        torch.tensor(_np(cs)), torch.tensor(_np(acts)), dho_t,
        torch.tensor(dcfin))
    for name, g, w, dt in zip(("dxs", "dW_r", "dchecks"), got_b, want_b[:3],
                              (xd, wd, F32)):
        _close(g, w, dt, name)


@pytest.mark.parametrize("mod", [klstm, kblk], ids=["lstm", "lstm_blocked"])
def test_c_entries_match_the_source(mod):
    """Every instance's C entry in the module's source declares the
    pointer and int counts its wrapper hands ``_build.entry``
    (FWD_ARGS, BWD_ARGS) before the trailing stream, so ctypes passes no
    pointer as a 32-bit int; the wrapper looks each kernel's entry up by
    name and instance (tests/test_torch_simple_rnn.py and
    tests/test_torch_gru.py check those two families)."""
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, mod.SOURCE)) as f:
        decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', f.read()))
    kinds = [(mod.NAME_FWD, mod.FWD_ARGS)]
    if hasattr(mod, "NAME_BWD"):
        kinds.append((mod.NAME_BWD, mod.BWD_ARGS))
    want = {f"{name}_{s}": args for name, args in kinds
            for s in {_check.suffix(x, w) for x in _check.RNN_DTYPES
                      for w in _check.RNN_DTYPES}}
    assert set(want) <= set(decls)
    for name, (n_ptr, n_int) in want.items():
        params = [p.strip() for p in decls[name].split(",")]
        assert params[-1] == "void* stream"
        got = ["ptr" if "*" in p else p.split()[0] for p in params[:-1]]
        assert got == ["ptr"] * n_ptr + ["int"] * n_int, name
    lib = os.path.basename(mod.SOURCE)[:-3]
    with open(mod.__file__) as f:
        lookups = re.findall(r'_build\.entry\("' + lib + r'", f"\{(NAME_\w+)'
                             r'\}_\{sfx\}", \*(\w+)\)', f.read())
    assert lookups == [(f"NAME_{k}", f"{k}_ARGS") for k in
                       ("FWD", "BWD")[:len(kinds)]]


# ------------------------------------------------------ the scan routes

@pytest.fixture
def bf16_policy():
    dtypes.set_policy(compute_dtype="bfloat16")
    jax_dtypes.set_policy(compute_dtype="bfloat16")
    yield
    dtypes.set_policy()
    jax_dtypes.set_policy()


def _scan_inputs(cell, b=6, t=T, d=D):
    """x float32 (an fc's product), weights and bias rounded to bf16."""
    rng = np.random.RandomState(4)
    width = {"rnn": d, "lstm": 4 * d, "gru": 3 * d}[cell]
    x = (rng.randn(b, t, width) * 0.3).astype(np.float32)
    lengths = rng.randint(1, t + 1, (b,)).astype(np.int32)
    lengths[-1] = t
    ws = {"rnn": [(d, d)], "lstm": [(d, 4 * d)],
          "gru": [(d, 2 * d), (d, d)]}[cell]
    weights = [rng.randn(*s).astype(np.float32) / np.sqrt(d) for s in ws]
    bias = (rng.randn(width) * 0.1).astype(np.float32)
    return x, lengths, weights, bias


def _scan_call(mod, cell, seq, weights, bias):
    if cell == "rnn":
        return mod.simple_rnn(seq, weights[0], bias=bias)
    if cell == "lstm":
        return mod.lstm(seq, weights[0], bias=bias)
    return mod.gru(seq, weights[0], weights[1], bias=bias)


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_scan_route_matches_jax_scan_under_bf16(bf16_policy, cell):
    """B 6 fails the fused rules, so both packages run the masked scan,
    whose ``matmul(h, W)`` rounds h to bf16 under the policy: loss and
    gradients (x float32, W and bias bf16) against JAX's."""
    x, lengths, weights, bias = _scan_inputs(cell)
    fin = (lambda f: f.h) if cell == "lstm" else (lambda f: f)

    def jloss(x, b, *ws):
        out, final = _scan_call(jax_rnn, cell, JaxSeq(x, jnp.asarray(
            lengths)), ws, b)
        return jnp.sum(out.data.astype(jnp.float32) ** 2) + jnp.sum(
            fin(final).astype(jnp.float32) ** 2)

    bf = jnp.bfloat16
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "0"
    try:
        val, grads = jax.jit(jax.value_and_grad(
            jloss, argnums=tuple(range(2 + len(weights)))))(
            jnp.asarray(x), jnp.asarray(bias).astype(bf),
            *(jnp.asarray(w).astype(bf) for w in weights))
    finally:
        jax_rnn.FUSED_LSTM = prior
    args = [torch.tensor(x, requires_grad=True),
            torch.tensor(bias).to(BF).requires_grad_(True)] + [
        torch.tensor(w).to(BF).requires_grad_(True) for w in weights]
    out, final = _scan_call(rnn, cell, SequenceBatch(
        args[0], torch.tensor(lengths)), args[2:], args[1])
    loss = (out.data.float() ** 2).sum() + (fin(final).float() ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=1e-4)
    for i, (a, g) in enumerate(zip(args, grads)):
        assert a.grad.dtype == a.dtype
        g = _np(g)
        err = np.abs(a.grad.float().numpy() - g).max()
        assert err <= STEP * np.abs(g).max(), (i, err)


# ------------------------------------------------- one DSL step per cell

V, H, BT, TT = 50, 128, 8, 12


def _text_rnn(M, cell):
    """``models/text_rnn.build(vocab=V, hidden=H, cell=cell)`` written
    with the DSL ``M`` (JAX's runs it unchanged)."""
    if M is JL:
        from paddle_tpu.layers.graph import reset_names
        reset_names()
    else:
        M.reset_names()
    word = M.data_layer("word", V, is_seq=True)
    label = M.data_layer("label", 1)
    x = M.embedding_layer(word, size=text_rnn.EMB)
    for _ in range(text_rnn.LAYERS):
        if cell == "rnn":
            x = M.recurrent_layer(M.fc_layer(x, size=H, act=None,
                                             bias_attr=False), act="tanh")
        elif cell == "lstm":
            x = M.lstmemory(M.fc_layer(x, size=4 * H, act=None,
                                       bias_attr=False))
        else:
            x = M.grumemory(M.fc_layer(x, size=3 * H, act=None))
    pooled = M.pooling_layer(x, pooling_type=M.pooling.Max)
    out = M.fc_layer(pooled, size=2, act="softmax")
    return M.classification_cost(out, label)


def _batch(seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, TT + 1, BT)
    lengths[-1] = TT
    return [(rng.randint(0, V, n).tolist(), int(rng.randint(0, 2)))
            for n in lengths]


@functools.lru_cache(maxsize=None)
def _jax_step(cell):
    """JAX's SGD(compute_dtype=bf16) under the bf16 policy, its fused
    routes forced (the kernels in interpret mode): (initial params,
    loss, gradients) of one batch, as numpy."""
    jax_dtypes.set_policy(compute_dtype="bfloat16")
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always"
    try:
        jt = JaxSGD(_text_rnn(JL, cell), update_equation=jax_optim.Momentum(
            learning_rate=0.01, momentum=0.9), compute_dtype=jnp.bfloat16,
            seed=3)
        from paddle_tpu.data.feeder import DataFeeder as JaxFeeder
        feed = JaxFeeder({"word": jax_integer_value_sequence(V),
                          "label": jax_integer_value(2)})(_batch(1))
        count = jax_rnn.FUSED_DISPATCH_COUNT
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jt._loss_and_extras(p, jt.model_state, feed,
                                          jax.random.PRNGKey(0))[0]))(
            jt.parameters)
        assert jax_rnn.FUSED_DISPATCH_COUNT - count == 2
    finally:
        jax_rnn.FUSED_LSTM = prior
        jax_dtypes.set_policy()
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return host(jt.parameters), float(loss), host(grads)


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_text_rnn_bf16_step_matches_jax(bf16_policy, cell):
    """The first SGD(compute_dtype=torch.bfloat16) step of text_rnn's
    ``cell`` (the port's model module) on JAX's initial weights: the
    loss and every gradient leaf, float32 leaves holding bf16 values;
    the JAX mirror of the config mints the same parameters."""
    start, want_loss, want_grads = _jax_step(cell)
    cost = text_rnn.build(vocab=V, hidden=H, cell=cell)
    trainer = SGD(cost, parameters=start, update_equation=optim.Momentum(
        learning_rate=0.01, momentum=0.9), compute_dtype=BF, device="cpu")
    assert trainer.topology.param_shapes() == {
        k: {n: a.shape for n, a in v.items()} for k, v in start.items()}
    feed = DataFeeder({"word": integer_value_sequence(V),
                       "label": integer_value(2)}, device="cpu")(_batch(1))
    total, _ = trainer._forward(feed)
    trainer._backward(total)
    np.testing.assert_allclose(float(total.detach()), want_loss, rtol=1e-4)
    got = tree_leaves(trainer.parameters)
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(got) == len(want)
    for p, w in zip(got, want):
        assert p.dtype == F32 and p.grad.dtype == F32
        g = p.grad.numpy()
        np.testing.assert_array_equal(g, p.grad.to(BF).float().numpy())
        assert np.abs(g - w).max() <= STEP * np.abs(w).max()


def test_cli_trains_and_tests_under_bfloat16(tmp_path):
    """``python -m paddle_tpu_torch train --dtype bfloat16 --device cpu``
    on a small text_rnn config writes a float32 pass dir that ``test
    --dtype bfloat16`` reads."""
    cfg = tmp_path / "cfg.py"
    cfg.write_text("from paddle_tpu_torch.models import text_rnn\n"
                   "def get_config():\n"
                   "    return text_rnn.config(n_batches=2, batch=8, "
                   "seq_len=12, vocab=50, hidden=128, cell='gru')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    base = [sys.executable, "-m", "paddle_tpu_torch"]
    run = subprocess.run(
        base + ["train", "--config", str(cfg), "--device", "cpu", "--dtype",
                "bfloat16", "--save_dir", str(tmp_path / "out")],
        capture_output=True, text=True, env=env, cwd=root, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    params, opt_state, _, meta = load_checkpoint(str(tmp_path / "out"))
    assert int(opt_state["step"]) == 2
    for leaf in jax.tree_util.tree_leaves(params):
        assert np.asarray(leaf).dtype == np.float32
    run = subprocess.run(
        base + ["test", "--config", str(cfg), "--device", "cpu", "--dtype",
                "bfloat16", "--model_dir", str(tmp_path / "out")],
        capture_output=True, text=True, env=env, cwd=root, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().startswith("test cost: ")
    assert np.isfinite(float(run.stdout.split(":")[1]))
