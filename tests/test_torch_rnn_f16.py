"""float16 operands on the port's recurrent path against the JAX
package's, on the CPU: the plain versions of the four recurrent kernel
families (B11 simple RNN, B9 LSTM, B10 GRU, B12 gate-blocked LSTM
forward and its plain backward) at every (xs, W) dtype pair with a
float16 operand against the Pallas kernels in interpret mode (B 8, T 7,
D 128; the blocked one at D 256), the wrappers' admission of every pair
of ``_check.RNN_DTYPES``, and one ``SGD(compute_dtype=torch.float16)``
step of each ``text_rnn`` cell against JAX's
``SGD(compute_dtype=jnp.float16)`` under the float16 policy (its fused
routes forced, the kernels in interpret mode).

Tolerances, as tests/test_torch_rnn_bf16.py states them for bf16: both
packages widen each operand on load, compute in float32 in other
summation orders and round each output once, so a float32 output is
held at 2e-5 absolute plus 2e-4 relative, a low-precision one may round
one step of its dtype further apart (2^-10 of the value's power of two
for float16, 2^-7 for bf16).  Through the DSL step every product
multiplies in float32 (``matmul`` under a float16 policy, both
packages), the parameters and the feed round to float16 at the step
boundary and the fused kernels round hs and dxs to float16: an ulp-level
difference in a carried h can round an output one float16 step apart,
so the loss is held at 1e-4 relative and each gradient leaf within
2^-10 of its largest entry.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.core import dtypes as jax_dtypes
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
from paddle_tpu_torch.data import (DataFeeder, integer_value,
                                   integer_value_sequence)
from paddle_tpu_torch.models import text_rnn
from paddle_tpu_torch.ops.kernels import _check
from paddle_tpu_torch.ops.kernels import gru as kgru
from paddle_tpu_torch.ops.kernels import lstm as klstm
from paddle_tpu_torch.ops.kernels import lstm_blocked as kblk
from paddle_tpu_torch.ops.kernels import simple_rnn as krnn
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.tree import tree_leaves

B, T, D, D_BLK = 8, 7, 128, 256
RTOL, ATOL = 2e-4, 2e-5
F32, BF, F16 = torch.float32, torch.bfloat16, torch.float16
JAX_DT = {F32: jnp.float32, BF: jnp.bfloat16, F16: jnp.float16}
STEP = {BF: 2.0 ** -7, F16: 2.0 ** -10}   # one step of the dtype, relative
# the (xs, W) pairs with a float16 operand (the bf16 ones and float32
# with float32 are tests/test_torch_rnn_bf16.py's and the float32
# kernels' own tests)
PAIRS = [(F32, F16), (F16, F16), (F16, F32), (BF, F16), (F16, BF)]
PAIR_IDS = [_check.suffix(x, w) for x, w in PAIRS]


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
    if dtype in STEP:
        with np.errstate(divide="ignore"):
            tol = tol + np.exp2(np.floor(np.log2(np.abs(w)))) * STEP[dtype]
    bad = np.abs(g - w) > tol
    assert not bad.any(), (what, float(np.abs(g - w).max()), int(bad.sum()))


def _lanes(mask):
    return jnp.broadcast_to(jnp.asarray(mask)[:, :, None], mask.shape + (128,))


def _mask(rng, t=T, b=B):
    lengths = rng.randint(1, t + 1, (b,))
    lengths[0] = 0
    lengths[-1] = t
    return (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)


def test_every_pair_is_admitted_and_named():
    """``RNN_DTYPES`` holds float16, each (xs, W) pair names its own C
    entry, and a wrapper refuses a dtype outside the set."""
    assert F16 in _check.RNN_DTYPES
    names = {_check.suffix(x, w) for x in _check.RNN_DTYPES
             for w in _check.RNN_DTYPES}
    assert len(names) == 9 and "f32" in names and "xf16_wf16" in names
    w = torch.zeros(D, D, dtype=F16)
    with pytest.raises(TypeError, match="xs must be"):
        krnn.simple_rnn_fwd(torch.zeros(T, B, D, dtype=torch.float64),
                            torch.ones(T, B), w)


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
    for name, g, w, dt in (("hs", got[0], hs, xd),
                           ("c_fin", got[1], cfin[0], F32),
                           ("cs", got[2], cs, F32),
                           ("acts", got[3], acts, F32)):
        _close(g, w, dt, name)
    got_b = klstm.lstm_bwd(
        torch.tensor(_np(acts)), torch.tensor(_np(cs)), _both(_np(hs), xd)[1],
        w_t, torch.tensor(checks), torch.tensor(mask), dho_t,
        torch.tensor(dcfin))
    for name, g, w, dt in zip(("dxs", "dW_r", "dchecks"), got_b, want_b,
                              (xd, wd, F32)):
        _close(g, w, dt, name)


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
    for name, g, w, dt in (("hs", got[0], hs, xd),
                           ("c_fin", got[1], cfin[0], F32),
                           ("cs", got[2], cs, F32),
                           ("acts", got[3], acts, F32)):
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


# ------------------------------------------------- one DSL step per cell

V, H, BT, TT = 50, 128, 8, 12


@pytest.fixture
def f16_policy():
    dtypes.set_policy(compute_dtype="float16")
    jax_dtypes.set_policy(compute_dtype="float16")
    yield
    dtypes.set_policy()
    jax_dtypes.set_policy()


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
    """JAX's SGD(compute_dtype=float16) under the float16 policy, its
    fused routes forced (the kernels in interpret mode, two dispatches:
    the float16 operands reach them): (initial params, loss, gradients)
    of one batch, as numpy."""
    jax_dtypes.set_policy(compute_dtype="float16")
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always"
    try:
        jt = JaxSGD(_text_rnn(JL, cell), update_equation=jax_optim.Momentum(
            learning_rate=0.01, momentum=0.9), compute_dtype=jnp.float16,
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
def test_text_rnn_f16_step_matches_jax(f16_policy, cell):
    """The first SGD(compute_dtype=torch.float16) step of text_rnn's
    ``cell`` on JAX's initial weights: the loss and every gradient leaf
    (float32 leaves holding float16 values: the step casts at its
    boundary)."""
    start, want_loss, want_grads = _jax_step(cell)
    cost = text_rnn.build(vocab=V, hidden=H, cell=cell)
    trainer = SGD(cost, parameters=start, update_equation=optim.Momentum(
        learning_rate=0.01, momentum=0.9), compute_dtype=F16, device="cpu")
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
        np.testing.assert_array_equal(g, p.grad.to(F16).float().numpy())
        assert np.abs(g - w).max() <= STEP[F16] * np.abs(w).max()


def test_seq_max_pool_takes_float16_as_jax():
    """The embedding-fed float16 layers max-pool float16 hs: the padding
    value is -1e30 cast to float16 (-inf), as JAX casts it, an empty row
    pools to 0 (a Python scalar that overflows float16 is refused on a
    CUDA tensor, so the port casts a tensor)."""
    from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
    from paddle_tpu.ops import sequence as jax_seq
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import sequence as seq_ops
    rng = np.random.RandomState(5)
    x = rng.randn(3, 5, 8).astype(np.float16)
    lengths = np.asarray([5, 2, 0], np.int32)
    want = np.asarray(jax_seq.seq_max_pool(JaxSeq(jnp.asarray(x),
                                                  jnp.asarray(lengths))))
    got = seq_ops.seq_max_pool(SequenceBatch(torch.tensor(x),
                                             torch.tensor(lengths)))
    assert got.dtype == F16
    np.testing.assert_array_equal(got.numpy(), want)
