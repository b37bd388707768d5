"""The port's training slice (core/sequence, ops, optim, models/text_lstm,
scripts/bench) against the JAX package's on identical numpy inputs, on
the CPU (where the LSTM kernels take their plain versions).

Tolerances: float32 on both sides.  Elementwise ops and gathers agree
to an ulp or two (1e-6); results that pass through the LSTM recurrence
or a matmul sum in different orders and are held at rtol 2e-4, atol
2e-5 as tests/test_pallas_lstm.py:71 holds the JAX kernel to its scan;
optimizer state after three Momentum steps is held per leaf at 1e-4 of
the leaf's largest value.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.core import sequence as jax_sequence
from paddle_tpu.models import text_lstm as jax_text_lstm
from paddle_tpu.ops import activations as jax_act
from paddle_tpu.ops import linear as jax_linear
from paddle_tpu.ops import losses as jax_losses
from paddle_tpu.ops import sequence as jax_seq_ops
from paddle_tpu_torch.core import sequence
from paddle_tpu_torch.models import text_lstm
from paddle_tpu_torch.ops import (activations, initializers, linear, losses,
                                  sequence as seq_ops)
from paddle_tpu_torch.optim import Momentum, schedules
from paddle_tpu_torch.scripts import bench
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

EXACT = 1e-6
RTOL, ATOL = 2e-4, 2e-5


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name", activations.names())
def test_activations_match_jax(name):
    x = np.linspace(-50.0, 50.0, 41, dtype=np.float32).reshape(-1, 1) \
        * np.asarray([1.0, 0.01], np.float32)
    want = np.asarray(jax_act.get(name)(jnp.asarray(x)))
    _close(activations.get(name)(_t(x)), want, rtol=EXACT, atol=EXACT)


def test_activation_registry_matches_jax_and_rejects_unknown():
    assert activations.names() == jax_act.names()
    x = torch.arange(3.0)
    for name in (None, "", "linear", "identity"):
        assert activations.get(name)(x) is x
    assert activations.get(torch.tanh) is torch.tanh
    with pytest.raises(KeyError, match="'bogus'"):
        activations.get("bogus")


@pytest.mark.parametrize("from_logits", [True, False])
def test_classification_cost_matches_jax(np_rng, from_logits):
    x = np_rng.randn(6, 4).astype(np.float32)
    if not from_logits:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        x[0, 0] = 0.0                        # the 1e-10 floor
    labels = np.asarray([0, 3, -1, 7, 2, 1], np.int32)   # out of range too
    want, want_g = jax.value_and_grad(
        lambda v: jax_losses.classification_cost(
            v, jnp.asarray(labels), from_logits=from_logits).sum())(
        jnp.asarray(x))
    xt = _t(x, grad=True)
    got = losses.classification_cost(xt, _t(labels), from_logits=from_logits)
    got.sum().backward()
    want_rows = np.asarray(jax_losses.classification_cost(
        jnp.asarray(x), jnp.asarray(labels), from_logits=from_logits))
    _close(got.detach(), want_rows, rtol=EXACT, atol=EXACT)
    _close(xt.grad, want_g, rtol=EXACT, atol=EXACT)


@pytest.mark.parametrize("pooling", ["max", "avg", "average", "sum", "sqrt",
                                     "last", "first"])
def test_pooling_matches_jax_with_an_empty_row(np_rng, pooling):
    data = np_rng.randn(4, 5, 6).astype(np.float32)
    lengths = np.asarray([3, 0, 5, 1], np.int32)
    w = np_rng.randn(4, 6).astype(np.float32)

    def jax_loss(d):
        out = jax_seq_ops.seq_pool(
            jax_sequence.SequenceBatch(d, jnp.asarray(lengths)), pooling)
        return jnp.sum(out * w), out
    (_, want), want_g = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(data))
    dt = _t(data, grad=True)
    got = seq_ops.seq_pool(sequence.SequenceBatch(dt, _t(lengths)), pooling)
    (got * _t(w)).sum().backward()
    _close(got.detach(), want, rtol=EXACT, atol=EXACT)
    _close(dt.grad, want_g, rtol=EXACT, atol=EXACT)
    if pooling in ("max", "avg", "sum", "sqrt"):
        assert not got[1].any()              # empty sequence pools to 0


@pytest.mark.parametrize("act", [None, "tanh", "relu"])
def test_fc_matches_jax(np_rng, act):
    x, w = np_rng.randn(3, 5, 8).astype(np.float32), \
        np_rng.randn(8, 4).astype(np.float32)
    b = np_rng.randn(4).astype(np.float32)
    want = jax_linear.fc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act)
    _close(linear.fc(_t(x), _t(w), _t(b), act), want, rtol=1e-5, atol=1e-5)
    _close(linear.fc(_t(x), _t(w)), jax_linear.fc(jnp.asarray(x),
                                                  jnp.asarray(w)),
           rtol=1e-5, atol=1e-5)


def test_sequence_batch_and_pad_sequences_match_jax():
    seqs = [np.asarray([1, 2, 3]), np.asarray([4]), np.asarray([], np.int64),
            np.asarray([5, 6, 7, 8, 9])]
    for max_len in (None, 4):
        want = jax_sequence.pad_sequences(seqs, max_len=max_len, pad_value=-1)
        got = sequence.pad_sequences(seqs, max_len=max_len, pad_value=-1,
                                     device="cpu")
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        np.testing.assert_array_equal(got.mask().numpy(),
                                      np.asarray(want.mask()))
        np.testing.assert_array_equal(got.bool_mask().numpy(),
                                      np.asarray(want.bool_mask()))
    assert (got.batch_size, got.max_len) == (4, 4)
    assert got.with_data(got.data * 2).lengths is got.lengths


def test_tree_helpers_follow_jax_order():
    tree = {"b": [np.float32(1), {"z": np.float32(2), "a": np.float32(3)}],
            "a": np.float32(4)}
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    summed = tree_map(lambda x, y: x + y, tree, tree)
    assert tree_leaves(summed) == [2 * x for x in tree_leaves(tree)]


def test_initializers_follow_the_jax_std_rules():
    gen = torch.Generator().manual_seed(0)
    w = initializers.normal()(gen, (400, 300))
    assert abs(float(w.std()) - 1 / 20) < 1e-3 and w.dtype == torch.float32
    u = initializers.uniform(0.1)(gen, (1000,))
    assert float(u.abs().max()) <= 0.1 and float(u.abs().max()) > 0.09
    assert float(initializers.uniform()(gen, (100, 2)).abs().max()) <= 0.1
    assert not initializers.constant(0.0)(gen, (3,)).any()
    assert float(initializers.normal(std=2.0, mean=5.0)(gen, (4000,)).mean()) \
        == pytest.approx(5.0, abs=0.2)


def test_schedules_constant_only():
    assert schedules.get(None, 0.1)(7) == pytest.approx(0.1)
    assert schedules.get("constant", 0.5)(0) == pytest.approx(0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        schedules.get("poly", 0.1)
    with pytest.raises(KeyError, match="bogus"):
        schedules.get("bogus", 0.1)


@pytest.mark.parametrize("cfg", [
    dict(), dict(nesterov=True), dict(clip_norm=0.5, l2=1e-2),
    dict(clip_threshold=0.3, l1=1e-3)], ids=["plain", "nesterov",
                                             "clipnorm_l2", "clipval_l1"])
def test_momentum_matches_jax_over_three_updates(np_rng, cfg):
    params = {"w": np_rng.randn(4, 3).astype(np.float32),
              "l0": {"b": np_rng.randn(5).astype(np.float32)}}
    grads = [tree_map(lambda p: np_rng.randn(*p.shape).astype(np.float32),
                      params) for _ in range(3)]
    jopt = jax_optim.Momentum(learning_rate=0.1, momentum=0.9, **cfg)
    jp = tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    opt = Momentum(learning_rate=0.1, momentum=0.9, **cfg)
    tp = tree_map(lambda a: torch.tensor(a), params)
    ts = opt.init(tp)
    for g in grads:
        jp, js = jopt.update(tree_map(jnp.asarray, g), js, jp)
        tp2, ts2 = opt.update(tree_map(torch.tensor, g), ts, tp)
        assert tp2 is tp and ts2 is ts       # updated in place
    assert ts["step"] == 3 and int(js["step"]) == 3
    for got, want in zip(tree_leaves(tp) + tree_leaves(ts["slots"]["mom"]),
                         jax.tree_util.tree_leaves(jp)
                         + jax.tree_util.tree_leaves(js["slots"]["mom"])):
        _close(got, want, rtol=1e-5, atol=1e-6)


def _jax_text_lstm(hidden, vocab, emb):
    jp = jax_text_lstm.init(jax.random.PRNGKey(0), vocab=vocab, emb_dim=emb,
                            hidden=hidden, num_layers=2)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def test_text_lstm_loss_and_grads_match_jax(np_rng):
    hidden, vocab, emb, b, t = 128, 50, 16, 8, 12
    jp, tree = _jax_text_lstm(hidden, vocab, emb)
    ids = np_rng.randint(0, vocab, (b, t)).astype(np.int32)
    ids[1, 3] = -1                           # an out-of-range id: a zero row
    lengths = np.asarray([12, 5, 0, 9, 1, 12, 7, 3], np.int32)
    labels = np_rng.randint(0, 2, (b,)).astype(np.int32)
    jids = jax_sequence.SequenceBatch(jnp.asarray(ids), jnp.asarray(lengths))
    want, want_g = jax.value_and_grad(jax_text_lstm.loss)(
        jp, jids, jnp.asarray(labels), 2, hidden)
    params = text_lstm.params_from_numpy(tree, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = text_lstm.loss(params, sequence.SequenceBatch(_t(ids), _t(lengths)),
                          _t(labels), 2, hidden)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for (path, w), got in zip(
            jax.tree_util.tree_flatten_with_path(want_g)[0],
            tree_leaves(params)):
        _close(got.grad, w, what=jax.tree_util.keystr(path))


def test_text_lstm_params_from_numpy_keys_and_layout():
    _, tree = _jax_text_lstm(128, 20, 8)
    params = text_lstm.params_from_numpy(tree, device="cpu")
    assert set(params) == {"emb", "l0", "l1", "out"}
    assert params["l0"]["b"].shape == (7 * 128,)
    np.testing.assert_array_equal(params["l1"]["w_r"].numpy(),
                                  tree["l1"]["w_r"])
    with pytest.raises(ValueError, match="text_lstm"):
        text_lstm.params_from_numpy(dict(tree, extra=tree["out"]),
                                    device="cpu")
    init = text_lstm.init(torch.Generator().manual_seed(0), vocab=20,
                          emb_dim=8, hidden=128, device="cpu")
    assert tree_map(lambda x: tuple(x.shape), init) \
        == tree_map(lambda x: tuple(x.shape), tree)


def test_bench_step_matches_jax_bench_step_over_three_steps():
    """The port's bench_lstm train step (autograd + in-place Momentum)
    against bench.py:335-340's jitted, donating JAX step, from the same
    initial params and batch, leaf by leaf."""
    hidden = 128
    port = bench.bench_lstm(batch=8, seq_len=12, hidden=hidden, vocab=50,
                            device="cpu")
    jp = tree_map(lambda x: jnp.asarray(x.detach().numpy().copy()),
                  port.params)
    opt = jax_optim.Momentum(learning_rate=0.01, momentum=0.9)
    js = opt.init(jp)
    jids = jax_sequence.SequenceBatch(jnp.asarray(port.ids.data.numpy()),
                                      jnp.asarray(port.ids.lengths.numpy()))
    jlabels = jnp.asarray(port.labels.numpy())

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, ids, labels):
        loss, grads = jax.value_and_grad(jax_text_lstm.loss)(
            params, ids, labels, 2, hidden)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss

    for _ in range(3):
        jp, js, jloss = step(jp, js, jids, jlabels)
        loss = port.train_step()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for got, want in zip(tree_leaves(port.params)
                         + tree_leaves(port.opt_state["slots"]["mom"]),
                         jax.tree_util.tree_leaves(jp)
                         + jax.tree_util.tree_leaves(js["slots"]["mom"])):
        got, want = got.detach().numpy(), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        text_lstm.init(torch.Generator().manual_seed(0), vocab=10,
                       emb_dim=4, hidden=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench_lstm(batch=2, seq_len=3, hidden=128, vocab=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sequence.pad_sequences([np.asarray([1])])
