"""The sparse-update embedding path (``paddle_tpu_torch/ops/sparse.py``
and ``trainer.SGD``'s sparse step) against the JAX package's, on the
CPU.

The same DSL graph is built in both packages (``tests/test_sparse.py``'s:
ids -> a sparse embedding -> sum pooling -> fc softmax), JAX's init
carried across, and the same host batches stepped through both
trainers: every parameter and every optimizer slot, the untouched rows
included, within 1e-5 of each leaf's largest entry after three steps;
losses to 1e-5 relative; uids and inv bit for bit (AdaGrad's and
Adam's parameters step by step where the step is well conditioned, as
``tests/test_torch_word2vec_seqtoseq.py`` holds them).  The JAX trainers
run once per module (one trace each: every batch has one shape).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.data import integer_value as j_integer_value
from paddle_tpu.data import integer_value_sequence as j_integer_value_seq
from paddle_tpu.layers.graph import reset_names as j_reset_names
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.ops import sparse as jax_sparse
from paddle_tpu.trainer import SGD as JaxSGD
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.data import DataFeeder, integer_value, \
    integer_value_sequence
from paddle_tpu_torch.models import text_rnn
from paddle_tpu_torch.ops import sparse as sparse_ops
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves

V, D, B, T = 40, 8, 6, 5
TOL = 1e-5
host = functools.partial(jax.tree_util.tree_map, np.asarray)


def _reset(M):
    (j_reset_names if M is JL else L.reset_names)()


def _model(M, sparse, budget=None, vocab=V):
    _reset(M)
    w = M.data_layer("w", size=vocab, is_seq=True)
    emb = M.embedding_layer(w, size=D, sparse_update=sparse,
                            sparse_budget=budget,
                            param_attr={"initial_std": 0.1, "name": "emb"})
    out = M.fc_layer(M.pooling_layer(emb, pooling_type="sum"), size=2,
                     act="softmax", param_attr={"initial_std": 0.1})
    return M.classification_cost(input=out, label=M.data_layer("lab", 1))


def _feeding(jax_side, vocab=V):
    if jax_side:
        return {"w": j_integer_value_seq(vocab), "lab": j_integer_value(2)}
    return {"w": integer_value_sequence(vocab), "lab": integer_value(2)}


def _batches(seed, n=3, vocab=V, b=B, t=T):
    """n batches of b samples, each batch's first sample t ids long (one
    padded shape for the jitted JAX step)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = [t] + list(rng.randint(2, t + 1, b - 1))
        out.append([(rng.randint(0, vocab, n_).tolist(), int(rng.randint(2)))
                    for n_ in lens])
    return out


def _assert_tree(got, want, what, tol=TOL):
    """Every leaf of the port's tree within ``tol`` of the largest entry
    of JAX's leaf."""
    got = [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
           else np.asarray(t) for t in tree_leaves(got)]
    want = jax.tree_util.tree_leaves(host(want))
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, what


def _opt(name, clip):
    kw = {"clip_norm": 0.05, "clip_threshold": 0.02} if clip else {}
    return {"momentum": lambda M: M.Momentum(learning_rate=0.1,
                                             momentum=0.9, **kw),
            "adagrad": lambda M: M.AdaGrad(learning_rate=0.1, **kw),
            "adam": lambda M: M.Adam(learning_rate=0.05, **kw)}[name]


# ------------------------------------------------------------------- ops

def test_unique_touched_gather_scatter_match_jax():
    ids = np.asarray([[9, 3, 7, 3], [1, 9, 5, 0]], np.int32)
    unique = jax.jit(jax_sparse.unique_touched, static_argnums=(1, 2))
    for budget in (8, 4):               # 4: truncated, JAX keeps the first
        ju, ji = unique(jnp.asarray(ids), budget, 100)
        tu, ti = sparse_ops.unique_touched(torch.tensor(ids), budget, 100)
        assert tu.dtype == ti.dtype == torch.int32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    table = np.arange(100 * 2, dtype=np.float32).reshape(100, 2)
    tu, ti, n = sparse_ops.unique_touched(torch.tensor(ids), 8, 100,
                                          with_count=True)
    assert n == 6
    rows = sparse_ops.gather_rows(torch.tensor(table), tu)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(
        jax_sparse.gather_rows(jnp.asarray(table), jnp.asarray(tu.numpy()))))
    np.testing.assert_array_equal(rows[ti.long()].numpy(), table[ids])
    assert [sparse_ops.default_row_budget(n) for n in (1, 2, 3, 9, 64)] \
        == [jax_sparse.default_row_budget(n) for n in (1, 2, 3, 9, 64)] \
        == [1, 2, 4, 16, 64]


def test_scatter_drops_fill_slots_with_last_row_touched():
    """V - 1 is a touched id and the fill slots gather it too: only the
    valid prefix is written back, so the fill slots' (different) rows
    never reach it, as JAX's mode="drop" throws them away."""
    vocab = 10
    ids = np.asarray([2, 9, 5, 9], np.int32)
    ju, _ = jax.jit(jax_sparse.unique_touched, static_argnums=(1, 2))(
        jnp.asarray(ids), 8, vocab)
    tu, _, n = sparse_ops.unique_touched(torch.tensor(ids), 8, vocab,
                                         with_count=True)
    new = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + 1
    want = jax_sparse.scatter_rows(jnp.zeros((vocab, 3)), ju,
                                   jnp.asarray(new))
    got = sparse_ops.scatter_rows(torch.zeros(vocab, 3), tu,
                                  torch.tensor(new), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the count read from uids when it is not given
    got2 = sparse_ops.scatter_rows(torch.zeros(vocab, 3), tu,
                                   torch.tensor(new))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want))
    assert got[9].tolist() == new[2].tolist()


# ------------------------------------------------------- trainer parity

@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sparse trainer over three batches for each (optimizer,
    clip) case: its losses, its (params, opt state) before the first
    step and after each, and the trainer itself (for the checkpoint
    tests)."""
    batches = _batches(0)
    runs = {}
    for name in ("momentum", "adagrad", "adam"):
        for clip in (False, True):
            tr = JaxSGD(_model(JL, True), update_equation=_opt(name, clip)(
                jax_optim), seed=3, donate=False)
            states = [(host(tr.parameters), host(tr.opt_state))]
            losses = []
            for b in batches:
                losses.append(float(tr.train_one_batch(
                    b, feeder=_feeding(True))))
                states.append((host(tr.parameters), host(tr.opt_state)))
            runs[name, clip] = (losses, states, tr)
    return batches, runs


def _port_run(start, opt, batches, sparse=True, model=None):
    tr = SGD(model or _model(L, sparse), parameters=start,
             update_equation=opt, device="cpu")
    feeder = DataFeeder(_feeding(False), device="cpu")
    losses = [float(tr.train_one_batch(b, feeder)) for b in batches]
    return tr, losses


def _conditioned(tree, slots, key):
    """For each leaf of ``tree``, its entries where sqrt(slot) is at
    least 1e-2 of the leaf's largest sqrt(slot): AdaGrad's and Adam's
    steps are g / sqrt(slot), so where a gradient sums to ~1e-6 out of
    cancelling terms its float32 rounding (XLA's order against
    torch's) moves the step by O(lr)."""
    out = []
    for leaf, slot in zip(jax.tree_util.tree_leaves(host(tree)),
                          jax.tree_util.tree_leaves(host(slots[key]))):
        root = np.sqrt(slot)
        out.append(root >= 1e-2 * root.max())
    return out


@pytest.mark.parametrize("clip", [False, True], ids=["plain", "clipped"])
@pytest.mark.parametrize("name", ["momentum", "adagrad", "adam"])
def test_sparse_steps_match_jax(jax_runs, name, clip):
    """Momentum: three steps from JAX's init, every leaf.  AdaGrad and
    Adam: each of the three steps from JAX's state before it (the
    trainer's leaves and state replaced), the slots whole and the
    parameters where the step is well conditioned (``_conditioned``)."""
    batches, runs = jax_runs
    losses, states, _ = runs[name, clip]
    opt = _opt(name, clip)(optim)
    tr = SGD(_model(L, True), parameters=states[0][0], update_equation=opt,
             device="cpu")
    feeder = DataFeeder(_feeding(False), device="cpu")
    assert set(tr.opt_state) == {"dense", "sparse"}
    for i, b in enumerate(batches):
        if name != "momentum":
            tr.parameters = L.params_from_numpy(tr.topology, states[i][0],
                                                "cpu")
            tr._track()
            tr.opt_state = tr._opt_on(states[i][1])
        got = float(tr.train_one_batch(b, feeder))
        assert got == pytest.approx(losses[i], rel=1e-5)
        params, opt_state = states[i + 1]
        assert not any(p.requires_grad
                       for p in tree_leaves(tr.parameters["emb"]))
        assert tr.opt_state["dense"]["step"] == int(
            opt_state["dense"]["step"])
        _assert_tree(tr.opt_state["dense"]["slots"],
                     opt_state["dense"]["slots"], f"{name} dense slots")
        _assert_tree(tr.opt_state["sparse"], opt_state["sparse"],
                     f"{name} sparse slots")
        if name == "momentum":
            continue
        slot = {"adagrad": "accum", "adam": "v"}[name]
        masks = _conditioned(
            {k: v for k, v in params.items() if k != "emb"},
            opt_state["dense"]["slots"], slot) \
            + _conditioned({"emb": params["emb"]}, opt_state["sparse"]["emb"],
                           slot)
        got_leaves = [t.detach().numpy() for t in tree_leaves(
            {k: v for k, v in tr.parameters.items() if k != "emb"})] \
            + [t.detach().numpy() for t in tree_leaves(tr.parameters["emb"])]
        want_leaves = jax.tree_util.tree_leaves(
            {k: v for k, v in params.items() if k != "emb"}) \
            + jax.tree_util.tree_leaves(params["emb"])
        for g, w, m in zip(got_leaves, want_leaves, masks):
            assert m.any()
            scale = float(np.abs(w).max())
            assert float(np.abs(g - w)[m].max()) <= TOL * scale, name
    if name == "momentum":
        _assert_tree(tr.parameters, states[-1][0], f"{name} params")


def test_sparse_checkpoints_cross_both_ways(jax_runs, tmp_path):
    """A sparse run saved by JAX resumes in the port and the reverse:
    one more step from either checkpoint equals the other package's."""
    batches, runs = jax_runs
    jt = runs["momentum", True][2]
    opt = _opt("momentum", True)
    jt.save(str(tmp_path / "jax"), pass_id=0, block=True)
    port = SGD(_model(L, True), update_equation=opt(optim), device="cpu")
    port.load(str(tmp_path / "jax"))
    feeder = DataFeeder(_feeding(False), device="cpu")
    got = float(port.train_one_batch(batches[1], feeder))
    want = float(jt.train_one_batch(batches[1], feeder=_feeding(True)))
    assert got == pytest.approx(want, rel=1e-5)
    _assert_tree(port.parameters, jt.parameters, "JAX -> port params")
    _assert_tree(port.opt_state, jt.opt_state, "JAX -> port opt state")
    # the reverse: the port's state, written by the port, into JAX
    port.save(str(tmp_path / "port"), pass_id=1, block=True)
    jt.load(str(tmp_path / "port"))
    want = float(jt.train_one_batch(batches[2], feeder=_feeding(True)))
    got = float(port.train_one_batch(batches[2], feeder))
    assert got == pytest.approx(want, rel=1e-5)
    _assert_tree(port.parameters, jt.parameters, "port -> JAX params")
    _assert_tree(port.opt_state, jt.opt_state, "port -> JAX opt state")


# ------------------------------------------------------ sparse vs dense

def _start():
    return {k: {n: t.detach().numpy().copy() for n, t in v.items()}
            for k, v in SGD(_model(L, False), update_equation=optim.Momentum(),
                            device="cpu").parameters.items()}


@pytest.mark.parametrize("opt", [
    lambda: optim.Momentum(learning_rate=0.1, momentum=0.0),
    lambda: optim.AdaGrad(learning_rate=0.1)], ids=["sgd", "adagrad"])
def test_sparse_equals_dense_for_row_local_rules(opt):
    """Plain SGD and AdaGrad: an untouched row's gradient is zero and
    its update too, so the sparse path equals the dense one."""
    start, batches = _start(), _batches(1)
    dense, _ = _port_run(start, opt(), batches, sparse=False)
    sparse, _ = _port_run(start, opt(), batches, sparse=True)
    for a, b in zip(tree_leaves(dense.parameters),
                    tree_leaves(sparse.parameters)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_sparse_momentum_equals_dense_when_every_row_is_touched():
    start = _start()
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(3):
        perm = rng.permutation(V).tolist()
        batches.append([(perm[i::B], i % 2) for i in range(B)])
    opt = lambda: optim.Momentum(learning_rate=0.1, momentum=0.9)  # noqa
    dense, _ = _port_run(start, opt(), batches, sparse=False)
    sparse, _ = _port_run(start, opt(), batches, sparse=True)
    np.testing.assert_allclose(dense.parameters["emb"]["w"].detach().numpy(),
                               sparse.parameters["emb"]["w"].detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_sparse_momentum_catch_up_differs_from_dense():
    """A row touched at step 1 and not at step 2 keeps its step-1 value
    under the sparse path; dense momentum moves it on."""
    start = _start()
    step1 = [([1, 2, 3], 0), ([4, 5], 1)]
    step2 = [([10, 11, 12], 0), ([13, 14], 1)]
    opt = lambda: optim.Momentum(learning_rate=0.1, momentum=0.9)  # noqa
    after1, _ = _port_run(start, opt(), [step1], sparse=True)
    sparse, _ = _port_run(start, opt(), [step1, step2], sparse=True)
    dense, _ = _port_run(start, opt(), [step1, step2], sparse=False)
    rows = [1, 2, 3, 4, 5]
    w1 = after1.parameters["emb"]["w"].detach()[rows]
    np.testing.assert_array_equal(
        sparse.parameters["emb"]["w"].detach()[rows].numpy(), w1.numpy())
    moved = (dense.parameters["emb"]["w"].detach()[rows] - w1).abs()
    assert bool((moved > 1e-6).all())


def test_sparse_budget_truncates_as_jax():
    """sparse_budget below the batch's distinct ids: both packages keep
    the smallest ids' rows and lose the rest of the batch's rows."""
    batch = [([0, 1, 2, 3, 4], 0), ([5, 6, 7, 8, 9], 1)]
    jt = JaxSGD(_model(JL, True, budget=4),
                update_equation=jax_optim.Momentum(learning_rate=1.0,
                                                   momentum=0.0),
                seed=3, donate=False)
    start = host(jt.parameters)
    want = float(jt.train_one_batch(batch, feeder=_feeding(True)))
    tr, got = _port_run(start, optim.Momentum(learning_rate=1.0,
                                              momentum=0.0), [batch],
                        model=_model(L, True, budget=4))
    assert got[0] == pytest.approx(want, rel=1e-5)
    _assert_tree(tr.parameters, jt.parameters, "truncated budget")
    moved = (tr.parameters["emb"]["w"].detach().numpy()
             != start["emb"]["w"]).any(axis=1)
    assert moved[:4].all() and not moved[4:].any()


# ------------------------------------------- ids outside the vocabulary

def _padded_feeds(pad, seed=4, n=2):
    """n (port feed, JAX feed) pairs of B rows whose padding holds
    ``pad`` and whose first valid position in every other row holds it
    too: ids drawn from [1, V - 1), so rows 0 and V - 1 are never
    touched."""
    from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
    from paddle_tpu_torch.core.sequence import SequenceBatch
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = np.asarray([T] + list(rng.randint(1, T + 1, B - 1)), np.int32)
        ids = rng.randint(1, V - 1, (B, T)).astype(np.int32)
        ids[np.arange(T)[None, :] >= lens[:, None]] = pad
        ids[::2, 0] = pad
        lab = rng.randint(0, 2, B).astype(np.int32)
        out.append(({"w": SequenceBatch(torch.tensor(ids), torch.tensor(lens)),
                     "lab": torch.tensor(lab)},
                    {"w": JaxSeq(jnp.asarray(ids), jnp.asarray(lens)),
                     "lab": lab}))
    return out


def _feed_steps(model, start, opt, feeds):
    tr = SGD(model, parameters=start, update_equation=opt, device="cpu")
    losses = [float(tr.train_one_batch(f)) for f in feeds]
    return tr, losses


@pytest.mark.parametrize("pad", [-1, V], ids=["minus1", "vocab"])
@pytest.mark.parametrize("opt", [
    lambda M: M.Momentum(learning_rate=0.1, momentum=0.0),
    lambda M: M.AdaGrad(learning_rate=0.1)], ids=["sgd", "adagrad"])
def test_sparse_equals_dense_on_out_of_range_ids(opt, pad):
    """ROADMAP C17: ids -1 or V (at padding and at valid positions) read
    zero rows on the dense path; the sparse step runs on such feeds,
    equals the port's dense step and JAX's dense step under a row-local
    rule, and writes no row the batches did not touch."""
    feeds = _padded_feeds(pad)
    jt = JaxSGD(_model(JL, False), update_equation=opt(jax_optim), seed=3,
                donate=False)
    start = host(jt.parameters)
    want = [float(jt.train_one_batch(f[1])) for f in feeds]
    dense, dense_losses = _feed_steps(_model(L, False), start, opt(optim),
                                      [f[0] for f in feeds])
    sparse, sparse_losses = _feed_steps(_model(L, True), start, opt(optim),
                                        [f[0] for f in feeds])
    np.testing.assert_allclose(dense_losses, want, rtol=TOL)
    np.testing.assert_allclose(sparse_losses, want, rtol=TOL)
    _assert_tree(dense.parameters, jt.parameters, "port dense vs JAX dense")
    _assert_tree(sparse.parameters, jt.parameters, "port sparse vs JAX dense")
    touched = set()
    for f in feeds:
        w = f[0]["w"]
        touched |= set(w.data[w.bool_mask()].tolist())
    untouched = sorted(set(range(V)) - touched)
    assert 0 in untouched and V - 1 in untouched
    np.testing.assert_array_equal(
        sparse.parameters["emb"]["w"].detach().numpy()[untouched],
        start["emb"]["w"][untouched])


def test_sparse_momentum_moves_only_in_range_rows():
    """Momentum with its catch-up rule on a -1- and V-padded feed: the
    rows the step moves are exactly the in-range ids of the batch."""
    feed = _padded_feeds(-1, seed=6, n=1)[0][0]
    w = feed["w"].data.clone()
    w[1, -1] = V
    feed["w"] = feed["w"].with_data(w)
    start = _start()
    tr, _ = _feed_steps(_model(L, True), start,
                        optim.Momentum(learning_rate=0.1, momentum=0.9),
                        [feed])
    moved = np.nonzero((tr.parameters["emb"]["w"].detach().numpy()
                        != start["emb"]["w"]).any(axis=1))[0]
    ids = w[(w >= 0) & (w < V)]
    assert moved.tolist() == sorted(set(ids.tolist()))


def test_jax_sparse_step_wraps_negative_ids():
    """ROADMAP C19: JAX's sparse step keeps -1 as a touched id; its
    ``gather_rows`` clips it to row 0 and ``.at[-1].set(mode="drop")``
    wraps it into row V - 1, so a row the batch never touched is
    written (JAX's dense step leaves it).  The port touches no row for
    it (test_sparse_equals_dense_on_out_of_range_ids)."""
    feeds = [f[1] for f in _padded_feeds(-1, n=1)]
    opt = lambda: jax_optim.Momentum(learning_rate=1.0,  # noqa: E731
                                     momentum=0.0)
    js = JaxSGD(_model(JL, True), update_equation=opt(), seed=3,
                donate=False)
    start = host(js.parameters)["emb"]["w"]
    js.train_one_batch(feeds[0])
    jd = JaxSGD(_model(JL, False), update_equation=opt(), seed=3,
                donate=False)
    jd.train_one_batch(feeds[0])
    assert (np.asarray(js.parameters["emb"]["w"])[V - 1]
            != start[V - 1]).any()
    np.testing.assert_array_equal(np.asarray(jd.parameters["emb"]["w"])[V - 1],
                                  start[V - 1])


# -------------------------------------------------------------- refusals

def _refusal(case, M):
    _reset(M)
    w = M.data_layer("w", size=V, is_seq=True)
    lab = M.data_layer("lab", 1)
    kw = {}
    attr = {"name": "emb"}
    if case == "not_data":
        emb = M.embedding_layer(M.fc_layer(w, size=1, act=None), size=D,
                                sparse_update=True)
    elif case == "other_consumer":
        emb = M.addto_layer([
            M.embedding_layer(w, size=D, sparse_update=True,
                              param_attr=attr),
            M.embedding_layer(w, size=D, param_attr={"name": "other"})])
    elif case == "shared":
        w2 = M.data_layer("w2", size=V, is_seq=True)
        emb = M.addto_layer([
            M.embedding_layer(w, size=D, sparse_update=True, param_attr=attr),
            M.embedding_layer(w2, size=D, param_attr=attr)])
    else:
        if case == "pruned":
            attr = {"name": "emb", "update_hooks": [
                {"type": "pruning", "sparsity_ratio": 0.5}]}
        kw = {"grad_accum": {"grad_accum_steps": 2},
              "quant": {"quant_weights": True}}.get(case, {})
        emb = M.embedding_layer(w, size=D, sparse_update=True,
                                param_attr=attr)
    out = M.fc_layer(M.pooling_layer(emb, pooling_type="sum"), size=2,
                     act="softmax")
    return M.classification_cost(out, lab), kw


@pytest.mark.parametrize("case,match", [
    ("not_data", "needs a data layer input"),
    ("other_consumer", "also feeds"),
    ("shared", "is shared with layer"),
    ("pruned", "can't be statically pruned"),
    ("grad_accum", "grad_accum_steps > 1 is unsupported"),
    ("quant", "quant_weights=True is unsupported with sparse_update")])
def test_sparse_refusals_match_jax(case, match):
    cost, kw = _refusal(case, JL)
    with pytest.raises(JaxConfigError, match=match):
        JaxSGD(cost, update_equation=jax_optim.Momentum(), **kw)
    cost, kw = _refusal(case, L)
    with pytest.raises(ConfigError, match=match):
        SGD(cost, update_equation=optim.Momentum(), device="cpu", **kw)


# -------------------------------------------------- text_rnn's LSTM, B9

def _text_rnn_jax(vocab, hidden):
    """models/text_rnn.build(cell="lstm", sparse_update=True) in JAX's
    DSL."""
    j_reset_names()
    word = JL.data_layer("word", vocab, is_seq=True)
    label = JL.data_layer("label", 1)
    x = JL.embedding_layer(word, size=text_rnn.EMB, sparse_update=True)
    for _ in range(text_rnn.LAYERS):
        x = JL.lstmemory(JL.fc_layer(x, size=4 * hidden, act=None,
                                     bias_attr=False))
    out = JL.fc_layer(JL.pooling_layer(x, pooling_type=JL.pooling.Max),
                      size=text_rnn.CLASSES, act="softmax")
    return JL.classification_cost(out, label)


def test_text_rnn_lstm_sparse_steps_match_jax():
    """Two steps of text_rnn's LSTM config with a sparse embedding at
    vocab 500, hidden 128, batch 8: JAX runs B9 (the fused route forced,
    Pallas in interpret mode), the port its plain version."""
    vocab, hidden, batch, seq = 500, 128, 8, 5
    batches = list(text_rnn.batches(4, 2, batch=batch, seq_len=seq,
                                    vocab=vocab)())
    jt = JaxSGD(_text_rnn_jax(vocab, hidden),
                update_equation=jax_optim.Momentum(learning_rate=0.01,
                                                   momentum=0.9),
                seed=3, donate=False)
    start = host(jt.parameters)
    prior, count = jax_rnn.FUSED_LSTM, jax_rnn.FUSED_DISPATCH_COUNT
    jax_rnn.FUSED_LSTM = "always"
    try:
        want = [float(jt.train_one_batch(
            b, feeder={"word": j_integer_value_seq(vocab),
                       "label": j_integer_value(2)})) for b in batches]
    finally:
        jax_rnn.FUSED_LSTM = prior
    assert jax_rnn.FUSED_DISPATCH_COUNT - count == 2
    tr = SGD(text_rnn.build(vocab=vocab, hidden=hidden, cell="lstm",
                            sparse_update=True), parameters=start,
             update_equation=text_rnn.optimizer(), device="cpu")
    feeder = DataFeeder(text_rnn.feeding(vocab), device="cpu")
    got = [float(tr.train_one_batch(b, feeder)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_tree(tr.parameters, jt.parameters, "text_rnn params")
    _assert_tree(tr.opt_state, jt.opt_state, "text_rnn opt state")


def test_jax_sparse_step_skips_pruning_masks():
    """ROADMAP C16: JAX's sparse step applies no pruning mask to the
    dense gradients (its dense step does), so a pruned fc beside a
    sparse embedding regrows its pruned weights there; the port masks
    them on both paths, as the reference's hook does every step."""
    def build(M):
        _reset(M)
        w = M.data_layer("w", size=V, is_seq=True)
        emb = M.embedding_layer(w, size=D, sparse_update=True,
                                param_attr={"name": "emb"})
        out = M.fc_layer(M.pooling_layer(emb, pooling_type="sum"), size=2,
                         act="softmax", param_attr={"update_hooks": [
                             {"type": "pruning", "sparsity_ratio": 0.5}]})
        return M.classification_cost(out, M.data_layer("lab", 1))
    batch = _batches(5, n=1)[0]
    jt = JaxSGD(build(JL), update_equation=jax_optim.Momentum(
        learning_rate=0.1, momentum=0.0), seed=3, donate=False)
    pruned = np.asarray(jt.parameters["__fc_0__"]["w0"]) == 0
    assert pruned.sum() == pruned.size // 2
    jt.train_one_batch(batch, feeder=_feeding(True))
    assert np.asarray(jt.parameters["__fc_0__"]["w0"])[pruned].any()
    tr = SGD(build(L), update_equation=optim.Momentum(learning_rate=0.1,
                                                       momentum=0.0),
             device="cpu")
    mask = tr.parameters["__fc_0__"]["w0"].detach() == 0
    tr.train_one_batch(batch, DataFeeder(_feeding(False), device="cpu"))
    assert int(mask.sum()) == pruned.size // 2
    assert not tr.parameters["__fc_0__"]["w0"].detach()[mask].any()
