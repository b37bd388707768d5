"""Nested sequences (``core/sequence.NestedSequenceBatch``, the feeder's
sub-sequence slots, ``ops/sequence.nested_seq_pool`` and
``agg_level="seq"`` pooling) against the JAX package's, on the CPU.

Inputs are drawn from a numpy seed, with empty sub-sequences and
samples holding fewer sub-sequences than the batch's widest.  Ids and
lengths bit for bit; pooled values and gradients within 1e-5 of each
one's largest entry; the nested graph of ``models/text_dsl``'s
``nested_lstm_net`` (sentences averaged, an LSTM over them) at batch 8,
hidden 128: its cost and every parameter gradient, JAX's side under
``jax.jit``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.core import sequence as jseq
from paddle_tpu.data import DataFeeder as JaxFeeder
from paddle_tpu.data import dense_vector as j_dense_vector
from paddle_tpu.data import integer_value as j_integer_value
from paddle_tpu.data import integer_value_sub_sequence as j_int_sub
from paddle_tpu.data.provider import SeqType as JSeqType
from paddle_tpu.layers.graph import reset_names as j_reset_names
from paddle_tpu.ops import sequence as jseq_ops
from paddle_tpu.trainer import SGD as JaxSGD
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.core import sequence as tseq
from paddle_tpu_torch.data import DataFeeder, dense_vector, integer_value, \
    integer_value_sub_sequence
from paddle_tpu_torch.data.provider import SeqType
from paddle_tpu_torch.models import text_dsl
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.error import ConfigError

V, B, HID, TOL = 60, 8, 128, 1e-5
POOLINGS = ("max", "avg", "sum", "sqrt", "last", "first")


def _nested_ids(seed, b=B, vocab=V, max_subs=4, max_len=5):
    """b samples of 1..max_subs sub-sequences of 0..max_len ids (empty
    ones included; the first sample the widest)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(b):
        n = max_subs if i == 0 else rng.randint(1, max_subs + 1)
        subs = [rng.randint(0, vocab, rng.randint(0, max_len + 1)).tolist()
                for _ in range(n)]
        if i == 0:
            subs[0] = rng.randint(0, vocab, max_len).tolist()
        out.append(subs)
    out[1][0] = []                          # an empty first sub-sequence
    return out


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


# ---------------------------------------------------------------- batches

def test_pad_nested_sequences_and_masks_match_jax():
    seqs = _nested_ids(0)
    for kw in ({}, {"max_outer": 3, "max_inner": 4}, {"max_outer": 6}):
        want = jseq.pad_nested_sequences(seqs, **kw)
        got = tseq.pad_nested_sequences(seqs, device="cpu", **kw)
        for g, w in zip(got, want):
            assert g.dtype in (torch.int32, torch.int64)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got.outer_lengths.dtype == got.inner_lengths.dtype \
            == torch.int32
        jmasks = jax.jit(lambda n: (n.outer_mask(), n.inner_mask(),
                                    n.flatten_outer()))(want)
        for fn, jm in zip(("outer_mask", "inner_mask"), jmasks):
            np.testing.assert_array_equal(getattr(got, fn)().numpy(),
                                          np.asarray(jm))
        flat, jflat = got.flatten_outer(), jmasks[2]
        np.testing.assert_array_equal(flat.data.numpy(),
                                      np.asarray(jflat.data))
        np.testing.assert_array_equal(flat.lengths.numpy(),
                                      np.asarray(jflat.lengths))
    lengths = np.random.RandomState(1).randint(1, 200, 500)
    assert tseq.bucket_boundaries(lengths) == jseq.bucket_boundaries(lengths)
    assert tseq.bucket_boundaries(lengths, 3, 16) \
        == jseq.bucket_boundaries(lengths, 3, 16)


def test_feeder_sub_sequence_slots_match_jax():
    rng = np.random.RandomState(2)
    ids = _nested_ids(3)
    dense = [[rng.randn(len(s) or 1, 3).astype(np.float32).tolist()
              for s in sample] for sample in ids]
    batch = [(i, d, int(rng.randint(2))) for i, d in zip(ids, dense)]
    jfeed = JaxFeeder({"w": j_int_sub(V),
                       "x": j_dense_vector(3, JSeqType.SUB_SEQUENCE),
                       "lab": j_integer_value(2)})(batch)
    feed = DataFeeder({"w": integer_value_sub_sequence(V),
                       "x": dense_vector(3, SeqType.SUB_SEQUENCE),
                       "lab": integer_value(2)}, device="cpu")(batch)
    for name in ("w", "x"):
        assert isinstance(feed[name], tseq.NestedSequenceBatch)
        for g, w in zip(feed[name], jfeed[name]):
            assert g.dtype == {np.dtype("int32"): torch.int32,
                               np.dtype("float32"): torch.float32}[
                                   np.asarray(w).dtype]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(feed["lab"].numpy(),
                                  np.asarray(jfeed["lab"]))


# ---------------------------------------------------------------- pooling

@pytest.fixture(scope="module")
def pooled_input():
    seqs = _nested_ids(4)
    ids = jseq.pad_nested_sequences(seqs)
    rng = np.random.RandomState(5)
    data = rng.randn(*np.shape(ids.data), 3).astype(np.float32)
    cot = rng.randn(B, np.shape(ids.data)[1], 3).astype(np.float32)
    return ids, data, cot


@pytest.mark.parametrize("each", [False, True], ids=["whole", "each"])
@pytest.mark.parametrize("pooling", POOLINGS)
def test_nested_seq_pool_matches_jax(pooled_input, pooling, each):
    """The value, and the gradient of sum(value * cotangent) with respect
    to the data, over sub-sequences that are empty and samples with fewer
    of them than the widest."""
    ids, data, cot = pooled_input

    def jfn(d):
        out = jseq_ops.nested_seq_pool(ids._replace(data=d), pooling,
                                       each_sequence=each)
        v = out.data if isinstance(out, jseq.SequenceBatch) else out
        c = cot if each else cot[:, 0]
        return jnp.sum(v * c), out
    (_, want), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.asarray(data))
    x = torch.tensor(data, requires_grad=True)
    got = seq_ops.nested_seq_pool(
        tseq.NestedSequenceBatch(x, *(torch.tensor(np.asarray(a))
                                      for a in ids[1:])),
        pooling, each_sequence=each)
    if each:
        assert isinstance(got, tseq.SequenceBatch)
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        got, want, c = got.data, want.data, cot
    else:
        c = cot[:, 0]
    _close(got.detach().numpy(), want, f"{pooling} value")
    (got * torch.tensor(c)).sum().backward()
    _close(x.grad.numpy(), jg, f"{pooling} gradient")
    if each:    # the rows past a sample's outer length are zero
        outer = np.asarray(ids.outer_lengths)
        for i, n in enumerate(outer):
            assert not got[i, n:].detach().numpy().any()


@pytest.mark.parametrize("ctor", ["pooling_layer", "last_seq", "first_seq"])
def test_seq_level_pooling_ctors_keep_jax_flags(ctor):
    """Each ctor's is_seq as JAX sets it, with agg_level "seq" or not."""
    for agg in (None, "seq"):
        j_reset_names()
        L.reset_names()
        want = getattr(JL, ctor)(JL.data_layer("x", 3, is_seq=True),
                                 agg_level=agg)
        got = getattr(L, ctor)(L.data_layer("x", 3, is_seq=True),
                               agg_level=agg)
        assert got.is_seq == want.is_seq == (agg == "seq")
        assert got.cfg == want.cfg


# ---------------------------------------------------------- nested graph

def _jax_nested_net(vocab, hid=HID, emb=128):
    """models/text_dsl.nested_lstm_net in JAX's DSL."""
    j_reset_names()
    words = JL.data_layer("words", vocab, is_seq=True)
    label = JL.data_layer("label", 1)
    sents = JL.pooling_layer(JL.embedding_layer(words, size=emb),
                             pooling_type=JL.pooling.Avg, agg_level="seq")
    lstm = JL.lstmemory(JL.fc_layer(sents, size=hid * 4, act=None,
                                    bias_attr=False), size=hid)
    out = JL.fc_layer(JL.pooling_layer(lstm, pooling_type=JL.pooling.Max),
                      size=2, act="softmax")
    return JL.classification_cost(out, label)


def _nested_batch(seed):
    rng = np.random.RandomState(seed)
    return [(s, int(rng.randint(2))) for s in _nested_ids(seed, max_subs=5,
                                                           max_len=6)]


def test_nested_graph_value_and_gradients_match_jax():
    """The cost of the nested graph and the gradient of its mean with
    respect to every parameter, then two Adam steps through SGD."""
    batches = [_nested_batch(6), _nested_batch(6)]
    jcost = _jax_nested_net(V)
    jtopo = JL.Topology(jcost)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(0)))
    jfeeding = {"words": j_int_sub(V), "label": j_integer_value(2)}
    jf = JaxFeeder(jfeeding)(batches[0])

    def jloss(p):
        return jnp.mean(jtopo.apply(p, jf, mode="train"))
    want, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    cost, _ = text_dsl.build("nested", vocab=V, hid=HID)
    topo = L.Topology(cost)
    assert [n.name for n in topo.order] == [n.name for n in jtopo.order]
    params = L.params_from_numpy(topo, tree, "cpu")
    for p in [t for v in params.values() for t in v.values()]:
        p.requires_grad_(True)
    feeder = DataFeeder(text_dsl.feeding(V, model="nested"), device="cpu")
    feed = feeder(batches[0])
    assert isinstance(feed["words"], tseq.NestedSequenceBatch)
    got = torch.mean(topo.apply(params, feed, mode="train"))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    got.backward()
    for k in tree:
        for n in tree[k]:
            _close(params[k][n].grad.numpy(), jg[k][n], f"{k}/{n}")
    # two Adam steps through both trainers (batches of one shape)
    jt = JaxSGD(jcost, parameters=jax.tree_util.tree_map(jnp.asarray, tree),
                update_equation=jax_optim.Adam(learning_rate=0.002),
                donate=False)
    want = [float(jt.train_one_batch(b, feeder=jfeeding)) for b in batches]
    tr = SGD(text_dsl.build("nested", vocab=V, hid=HID)[0], parameters=tree,
             update_equation=text_dsl.optimizer("nested"), device="cpu")
    got = [float(tr.train_one_batch(b, feeder)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k in tree:
        for n in tree[k]:
            _close(tr.opt_state["slots"]["m"][k][n].numpy(),
                   jt.opt_state["slots"]["m"][k][n], f"m {k}/{n}")


def test_sparse_update_refuses_a_nested_id_feed():
    """JAX's sparse step reads plain or sequence id feeds only, so a
    nested id feed fails there; the port refuses it with a ConfigError
    at the step that meets it."""
    batch = _nested_batch(7)

    def build(M):
        words = M.data_layer("words", V, is_seq=True)
        sents = M.pooling_layer(M.embedding_layer(words, size=8,
                                                  sparse_update=True),
                                pooling_type="sum", agg_level="seq")
        out = M.fc_layer(M.pooling_layer(sents, pooling_type="sum"),
                         size=2, act="softmax")
        return M.classification_cost(out, M.data_layer("label", 1))
    j_reset_names()
    jt = JaxSGD(build(JL), update_equation=jax_optim.Momentum())
    with pytest.raises(Exception):
        jt.train_one_batch(batch, feeder={"words": j_int_sub(V),
                                          "label": j_integer_value(2)})
    L.reset_names()
    tr = SGD(build(L), update_equation=optim.Momentum(), device="cpu")
    with pytest.raises(ConfigError, match="nested sequence"):
        tr.train_one_batch(batch, feeder=DataFeeder(
            {"words": integer_value_sub_sequence(V),
             "label": integer_value(2)}, device="cpu"))


def test_nested_config_reads_imdb_sentences():
    """text_dsl's nested config: each review cut into sub-sequences of at
    most SUB_LEN tokens, at most MAX_SUBS of them, fed nested."""
    cfg = text_dsl.config("nested", n_batches=1, batch=4)
    batch = next(iter(cfg["train_reader"]()))
    for subs, label in batch:
        assert 1 <= len(subs) <= text_dsl.MAX_SUBS
        assert all(len(s) <= text_dsl.SUB_LEN for s in subs)
    feed = DataFeeder(cfg["feeding"], device="cpu")(batch)
    assert isinstance(feed["words"], tseq.NestedSequenceBatch)
    assert feed["words"].data.shape[0] == 4
