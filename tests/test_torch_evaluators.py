"""The port's evaluators (``paddle_tpu_torch/evaluators``) against the
JAX package's on the same arrays: every implementation, mirroring
``tests/test_evaluators.py``'s ten cases plus random draws from a numpy
seed, and every DSL ctor (printers by what they print).  Counts, chunk
F1 and the CTC error are held exact; AUC, precision/recall and pnpair
within 1e-6."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu import evaluators as JE
import paddle_tpu.layers as JL
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu_torch import evaluators as E
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core.sequence import SequenceBatch

TOL = 1e-6


def _jax(a):
    return jnp.asarray(a)


def _port(a):
    return torch.tensor(np.asarray(a))


def _same(got, want, exact):
    """Results (floats, dicts of floats, arrays) equal, or within TOL."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], exact)
        return
    if exact:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def _classification_error(P, arr, rng):
    ev = P.ClassificationError()
    st = ev.update(ev.init(), pred=arr([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]]),
                   label=arr([0, 1, 1]))
    out = [ev.result(st)]
    pred = rng.rand(64, 5).astype(np.float32)
    lab = rng.randint(0, 5, 64).astype(np.int32)
    w = rng.randint(0, 3, 64).astype(np.float32)
    st = ev.update(st, pred=arr(pred), label=arr(lab), weight=arr(w))
    st = ev.update(st, pred=arr(pred[:9]), label=arr(lab[:9]),
                   mask=arr((lab[:9] > 1).astype(np.float32)))
    out += [ev.result(st), float(st["wrong"]), float(st["total"])]
    return out


def _auc(P, arr, rng):
    ev = P.Auc()
    pred = np.asarray([0.9, 0.8, 0.2, 0.1], np.float32)
    label = np.asarray([1, 1, 0, 0])
    out = [ev.result(ev.update(ev.init(), pred=arr(pred), label=arr(label))),
           ev.result(ev.update(ev.init(), pred=arr(1 - pred),
                               label=arr(label)))]
    # probabilities on bucket edges (k / 1024), 1.0 and a [B, 2] softmax
    edges = (rng.randint(0, 1025, 200) / 1024.0).astype(np.float32)
    lab = rng.randint(0, 2, 200)
    st = ev.update(ev.init(), pred=arr(edges), label=arr(lab),
                   weight=arr(rng.rand(200).astype(np.float32)))
    two = rng.rand(50, 2).astype(np.float32)
    two /= two.sum(1, keepdims=True)
    st = ev.update(st, pred=arr(two), label=arr(rng.randint(0, 2, 50)))
    out += [ev.result(st), np.asarray(st["pos"]), np.asarray(st["neg"])]
    rk = P.RankAuc()
    out.append(rk.result(rk.update(rk.init(), pred=arr(edges),
                                   label=arr(lab))))
    return out


def _precision_recall(P, arr, rng):
    ev = P.PrecisionRecall(num_classes=2, positive_label=1)
    pred = [[0.2, 0.8], [0.9, 0.1], [0.3, 0.7], [0.6, 0.4]]
    out = [ev.result(ev.update(ev.init(), pred=arr(pred),
                               label=arr([1, 1, 0, 0])))]
    macro = P.PrecisionRecall(num_classes=6)
    st = macro.init()
    for _ in range(3):
        st = macro.update(st, pred=arr(rng.rand(40, 6).astype(np.float32)),
                          label=arr(rng.randint(0, 6, 40)))
    out.append(macro.result(st))
    return out


def _chunk_exact(P, arr, rng):
    ev = P.ChunkEvaluator(num_chunk_types=2)
    tags = np.asarray([[0, 1, 2]])
    st = ev.update(ev.init(), pred=arr(tags), label=arr(tags),
                   lengths=arr([3]))
    return [ev.result(st), dict(st)]


def _chunk_partial(P, arr, rng):
    ev = P.ChunkEvaluator(num_chunk_types=2)
    st = ev.update(ev.init(), pred=arr([[0, 0, 2]]), label=arr([[0, 1, 2]]),
                   lengths=arr([3]))
    # random IOB tags over 3 types (O = 6), ragged
    pred = rng.randint(0, 7, (16, 20))
    gold = np.where(rng.rand(16, 20) < 0.7, pred, rng.randint(0, 7, (16, 20)))
    st = ev.update(st, pred=arr(pred), label=arr(gold),
                   lengths=arr(rng.randint(0, 21, 16)))
    return [ev.result(st), dict(st)]


def _chunk_schemes(P, arr, rng):
    cases = {"IOE": [0, 1, 3, 4], "IOBES": [0, 2, 7, 8],
             "plain": [0, 0, 1, 2]}
    out = []
    for scheme, tags in cases.items():
        ev = P.ChunkEvaluator(scheme=scheme, num_chunk_types=2)
        st = ev.update(ev.init(), pred=arr([tags]), label=arr([tags]),
                       lengths=arr([len(tags)]))
        n_tag = {"IOE": 2, "IOBES": 4, "plain": 1}[scheme]
        pred = rng.randint(0, 3 * n_tag + 1, (8, 15))
        gold = rng.randint(0, 3 * n_tag + 1, (8, 15))
        ev3 = P.ChunkEvaluator(scheme=scheme, num_chunk_types=3)
        st3 = ev3.update(ev3.init(), pred=arr(pred), label=arr(gold))
        out += [ev.result(st), dict(st), ev3.result(st3), dict(st3)]
    return out


def _chunk_requires_num_types(P, arr, rng):
    ev = P.ChunkEvaluator()
    with pytest.raises(ValueError, match="num_chunk_types"):
        ev.update(ev.init(), pred=arr([[0]]), label=arr([[0]]),
                  lengths=arr([1]))
    with pytest.raises(ValueError, match="unknown chunk scheme"):
        P.ChunkEvaluator(scheme="BIO")
    with pytest.raises(KeyError, match="unknown evaluator"):
        P.get("nope")
    return [type(P.get("chunk", num_chunk_types=2)).__name__]


def _chunk_excluded(P, arr, rng):
    ev = P.ChunkEvaluator(num_chunk_types=2, excluded_chunk_types=(1,))
    tags = np.asarray([[0, 1, 2]])
    st = ev.update(ev.init(), pred=arr(tags), label=arr(tags),
                   lengths=arr([3]))
    # negative padding without lengths stops the decode
    st = ev.update(st, pred=arr([[0, 1, -1, 2]]), label=arr([[0, 1, 2, -1]]))
    return [ev.result(st), dict(st)]


def _ctc_error(P, arr, rng):
    ev = P.CTCError()
    st = ev.update(ev.init(), decoded=arr([[1, 2, 3]]),
                   decoded_lengths=arr([3]), label=arr([[1, 3]]),
                   label_lengths=arr([2]))
    st = ev.update(st, decoded=arr(rng.randint(0, 5, (6, 9))),
                   decoded_lengths=arr(rng.randint(0, 10, 6)),
                   label=arr(rng.randint(0, 5, (6, 7))),
                   label_lengths=arr(rng.randint(1, 8, 6)))
    return [ev.result(st), dict(st)]


def _sum_column_sum(P, arr, rng):
    ev = P.SumEvaluator()
    out = [ev.result(ev.update(ev.init(), value=arr([[1.0], [2.0]])))]
    v = rng.rand(12, 3).astype(np.float32)
    w = rng.rand(12).astype(np.float32)
    st = ev.update(ev.init(), value=arr(v), weight=arr(w))
    out.append(ev.result(st))
    ev2 = P.ColumnSum(size=3)
    st2 = ev2.update(ev2.init(), value=arr(v), weight=arr(w))
    out += [ev2.result(st2), float(st2["total"])]
    # a sequence value sums its valid positions only
    data = rng.rand(4, 5, 2).astype(np.float32)
    lens = np.asarray([5, 0, 2, 3], np.int32)
    seq = (JaxSeq(jnp.asarray(data), jnp.asarray(lens)) if arr is _jax
           else SequenceBatch(torch.tensor(data), torch.tensor(lens)))
    out.append(ev.result(ev.update(ev.init(), value=seq)))
    pn = P.PnPair()
    st = pn.init()
    for _ in range(2):
        st = pn.update(st, pred=arr(rng.rand(30).astype(np.float32)),
                       label=arr(rng.randint(0, 3, 30)),
                       query_id=arr(rng.randint(0, 4, 30)))
    out.append(pn.result(st))
    out.append(pn.result(pn.update(pn.init(), pred=arr([0.5, 0.5, 0.1]),
                                   label=arr([1, 0, 0]))))
    return out


# (case, exact): the ten cases of tests/test_evaluators.py
CASES = {
    "classification_error": (_classification_error, True),
    "auc_perfect_and_random": (_auc, False),
    "precision_recall_binary": (_precision_recall, False),
    "chunk_f1_exact_match": (_chunk_exact, True),
    "chunk_f1_partial": (_chunk_partial, True),
    "chunk_schemes_ioe_iobes_plain": (_chunk_schemes, True),
    "chunk_requires_num_types": (_chunk_requires_num_types, True),
    "chunk_excluded_types": (_chunk_excluded, True),
    "ctc_error_edit_distance": (_ctc_error, True),
    "sum_column_sum_pnpair": (_sum_column_sum, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_jax(case):
    fn, exact = CASES[case]
    want = fn(JE, _jax, np.random.RandomState(7))
    got = fn(E, _port, np.random.RandomState(7))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w, exact)


def test_tensor_state_stays_on_the_batch_device():
    """The additive state becomes the batch's tensors (no host copy in
    update); only result() reads it back."""
    ev = E.Auc()
    st = ev.update(ev.init(), pred=torch.rand(8), label=torch.ones(8))
    assert isinstance(st["pos"], torch.Tensor) and st["pos"].shape == (1024,)
    ce = E.ClassificationError()
    st = ce.update(ce.init(), pred=torch.rand(8, 3),
                   label=torch.zeros(8, dtype=torch.int32))
    assert all(isinstance(v, torch.Tensor) for v in st.values())


# ------------------------------------------------------------------ DSL

def _layers(M):
    if M is JL:
        from paddle_tpu.layers.graph import reset_names
    else:
        reset_names = L.reset_names
    reset_names()
    return {"x": M.data_layer("x", 4), "y": M.data_layer("y", 1),
            "w": M.data_layer("w", 1), "q": M.data_layer("q", 1),
            "s": M.data_layer("s", 5, is_seq=True)}


def _feeds(rng):
    x = rng.rand(10, 4).astype(np.float32)
    return {"x": x, "y": rng.randint(0, 4, 10).astype(np.int32),
            "w": rng.randint(0, 3, 10).astype(np.float32),
            "q": rng.randint(0, 3, 10).astype(np.int32),
            "s": rng.rand(3, 6, 5).astype(np.float32),
            "s_len": np.asarray([6, 2, 4], np.int32),
            "tags": rng.randint(0, 5, (3, 6)).astype(np.int32),
            "lab_seq": rng.randint(1, 5, (3, 4)).astype(np.int32),
            "lab_len": np.asarray([4, 1, 3], np.int32)}


def _seq(M, data, lens):
    if M is JL:
        return JaxSeq(jnp.asarray(data), jnp.asarray(lens))
    return SequenceBatch(torch.tensor(data), torch.tensor(lens))


# ctor -> (build(M, layers, D) -> spec, update(M, spec, feeds, arr))
DSL = {
    "classification_error_evaluator": (
        lambda D, ls: D.classification_error_evaluator(ls["x"], ls["y"],
                                                       weight=ls["w"]),
        lambda M, s, f, a: s.update(a(f["x"]), a(f["y"]), a(f["w"]))),
    "auc_evaluator": (
        lambda D, ls: D.auc_evaluator(ls["x"], ls["y"]),
        lambda M, s, f, a: s.update(a(f["x"][:, 0]),
                                    a((f["y"] > 1).astype(np.int32)))),
    "sum_evaluator": (
        lambda D, ls: D.sum_evaluator(ls["x"], weight=ls["w"]),
        lambda M, s, f, a: s.update(a(f["x"]), weight=a(f["w"]))),
    "column_sum_evaluator": (
        lambda D, ls: D.column_sum_evaluator(ls["x"]),
        lambda M, s, f, a: s.update(a(f["x"]))),
    "precision_recall_evaluator": (
        lambda D, ls: D.precision_recall_evaluator(ls["x"], ls["y"],
                                                   positive_label=2),
        lambda M, s, f, a: s.update(a(f["x"]), a(f["y"]))),
    "pnpair_evaluator": (
        lambda D, ls: D.pnpair_evaluator(ls["x"], ls["y"], ls["q"]),
        lambda M, s, f, a: s.update(a(f["x"][:, 1]), a(f["y"]),
                                    extra={"query_id": a(f["q"])})),
    "chunk_evaluator": (
        lambda D, ls: D.chunk_evaluator(ls["s"], ls["y"], num_chunk_types=2),
        lambda M, s, f, a: s.update(_seq(M, f["s"], f["s_len"]),
                                    a(f["tags"]))),
    "ctc_error_evaluator": (
        lambda D, ls: D.ctc_error_evaluator(ls["s"], ls["y"]),
        lambda M, s, f, a: s.update(_seq(M, f["s"], f["s_len"]),
                                    _seq(M, f["lab_seq"], f["lab_len"]))),
    "evaluator_base": (
        lambda D, ls: D.evaluator_base(ls["x"], "classification_error",
                                       label=ls["y"], name="base"),
        lambda M, s, f, a: s.update(a(f["x"]), a(f["y"]))),
    "value_printer_evaluator": (
        lambda D, ls: D.value_printer_evaluator(ls["x"]),
        lambda M, s, f, a: s.update(a(f["x"][:2]))),
    "gradient_printer_evaluator": (
        lambda D, ls: D.gradient_printer_evaluator(ls["x"]),
        lambda M, s, f, a: s.update(a(f["x"][:2]))),
    "maxid_printer_evaluator": (
        lambda D, ls: D.maxid_printer_evaluator(ls["x"]),
        lambda M, s, f, a: s.update(a(f["x"]))),
    "maxframe_printer_evaluator": (
        lambda D, ls: D.maxframe_printer_evaluator(ls["x"]),
        lambda M, s, f, a: s.update(a(f["x"]))),
    "seqtext_printer_evaluator": (
        lambda D, ls: D.seqtext_printer_evaluator(ls["s"]),
        lambda M, s, f, a: s.update(_seq(M, f["tags"], f["s_len"]))),
    "classification_error_printer_evaluator": (
        lambda D, ls: D.classification_error_printer_evaluator(ls["x"],
                                                               ls["y"]),
        lambda M, s, f, a: s.update(a(f["x"]), a(f["y"]))),
}


def test_dsl_lists_the_jax_ctors():
    from paddle_tpu.evaluators import dsl as jdsl
    from paddle_tpu_torch.evaluators import dsl
    assert dsl.__all__ == jdsl.__all__
    assert sorted(set(DSL) | {"EvaluatorSpec"}) == sorted(dsl.__all__)


@pytest.mark.parametrize("ctor", sorted(DSL))
def test_dsl_ctor_matches_jax(ctor, capsys):
    """Each ctor bound to the same layers in both DSLs, updated twice on
    the same arrays, reset, updated again: the same name, kind and
    result (a printer: the same text)."""
    build, update = DSL[ctor]
    runs = []
    for M, D, arr in ((JL, JE, _jax), (L, E, _port)):
        spec = build(D, _layers(M))
        rng = np.random.RandomState(3)
        outs = []
        for _ in range(2):
            update(M, spec, _feeds(rng), arr)
            outs.append(spec.result())
        spec.reset()
        update(M, spec, _feeds(rng), arr)
        outs.append(spec.result())
        runs.append((spec.name, spec.kind, outs, capsys.readouterr().out))
    (jname, jkind, jouts, jtext), (name, kind, outs, text) = runs
    assert (name, kind) == (jname, jkind)
    assert text == jtext
    exact = ctor.startswith(("chunk", "ctc", "classification", "evaluator"))
    for g, w in zip(outs, jouts):
        if w is None:
            assert g is None
        else:
            _same(g, w, exact)
