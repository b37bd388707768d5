"""The tagging demos, quick_start's cnn and the introduction as the
port's layer-DSL configs (``paddle_tpu_torch/models/tagging_dsl.py``,
``models/text_dsl.cnn_net``) and the conll05 loader against the JAX
package and the demos' own configs on the CPU:

- the conll05 loader's samples for both splits, element for element;
- the SRL db-LSTM + CRF at emb 16 / hid 16 / depth 2 against
  ``demo/semantic_role_labeling/train.py``'s ``get_config`` with the
  demo module's ``EMB`` / ``HID`` / ``DEPTH`` set on the loaded module
  (the demo's file unchanged), on JAX's init carried across: the loss
  and every gradient leaf on six conll05 sentences (ragged, 12-38
  tokens), in float64 on both sides (x64 and both packages' float64
  policy; see the test); the decoded paths held by their score under
  JAX's emissions against JAX's best score (the count of tags equal to
  JAX's reported), here and in the next two;
- the SRL network at hid 128, batch 8, depth 2 on eight short sentences,
  where both packages take B9's resident route (B % 8 == 0, D % 128 ==
  0): the port's plain version of the fused LSTM against JAX's Pallas
  kernel run in interpret mode (``rnn.FUSED_LSTM = "always"``, as
  tests/test_pallas_lstm.py runs it);
- sequence_tagging's ``linear_crf_net`` and quick_start's ``cnn_net``
  against the same networks built by hand in the JAX DSL (ROADMAP C15:
  the demo's 224-wide mixed layer fails at apply in JAX, pinned here;
  C14: the demo's ``sequence_conv_pool`` likewise);
- two ``trainer.SGD`` steps of SRL (Adam lr 1e-3, clip_threshold 5.0)
  and of sequence_tagging (Momentum 0.01 / 0.9, l2 1e-4) against
  ``paddle_tpu.trainer.SGD``'s;
- the introduction's fit over its 8 passes reaches w ~ 2, b ~ 0.3, as
  JAX's trainer does, and both reach the same line;
- one CLI pass of ``tagging_dsl.py`` (model=tagging) and its test job.

Tolerances (as tests/test_torch_text_demos.py): losses and path scores
at 1e-5 relative (TOL), each gradient leaf within 1e-5 of its largest
entry (GRAD_TOL), the float64 SRL step at 1e-9 (F64_TOL),
parameters after two steps within 1e-4 of their largest entry
(STEP_TOL; Adam's where sqrt(v) is within 1e-2 of its leaf's largest,
since Adam's g / (|g| + eps) amplifies a tiny gradient's rounding, and
its m and v slots everywhere); the introduction's line within 1e-4 of
JAX's and within 0.05 of (2, 0.3).
"""

import contextlib
import functools
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.core import dtypes as jax_dtypes
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.data import integer_value_sequence as jax_int_seq
from paddle_tpu.data.datasets import conll05 as jax_conll05
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.trainer import SGD as JaxSGD
import paddle_tpu.layers as JL
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.data import DataFeeder
from paddle_tpu_torch.data.datasets import conll05, imdb
from paddle_tpu_torch.models import tagging_dsl, text_dsl
from paddle_tpu_torch.ops.kernels import lstm as klstm
from paddle_tpu_torch.trainer import SGD, cli
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_crf import path_score

TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
F64_TOL = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"emb": 16, "hid": 16, "depth": 2}
WIDE = {"emb": 16, "hid": 128, "depth": 2}


@pytest.mark.parametrize("split", ["train", "test"])
def test_conll05_rows_equal_jax(split):
    n = 0
    for mine, theirs in zip(getattr(conll05, split)()(),
                            getattr(jax_conll05, split)()()):
        assert len(mine) == len(theirs) == 3
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
        assert 5 <= len(mine[0]) < 40
        n += 1
    assert n == {"train": 1024, "test": 128}[split]
    assert (conll05.WORD_DICT, conll05.PRED_DICT, conll05.NUM_LABELS) == (
        jax_conll05.WORD_DICT, jax_conll05.PRED_DICT, jax_conll05.NUM_LABELS)
    assert conll05.get_dict() == jax_conll05.get_dict()


@functools.lru_cache(maxsize=None)
def _demo(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_train", os.path.join(ROOT, "demo", name, "train.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


def _srl_demo(emb, hid, depth):
    """The SRL demo's get_config at these widths: (cost, decoded,
    feeding)."""
    demo = _demo("semantic_role_labeling")
    demo.EMB, demo.HID, demo.DEPTH = emb, hid, depth
    jax_reset_names()
    cfg = demo.get_config()
    return cfg["cost"], cfg["output"], cfg["feeding"]


def _jax_tagging(M=JL):
    """sequence_tagging's network built by hand in a DSL: its features
    as the concat of the 192-wide window and the predicate embedding."""
    words = M.data_layer("words", size=conll05.WORD_DICT, is_seq=True)
    preds = M.data_layer("preds", size=conll05.PRED_DICT, is_seq=True)
    label = M.data_layer("label", size=1, is_seq=True)
    word = M.embedding_layer(words, size=64)
    pred = M.embedding_layer(preds, size=32)
    window = M.mixed_layer(size=192, input=[
        M.context_projection(word, context_len=3, context_start=-1)],
        act=None)
    hid = M.fc_layer(M.concat_layer([window, pred]), size=128, act="tanh")
    emission = M.fc_layer(hid, size=conll05.NUM_LABELS, act=None)
    cost = M.crf_layer(emission, label, size=conll05.NUM_LABELS, name="crf")
    decoded = M.crf_decoding_layer(emission, size=conll05.NUM_LABELS,
                                   param_name=cost.cfg["param_name"])
    return cost, decoded


JAX_TAGGING_FEEDING = {"words": jax_int_seq(conll05.WORD_DICT),
                       "preds": jax_int_seq(conll05.PRED_DICT),
                       "label": jax_int_seq(conll05.NUM_LABELS)}


def _jax_net(model):
    """(cost, decoded) of ``model`` in the JAX DSL, fresh names."""
    if model == "srl":
        return _srl_demo(**SMALL)[:2]
    if model == "srl_wide":
        return _srl_demo(**WIDE)[:2]
    jax_reset_names()
    return _jax_tagging()


def _port_net(model):
    if model == "tagging":
        return tagging_dsl.build("tagging")
    return tagging_dsl.build("srl", **(WIDE if model == "srl_wide"
                                       else SMALL))


def _sentences(n=6, start=0, max_len=None):
    rows = [r for r in conll05.train()()
            if max_len is None or len(r[0]) <= max_len]
    return [tuple(list(map(int, c)) for c in r) for r in rows[start:start
                                                              + n]]


def _feeds(batch):
    tf = DataFeeder(tagging_dsl.feeding(), device="cpu")(batch)
    jf = {k: JaxSeq(jnp.asarray(v.data.numpy()), jnp.asarray(v.lengths
                                                              .numpy()))
          for k, v in tf.items()}
    return jf, tf


@contextlib.contextmanager
def _float64(on):
    """JAX's x64 and both packages' float64 policy for the block, where
    ``on``."""
    if not on:
        yield
        return
    jax.config.update("jax_enable_x64", True)
    jax_dtypes.set_policy("float64", "float64")
    dtypes.set_policy("float64", "float64")
    try:
        yield
    finally:
        dtypes.set_policy("float32", None)
        jax_dtypes.set_policy("float32", None)
        jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def _jax_run(model):
    """JAX's side of ``model`` on its sentences (SHAPES): its float32
    init as numpy, the batch, the loss, its gradients, the emissions and
    the decoded tags (in float64 for ``srl``)."""
    n, max_len, f64 = SHAPES[model]
    cost, decoded = _jax_net(model)
    topo = JL.Topology([cost, decoded, cost.inputs[0]])
    tree = jax.tree_util.tree_map(np.asarray,
                                  topo.init(jax.random.PRNGKey(1)))
    batch = _sentences(n=n, max_len=max_len)
    jf, _ = _feeds(batch)
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always" if model == "srl_wide" else "0"
    try:
        with _float64(f64):
            p = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64 if f64 else None),
                tree)
            jl, jg = jax.jit(jax.value_and_grad(lambda q, f: jnp.mean(
                JL.Topology(cost).apply(q, f, mode="train"))))(p, jf)
            _, tags, em = jax.jit(lambda q, f: topo.apply(
                q, f, mode="test"))(p, jf)
            out = (float(jl), jax.tree_util.tree_map(np.asarray, jg),
                   np.asarray(em.data, np.float64),
                   np.asarray(tags.data)[..., 0])
    finally:
        jax_rnn.FUSED_LSTM = prior
    return (tree, batch) + out


# model -> (sentences, at most this many tokens, float64 on both sides)
SHAPES = {"srl": (6, None, True), "srl_wide": (8, 6, False),
          "tagging": (6, None, False)}


@pytest.mark.parametrize("model", sorted(SHAPES))
def test_tagging_loss_grads_and_paths_match_jax(model):
    """The loss and every gradient leaf on JAX's init; the port's decoded
    path reaches JAX's best score under JAX's emissions and weight.  The
    SRL network at hid 16 runs in float64 on both sides (F64_TOL): in
    float32 its gradient leaves read up to 1.9e-5 of their largest entry
    (the predicate embedding, one row summing every token's gradient
    through 2 x 38 recurrent steps and the CRF), and in float64 7e-15, so
    float32 shows only rounding there."""
    tree, batch, jl, jg, jem, jtags = _jax_run(model)
    f64 = SHAPES[model][2]
    tol, grad_tol = (F64_TOL, F64_TOL) if f64 else (TOL, GRAD_TOL)
    cost, decoded = _port_net(model)
    ttopo = L.Topology([cost, decoded])
    jax_reset_names()
    assert [n_.name for n_ in ttopo.order] == [
        n_.name for n_ in JL.Topology(list(_jax_net(model))).order]
    params = L.params_from_numpy(ttopo, tree, "cpu")
    if f64:
        params = tree_map(torch.Tensor.double, params)
    _, tf = _feeds(batch)
    if model == "srl_wide":
        # both packages take the resident fused route at this shape
        assert klstm.supported(len(batch), WIDE["hid"], "tanh", "sigmoid",
                               "tanh", None)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    with _float64(f64):
        loss = torch.mean(L.Topology(cost).apply(params, tf, mode="train"))
        loss.backward()
        with torch.no_grad():
            tags = ttopo.apply(params, tf, mode="test")[1].data[..., 0]
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=tol)
    for got, want in zip(tree_leaves(params), jax.tree_util.tree_leaves(jg)):
        assert got.grad.dtype == (torch.float64 if f64 else torch.float32)
        assert np.abs(got.grad.numpy() - want).max() \
            <= grad_tol * np.abs(want).max()
    tags = tags.numpy()
    lengths = tf["words"].lengths.numpy()
    w = tree["crf"]["w"].astype(np.float64)
    best = path_score(jem, jtags, lengths, w)
    np.testing.assert_allclose(path_score(jem, tags, lengths, w), best,
                               rtol=TOL)
    mask = np.arange(tags.shape[1])[None, :] < lengths[:, None]
    print(f"{model}: {int((tags == jtags)[mask].sum())} of "
          f"{int(mask.sum())} decoded tags equal JAX's")


def test_jax_sequence_tagging_demo_fails_at_apply():
    """ROADMAP C15: the demo sums a 192-wide context part and a 32-wide
    identity part in one 224-wide mixed layer; JAX builds it and fails
    at apply."""
    jax_reset_names()
    cfg = _demo("sequence_tagging").get_config()
    topo = JL.Topology(cfg["cost"])
    params = topo.init(jax.random.PRNGKey(0))
    jf, _ = _feeds(_sentences(4))
    with pytest.raises(TypeError, match=r"incompatible shapes for "
                                        r"broadcasting: \(4, \d+, 192\), "
                                        r"\(4, \d+, 32\)"):
        topo.apply(params, jf)


def test_jax_quick_start_cnn_demo_fails_at_apply():
    """ROADMAP C14: the quick_start demo's default cnn config builds in
    JAX and cannot take a step."""
    jax_reset_names()
    words = JL.data_layer("words", size=imdb.WORD_DIM, is_seq=True)
    label = JL.data_layer("label", size=1)
    cost, _ = _demo("quick_start").cnn_net(words, label)
    topo = JL.Topology(cost)
    params = topo.init(jax.random.PRNGKey(0))
    ids = jnp.asarray(np.arange(12, dtype=np.int32).reshape(2, 6))
    with pytest.raises(ValueError, match="Incompatible shapes for "
                                         "broadcasting"):
        topo.apply(params, {"words": JaxSeq(ids, jnp.asarray([6, 4])),
                            "label": jnp.asarray([0, 1])})


def _jax_cnn():
    """quick_start's cnn as the reference builds it, in the JAX DSL."""
    jax_reset_names()
    words = JL.data_layer("words", size=imdb.WORD_DIM, is_seq=True)
    label = JL.data_layer("label", size=1)
    emb = JL.embedding_layer(words, size=128)
    window = JL.mixed_layer(size=3 * 128, input=[
        JL.context_projection(emb, context_len=3)])
    conv = JL.pooling_layer(JL.fc_layer(window, size=256, act="relu"),
                            pooling_type=JL.pooling.Max)
    out = JL.fc_layer(conv, size=2, act="softmax")
    return JL.classification_cost(out, label)


def test_quick_start_cnn_matches_the_jax_network_by_hand():
    jtopo = JL.Topology(_jax_cnn())
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(1)))
    ttopo = L.Topology(text_dsl.build("cnn")[0])
    assert [n.name for n in ttopo.order] == [n.name for n in jtopo.order]
    params = L.params_from_numpy(ttopo, tree, "cpu")
    rows = [next(r for i, r in enumerate(imdb.train()()) if i == k)
            for k in range(3)]
    batch = [(list(map(int, ids)), label) for ids, label in rows]
    tf = DataFeeder(text_dsl.feeding(), device="cpu")(batch)
    jf = {"words": JaxSeq(jnp.asarray(tf["words"].data.numpy()),
                          jnp.asarray(tf["words"].lengths.numpy())),
          "label": jnp.asarray(tf["label"].numpy())}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, f: jnp.mean(jtopo.apply(p, f, mode="train"))))(
        jax.tree_util.tree_map(jnp.asarray, tree), jf)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = torch.mean(ttopo.apply(params, tf, mode="train"))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    loss.backward()
    for got, want in zip(tree_leaves(params), jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        assert np.abs(got.grad.numpy() - want).max() \
            <= GRAD_TOL * np.abs(want).max()


def _step_close(got, want, where=None):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        d = np.abs(g.detach().numpy() - w)
        if where is not None:
            d = d[where[i]]
        assert d.max() <= STEP_TOL * np.abs(w).max()


@pytest.mark.parametrize("model", ["srl", "tagging"])
def test_sgd_steps_match_jax(model):
    batches = [_sentences(4), _sentences(4, start=4)]
    if model == "srl":
        cost, _, jax_feeding = _srl_demo(**SMALL)
        jopt = jax_optim.Adam(learning_rate=1e-3, clip_threshold=5.0)
    else:
        cost, _ = _jax_net("tagging")
        jax_feeding = JAX_TAGGING_FEEDING
        jopt = jax_optim.Momentum(learning_rate=0.01, momentum=0.9, l2=1e-4)
    jt = JaxSGD(cost, update_equation=jopt, seed=2)
    start = jax.tree_util.tree_map(np.asarray, jt.parameters)
    want = [float(jt.train_one_batch(b, feeder=jax_feeding))
            for b in batches]
    trainer = SGD(_port_net(model)[0], parameters=start,
                  update_equation=tagging_dsl.optimizer(model),
                  device="cpu")
    got = [float(trainer.train_one_batch(b, feeder=tagging_dsl.feeding()))
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=TOL)
    params = jax.tree_util.tree_leaves(jt.parameters)
    if model == "tagging":
        _step_close(tree_leaves(trainer.parameters), params)
        return
    slots = trainer.opt_state["slots"]
    jm = jax.tree_util.tree_leaves(jt.opt_state["slots"]["m"])
    jv = jax.tree_util.tree_leaves(jt.opt_state["slots"]["v"])
    _step_close(tree_leaves(slots["m"]) + tree_leaves(slots["v"]), jm + jv)
    scale = [np.sqrt(np.asarray(v)) for v in jv]
    _step_close(tree_leaves(trainer.parameters), params,
                where=[r >= 1e-2 * r.max() for r in scale])


def test_fit_a_line_reaches_the_line_as_jax():
    """8 passes of the introduction (Momentum 0.1 / 0.9, batch 64) from
    JAX's init: both trainers reach w ~ 2, b ~ 0.3, the same line."""
    demo = _demo("introduction")
    jax_reset_names()
    cfg = demo.get_config()
    jt = JaxSGD(cfg["cost"], update_equation=jax_optim.Momentum(
        learning_rate=0.1, momentum=0.9), seed=0)
    start = jax.tree_util.tree_map(np.asarray, jt.parameters)
    jt.train(cfg["train_reader"], num_passes=8, feeding=cfg["feeding"],
             log_period=0)
    mine = tagging_dsl.config("fit_a_line")
    tr = SGD(mine["cost"], parameters=start,
             update_equation=mine["optimizer"], device="cpu")
    tr.train(mine["train_reader"], num_passes=8, feeding=mine["feeding"],
             log_period=0)
    got = [float(tr.parameters["fc"][k].detach().reshape(-1)[0])
           for k in ("w0", "b")]
    want = [float(np.asarray(jt.parameters["fc"][k]).reshape(-1)[0])
            for k in ("w0", "b")]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, [2.0, 0.3], atol=0.05)


def test_cli_trains_the_tagging_config(tmp_path, capsys):
    """``python -m paddle_tpu_torch train --config
    paddle_tpu_torch/models/tagging_dsl.py --config_args
    model=tagging,batches=2`` at the demo's widths, then the test job on
    its pass dir."""
    path = os.path.join(ROOT, "paddle_tpu_torch", "models", "tagging_dsl.py")
    save = tmp_path / "out"
    assert cli.main(["train", "--config", path, "--config_args",
                     "model=tagging,batches=2", "--device", "cpu",
                     "--save_dir", str(save)]) == 0
    assert (save / "pass-00000" / "params.npz").exists()
    capsys.readouterr()
    assert cli.main(["test", "--config", path, "--config_args",
                     "model=tagging,batches=2", "--device", "cpu",
                     "--model_dir", str(save)]) == 0
    assert capsys.readouterr().out.startswith("test cost: ")
