"""The text demos as the port's layer-DSL configs
(``paddle_tpu_torch/models/text_dsl.py``) and the imdb loader
(``data/datasets/imdb``) against the JAX package and the demos' own
networks (``demo/sentiment/train.py``, ``demo/quick_start/train.py``) on
the CPU:

- the imdb loader's samples for both splits and its word dict, element
  for element;
- sentiment's ``stacked_lstm_net`` (at hid 16), quick_start's ``lr_net``
  and ``lstm_net`` (at their widths), built by the demo (JAX) and by
  ``text_dsl`` (the port) on JAX's init carried across: the loss and
  every gradient leaf on six imdb reviews (8-119 tokens, ragged);
- two ``trainer.SGD`` steps of sentiment at hid 16 (Adam with l2 and
  clip_norm) against ``paddle_tpu.trainer.SGD``'s: the losses, the
  Adam slots and the parameters (those whose gradient scale is within
  1e-2 of their leaf's largest; see the test);
- an unknown model raises (quick_start's ``cnn_net`` is held in
  tests/test_torch_tagging_demos.py);
- one CLI pass of the sentiment config at its full width.

Tolerances: float32 on both sides in other summation orders through up
to 119 recurrent steps: losses at 1e-5 relative (TOL), each gradient
leaf within 1e-5 of its largest entry (GRAD_TOL), each Adam slot and
parameter leaf after two steps within 1e-4 of its largest entry
(STEP_TOL, as tests/test_torch_trainer.py holds its steps).
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.data.datasets import imdb as jax_imdb
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.trainer import SGD as JaxSGD
import paddle_tpu.layers as JL
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.data import DataFeeder
from paddle_tpu_torch.data.datasets import imdb
from paddle_tpu_torch.models import text_dsl
from paddle_tpu_torch.trainer import SGD, cli
from paddle_tpu_torch.trainer.checkpoint import load_checkpoint
from paddle_tpu_torch.utils.tree import tree_leaves

TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
HID = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("split", ["train", "test"])
def test_imdb_rows_equal_jax(split):
    mine, theirs = getattr(imdb, split)(), getattr(jax_imdb, split)()
    n = 0
    for (ids, label), (jids, jlabel) in zip(mine(), theirs()):
        np.testing.assert_array_equal(ids, jids)
        assert label == jlabel and 8 <= len(ids) < 120
        n += 1
    assert n == {"train": 2048, "test": 256}[split]
    assert imdb.WORD_DIM == jax_imdb.WORD_DIM == 5147
    assert imdb.word_dict() == jax_imdb.word_dict()


@functools.lru_cache(maxsize=None)
def _demo(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_train", os.path.join(ROOT, "demo", name, "train.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


# model -> (the demo's network in the JAX DSL, the port's sizes)
MODELS = {
    "sentiment": (lambda w, y: _demo("sentiment").stacked_lstm_net(
        w, y, hid=HID), {"hid": HID}),
    "lr": (lambda w, y: _demo("quick_start").lr_net(w, y), {}),
    "lstm": (lambda w, y: _demo("quick_start").lstm_net(w, y), {}),
}


def _jax_cost(model):
    jax_reset_names()
    words = JL.data_layer("words", size=imdb.WORD_DIM, is_seq=True)
    label = JL.data_layer("label", size=1)
    return MODELS[model][0](words, label)[0]


def _port_cost(model):
    return text_dsl.build(model, **MODELS[model][1])[0]


def _reviews(n=6, start=0):
    it = imdb.train()()
    rows = [next(it) for _ in range(start + n)][start:]
    return [(list(map(int, ids)), label) for ids, label in rows]


def _feeds(batch):
    tf = DataFeeder(text_dsl.feeding(), device="cpu")(batch)
    jf = {"words": JaxSeq(jnp.asarray(tf["words"].data.numpy()),
                          jnp.asarray(tf["words"].lengths.numpy())),
          "label": jnp.asarray(tf["label"].numpy())}
    return jf, tf


@pytest.mark.parametrize("model", sorted(MODELS))
def test_text_demo_loss_and_grads_match_jax(model):
    jtopo = JL.Topology(_jax_cost(model))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(1)))
    ttopo = L.Topology(_port_cost(model))
    assert [n.name for n in ttopo.order] == [n.name for n in jtopo.order]
    params = L.params_from_numpy(ttopo, tree, "cpu")
    jf, tf = _feeds(_reviews())
    jl, jg = jax.value_and_grad(
        lambda p: jnp.mean(jtopo.apply(p, jf, mode="train")))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = torch.mean(ttopo.apply(params, tf, mode="train"))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    loss.backward()
    for got, want in zip(tree_leaves(params), jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        assert np.abs(got.grad.numpy() - want).max() \
            <= GRAD_TOL * np.abs(want).max()


def _close(got, want, where=None):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        d = np.abs(g.detach().numpy() - w)
        if where is not None:
            d = d[where[i]]
        assert d.max() <= STEP_TOL * np.abs(w).max()


def test_sentiment_sgd_steps_match_jax():
    """Two ``train_one_batch`` steps of the sentiment config at hid 16
    with the demo's optimizer (Adam lr 0.002, l2 1e-4, clip_norm 5.0)
    from the JAX trainer's weights: the losses, Adam's m and v slots,
    and the parameters.  Adam steps each entry by m / (sqrt(v) + eps),
    its gradient over its own scale, so an entry whose gradient is far
    below its leaf's largest carries its gradient's rounding into its
    step amplified by that ratio (an embedding entry with gradients of
    ~1e-7 moved 9e-6 of its 4e-3 step): the parameters are held where
    sqrt(v) is at least 1e-2 of its leaf's largest, and the rest
    through their m and v."""
    batches = [_reviews(4), _reviews(4, start=4)]
    jax_feeding = _demo("sentiment").get_config()["feeding"]
    jt = JaxSGD(_jax_cost("sentiment"), update_equation=jax_optim.Adam(
        learning_rate=0.002, l2=1e-4, clip_norm=5.0), seed=2)
    start = jax.tree_util.tree_map(np.asarray, jt.parameters)
    want = [float(jt.train_one_batch(b, feeder=jax_feeding))
            for b in batches]
    trainer = SGD(_port_cost("sentiment"), parameters=start,
                  update_equation=text_dsl.optimizer("sentiment"),
                  device="cpu")
    got = [float(trainer.train_one_batch(b, feeder=text_dsl.feeding()))
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=TOL)
    slots = trainer.opt_state["slots"]
    jm = jax.tree_util.tree_leaves(jt.opt_state["slots"]["m"])
    jv = jax.tree_util.tree_leaves(jt.opt_state["slots"]["v"])
    _close(tree_leaves(slots["m"]) + tree_leaves(slots["v"]), jm + jv)
    scale = [np.sqrt(np.asarray(v)) for v in jv]
    _close(tree_leaves(trainer.parameters),
           jax.tree_util.tree_leaves(jt.parameters),
           where=[r >= 1e-2 * r.max() for r in scale])


def test_quick_start_cnn_raises_naming_a10b():
    """A model text_dsl does not have raises naming the ones it has (the
    cnn config builds since ``sequence_conv_pool`` came: its parity test
    is tests/test_torch_tagging_demos.py)."""
    with pytest.raises(ValueError, match="one of"):
        text_dsl.build("bow")


def test_cli_trains_the_sentiment_config(tmp_path, capsys):
    """``python -m paddle_tpu_torch train --config
    paddle_tpu_torch/models/text_dsl.py --config_args
    model=sentiment,batches=2`` at the demo's widths (hid 128, batch 64),
    then the test job on its pass dir."""
    path = os.path.join(ROOT, "paddle_tpu_torch", "models", "text_dsl.py")
    save = tmp_path / "out"
    assert cli.main(["train", "--config", path, "--config_args",
                     "model=sentiment,batches=2", "--device", "cpu",
                     "--save_dir", str(save)]) == 0
    meta = json.loads((save / "pass-00000" / "meta.json").read_text())
    assert meta["pass_id"] == 0
    params, opt_state, _, _ = load_checkpoint(str(save))
    assert int(opt_state["step"]) == 2
    assert set(params) == set(L.Topology(text_dsl.build()[0]).param_shapes())
    assert params["__lstmemory_1__"]["w"].shape == (128, 512)
    capsys.readouterr()
    assert cli.main(["test", "--config", path, "--config_args",
                     "model=sentiment,batches=1", "--device", "cpu",
                     "--model_dir", str(save)]) == 0
    cost = float(capsys.readouterr().out.split("test cost: ")[1])
    assert np.isfinite(cost)
