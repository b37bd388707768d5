"""The four text loaders (``data/datasets/{imikolov,wmt14,uci_housing,
sentiment}``), demo/word2vec as the port's config
(``models/word2vec_dsl.py``) and demo/seqToseq's script
(``models/seqtoseq_demo.py``) against the JAX package and the demos' own
files on the CPU.

- Each loader's samples for both splits, element for element, and its
  constants (``sentiment.train()`` an iterator, as in the reference).
- Two ``trainer.SGD`` steps of demo/word2vec, hsigmoid and softmax,
  against ``paddle_tpu.trainer.SGD`` on the demo's own ``get_config``
  (``demo/word2vec/train.py``) from the JAX trainer's weights: the
  losses, AdaGrad's ``accum`` slots and each step's parameters (from one
  state, see the test), the embedding ``emb`` shared by the four context
  words included; its checkpoint round trip; one CLI pass of
  ``word2vec_dsl.py`` in each variant.
- Two Adam steps (lr 5e-4, clip_norm 5.0) of the seqToseq demo at
  hidden 128, batch 8 (the demo's reader and ``feed_batch``) from JAX's
  init, against ``jax.value_and_grad(seq2seq.loss)`` +
  ``optim.Adam``: there both packages take B10's route (JAX's Pallas GRU
  forced, in interpret mode; the port's plain versions of its kernels).
  Then ``seq2seq.generate`` (beam 5) on 2 test sources, held up to the
  first step at which the port's 40-step search comes within 2e-3 of a
  top-K / top-(K+1) tie.

Tolerances as tests/test_torch_text_demos.py's: losses at 1e-5
relative (TOL), slots and stepped parameters within 1e-4 of their
leaf's largest entry (STEP_TOL; AdaGrad's and Adam's parameters where
the square root of their second-moment slot is at least 1e-2 of its
leaf's largest, see the tests and tests/test_torch_text_demos.py); beam
scores within 1e-5 relative.
"""

import functools
import importlib.util
import itertools
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.data.datasets import imikolov as jax_imikolov
from paddle_tpu.data.datasets import sentiment as jax_sentiment
from paddle_tpu.data.datasets import uci_housing as jax_uci
from paddle_tpu.data.datasets import wmt14 as jax_wmt14
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.models import seq2seq as jax_seq2seq
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.trainer import SGD as JaxSGD
from paddle_tpu_torch.data.datasets import (imikolov, sentiment,
                                            uci_housing, wmt14)
from paddle_tpu_torch.models import seq2seq, seqtoseq_demo, word2vec_dsl
from paddle_tpu_torch.trainer import SGD, cli
from paddle_tpu_torch.trainer.checkpoint import load_checkpoint
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

TOL = 1e-5
STEP_TOL = 1e-4
SCORE_RTOL = 1e-5
BEAM_MARGIN = 2e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ loaders

def _equal_rows(mine, theirs):
    n = 0
    for a, b in itertools.zip_longest(mine, theirs):
        assert a is not None and b is not None
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        n += 1
    return n


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("name", ["imikolov", "wmt14", "uci_housing"])
def test_loader_rows_equal_jax(name, split):
    mine, theirs = {"imikolov": (imikolov, jax_imikolov),
                    "wmt14": (wmt14, jax_wmt14),
                    "uci_housing": (uci_housing, jax_uci)}[name]
    n = _equal_rows(getattr(mine, split)()(), getattr(theirs, split)()())
    assert n == {("imikolov", "train"): 4096, ("imikolov", "test"): 512,
                 ("wmt14", "train"): 2048, ("wmt14", "test"): 256,
                 ("uci_housing", "train"): 404,
                 ("uci_housing", "test"): 102}[name, split]


def test_loader_constants_equal_jax():
    assert imikolov.WORD_DIM == jax_imikolov.WORD_DIM == 2073
    assert imikolov.build_dict() == jax_imikolov.build_dict()
    assert (wmt14.SRC_DICT_SIZE, wmt14.TRG_DICT_SIZE, wmt14.START,
            wmt14.END, wmt14.UNK) == (jax_wmt14.SRC_DICT_SIZE,
                                      jax_wmt14.TRG_DICT_SIZE,
                                      jax_wmt14.START, jax_wmt14.END,
                                      jax_wmt14.UNK)
    assert uci_housing.DIM == jax_uci.DIM == 13
    assert uci_housing.feature_names == jax_uci.feature_names
    np.testing.assert_array_equal(uci_housing._W, jax_uci._W)
    assert (sentiment.NUM_TRAINING_INSTANCES,
            sentiment.NUM_TOTAL_INSTANCES) == (
        jax_sentiment.NUM_TRAINING_INSTANCES,
        jax_sentiment.NUM_TOTAL_INSTANCES)


def test_sentiment_iterators_equal_jax():
    """``train()`` / ``test()`` are iterators of (ids, label), not reader
    creators, as in the reference; the word dict too."""
    assert sentiment.get_word_dict() == jax_sentiment.get_word_dict()
    for split, n in (("train", 1600), ("test", 400)):
        it = getattr(sentiment, split)()
        assert iter(it) is it
        assert _equal_rows(it, getattr(jax_sentiment, split)()) == n


# ------------------------------------------------------------ word2vec

@functools.lru_cache(maxsize=None)
def _demo(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_train", os.path.join(ROOT, "demo", name, "train.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


def _close(got, want, where=None):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        d = np.abs(g.detach().cpu().numpy() - w)
        if where is not None:
            d = d[where[i]]
        assert d.max() <= STEP_TOL * np.abs(w).max()


@functools.lru_cache(maxsize=None)
def _jax_word2vec(use_hsigmoid):
    """The demo's config through JAX's trainer: the start params, the
    first two batches, their losses, and the params and accum slots
    after each step."""
    jax_reset_names()
    cfg = _demo("word2vec").get_config(use_hsigmoid=use_hsigmoid)
    batches = list(itertools.islice(cfg["train_reader"](), 2))
    jt = JaxSGD(cfg["cost"], update_equation=cfg["optimizer"], seed=3)
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    start = host(jt.parameters)
    losses, states = [], []
    for b in batches:
        losses.append(float(jt.train_one_batch(b, feeder=cfg["feeding"])))
        states.append((host(jt.parameters),
                       host(jt.opt_state["slots"]["accum"])))
    return start, batches, losses, states


def _word2vec_trainer(use_hsigmoid, params):
    """The port's SGD on the config's graph from ``params`` (numpy)."""
    cfg = word2vec_dsl.config(use_hsigmoid)
    trainer = SGD(cfg["cost"], parameters=params,
                  update_equation=cfg["optimizer"], device="cpu")
    return trainer, cfg["feeding"]


def _set_state(trainer, params, accum, step):
    """``trainer`` from ``params`` (numpy) and AdaGrad's ``accum`` after
    ``step`` steps (None: the optimizer's initial state)."""
    with torch.no_grad():
        for layer, leaves in params.items():
            for name, value in leaves.items():
                trainer.parameters[layer][name].copy_(torch.tensor(value))
    trainer.opt_state = (trainer.optimizer.init(trainer.parameters)
                         if accum is None else
                         {"step": step, "slots": {"accum": tree_map(
                             torch.tensor, accum)}})


@pytest.mark.parametrize("use_hsigmoid", [True, False],
                         ids=["hsigmoid", "softmax"])
def test_word2vec_sgd_steps_match_jax(use_hsigmoid, tmp_path):
    """Two ``train_one_batch`` steps of the demo (AdaGrad lr 0.1) from the
    JAX trainer's weights: the losses and AdaGrad's ``accum`` after them.
    AdaGrad divides each entry's step by sqrt(accum) + 1e-6, so an entry
    whose gradient is near 1e-6 carries its gradient's float32 rounding
    into its step amplified up to lr / 1e-6 = 1e5 times (hsigmoid's
    w[17, 84]: a gradient of 1.37e-7 whose two sums differ by 1.2e-9
    moved 9.0e-5 apart in one step, 3.7e-4 of the leaf's largest entry),
    and the second step, at a loss of 21, carries such a difference into
    its neighbours' gradients.  So each step's parameters are held from
    one state: a port trainer holding JAX's parameters and accum before
    the step takes it, and its parameters are held where sqrt(accum) is
    at least 1e-2 of its leaf's largest (the rest through accum)."""
    start, batches, want, states = _jax_word2vec(use_hsigmoid)
    trainer, feeding = _word2vec_trainer(use_hsigmoid, start)
    assert sorted(trainer.parameters) == sorted(start)
    assert trainer.parameters["emb"]["w"].shape == (2073, 32)
    got = [float(trainer.train_one_batch(b, feeder=feeding))
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=TOL)
    _close(tree_leaves(trainer.opt_state["slots"]["accum"]),
           jax.tree_util.tree_leaves(states[-1][1]))
    before = [(start, None)] + states[:-1]
    one, _ = _word2vec_trainer(use_hsigmoid, start)
    for i, ((params, accum), (jparams, jaccum)) in enumerate(
            zip(before, states)):
        _set_state(one, params, accum, i)
        loss = float(one.train_one_batch(batches[i], feeder=feeding))
        np.testing.assert_allclose(loss, want[i], rtol=TOL)
        scale = [np.sqrt(a) for a in jax.tree_util.tree_leaves(jaccum)]
        _close(tree_leaves(one.parameters),
               jax.tree_util.tree_leaves(jparams),
               where=[r >= 1e-2 * r.max() for r in scale])
    # the shared table round-trips through a checkpoint
    trainer.save(str(tmp_path), pass_id=0)
    params, _, _, _ = load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(
        params["emb"]["w"], trainer.parameters["emb"]["w"].detach().numpy())
    _set_state(one, start, None, 0)
    one.load(str(tmp_path))
    for a, b in zip(tree_leaves(one.parameters),
                    tree_leaves(trainer.parameters)):
        assert torch.equal(a, b)
    assert one.opt_state["step"] == 2
    assert torch.equal(one.opt_state["slots"]["accum"]["emb"]["w"],
                       trainer.opt_state["slots"]["accum"]["emb"]["w"])


def test_word2vec_cli_trains_both_variants(tmp_path):
    """``python -m paddle_tpu_torch train --config
    paddle_tpu_torch/models/word2vec_dsl.py`` at the demo's widths (vocab
    2073, batch 64), hsigmoid by default and softmax with
    ``use_hsigmoid=0``."""
    path = os.path.join(ROOT, "paddle_tpu_torch", "models",
                        "word2vec_dsl.py")
    for args, out_key in (("batches=2", "__hsigmoid_0__"),
                          ("use_hsigmoid=0,batches=2", "__fc_1__")):
        save = tmp_path / args.replace(",", "_").replace("=", "")
        assert cli.main(["train", "--config", path, "--config_args", args,
                         "--device", "cpu", "--save_dir", str(save)]) == 0
        meta = json.loads((save / "pass-00000" / "meta.json").read_text())
        assert meta["pass_id"] == 0
        params, opt_state, _, _ = load_checkpoint(str(save))
        assert int(opt_state["step"]) == 2
        assert params["emb"]["w"].shape == (2073, 32)
        assert out_key in params and "accum" in opt_state["slots"]


# ------------------------------------------------------------ seqToseq

H, SEQ_BATCH = 128, 8
# the readout's scale in the generate case (tests/test_torch_seq2seq.py's
# greedy case scales it too): after two steps from a random init the
# unscaled search comes within BEAM_MARGIN of a tie at its first step
READOUT = 8.0


@functools.lru_cache(maxsize=None)
def _jax_seqtoseq():
    """JAX's side of the demo at hidden 128: init, the first two batches
    of the demo's reader, and two Adam steps through B10's route
    (forced, in interpret mode)."""
    demo = _demo("seqToseq")
    # jitted: one compile in place of one for each op of the init
    params = jax.jit(functools.partial(
        jax_seq2seq.init, src_vocab=jax_wmt14.SRC_DICT_SIZE,
        trg_vocab=jax_wmt14.TRG_DICT_SIZE, emb_dim=H, hidden=H))(
            jax.random.PRNGKey(0))
    start = jax.tree_util.tree_map(np.asarray, params)
    batches = list(itertools.islice(demo.make_batches(SEQ_BATCH)(), 2))
    opt = jax_optim.Adam(learning_rate=5e-4, clip_norm=5.0)
    state = opt.init(params)

    @jax.jit
    def step(params, state, src, trg_in, trg_next):
        loss, grads = jax.value_and_grad(jax_seq2seq.loss)(
            params, src, trg_in, trg_next)
        params, state = opt.update(grads, state, params)
        return params, state, loss

    # both batches padded to one width, so that the step traces once
    feeds = [demo.feed_batch(b) for b in batches]
    width = max(s.data.shape[1] for f in feeds for s in f)
    feeds = [[JaxSeq(jnp.pad(s.data, ((0, 0), (0, width - s.data.shape[1]))),
                     s.lengths) for s in f] for f in feeds]
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always"
    try:
        losses = []
        for f in feeds:
            params, state, loss = step(params, state, *f)
            losses.append(float(loss))
    finally:
        jax_rnn.FUSED_LSTM = prior
    assert step._cache_size() == 1
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return start, batches, losses, host(params), host(state["slots"])


def test_seqtoseq_demo_adam_steps_match_jax():
    start, batches, want, jparams, jslots = _jax_seqtoseq()
    assert batches == list(itertools.islice(
        seqtoseq_demo.make_batches(SEQ_BATCH)(), 2))
    params, opt_state, step = seqtoseq_demo.setup(H, H, "cpu", params=start)
    got = [float(step(*seqtoseq_demo.feed_batch(b, "cpu")))
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=TOL)
    jm = jax.tree_util.tree_leaves(jslots["m"])
    jv = jax.tree_util.tree_leaves(jslots["v"])
    _close(tree_leaves(opt_state["slots"]["m"])
           + tree_leaves(opt_state["slots"]["v"]), jm + jv)
    scale = [np.sqrt(v) for v in jv]
    _close(tree_leaves(params), jax.tree_util.tree_leaves(jparams),
           where=[r >= 1e-2 * r.max() for r in scale])


def test_seqtoseq_demo_generate_matches_jax():
    """Beam generate (beam 5) on the first 2 wmt14 test sources with the
    parameters after the two steps (JAX's, the readout scaled by
    READOUT): the port's 40-step search gives the first step at which
    either row's K-th and (K+1)-th candidates come within BEAM_MARGIN;
    both packages' searches cut there must give equal tokens and lengths
    and scores within SCORE_RTOL."""
    tree = dict(_jax_seqtoseq()[3])
    tree["out2"] = {"w": tree["out2"]["w"] * READOUT, "b": tree["out2"]["b"]}
    params = seq2seq.params_from_numpy(tree, "cpu")
    batch = list(itertools.islice(wmt14.test()(), 2))
    src, _, _ = seqtoseq_demo.feed_batch(batch, "cpu")
    kw = dict(beam_size=5, bos_id=wmt14.START, eos_id=wmt14.END)
    trace = []
    seq2seq.generate(params, src, max_len=40, trace=trace, **kw)
    near = np.stack([s["gap"].numpy() for s in trace]) < BEAM_MARGIN
    cut = int(near.any(axis=1).argmax()) if near.any() else len(trace)
    assert cut >= 8, cut
    got = seq2seq.generate(params, src, max_len=cut, **kw)
    jsrc, _, _ = _demo("seqToseq").feed_batch(batch)
    want = jax.jit(functools.partial(jax_seq2seq.generate, max_len=cut,
                                     **kw))(
        jax.tree_util.tree_map(jnp.asarray, tree), jsrc)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=SCORE_RTOL)


def test_entry_points_run_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    from paddle_tpu_torch.scripts import bench
    batch = next(seqtoseq_demo.make_batches(8)())
    for call in (lambda: seqtoseq_demo.setup(),
                 lambda: seqtoseq_demo.feed_batch(batch),
                 lambda: seqtoseq_demo.train(0, str(tmp_path)),
                 lambda: seqtoseq_demo.generate(str(tmp_path)),
                 lambda: bench.bench_seqtoseq_demo(),
                 lambda: SGD(word2vec_dsl.build()[0],
                             update_equation=word2vec_dsl.optimizer())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
