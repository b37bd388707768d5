"""The MovieLens recommender (``paddle_tpu_torch/models/recommendation``,
``data/datasets/movielens``) against the JAX package and
``demo/recommendation/train.py`` on the CPU: the loader's samples for
both splits element for element; JAX's init carried across by
``params_from_numpy``; the forward, the loss and every gradient leaf at
embedding width 16 on a batch of the loader's samples fed by each
package's ``feed_batch``; three steps of the demo's Adam step.

Tolerances: float32 on both sides in other summation orders -- the
predictions and the loss at 1e-5 absolute and relative (TOL), each
gradient leaf and each parameter after the steps within 1e-5 of its
largest entry (LEAF_TOL).
"""

import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.data.datasets import movielens as jax_movielens
from paddle_tpu.models import recommendation as jax_rec
from paddle_tpu_torch import optim
from paddle_tpu_torch.data import reader
from paddle_tpu_torch.data.datasets import movielens
from paddle_tpu_torch.models import recommendation
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

TOL = 1e-5
LEAF_TOL = 1e-5
EMB = HIDDEN = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("split", ["train", "test"])
def test_movielens_slots_equal_jax(split):
    """The synthetic fallback's 8 slots (uid, gender, age, job, mid,
    category ids, title ids, score), sample by sample."""
    mine, theirs = getattr(movielens, split)(), getattr(jax_movielens,
                                                        split)()
    n = 0
    for got, want in zip(mine(), theirs()):
        assert len(got) == 8
        assert got[:5] == want[:5] and got[7] == want[7]
        np.testing.assert_array_equal(got[5], want[5])
        np.testing.assert_array_equal(got[6], want[6])
        n += 1
    assert n == {"train": 4096, "test": 512}[split]
    for name in ("MAX_USER", "MAX_MOVIE", "AGES", "JOBS", "CATEGORIES",
                 "TITLE_DIM"):
        assert getattr(movielens, name) == getattr(jax_movielens, name)


def _demo():
    spec = importlib.util.spec_from_file_location(
        "recommendation_train", os.path.join(ROOT, "demo", "recommendation",
                                             "train.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


@pytest.fixture(scope="module")
def case():
    """JAX's init at width 16 as numpy, and two batches of 16 train
    samples fed by the demo's ``feed_batch`` (JAX) and the port's."""
    jp = jax.tree_util.tree_map(
        np.asarray, jax_rec.init(jax.random.PRNGKey(3), emb=EMB,
                                 hidden=HIDDEN))
    batches = list(reader.firstn(reader.batch(movielens.train(), 16), 2)())
    demo = _demo()
    return {"jp": jp,
            "jfeeds": [demo.feed_batch(b) for b in batches],
            "feeds": [recommendation.feed_batch(b, device="cpu")
                      for b in batches]}


def test_feed_batch_matches_the_demo(case):
    for jf, tf in zip(case["jfeeds"], case["feeds"]):
        for j, t in zip(jf[:6] + jf[7:], tf[:6] + tf[7:]):
            assert t.dtype == torch.float32 or t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(tf[6].data.numpy(),
                                      np.asarray(jf[6].data))
        np.testing.assert_array_equal(tf[6].lengths.numpy(),
                                      np.asarray(jf[6].lengths))


def test_params_from_numpy_carries_the_jax_init(case):
    tp = recommendation.params_from_numpy(case["jp"], "cpu", emb=EMB,
                                          hidden=HIDDEN)
    for got, want in zip(tree_leaves(tp),
                         jax.tree_util.tree_leaves(case["jp"])):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not fit"):
        recommendation.params_from_numpy(case["jp"], "cpu")
    # the port's init draws the JAX init's shapes at the JAX defaults
    full = recommendation.init(torch.Generator().manual_seed(0),
                               device="cpu")
    assert full["user_emb"].shape == (6041, 256)
    assert full["movie_emb"].shape == (3953, 256)
    assert full["title_emb"].shape == (5174, 128)
    assert full["movie_fc"]["w"].shape == (448, 256)


def _port_params(jp):
    p = recommendation.params_from_numpy(jp, "cpu", emb=EMB, hidden=HIDDEN)
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    return p


def _leaves_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert np.abs(g - w).max() <= LEAF_TOL * np.abs(w).max(), \
            np.abs(g - w).max() / np.abs(w).max()


def test_forward_loss_and_grads_match_jax(case):
    jp, jf, tf = case["jp"], case["jfeeds"][0], case["feeds"][0]
    tp = _port_params(jp)
    np.testing.assert_allclose(
        recommendation.forward(tp, *tf[:7]).detach().numpy(),
        np.asarray(jax_rec.forward(jp, *jf[:7])), rtol=TOL, atol=TOL)
    jl, jg = jax.value_and_grad(jax_rec.loss)(jp, *jf)
    loss = recommendation.loss(tp, *tf)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    loss.backward()
    _leaves_close([p.grad for p in tree_leaves(tp)],
                  jax.tree_util.tree_leaves(jg))


def test_demo_adam_steps_match_jax(case):
    """Three steps of the demo's step (value_and_grad of the loss, Adam
    lr 1e-3) from the same weights, on the two batches in turn."""
    jopt = jax_optim.Adam(learning_rate=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, case["jp"])
    jstate = jopt.init(jp)

    @jax.jit
    def step(params, opt_state, *feed):
        loss, grads = jax.value_and_grad(jax_rec.loss)(params, *feed)
        params, opt_state = jopt.update(grads, opt_state, params)
        return params, opt_state, loss

    opt = optim.Adam(learning_rate=1e-3)
    tp = _port_params(case["jp"])
    state = opt.init(tp)
    for i in range(3):
        jp, jstate, jl = step(jp, jstate, *case["jfeeds"][i % 2])
        for p in tree_leaves(tp):
            p.grad = None
        loss = recommendation.loss(tp, *case["feeds"][i % 2])
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, tp), state, tp)
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=TOL)
    _leaves_close(tree_leaves(tp), jax.tree_util.tree_leaves(jp))
