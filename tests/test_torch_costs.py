"""The port's cost zoo against the JAX package's on the CPU: every loss
of ``ops/losses.py`` and every cost layer of ``layers/api.py``.

- Each loss function on inputs from a numpy seed: the per-sample loss,
  and the gradient of the sum of the losses times a seeded cotangent
  with respect to the prediction (and, for the pairwise and ranking
  costs, both scores).
- Each cost layer, built with both DSLs over fc layers (dense rows and
  ragged sequences), on JAX's init carried across
  (``params_from_numpy``): the per-sample cost and every parameter's
  gradient of its mean; weighted where the JAX layer takes a weight
  (``classification_cost``, ``regression_cost``, ``rank_cost``).

Tolerances: float32 on both sides in other summation orders: losses
within 1e-5 of their largest entry (TOL), each gradient leaf within 1e-5
of its largest entry (GRAD_TOL).  A leaf whose true gradient is 0 (the
score layer's bias under ``lambda_cost``, whose scores enter only as
pairwise differences) reads float32 rounding on both sides (~1e-8): it
is held to at most NOISE on each side instead.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.ops import losses as jax_losses
import paddle_tpu.layers as JL
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import losses
from paddle_tpu_torch.utils.tree import tree_leaves

TOL = 1e-5
GRAD_TOL = 1e-5
NOISE = 1e-6
B, T, D = 6, 7, 5
LENGTHS = np.array([7, 1, 4, 6, 2, 5], np.int32)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), \
        (what, np.abs(got - want).max(), np.abs(want).max())


# ------------------------------------------------------------ the ops

def _op_inputs():
    r = np.random.RandomState(0)
    f = np.float32
    rel = r.randint(0, 4, (B, T)).astype(f)
    mask = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(f)
    return {
        "pred": r.randn(B, D).astype(f),
        "label": r.randn(B, D).astype(f),
        "big": (3 * r.randn(B, D)).astype(f),
        "ids": r.randint(0, D, (B,)).astype(np.int32),
        "probs": r.uniform(0.02, 0.98, (B, D)).astype(f),
        "soft": r.uniform(0, 1, (B, D)).astype(f),
        "hot": (r.uniform(0, 1, (B, D)) < 0.4).astype(f),
        "p1": r.uniform(0.05, 0.95, (B, 1)).astype(f),
        "y01": r.randint(0, 2, (B,)).astype(f),
        "left": r.randn(B, 1).astype(f),
        "right": r.randn(B, 1).astype(f),
        "rank_label": r.choice([0.0, 0.5, 1.0], (B, 1)).astype(f),
        "weight": r.uniform(0.5, 2, (B, 1)).astype(f),
        "scores": r.randn(B, T).astype(f),
        "rel": rel, "mask": mask,
        "x3": r.randn(B, 3, 4).astype(f),
        "cot": r.randn(B).astype(f),
    }


# name -> (function name, argument keys, keys differentiated, kwargs)
OPS = {
    "square_error": ("square_error", ("pred", "label"), ("pred",), {}),
    "cross_entropy_with_selfnorm": ("cross_entropy_with_selfnorm",
                                    ("big", "ids"), ("big",),
                                    {"alpha": 0.3}),
    "soft_binary_class_cross_entropy": ("soft_binary_class_cross_entropy",
                                        ("probs", "soft"), ("probs",), {}),
    "multi_binary_label_cross_entropy": ("multi_binary_label_cross_entropy",
                                         ("big", "hot"), ("big",), {}),
    "binary_classification_cost": ("binary_classification_cost",
                                   ("p1", "y01"), ("p1",), {}),
    "rank_cost": ("rank_cost", ("left", "right", "rank_label"),
                  ("left", "right"), {}),
    "rank_cost_weighted": ("rank_cost", ("left", "right", "rank_label",
                                         "weight"), ("left", "right"), {}),
    "lambda_cost": ("lambda_cost", ("scores", "rel", "mask"), ("scores",),
                    {"ndcg_num": 3}),
    "huber_regression": ("huber_regression", ("big", "label"), ("big",),
                         {"delta": 1.5}),
    "huber_classification": ("huber_classification", ("left", "y01"),
                             ("left",), {}),
    "smooth_l1": ("smooth_l1", ("big", "label"), ("big",), {}),
    "sum_cost": ("sum_cost", ("x3",), ("x3",), {}),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_loss_op_and_gradient_match_jax(case):
    fname, keys, diff, kw = OPS[case]
    arrays = _op_inputs()
    cot = arrays["cot"]
    jfn, tfn = getattr(jax_losses, fname), getattr(losses, fname)

    def jloss(*dargs):
        args = {k: jnp.asarray(arrays[k]) for k in keys}
        args.update(zip(diff, dargs))
        return jfn(*(args[k] for k in keys), **kw)

    want = jloss(*(jnp.asarray(arrays[k]) for k in diff))
    want_grads = jax.grad(lambda *a: jnp.sum(jloss(*a) * cot),
                          argnums=tuple(range(len(diff))))(
        *(jnp.asarray(arrays[k]) for k in diff))
    targs = {k: torch.tensor(arrays[k]) for k in keys}
    for k in diff:
        targs[k].requires_grad_(True)
    got = tfn(*(targs[k] for k in keys), **kw)
    _close(got.detach().numpy(), want, TOL, case)
    (got * torch.tensor(cot)).sum().backward()
    for k, g in zip(diff, want_grads):
        _close(targs[k].grad.numpy(), g, GRAD_TOL, f"{case} d{k}")


def test_masked_seq_mean_matches_jax():
    a = _op_inputs()
    _close(losses.masked_seq_mean(torch.tensor(a["scores"]),
                                  torch.tensor(a["mask"])).numpy(),
           jax_losses.masked_seq_mean(jnp.asarray(a["scores"]),
                                      jnp.asarray(a["mask"])), TOL)


# ------------------------------------------------------------ the layers

def _x(M):
    return M.data_layer("x", size=D)


def _xs(M):
    return M.data_layer("xs", size=D, is_seq=True)


def _label(M):
    return M.data_layer("label", size=1)


def _softmax(M):
    return M.fc_layer(_x(M), size=4, act="softmax")


def _weight(M):
    return M.data_layer("w", size=1)


# name -> the cost in DSL module M
LAYERS = {
    "classification_cost": lambda M: M.classification_cost(_softmax(M),
                                                           _label(M)),
    "classification_cost_weighted": lambda M: M.classification_cost(
        _softmax(M), _label(M), weight=_weight(M)),
    "cross_entropy": lambda M: M.cross_entropy(_softmax(M), _label(M)),
    "regression_cost": lambda M: M.regression_cost(
        M.fc_layer(_x(M), size=3, act=None), M.data_layer("y", size=3)),
    "regression_cost_weighted": lambda M: M.regression_cost(
        M.fc_layer(_x(M), size=3, act=None), M.data_layer("y", size=3),
        weight=_weight(M)),
    "regression_cost_seq": lambda M: M.regression_cost(
        M.fc_layer(_xs(M), size=3, act="tanh"),
        M.data_layer("ys", size=3, is_seq=True)),
    "mse_cost": lambda M: M.mse_cost(M.fc_layer(_x(M), size=3, act=None),
                                     M.data_layer("y", size=3)),
    "cross_entropy_with_selfnorm": lambda M: M.cross_entropy_with_selfnorm(
        M.fc_layer(_x(M), size=4, act=None), _label(M), alpha=0.2),
    "soft_binary_class_cross_entropy":
        lambda M: M.soft_binary_class_cross_entropy(
            M.fc_layer(_x(M), size=3, act="sigmoid"),
            M.data_layer("y", size=3)),
    "multi_binary_label_cross_entropy":
        lambda M: M.multi_binary_label_cross_entropy(
            M.fc_layer(_x(M), size=3, act=None), M.data_layer("hot", size=3)),
    "rank_cost": lambda M: M.rank_cost(
        M.fc_layer(_x(M), size=1, act=None),
        M.fc_layer(M.data_layer("x2", size=D), size=1, act=None),
        M.data_layer("rank", size=1)),
    "rank_cost_weighted": lambda M: M.rank_cost(
        M.fc_layer(_x(M), size=1, act=None),
        M.fc_layer(M.data_layer("x2", size=D), size=1, act=None),
        M.data_layer("rank", size=1), weight=_weight(M)),
    "lambda_cost": lambda M: M.lambda_cost(
        M.fc_layer(_xs(M), size=1, act=None),
        M.data_layer("rel", size=1, is_seq=True), NDCG_num=3),
    "huber_cost": lambda M: M.huber_cost(
        M.fc_layer(_x(M), size=1, act=None), M.data_layer("y01", size=1)),
    "smooth_l1_cost": lambda M: M.smooth_l1_cost(
        M.fc_layer(_x(M), size=3, act=None), M.data_layer("y", size=3)),
    "sum_cost": lambda M: M.sum_cost(M.fc_layer(_x(M), size=3,
                                                act="tanh")),
}


def _layer_feed():
    """numpy feed of every data layer above: arrays, or (data, lengths)
    for sequences."""
    r = np.random.RandomState(1)
    f = np.float32
    return {
        "x": r.randn(B, D).astype(f), "x2": r.randn(B, D).astype(f),
        "xs": (r.randn(B, T, D).astype(f), LENGTHS),
        "label": r.randint(0, 4, (B,)).astype(np.int32),
        "w": r.uniform(0.5, 2, (B, 1)).astype(f),
        "y": r.randn(B, 3).astype(f),
        "ys": (r.randn(B, T, 3).astype(f), LENGTHS),
        "hot": (r.uniform(0, 1, (B, 3)) < 0.4).astype(f),
        "rank": r.choice([0.0, 0.5, 1.0], (B, 1)).astype(f),
        "rel": (r.randint(0, 4, (B, T, 1)).astype(f), LENGTHS),
        "y01": r.randint(0, 2, (B, 1)).astype(f),
    }


def _feeds(feed, names):
    jf, tf = {}, {}
    for k in names:
        v = feed[k]
        if isinstance(v, tuple):
            jf[k] = JaxSeq(jnp.asarray(v[0]), jnp.asarray(v[1]))
            tf[k] = SequenceBatch(torch.tensor(v[0]), torch.tensor(v[1]))
        else:
            jf[k], tf[k] = jnp.asarray(v), torch.tensor(v)
    return jf, tf


def check_graph(build, feed, seed=0, tol=TOL, grad_tol=GRAD_TOL,
                mode="train", zero_grads=()):
    """``build(M)`` in both DSLs on JAX's init: the output and every
    parameter's gradient of its mean (the (key, name) leaves in
    ``zero_grads`` within NOISE of 0 on both sides).  Returns (port
    output, JAX output)."""
    jax_reset_names()
    jtopo = JL.Topology(build(JL))
    L.reset_names()
    ttopo = L.Topology(build(L))
    assert [n.name for n in ttopo.order] == [n.name for n in jtopo.order]
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(seed)))
    params = L.params_from_numpy(ttopo, tree, "cpu")
    jf, tf = _feeds(feed, ttopo.data_layers)

    def jout(p):
        v = jtopo.apply(p, jf, mode=mode)
        return v.data if isinstance(v, JaxSeq) else v

    want = jax.jit(jout)(jax.tree_util.tree_map(jnp.asarray, tree))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    got = ttopo.apply(params, tf, mode=mode)
    got = got.data if isinstance(got, SequenceBatch) else got
    _close(got.detach().numpy(), want, tol)
    if got.requires_grad:
        jg = jax.jit(jax.grad(lambda p: jnp.mean(jout(p))))(
            jax.tree_util.tree_map(jnp.asarray, tree))
        torch.mean(got).backward()
        for k in tree:
            for n in tree[k]:
                g, w = params[k][n].grad.numpy(), np.asarray(jg[k][n])
                if (k, n) in zero_grads:
                    assert max(np.abs(g).max(), np.abs(w).max()) <= NOISE
                else:
                    _close(g, w, grad_tol, f"{k}/{n}")
    return got.detach(), want


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_cost_layer_and_gradients_match_jax(case):
    zero = (("__fc_0__", "b"),) if case == "lambda_cost" else ()
    got, _ = check_graph(LAYERS[case], _layer_feed(), zero_grads=zero)
    assert got.shape == (B,)
