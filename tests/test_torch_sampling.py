"""The port's sampled losses (``ops/sampling.py``, ``nce_layer``,
``hsigmoid``) and the optimizers beyond Momentum and Adam
(``optim/optimizers.py``: AdaGrad, AdaDelta, RMSProp, DecayedAdaGrad,
AdaMax and ``get``) against the JAX package's on the CPU.

- ``nce_loss`` on shared draws (the same negative ids on both sides),
  uniform and with a noise distribution: the loss and its gradients with
  respect to x, w and b.
- ``nce_layer`` in a graph: the port's own draws (its ``Context.uniform``)
  recorded and fed to JAX's ``nce_loss`` on JAX's init; the parameter
  gradients too.  The draws themselves are held by frequency.
- ``_bit_codes`` at V 2073 (code length 12) and V 16 (a power of two);
  ``hsigmoid_loss`` and the ``hsigmoid`` layer; a label whose path has
  no valid node (label 0) costs 0 and gives row 0 no gradient.
- ``top_k`` (ties lowest id first); the distributions of
  ``uniform_neg_samples`` and ``multinomial_alias_sample``.
- Each optimizer over three steps on one tree against JAX's, with and
  without ``clip_norm`` / ``l2``; ``optim.get`` by name.

Tolerances: losses and gradients within 1e-5 of their largest entry;
parameters and slots after three steps within 1e-4 of their largest
entry (as tests/test_torch_trainer.py holds its steps); draws within 5
binomial standard deviations of each probability.
"""

import contextlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.ops import sampling as jax_sampling
import paddle_tpu.layers as JL
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.layers import graph
from paddle_tpu_torch.ops import sampling
from tests.test_torch_elementwise import check_layer, close

TOL = 1e-5
STEP_TOL = 1e-4
B, D, V, K = 6, 8, 50, 5


def _arrays():
    r = np.random.RandomState(11)
    f = np.float32
    return {"x": r.randn(B, D).astype(f), "w": r.randn(V, D).astype(f),
            "b": r.randn(V).astype(f),
            "labels": r.randint(0, V, (B,)).astype(np.int32),
            "neg": r.randint(0, V, (B, K)).astype(np.int32),
            "probs": r.dirichlet(np.ones(V)).astype(f),
            "cot": r.randn(B).astype(f)}


@contextlib.contextmanager
def _recording(drawn):
    """Within it, every ``Context.uniform`` draw is appended to
    ``drawn``."""
    plain = graph.Context.uniform

    def record(ctx, shape, device):
        drawn.append(plain(ctx, shape, device))
        return drawn[-1]

    graph.Context.uniform = record
    try:
        yield
    finally:
        graph.Context.uniform = plain


def _uniform_ids(u, n):
    """The ids ``nce_layer`` makes of its draws: floor(u * n) in float32,
    at most n - 1."""
    return np.minimum(np.floor(u.numpy() * np.float32(n)),
                      n - 1).astype(np.int32)


def _loss_and_grads(jfn, tfn, a, keys):
    """(port, JAX) loss and gradients of sum(loss * cot) w.r.t. keys
    (JAX's under one jit: one compile in place of one an op)."""
    @jax.jit
    def jax_side(*xs):
        return jfn(*xs), jax.grad(lambda *xs: jnp.sum(jfn(*xs) * a["cot"]),
                                  argnums=(0, 1, 2))(*xs)

    want, jg = jax_side(*(jnp.asarray(a[k]) for k in keys))
    ts = [torch.tensor(a[k]).requires_grad_(True) for k in keys]
    got = tfn(*ts)
    (got * torch.tensor(a["cot"])).sum().backward()
    close(got.detach().numpy(), want, TOL, "loss")
    for t, g, k in zip(ts, jg, keys):
        close(t.grad.numpy(), g, TOL, f"d{k}")


@pytest.mark.parametrize("noise", ["uniform", "probs"])
def test_nce_loss_on_shared_draws_matches_jax(noise):
    a = _arrays()
    kw = {} if noise == "uniform" else {"sample_probs": a["probs"]}

    def jfn(x, w, b):
        return jax_sampling.nce_loss(
            x, w, b, jnp.asarray(a["labels"]), jnp.asarray(a["neg"]), V,
            **{k: jnp.asarray(v) for k, v in kw.items()})

    def tfn(x, w, b):
        return sampling.nce_loss(
            x, w, b, torch.tensor(a["labels"]), torch.tensor(a["neg"]), V,
            **{k: torch.tensor(v) for k, v in kw.items()})

    _loss_and_grads(jfn, tfn, a, ("x", "w", "b"))


def test_nce_layer_on_its_own_draws_matches_jax():
    """The layer's negatives come from the apply's generator; recorded,
    they give JAX's ``nce_loss`` on JAX's init the layer's loss and its
    parameters' gradients."""
    a = _arrays()

    def build(M):
        x = M.data_layer("x", size=D)
        return M.nce_layer(M.fc_layer(x, size=D, act="tanh"),
                           M.data_layer("label", size=1), num_classes=V,
                           num_neg_samples=K)

    jax_reset_names()
    jtopo = JL.Topology(build(JL))
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(jtopo.init)(
        jax.random.PRNGKey(0)))
    L.reset_names()
    topo = L.Topology(build(L))
    params = L.params_from_numpy(topo, tree, "cpu")
    for p in params.values():
        for t in p.values():
            t.requires_grad_(True)
    drawn = []
    with _recording(drawn):
        got = topo.apply(params, {"x": torch.tensor(a["x"]),
                                  "label": torch.tensor(a["labels"])},
                         generator=torch.Generator().manual_seed(5))
    assert len(drawn) == 1 and tuple(drawn[0].shape) == (B, K)
    neg = jnp.asarray(_uniform_ids(drawn[0], V))
    fc, nce = sorted(tree)

    def jloss(p):
        h = jnp.tanh(jnp.asarray(a["x"]) @ p[fc]["w0"] + p[fc]["b"])
        return jax_sampling.nce_loss(h, p[nce]["w"], p[nce]["b"],
                                     jnp.asarray(a["labels"]), neg, V)

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want, jg = jax.jit(lambda p: (jloss(p), jax.grad(
        lambda p: jnp.sum(jloss(p) * a["cot"]))(p)))(jp)
    close(got.detach().numpy(), want, TOL, "loss")
    (got * torch.tensor(a["cot"])).sum().backward()
    for k in tree:
        for n in tree[k]:
            close(params[k][n].grad.numpy(), jg[k][n], TOL, f"d {k}/{n}")


def test_nce_layer_draws_are_uniform():
    n = 20000
    L.reset_names()
    topo = L.Topology(L.nce_layer(L.data_layer("x", size=D),
                                  L.data_layer("label", size=1),
                                  num_classes=V, num_neg_samples=n))
    params = topo.init(torch.Generator().manual_seed(0), device="cpu")
    drawn = []
    with _recording(drawn):
        topo.apply(params, {"x": torch.zeros(1, D),
                            "label": torch.zeros(1, dtype=torch.int32)},
                   generator=torch.Generator().manual_seed(1))
    ids = _uniform_ids(drawn[0], V).reshape(-1)
    share = np.bincount(ids, minlength=V) / n
    p = 1.0 / V
    assert ids.max() < V and (np.abs(share - p)
                              <= 5 * np.sqrt(p * (1 - p) / n)).all()


@pytest.mark.parametrize("v, code_len", [(2073, 12), (16, 4)])
def test_bit_codes_match_jax(v, code_len):
    labels = np.arange(v, dtype=np.int32)
    got = sampling._bit_codes(torch.tensor(labels), code_len)
    want = jax_sampling._bit_codes(jnp.asarray(labels), code_len)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nodes, _, valid = (x.numpy() for x in got)
    # every valid node is an internal node of the V - 1
    assert nodes.max() <= v - 2 and valid[:, 0].sum() == v - 1


@pytest.mark.parametrize("v", [2073, 16])
def test_hsigmoid_loss_matches_jax(v):
    r = np.random.RandomState(12)
    a = {"x": r.randn(B, D).astype(np.float32),
         "w": r.randn(v - 1, D).astype(np.float32),
         "b": r.randn(v - 1).astype(np.float32),
         "cot": r.randn(B).astype(np.float32)}
    labels = np.array([0, 1, v - 1, v // 2, 3, v - 2], np.int32)

    def jfn(x, w, b):
        return jax_sampling.hsigmoid_loss(x, w, b, jnp.asarray(labels), v)

    def tfn(x, w, b):
        return sampling.hsigmoid_loss(x, w, b, torch.tensor(labels), v)

    _loss_and_grads(jfn, tfn, a, ("x", "w", "b"))


def test_hsigmoid_invalid_nodes_give_row_0_no_gradient():
    """Label 0's path has no valid node: its cost is 0 and every node it
    clamps to row 0 adds nothing to row 0's gradient."""
    r = np.random.RandomState(13)
    w = torch.tensor(r.randn(15, D).astype(np.float32), requires_grad=True)
    b = torch.tensor(r.randn(15).astype(np.float32), requires_grad=True)
    x = torch.tensor(r.randn(3, D).astype(np.float32))
    loss = sampling.hsigmoid_loss(x, w, b, torch.zeros(3, dtype=torch.int32),
                                  16)
    assert not loss.detach().any()
    loss.sum().backward()
    assert not w.grad.any() and not b.grad.any()


def test_hsigmoid_layer_matches_jax():
    r = np.random.RandomState(14)
    feed = {"x": r.randn(B, D).astype(np.float32),
            "label": r.randint(0, 40, (B, 1)).astype(np.int32)}

    def build(M):
        h = M.fc_layer(M.data_layer("x", size=D), size=D, act="sigmoid")
        return M.hsigmoid(h, M.data_layer("label", size=1), num_classes=40)

    check_layer(build, feed)


def test_top_k_matches_jax():
    r = np.random.RandomState(15)
    x = r.randn(4, 9).astype(np.float32)
    x[1, 6] = x[1, 2] = x[1].max() + 1.0      # a tie: the lower id first
    got = sampling.top_k(torch.tensor(x), 3)
    want = jax_sampling.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32 and got[1][1, 0] == 2


def test_draws_follow_their_distributions():
    gen = torch.Generator().manual_seed(4)
    n = 20000
    ids = sampling.uniform_neg_samples(gen, (n // 4, 4), 7)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (n // 4, 4)
    share = np.bincount(ids.numpy().reshape(-1), minlength=7) / n
    assert (np.abs(share - 1 / 7) <= 5 * np.sqrt(1 / 7 * 6 / 7 / n)).all()
    probs = np.array([0.5, 0.0, 0.2, 0.3], np.float32)
    draws = sampling.multinomial_alias_sample(gen, torch.tensor(probs),
                                              (n // 2, 2))
    assert draws.dtype == torch.int32 and tuple(draws.shape) == (n // 2, 2)
    share = np.bincount(draws.numpy().reshape(-1), minlength=4) / n
    assert (np.abs(share - probs)
            <= 5 * np.sqrt(probs * (1 - probs) / n)).all()
    # per-row distributions broadcast over the trailing dims, as JAX's
    rows = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    got = sampling.multinomial_alias_sample(gen, rows, (5, 3))
    assert got.tolist() == [[0, 1, 0]] * 5


# ------------------------------------------------------------ optimizers

OPTIMIZERS = {
    "AdaGrad": {"learning_rate": 0.1},
    "AdaDelta": {"learning_rate": 1.0, "rho": 0.9},
    "RMSProp": {"learning_rate": 0.01, "rho": 0.9},
    "DecayedAdaGrad": {"learning_rate": 0.05, "rho": 0.9},
    "AdaMax": {"learning_rate": 0.01},
}


def _tree():
    r = np.random.RandomState(16)
    f = np.float32
    return ({"fc": {"w": r.randn(4, 3).astype(f), "b": r.randn(3).astype(f)},
             "emb": {"w": r.randn(5, 2).astype(f)}},
            [{"fc": {"w": r.randn(4, 3).astype(f) * s,
                     "b": r.randn(3).astype(f) * s},
              "emb": {"w": r.randn(5, 2).astype(f) * s}}
             for s in (1.0, 3.0, 0.5)])


@pytest.mark.parametrize("decorated", [False, True], ids=["plain",
                                                          "clip_norm_l2"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_three_steps_match_jax(name, decorated):
    kw = dict(OPTIMIZERS[name])
    if decorated:
        kw.update(clip_norm=1.0, l2=1e-2)
    start, grads = _tree()
    jopt = getattr(jax_optim, name)(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, start)
    js = jopt.init(jp)
    topt = getattr(optim, name)(**kw)
    tp = jax.tree_util.tree_map(torch.tensor, start)
    ts = topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for g in grads:
        jp, js = jupdate(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(jax.tree_util.tree_map(torch.tensor, g), ts, tp)
    assert ts["step"] == int(js["step"]) == 3
    for got, want in zip(
            jax.tree_util.tree_leaves(tp) + jax.tree_util.tree_leaves(
                ts["slots"]),
            jax.tree_util.tree_leaves(jp) + jax.tree_util.tree_leaves(
                js["slots"])):
        close(got.numpy(), want, STEP_TOL)
    assert sorted(ts["slots"]) == sorted(js["slots"])


@pytest.mark.parametrize("name", ["momentum", "sgd", "adagrad", "adadelta",
                                  "rmsprop", "decayed_adagrad", "adam",
                                  "adamax"])
def test_optim_get_matches_jax(name):
    """``get`` builds the optimizer JAX's builds (case-insensitive): one
    step from the same tree gives the same parameters."""
    start, grads = _tree()
    jopt = jax_optim.get(name.upper(), learning_rate=0.05)
    jp, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads[0]),
                        jopt.init(jax.tree_util.tree_map(jnp.asarray, start)),
                        jax.tree_util.tree_map(jnp.asarray, start))
    topt = optim.get(name.upper(), learning_rate=0.05)
    tp = jax.tree_util.tree_map(torch.tensor, start)
    tp, _ = topt.update(jax.tree_util.tree_map(torch.tensor, grads[0]),
                        topt.init(tp), tp)
    for got, want in zip(jax.tree_util.tree_leaves(tp),
                         jax.tree_util.tree_leaves(jp)):
        close(got.numpy(), want, STEP_TOL)
    with pytest.raises(KeyError, match="unknown optimizer"):
        optim.get("lbfgs")
