"""The four demos with no earlier port config -- traffic_prediction,
moe, gan and lm -- as the port's ``models/{traffic,moe,gan}_dsl.py`` and
``models/lm_demo.py`` against the demos' own files
(``demo/*/train*.py``, loaded with ``importlib`` on the JAX side) on the
CPU:

- each demo's data equals the port's element for element (traffic's
  sliding windows, moe's points, gan's ring batches, lm's packed rows);
- the loss and every gradient leaf from JAX's init carried across
  (``params_from_numpy``), at the demos' widths on a small batch;
- three optimizer steps: RMSProp through ``SGD`` for traffic, Adam
  through ``SGD`` for moe, the demo's alternating Adam steps for gan,
  Adam on the packed ``lm_loss`` for lm;
- traffic's 24 heads share one ``_link_vec.w`` leaf in both packages;
- lm's greedy ``lm_generate`` tokens equal JAX's up to the first top-1 /
  top-2 margin below MARGIN_TOL; the first sampled step's top-8 /
  temperature-0.7 distribution within 1e-5 of JAX's (the draws come from
  other generators, so sampled tokens are not compared).

Tolerances: float32 on both sides in other summation orders; losses at
TOL = 1e-5 relative, each gradient leaf within GRAD_TOL = 1e-5 of its
largest entry, parameters after three steps within STEP_TOL = 1e-4 of
each leaf's largest entry.  The JAX sides run under ``jax.jit``.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.data import DataFeeder as JaxFeeder
from paddle_tpu.data import reader as jax_reader
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.trainer import SGD as JaxSGD
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.data import DataFeeder
from paddle_tpu_torch.models import gan_dsl, lm_demo, moe_dsl, traffic_dsl
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.tree import tree_leaves

TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
MARGIN_TOL = 2e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _demo(name, file="train.py"):
    spec = importlib.util.spec_from_file_location(
        f"{name}_demo_a14", os.path.join(ROOT, "demo", name, file))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


def _jax_config(name):
    """The demo's ``get_config()`` with a fresh JAX layer-name registry
    (the demos do not reset it)."""
    jax_reset_names()
    return _demo(name).get_config()


def _close_leaves(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), \
            f"{what} leaf {i}: {err} of {float(np.abs(w).max())}"


def _jax_loss_and_grads(topo, tree, feed):
    """JAX's summed cost means and gradients under one jit."""
    def f(p):
        outs = topo.apply(p, feed, mode="train")
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.mean(o) for o in outs)
    value, grads = jax.jit(jax.value_and_grad(f))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return float(value), jax.tree_util.tree_leaves(grads)


def _port_loss_and_grads(topo, params, feed):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    outs = topo.apply(params, feed, mode="train")
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum(torch.mean(o) for o in outs)
    loss.backward()
    return float(loss.detach()), [p.grad for p in tree_leaves(params)]


def _dsl_check(jax_cost, port_cost, jax_feeding, port_feeding, batch,
               seed=1):
    """The loss and every gradient of one DSL graph from JAX's init."""
    jtopo = JL.Topology(jax_cost)
    ttopo = L.Topology(port_cost)
    assert [n.name for n in ttopo.order] == [n.name for n in jtopo.order]
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(seed)))
    params = L.params_from_numpy(ttopo, tree, "cpu")
    jl, jg = _jax_loss_and_grads(jtopo, tree,
                                 JaxFeeder(jax_feeding)(batch))
    tl, tg = _port_loss_and_grads(
        ttopo, params, DataFeeder(port_feeding, device="cpu")(batch))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    _close_leaves(tg, jg, GRAD_TOL, "gradient")
    return tree


def _sgd_steps(jax_cost, port_cost, jax_opt, port_opt, jax_feeding,
               port_feeding, batches):
    """Three SGD steps in both packages from JAX's weights: the losses
    and the parameters."""
    jt = JaxSGD(jax_cost, update_equation=jax_opt, seed=3)
    start = jax.tree_util.tree_map(np.asarray, jt.parameters)
    want = [float(jt.train_one_batch(b, feeder=jax_feeding))
            for b in batches]
    tr = SGD(port_cost, parameters=start, update_equation=port_opt,
             device="cpu")
    got = [float(tr.train_one_batch(b, feeder=port_feeding))
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=TOL)
    _close_leaves(tree_leaves(tr.parameters),
                  jax.tree_util.tree_leaves(jt.parameters), STEP_TOL,
                  "parameters after three steps")
    return tr, jt


# ------------------------------------------------------------ traffic

def test_traffic_samples_equal_the_demos():
    demo = _demo("traffic_prediction")
    n = 0
    for mine, theirs in zip(traffic_dsl.samples(), demo.samples()):
        assert mine == theirs
        n += 1
    assert n == sum(1 for _ in demo.samples()) == 24 * (400 - 48)
    assert (traffic_dsl.TERM_NUM, traffic_dsl.FORECASTING_NUM,
            traffic_dsl.LABEL_VALUE_NUM, traffic_dsl.EMB_SIZE) == (
        demo.TERM_NUM, demo.FORECASTING_NUM, demo.LABEL_VALUE_NUM,
        demo.EMB_SIZE)


def _traffic_batches(n, size=8):
    it = traffic_dsl.samples()
    rows = [next(it) for _ in range(n * size)]
    return [rows[i * size:(i + 1) * size] for i in range(n)]


def test_traffic_loss_grads_and_rmsprop_steps_match_jax():
    jcfg = _jax_config("traffic_prediction")
    costs, _ = traffic_dsl.build()
    tree = _dsl_check(jcfg["cost"], costs, jcfg["feeding"],
                      traffic_dsl.feeding(), _traffic_batches(1, 16)[0])
    # the 24 heads share ONE _link_vec.w leaf, in both packages
    ttopo = L.Topology(costs)
    params = ttopo.init(torch.Generator().manual_seed(0), device="cpu")
    for t in (tree, params):
        assert "_link_vec.w" in t
        links = [k for k in t if "link" in k]
        assert links == ["_link_vec.w"], links
        assert sorted(k for k in t if k.startswith("score_")) == sorted(
            f"score_{(i + 1) * 5}min" for i in range(24))
    jcfg = _jax_config("traffic_prediction")
    costs, _ = traffic_dsl.build()
    assert isinstance(jcfg["optimizer"], type(jax_optim.RMSProp(1e-3)))
    _sgd_steps(jcfg["cost"], costs, jax_optim.RMSProp(learning_rate=1e-3),
               traffic_dsl.optimizer(), jcfg["feeding"],
               traffic_dsl.feeding(), _traffic_batches(3))


# ------------------------------------------------------------ moe

def test_moe_points_equal_the_demos():
    demo = _demo("moe")
    mine = list(moe_dsl.samples()())
    theirs = list(demo._synthetic()())
    assert len(mine) == len(theirs) == moe_dsl.N_POINTS
    for (x, y), (jx, jy) in zip(mine, theirs):
        np.testing.assert_array_equal(x, jx)
        assert y == jy


def test_moe_loss_grads_adam_steps_and_accuracy_match_jax():
    jcfg = _jax_config("moe")
    cost, out = moe_dsl.build()
    batch = list(moe_dsl.samples()())[:16]
    tree = _dsl_check(jcfg["cost"], cost, jcfg["feeding"],
                      moe_dsl.feeding(), batch)
    # the demo's accuracy check on the same weights
    jprobs = np.asarray(JL.Topology([jcfg["output"]]).apply(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {"x": jnp.asarray(moe_dsl.points(512, seed=1)[0])}, mode="test"))
    want = float((jprobs.argmax(-1) == moe_dsl.points(512, seed=1)[1])
                 .mean())
    params = L.params_from_numpy(L.Topology([out]), tree, "cpu")
    assert moe_dsl.quadrant_accuracy(out, params) == want
    jcfg = _jax_config("moe")
    cost, _ = moe_dsl.build()
    rows = list(moe_dsl.samples()())
    _sgd_steps(jcfg["cost"], cost, jax_optim.Adam(learning_rate=0.01),
               moe_dsl.optimizer(), jcfg["feeding"], moe_dsl.feeding(),
               [rows[i * 16:(i + 1) * 16] for i in range(3)])


# ------------------------------------------------------------ gan

def test_gan_batches_equal_the_demos():
    demo = _demo("gan")
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(3):
        np.testing.assert_array_equal(gan_dsl.real_batch(a),
                                      demo.real_batch(b))


def _jax_gan(demo):
    """The demo's two networks on its init, with its two steps jitted as
    the demo writes them."""
    g_topo, d_topo, _, _ = demo.build()
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    gp, dp = g_topo.init(kg), d_topo.init(kd)
    g_opt = jax_optim.Adam(learning_rate=gan_dsl.LR)
    d_opt = jax_optim.Adam(learning_rate=gan_dsl.LR)
    eps = gan_dsl.EPS

    def d_score(dp, pts):
        return d_topo.apply(dp, {"pt": pts}, mode="test")

    def d_loss(dp, gp, z, real):
        fake = g_topo.apply(gp, {"z": z}, mode="test")
        return -jnp.mean(jnp.log(d_score(dp, real) + eps)
                         + jnp.log(1 - d_score(dp, fake) + eps))

    def g_loss(gp, dp, z):
        fake = g_topo.apply(gp, {"z": z}, mode="test")
        return -jnp.mean(jnp.log(d_score(dp, fake) + eps))

    @jax.jit
    def d_step(dp, ds, gp, z, real):
        l, g = jax.value_and_grad(d_loss)(dp, gp, z, real)
        dp, ds = d_opt.update(g, ds, dp)
        return dp, ds, l, g

    @jax.jit
    def g_step(gp, gs, dp, z):
        l, g = jax.value_and_grad(g_loss)(gp, dp, z)
        gp, gs = g_opt.update(g, gs, gp)
        return gp, gs, l, g

    return (gp, dp, g_opt.init(gp), d_opt.init(dp), d_step, g_step,
            jax.jit(d_loss), jax.jit(g_loss))


def test_gan_losses_grads_and_alternating_adam_steps_match_jax():
    demo = _demo("gan")
    gp, dp, gs, ds, d_step, g_step, _, _ = _jax_gan(demo)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    g_topo, d_topo, _, _ = gan_dsl.build()
    gan = gan_dsl.Gan(L.params_from_numpy(g_topo, to_np(gp), "cpu"),
                      L.params_from_numpy(d_topo, to_np(dp), "cpu"))
    rng_j, rng_t = np.random.RandomState(0), np.random.RandomState(0)
    for step in range(3):
        z = rng_j.randn(gan_dsl.BATCH, gan_dsl.Z).astype(np.float32)
        real = demo.real_batch(rng_j)
        # this step's gradients from the same weights, both networks
        zt, rt = torch.tensor(z), torch.tensor(real)
        from paddle_tpu_torch.utils.tree import value_and_grad
        tl, tg = value_and_grad(
            lambda p: gan.d_loss(p, gan.g_params, zt, rt), gan.d_params)
        dp, ds, jl, jg = d_step(dp, ds, gp, jnp.asarray(z),
                                jnp.asarray(real))
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
        _close_leaves(tree_leaves(tg), jax.tree_util.tree_leaves(jg),
                      GRAD_TOL, f"d gradient, step {step}")
        z2 = rng_j.randn(gan_dsl.BATCH, gan_dsl.Z).astype(np.float32)
        gp, gs, jgl, jgg = g_step(gp, gs, dp, jnp.asarray(z2))
        dl, gl = gan.step(rng_t)
        np.testing.assert_allclose(float(dl), float(jl), rtol=TOL)
        np.testing.assert_allclose(float(gl), float(jgl), rtol=TOL)
        _close_leaves(tree_leaves(gan.d_params),
                      jax.tree_util.tree_leaves(dp), STEP_TOL,
                      f"d params, step {step}")
        _close_leaves(tree_leaves(gan.g_params),
                      jax.tree_util.tree_leaves(gp), STEP_TOL,
                      f"g params, step {step}")
    # the end check's radii on the same draws
    z = np.random.RandomState(9).randn(256, gan_dsl.Z).astype(np.float32)
    want = np.asarray(g_topo_apply(demo, gp, z))
    got = gan.radii(np.random.RandomState(9))
    np.testing.assert_allclose(got, np.sqrt((want ** 2).sum(-1)), rtol=1e-4)


def g_topo_apply(demo, gp, z):
    g_topo = demo.build()[0]
    return jax.jit(lambda p, z: g_topo.apply(p, {"z": z}, mode="test"))(
        gp, jnp.asarray(z))


# ------------------------------------------------------------ lm

def test_lm_grammar_and_packed_rows_equal_the_demos():
    demo = _demo("lm", "train_and_sample.py")
    assert (lm_demo.VOCAB, lm_demo.CHARS, lm_demo.ENC) == (
        demo.VOCAB, demo.CHARS, demo.ENC)
    for a, b in zip(lm_demo.sentences(64), demo.sentences(64)):
        np.testing.assert_array_equal(a, b)
    theirs = jax_reader.batch(
        jax_reader.packed(lambda: demo.sentences(512), 24, buffer_size=64),
        16, drop_last=True)
    n = 0
    for mine, want in zip(lm_demo.packed_batches()(), theirs()):
        for m, w in zip(lm_demo.stack(mine), lm_demo.stack(want)):
            np.testing.assert_array_equal(m, w)
        n += 1
    assert n == sum(1 for _ in theirs()) > 10


@pytest.fixture(scope="module")
def lm_runs():
    """JAX's trunk at the demo's widths, its loss and gradients on the
    first packed batch, and three jitted Adam steps over the first three
    batches (the demo's step)."""
    tree = jax_tf.init(jax.random.PRNGKey(0), src_vocab=lm_demo.VOCAB,
                       trg_vocab=1, d_model=lm_demo.D_MODEL,
                       dff=lm_demo.DFF, enc_layers=lm_demo.LAYERS,
                       dec_layers=0, max_len=lm_demo.MAX_LEN)
    start = jax.tree_util.tree_map(np.asarray, tree)
    opt = jax_optim.Adam(learning_rate=lm_demo.LR)

    def loss(p, data, seg, pos):
        toks = JaxSeq(data, jnp.full((data.shape[0],), data.shape[1],
                                     jnp.int32))
        return jax_tf.lm_loss(p, toks, lm_demo.HEADS, segment_ids=seg,
                              positions=pos)

    @jax.jit
    def step(p, s, data, seg, pos):
        l, g = jax.value_and_grad(loss)(p, data, seg, pos)
        p2, s2 = opt.update(g, s, p)
        return p2, s2, l, g

    batches = [lm_demo.stack(rows) for _, rows in
               zip(range(3), lm_demo.packed_batches()())]
    p, s = tree, opt.init(tree)
    losses, first_grads = [], None
    for data, seg, pos in batches:
        p, s, l, g = step(p, s, *map(jnp.asarray, (data, seg, pos)))
        losses.append(float(l))
        # the LM tree's unused trg_emb / out leaves are not carried
        # across (transformer.params_from_numpy drops them)
        first_grads = first_grads or jax.tree_util.tree_leaves(
            {k: v for k, v in g.items() if k not in ("trg_emb", "out")})
    return {"start": start, "batches": batches, "losses": losses,
            "grads": first_grads, "params": p}


def test_lm_loss_grads_and_adam_steps_match_jax(lm_runs):
    params = transformer.params_from_numpy(lm_runs["start"], "cpu")
    tr = lm_demo.Trainer(params)
    got = []
    for i, rows in zip(range(3), lm_demo.packed_batches()()):
        if i == 0:
            data, seg, pos = map(torch.tensor, lm_runs["batches"][0])
            from paddle_tpu_torch.utils.tree import value_and_grad
            _, g = value_and_grad(
                lambda p: lm_demo.loss(p, data, seg, pos), tr.params)
            _close_leaves(tree_leaves(g), lm_runs["grads"], GRAD_TOL,
                          "lm gradient")
        got.append(float(tr.step(rows)))
    np.testing.assert_allclose(got, lm_runs["losses"], rtol=TOL)
    want = transformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, lm_runs["params"]), "cpu")
    _close_leaves(tree_leaves(tr.params), tree_leaves(want), STEP_TOL,
                  "lm params after three steps")


def _margins(params, ids):
    """The top-1 / top-2 gap of the port's logits at every position of
    ``ids`` [T]."""
    with torch.no_grad():
        logits = transformer.lm_logits(
            params, _seq(torch.as_tensor(ids[None])), lm_demo.HEADS)[0]
    top = torch.topk(logits, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).numpy()


def _seq(data):
    from paddle_tpu_torch.core.sequence import SequenceBatch
    return SequenceBatch(data.to(torch.int64), torch.full(
        (data.shape[0],), data.shape[1], dtype=torch.int32))


@pytest.mark.parametrize("prompt_txt", lm_demo.PROMPTS)
def test_lm_generate_greedy_and_sampled_distribution_match_jax(
        lm_runs, prompt_txt):
    """Greedy tokens up to the port's first margin below MARGIN_TOL, and
    the first sampled step's distribution (logits / 0.7 cut to the top
    8, softmax) within 1e-5 of JAX's."""
    jparams = lm_runs["params"]
    params = transformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    prompt = lm_demo.encode_prompt(prompt_txt)
    got = lm_demo.generate(params, prompt_txt)
    want = np.asarray(jax.jit(lambda p, x: jax_tf.lm_generate(
        p, x, max_len=lm_demo.MAX_LEN, num_heads=lm_demo.HEADS))(
        jparams, jnp.asarray(prompt)))[0]
    tp = prompt.shape[1]
    marg = _margins(params, got)
    n = 0
    for t in range(tp, lm_demo.MAX_LEN):
        assert got[t] == want[t], (t, got, want)
        n += 1
        if marg[t - 1] < MARGIN_TOL:
            break
    assert n >= 1

    def first_dist(logits):
        logits = logits / lm_demo.TEMPERATURE
        kth = np.sort(logits)[-lm_demo.TOP_K]
        logits = np.where(logits < kth, -np.inf, logits)
        e = np.exp(logits - logits.max())
        return e / e.sum()

    with torch.no_grad():
        mine = transformer.lm_logits(params, _seq(torch.tensor(prompt)),
                                     lm_demo.HEADS)[0, -1].numpy()
    theirs = np.asarray(jax.jit(lambda p, x: jax_tf.lm_logits(
        p, JaxSeq(x, jnp.full((1,), x.shape[1], jnp.int32)),
        lm_demo.HEADS))(jparams, jnp.asarray(prompt)))[0, -1]
    np.testing.assert_allclose(first_dist(mine), first_dist(theirs),
                               atol=1e-5)
    # the sampler itself: a top-8 draw never leaves the top 8
    gen = torch.Generator().manual_seed(7)
    ids = lm_demo.generate(params, prompt_txt, gen)
    assert ids.shape == (lm_demo.MAX_LEN,)
    assert first_dist(mine)[ids[tp]] > 0
