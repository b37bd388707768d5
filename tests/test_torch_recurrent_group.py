"""The port's ``recurrent_group`` (``layers/recurrent.py`` with
``ops/rnn.recurrent_group``) against the JAX package's on the CPU.

Each config is built with both DSLs (same layer names, so the same
parameter keys), JAX's init perturbed by seeded noise (so the zero
biases and peepholes carry weight) and carried across with
``params_from_numpy``, whose key set must equal JAX's (the step layers'
parameters at top level under their sharing keys).  Held: every output
(values and lengths) and the gradient of every parameter and every
float feed of ``sum(out * cos(0.37 k))`` over the outputs, in test mode,
JAX under ``jax.jit``.  The configs cover ``memory`` with zero, layer
and constant boots, ``set_input``, a memory linked to a consumer of the
output, ``StaticInput`` with ``is_seq`` False and True (the encoder of
``simple_attention``), two outputs with ``get_output_layer``,
``reverse`` (over the padded time axis: the engine's own test), and the
scan hoist on and off (``_hoistable_frontier`` naming JAX's nodes).
Ragged batches include a row of length 1.  Then a
few ``SGD`` steps of a small ``lstmemory_group`` classifier against
JAX's trainer, and port-only checks: per-step dropout masks differ
across steps, train mode hoists no dropout node, a mixed layer's
``drop_rate`` drops once, and the refusals.

Tolerance: float32 on both sides in other summation orders; outputs,
losses and gradients within TOL = 1e-5 of each leaf's largest entry.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers import recurrent as JR
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.layers.graph import value_data as jax_value
from paddle_tpu.trainer import SGD as JaxSGD
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers import recurrent as R
from paddle_tpu_torch.layers.graph import value_data
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.error import ConfigError

TOL = 1e-5
B, T, DIN, H, E = 4, 7, 5, 6, 4
LENGTHS = np.array([7, 1, 4, 6], np.int32)
ENC_LENGTHS = np.array([3, 5, 1, 5], np.int32)


def _reset(M):
    (jax_reset_names if M is JL else L.reset_names)()


def _seq_np(rng, lengths, width, t=T):
    data = rng.randn(len(lengths), t, width).astype(np.float32)
    data[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    return data


def feeds(spec, seed=0):
    """{name: (kind, width)} -> (JAX feed, port feed): 'seq' rows of
    LENGTHS, 'enc' rows of ENC_LENGTHS (T 5), 'ids' id sequences of
    LENGTHS below ``width``, 'dense' [B, width] rows."""
    rng = np.random.RandomState(seed)
    jf, tf = {}, {}
    for name, (kind, width) in sorted(spec.items()):
        if kind in ("seq", "enc"):
            lens = LENGTHS if kind == "seq" else ENC_LENGTHS
            data = _seq_np(rng, lens, width, T if kind == "seq" else 5)
        elif kind == "ids":
            lens = LENGTHS
            data = rng.randint(0, width, (B, T)).astype(np.int32)
        else:
            a = rng.randn(B, width).astype(np.float32)
            jf[name], tf[name] = jnp.asarray(a), torch.tensor(a)
            continue
        jf[name] = JaxSeq(jnp.asarray(data), jnp.asarray(lens))
        tf[name] = SequenceBatch(torch.tensor(data), torch.tensor(lens))
    return jf, tf


def _outs(v, seq_type):
    return v if isinstance(v, tuple) and not isinstance(v, seq_type) \
        else (v,)


def _cot(shape, lib):
    n = int(np.prod(shape))
    return lib.cos(0.37 * lib.arange(n, dtype=lib.float32)).reshape(shape)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} of {scale}"


def jax_side(build, spec, seed=0, mode="test"):
    """JAX's topology, perturbed init (numpy), feed, outputs, loss and
    gradients (params, float feeds) under jax.jit."""
    jax_reset_names()
    topo = JL.Topology(build(JL))
    rng = np.random.RandomState(seed + 100)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), topo.init(jax.random.PRNGKey(seed)))
    jf, _ = feeds(spec, seed)
    floats = {k: jax_value(v) for k, v in jf.items()
              if jnp.issubdtype(jax_value(v).dtype, jnp.floating)}

    def f(p, fl):
        feed = {k: (v._replace(data=fl[k]) if isinstance(v, JaxSeq)
                    else fl[k]) if k in fl else v for k, v in jf.items()}
        vals = _outs(topo.apply(p, feed, mode=mode), JaxSeq)
        loss = sum(jnp.sum(jax_value(v) * _cot(jax_value(v).shape, jnp))
                   for v in vals)
        return loss, vals

    (loss, vals), (gp, gf) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, tree), floats)
    return {"topo": topo, "tree": tree, "loss": float(loss), "vals": vals,
            "gp": gp, "gf": gf}


def port_side(build, spec, tree, seed=0, mode="test"):
    L.reset_names()
    topo = L.Topology(build(L))
    params = L.params_from_numpy(topo, tree, device="cpu")
    for v in params.values():
        for t in v.values():
            t.requires_grad_(True)
    _, tf = feeds(spec, seed)
    for v in tf.values():
        if value_data(v).is_floating_point():
            value_data(v).requires_grad_(True)
    vals = _outs(topo.apply(params, tf, mode=mode), SequenceBatch)
    loss = sum(torch.sum(value_data(v) * _cot(tuple(value_data(v).shape),
                                              torch)) for v in vals)
    loss.backward()
    return {"topo": topo, "params": params, "feed": tf,
            "loss": float(loss.detach()), "vals": vals}


def check(build, spec, seed=0, want=None):
    """``build`` in both DSLs held as the module doc says; returns the
    two sides."""
    want = want or jax_side(build, spec, seed)
    got = port_side(build, spec, want["tree"], seed)
    assert got["topo"].param_shapes().keys() == want["tree"].keys()
    assert [n.name for n in got["topo"].order] \
        == [n.name for n in want["topo"].order]
    _close(got["loss"], want["loss"], "loss")
    assert len(got["vals"]) == len(want["vals"])
    for i, (g, w) in enumerate(zip(got["vals"], want["vals"])):
        _close(value_data(g).detach().numpy(), jax_value(w), f"output {i}")
        if isinstance(w, JaxSeq):
            np.testing.assert_array_equal(g.lengths.numpy(), w.lengths)
    for k in want["tree"]:
        for n in want["tree"][k]:
            _close(got["params"][k][n].grad.numpy(), want["gp"][k][n],
                   f"grad {k}/{n}")
    for k, w in want["gf"].items():
        _close(value_data(got["feed"][k]).grad.numpy(), w,
               f"grad feed {k}")
    return got, want


# ---------------------------------------------------------------- configs

def _fc_step(M, x, mem, name="h"):
    return M.fc_layer([x, mem], size=H, act="tanh", name=name)


def zero_boot(M, reverse=False):
    x = M.data_layer("x", size=DIN, is_seq=True)

    def step(xt):
        return _fc_step(M, xt, M.memory(name="h", size=H))
    return M.last_seq(M.recurrent_group(step, x, reverse=reverse))


def layer_boot(M):
    x = M.data_layer("x", size=DIN, is_seq=True)
    boot = M.fc_layer(M.data_layer("c", size=E), size=H, act="tanh")

    def step(xt):
        return _fc_step(M, xt, M.memory(name="h", size=H, boot_layer=boot))
    return M.recurrent_group(step, x)


def const_boot(M):
    x = M.data_layer("x", size=DIN, is_seq=True)

    def step(xt):
        return _fc_step(M, xt, M.memory(name="h", size=H,
                                        boot_with_const_id=2))
    return M.recurrent_group(step, x)


def set_input(M):
    x = M.data_layer("x", size=DIN, is_seq=True)

    def step(xt):
        mem = M.memory(name=None, size=H)
        h = _fc_step(M, xt, mem, name="late")
        mem.set_input(h)
        return h
    return M.recurrent_group(step, x)


def consumer_link(M):
    """The memory links ``c``, a consumer of the output ``h`` that is
    not an ancestor of it."""
    x = M.data_layer("x", size=DIN, is_seq=True)

    def step(xt):
        h = _fc_step(M, xt, M.memory(name="c", size=H))
        M.slope_intercept_layer(h, slope=0.5, intercept=0.25, name="c")
        return h
    return M.recurrent_group(step, x)


def statics(M):
    """StaticInput with is_seq False (a boot source and an fc input)
    and True (simple_attention's encoder and its projection)."""
    x = M.data_layer("x", size=DIN, is_seq=True)
    enc = M.data_layer("enc", size=E, is_seq=True)
    ctx = M.data_layer("c", size=E)
    enc_proj = M.fc_layer(enc, size=H, act=None, bias_attr=False)

    def step(xt, enc_s, proj_s, ctx_s):
        mem = M.memory(name="h", size=H,
                       boot_layer=M.fc_layer(ctx, size=H, act="tanh"))
        att = M.simple_attention(enc_s, proj_s, mem)
        return M.fc_layer([xt, att, mem, ctx_s], size=H, act="tanh",
                          name="h")
    return M.recurrent_group(step, [
        x, M.StaticInput(enc, is_seq=True),
        M.StaticInput(enc_proj, is_seq=True), M.StaticInput(ctx)])


def two_outputs(M):
    x = M.data_layer("x", size=DIN, is_seq=True)

    def step(xt):
        h = _fc_step(M, xt, M.memory(name="h", size=H))
        return h, M.fc_layer(h, size=3, act="softmax", name="probs")
    group = M.recurrent_group(step, x, name="two")
    return [M.last_seq(group), M.get_output_layer(group, index=1)]


def hoist(M):
    """tests/test_scan_hoist.py's graph: an embedding and a two-input fc
    over the step inputs (the frontier: the fc), a memory and a static
    input past it."""
    w = M.data_layer("w", size=30, is_seq=True)
    s = M.data_layer("s", size=DIN, is_seq=True)
    ctxv = M.data_layer("c", size=E)

    def step(tok, feat, stat):
        mem = M.memory(name="h", size=H)
        emb = M.embedding_layer(tok, size=5)
        proj = M.fc_layer([emb, feat], size=H, act=None, bias_attr=False)
        return M.fc_layer([proj, mem, stat], size=H, act="tanh", name="h")
    return M.last_seq(M.recurrent_group(step, [w, s, M.StaticInput(ctxv)]))


SEQ = {"x": ("seq", DIN)}
CASES = {
    "zero_boot": (zero_boot, SEQ),
    "reverse": (lambda M: zero_boot(M, reverse=True), SEQ),
    "layer_boot": (layer_boot, {**SEQ, "c": ("dense", E)}),
    "const_boot": (const_boot, SEQ),
    "set_input": (set_input, SEQ),
    "consumer_link": (consumer_link, SEQ),
    "static_inputs": (statics, {**SEQ, "enc": ("enc", E),
                                "c": ("dense", E)}),
    "two_outputs": (two_outputs, SEQ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_matches_jax(case):
    build, spec = CASES[case]
    check(build, spec)


@pytest.fixture(scope="module")
def hoist_jax():
    spec = {"w": ("ids", 30), "s": ("seq", DIN), "c": ("dense", E)}
    prior = JR.HOIST_SCAN_INVARIANTS
    runs = {}
    try:
        for on in (True, False):
            JR.HOIST_SCAN_INVARIANTS = on
            runs[on] = jax_side(hoist, spec)
    finally:
        JR.HOIST_SCAN_INVARIANTS = prior
    return spec, runs


@pytest.mark.parametrize("on", [True, False], ids=["hoisted", "in_loop"])
def test_hoist_matches_jax_on_and_off(hoist_jax, on):
    spec, runs = hoist_jax
    prior = R.HOIST_SCAN_INVARIANTS
    R.HOIST_SCAN_INVARIANTS = on
    try:
        check(hoist, spec, want=runs[on])
    finally:
        R.HOIST_SCAN_INVARIANTS = prior


def _group(topo):
    return next(n for n in topo.order if n.layer_type == "recurrent_group")


def test_hoistable_frontier_names_jax_nodes(hoist_jax):
    _, runs = hoist_jax
    L.reset_names()
    mine = _group(L.Topology(hoist(L)))
    theirs = _group(runs[True]["topo"])
    for mode in ("train", "test"):
        got = R._hoistable_frontier(mine.cfg["sub_topo"],
                                    mine.cfg["seq_phs"], mode)
        want = JR._hoistable_frontier(theirs.cfg["sub_topo"],
                                      theirs.cfg["seq_phs"], mode)
        assert [n.name for n in got] == [n.name for n in want]
        assert [n.layer_type for n in got] == ["fc"]


def test_hoisted_values_equal_in_loop_values(hoist_jax):
    spec, runs = hoist_jax
    vals = {}
    prior = R.HOIST_SCAN_INVARIANTS
    try:
        for on in (True, False):
            R.HOIST_SCAN_INVARIANTS = on
            got = port_side(hoist, spec, runs[True]["tree"])
            vals[on] = [got["loss"]] + [
                t.grad for v in got["params"].values() for t in v.values()]
    finally:
        R.HOIST_SCAN_INVARIANTS = prior
    _close(vals[True][0], vals[False][0], "loss")
    for a, b in zip(vals[True][1:], vals[False][1:]):
        _close(a.numpy(), b.numpy(), "grad")


# ------------------------------------------------------------- training

V, EMB, HID = 20, 6, 5


def classifier(M):
    """A small text classifier with an lstmemory_group between the
    embedding's projection and the max pool."""
    w = M.data_layer("w", size=V, is_seq=True)
    x4 = M.fc_layer(M.embedding_layer(w, size=EMB), size=4 * HID, act=None,
                    bias_attr=False)
    h = M.networks.lstmemory_group(x4, size=HID, name="lg")
    out = M.fc_layer(M.pooling_layer(h, pooling_type=M.pooling.Max),
                     size=2, act="softmax")
    return M.classification_cost(out, M.data_layer("lab", 1))


def test_sgd_steps_of_an_lstmemory_group_classifier_match_jax():
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(3):
        lens = [T] + list(rng.randint(1, T + 1, B - 1))
        batches.append([(rng.randint(0, V, n).tolist(), int(rng.randint(2)))
                        for n in lens])
    from paddle_tpu.data import integer_value as ji, \
        integer_value_sequence as jis
    from paddle_tpu_torch.data import DataFeeder, integer_value, \
        integer_value_sequence
    jax_reset_names()
    jt = JaxSGD(classifier(JL), update_equation=jax_optim.Momentum(
        learning_rate=0.1, momentum=0.9), seed=3, donate=False)
    start = jax.tree_util.tree_map(np.asarray, jt.parameters)
    want = [float(jt.train_one_batch(b, feeder={"w": jis(V), "lab": ji(2)}))
            for b in batches]
    L.reset_names()
    tr = SGD(classifier(L), parameters=start, update_equation=optim.Momentum(
        learning_rate=0.1, momentum=0.9), device="cpu")
    feeder = DataFeeder({"w": integer_value_sequence(V),
                         "lab": integer_value(2)}, device="cpu")
    got = [float(tr.train_one_batch(b, feeder)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=TOL)
    for k, v in jt.parameters.items():
        for n, a in v.items():
            _close(tr.parameters[k][n].detach().numpy(), a, f"{k}/{n}")


# ------------------------------------------------------------- port only

def _dropout_group(rate=0.5):
    L.reset_names()
    x = L.data_layer("x", size=64, is_seq=True)
    return L.Topology(L.recurrent_group(
        lambda xt: L.dropout_layer(xt, rate), x))


def test_step_dropout_masks_differ_across_steps_and_follow_the_generator():
    topo = _dropout_group()
    x = SequenceBatch(torch.ones(2, 5, 64),
                      torch.tensor([5, 5], dtype=torch.int32))

    def run(seed):
        return topo.apply({}, {"x": x}, mode="train",
                          generator=torch.Generator().manual_seed(seed)).data
    a = run(1)
    kept = a != 0
    assert torch.equal(a[kept], torch.full_like(a[kept], 2.0))
    for t in range(1, 5):
        assert not torch.equal(kept[:, t], kept[:, 0])
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
    assert torch.equal(topo.apply({}, {"x": x}, mode="test").data, x.data)


def test_train_mode_hoists_no_dropout_node():
    L.reset_names()
    s = L.data_layer("s", size=DIN, is_seq=True)

    def step(feat):
        proj = L.fc_layer(feat, size=H, act=None,
                          layer_attr={"drop_rate": 0.5})
        return L.fc_layer([proj, L.memory(name="h", size=H)], size=H,
                          act="tanh", name="h")
    group = _group(L.Topology(L.recurrent_group(step, s)))
    sub, phs = group.cfg["sub_topo"], group.cfg["seq_phs"]
    assert R._hoistable_frontier(sub, phs, "train") == []
    assert [n.layer_type for n in R._hoistable_frontier(sub, phs, "test")] \
        == ["fc"]


def test_mixed_layer_drops_once():
    """A mixed layer's drop_rate applies once (inside its impl, as JAX's
    graph leaves it there): the kept share is within 6 binomial standard
    deviations of 1 - rate."""
    rate, n = 0.5, 64 * 256
    L.reset_names()
    x = L.data_layer("x", size=256)
    m = L.mixed_layer(size=256, input=[L.identity_projection(x)],
                      layer_attr={"drop_rate": rate})
    out = L.Topology(m).apply({}, {"x": torch.ones(64, 256)},
                              generator=torch.Generator().manual_seed(0))
    kept = float((out != 0).float().mean())
    assert abs(kept - (1 - rate)) <= 6 * np.sqrt(rate * (1 - rate) / n)


def test_engine_freezes_finished_rows_and_zeroes_their_outputs():
    lengths = torch.tensor([3, 1], dtype=torch.int32)
    x = SequenceBatch(torch.ones(2, 3, 1), lengths)

    def step(mems, frames):
        new = mems[0] + frames[0]
        return (new,), new
    out, (final,) = rnn_ops.recurrent_group(step, x, (torch.zeros(2, 1),))
    assert out.data[:, :, 0].tolist() == [[1, 2, 3], [1, 0, 0]]
    assert final[:, 0].tolist() == [3, 1]
    out, (final,) = rnn_ops.recurrent_group(step, x, (torch.zeros(2, 1),),
                                            reverse=True)
    assert out.data[:, :, 0].tolist() == [[3, 2, 1], [1, 0, 0]]


def test_group_refusals_match_jax():
    for M, err in ((JL, JaxConfigError), (L, ConfigError)):
        _reset(M)
        dense = M.data_layer("d", size=DIN)
        with pytest.raises(err, match="is not a sequence; wrap"):
            M.recurrent_group(lambda x: x, dense)
        with pytest.raises(err, match="must be called inside"):
            M.memory(name="h", size=H)
    L.reset_names()
    x = L.data_layer("x", size=DIN, is_seq=True)
    # outside a v1 parse (where tests/test_torch_compat.py promotes it)
    with pytest.raises(ConfigError, match="is not a sequence; wrap"):
        L.recurrent_group(lambda s: s, L.data_layer("d", size=DIN))
    # nested groups run now (tests/test_torch_nested_group.py); mixing a
    # SubsequenceInput with a flat sequence JAX refuses too
    with pytest.raises(ConfigError, match="cannot mix SubsequenceInput"):
        L.recurrent_group(lambda s, y: y, [L.SubsequenceInput(x), x])
    with pytest.raises(ConfigError, match="no matching layer"):
        L.recurrent_group(lambda s: _fc_step(
            L, s, L.memory(name="nowhere", size=H)), x)
    group = L.recurrent_group(lambda s: _fc_step(
        L, s, L.memory(name="h", size=H)), x)
    got = L.get_output_layer(group, index=0)
    with pytest.raises(ConfigError, match="single output"):
        topo = L.Topology(got)
        topo.apply(topo.init(torch.Generator().manual_seed(0), "cpu"),
                   {"x": feeds(SEQ)[1]["x"]}, mode="test")
