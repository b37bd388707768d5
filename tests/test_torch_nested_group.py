"""The port's nested ``recurrent_group`` (``SubsequenceInput`` groups over
``ops/rnn.nested_recurrent_group``) against the JAX package's on the CPU.

The engine alone: a step with a [B, H] and a sequence-valued output,
forward and reversed, values and the gradients of its weights and its
input.  Then DSL configs built with both packages (same names, so the
same parameter keys), JAX's init perturbed by seeded noise and carried
across with ``params_from_numpy``: the ``sequence_nest_rnn`` group of
``tests/test_nested_rnn.py`` (an inner group booted from the outer
memory), a step whose inner group's output stacks to a
``NestedSequenceBatch``, and a hierarchical classifier's step (an
``lstmemory`` over the sentence, ``last_seq``, an fc over it and the
outer memory).  Held: every output (values, lengths) and the gradient
of every parameter and of the float feed of ``sum(out * cos(0.37 k))``,
JAX under ``jax.jit``.  Port-only: nested equals the flat group over
the concatenated words, padding invariance, and the two refusals.

Tolerance: float32 on both sides in other summation orders; values
within TOL = 1e-5 and gradients within GRAD_TOL = 1e-4 of each leaf's
largest entry.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu.core.sequence import NestedSequenceBatch as JaxNest
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.layers.graph import value_data as jax_value
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch
from paddle_tpu_torch.layers.graph import value_data
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.utils.error import ConfigError

TOL = 1e-5
GRAD_TOL = 1e-4
DIM, HID = 4, 6
# sub-sequence lengths of each sample: a one-step sub-sequence, a sample
# of one sub-sequence, a sample of three
SUB_LENS = [[3, 1], [2, 4, 1], [2], [1, 3, 2]]


def nest_np(seed, width=DIM, extra_s=0, extra_t=0, pad=0.0):
    """(data [B, S, T, width], outer [B], inner [B, S]) numpy, ``pad``
    in every padded slot, S and T widened by ``extra_s`` / ``extra_t``."""
    rng = np.random.RandomState(seed)
    b = len(SUB_LENS)
    s = max(len(x) for x in SUB_LENS) + extra_s
    t = max(max(x) for x in SUB_LENS) + extra_t
    data = np.full((b, s, t, width), pad, np.float32)
    inner = np.zeros((b, s), np.int32)
    for i, lens in enumerate(SUB_LENS):
        for j, n in enumerate(lens):
            inner[i, j] = n
            data[i, j, :n] = rng.randn(n, width)
    outer = np.asarray([len(x) for x in SUB_LENS], np.int32)
    return data, outer, inner


def flat_np(data, outer, inner):
    """The same words concatenated per sample: (data [B, T, D], lengths)."""
    rows = [np.concatenate([data[i, j, :inner[i, j]]
                            for j in range(outer[i])]) for i in range(len(outer))]
    t = max(len(r) for r in rows)
    out = np.zeros((len(rows), t, data.shape[-1]), np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, np.asarray([len(r) for r in rows], np.int32)


def _cot(shape, lib):
    n = int(np.prod(shape))
    return lib.cos(0.37 * lib.arange(n, dtype=lib.float32)).reshape(shape)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} of {scale}"


def _lengths_equal(got, want):
    if isinstance(want, JaxNest):
        assert isinstance(got, NestedSequenceBatch)
        np.testing.assert_array_equal(got.outer_lengths.numpy(),
                                      want.outer_lengths)
        np.testing.assert_array_equal(got.inner_lengths.numpy(),
                                      want.inner_lengths)
    elif isinstance(want, JaxSeq):
        assert isinstance(got, SequenceBatch)
        np.testing.assert_array_equal(got.lengths.numpy(), want.lengths)


# ------------------------------------------------------------ the engine

def _engine_weights(seed):
    rng = np.random.RandomState(seed)
    return [0.5 * rng.randn(*s).astype(np.float32)
            for s in ((DIM, HID), (HID, HID), (HID,))]


def _engine_step(lib, w, u, v, as_seq):
    """mem <- tanh(sum_t(frame) / (len + 1) W + mem U); outputs (mem,
    the frame scaled by tanh(mem . v) as a sequence)."""
    def step(mems, frames):
        (mem,), (fr,) = mems, frames
        m = fr.mask(fr.data.dtype)
        mean = (fr.data * m[..., None]).sum(1) / (m.sum(1)[:, None] + 1.0)
        new = lib.tanh(mean @ w + mem @ u)
        scale = lib.tanh(new @ v)
        return (new,), (new, as_seq(fr.data * scale[:, None, None],
                                    fr.lengths))
    return step


@pytest.mark.parametrize("reverse", [False, True])
def test_engine_matches_jax(reverse):
    data, outer, inner = nest_np(0)
    ws = _engine_weights(1)
    boot = np.random.RandomState(2).randn(len(outer), HID).astype(np.float32)

    def jax_loss(ws_, x):
        step = _engine_step(jnp, *ws_, lambda d, ln: JaxSeq(d, ln))
        (o_mem, o_seq), final = jax_rnn.nested_recurrent_group(
            step, (JaxNest(x, jnp.asarray(outer), jnp.asarray(inner)),),
            (jnp.asarray(boot),), reverse=reverse)
        loss = (jnp.sum(o_mem.data * _cot(o_mem.data.shape, jnp))
                + jnp.sum(o_seq.data * _cot(o_seq.data.shape, jnp))
                + jnp.sum(final[0] * _cot(final[0].shape, jnp)))
        return loss, (o_mem, o_seq, final[0])

    (jl, (jm, js, jf)), (jgw, jgx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(
            [jnp.asarray(w) for w in ws], jnp.asarray(data))

    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    tx = torch.tensor(data, requires_grad=True)
    step = _engine_step(torch, *tw, lambda d, ln: SequenceBatch(d, ln))
    (o_mem, o_seq), final = rnn_ops.nested_recurrent_group(
        step, (NestedSequenceBatch(tx, torch.tensor(outer),
                                   torch.tensor(inner)),),
        (torch.tensor(boot),), reverse=reverse)
    loss = (torch.sum(o_mem.data * _cot(tuple(o_mem.data.shape), torch))
            + torch.sum(o_seq.data * _cot(tuple(o_seq.data.shape), torch))
            + torch.sum(final[0] * _cot(tuple(final[0].shape), torch)))
    loss.backward()
    assert isinstance(o_mem, SequenceBatch) \
        and isinstance(o_seq, NestedSequenceBatch)
    _close(float(loss.detach()), float(jl), "loss")
    _close(o_mem.data.detach().numpy(), jm.data, "[B, H] output")
    _lengths_equal(o_mem, jm)
    _close(o_seq.data.detach().numpy(), js.data, "sequence output")
    _lengths_equal(o_seq, js)
    _close(final[0].detach().numpy(), jf, "final memory")
    for i, (t, g) in enumerate(zip(tw, jgw)):
        _close(t.grad.numpy(), g, f"grad w{i}", GRAD_TOL)
    _close(tx.grad.numpy(), jgx, "grad input", GRAD_TOL)


# ------------------------------------------------------------ DSL configs

def nest_rnn(M):
    """tests/test_nested_rnn.py's sequence_nest_rnn: the inner memory
    booted from the outer one, the outer memory the inner output's
    last step (a consumer link)."""
    x = M.data_layer("x", size=DIM, is_seq=True)

    def outer_step(subseq):
        outer_mem = M.memory(name="outer_state", size=HID)

        def inner_step(y):
            inner_mem = M.memory(name="inner_state", size=HID,
                                 boot_layer=outer_mem)
            return M.fc_layer([y, inner_mem], size=HID, act="tanh",
                              name="inner_state",
                              param_attr={"name": "rnnfc"})

        return M.last_seq(M.recurrent_group(inner_step, subseq),
                          name="outer_state")

    return M.recurrent_group(outer_step, M.SubsequenceInput(x))


def nest_rnn_unbooted(M):
    """nest_rnn with the inner memory NOT booted from the outer one: the
    state restarts at every sub-sequence (the chip's control)."""
    x = M.data_layer("x", size=DIM, is_seq=True)

    def outer_step(subseq):
        M.memory(name="outer_state", size=HID)

        def inner_step(y):
            inner_mem = M.memory(name="inner_state", size=HID)
            return M.fc_layer([y, inner_mem], size=HID, act="tanh",
                              name="inner_state",
                              param_attr={"name": "rnnfc"})

        return M.last_seq(M.recurrent_group(inner_step, subseq),
                          name="outer_state")

    return M.recurrent_group(outer_step, M.SubsequenceInput(x))


def flat_rnn(M):
    xf = M.data_layer("x", size=DIM, is_seq=True)

    def step(y):
        mem = M.memory(name="state", size=HID)
        return M.fc_layer([y, mem], size=HID, act="tanh", name="state",
                          param_attr={"name": "rnnfc"})

    return M.recurrent_group(step, xf)


def seq_output(M):
    """The step returns its inner group's sequence output."""
    x = M.data_layer("x", size=DIM, is_seq=True)

    def outer_step(subseq):
        def inner_step(y):
            mem = M.memory(name="s", size=HID)
            return M.fc_layer([y, mem], size=HID, act="tanh", name="s")
        return M.recurrent_group(inner_step, subseq)

    return M.recurrent_group(outer_step, M.SubsequenceInput(x))


def classifier(M):
    """The chip's nested_group model at this size: per sentence an fc of
    4·HID, an lstmemory of HID and last_seq; an fc over [last, outer
    memory] that names the memory; last_seq and a softmax of 2."""
    x = M.data_layer("x", size=DIM, is_seq=True)

    def outer_step(sent):
        doc = M.memory(name="doc", size=HID)
        lstm = M.lstmemory(M.fc_layer(sent, size=4 * HID, act=None,
                                      bias_attr=False), size=HID)
        return M.fc_layer([M.last_seq(lstm), doc], size=HID, act="tanh",
                          name="doc")

    group = M.recurrent_group(outer_step, M.SubsequenceInput(x))
    return M.fc_layer(M.last_seq(group), size=2, act="softmax")


def jax_side(build, feed_np, seed=0):
    jax_reset_names()
    topo = JL.Topology(build(JL))
    rng = np.random.RandomState(seed + 100)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), topo.init(jax.random.PRNGKey(seed)))
    data, outer, inner = feed_np

    def f(p, x):
        out = topo.apply(p, {"x": JaxNest(x, jnp.asarray(outer),
                                          jnp.asarray(inner))}, mode="test")
        return jnp.sum(jax_value(out) * _cot(jax_value(out).shape, jnp)), out

    (loss, out), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(data))
    return {"topo": topo, "tree": tree, "loss": float(loss), "out": out,
            "gp": gp, "gx": gx}


def port_side(build, feed_np, tree):
    L.reset_names()
    topo = L.Topology(build(L))
    params = L.params_from_numpy(topo, tree, device="cpu")
    for v in params.values():
        for t in v.values():
            t.requires_grad_(True)
    data, outer, inner = feed_np
    x = torch.tensor(data, requires_grad=True)
    out = topo.apply(params, {"x": NestedSequenceBatch(
        x, torch.tensor(outer), torch.tensor(inner))}, mode="test")
    loss = torch.sum(value_data(out) * _cot(tuple(value_data(out).shape),
                                            torch))
    loss.backward()
    return {"topo": topo, "params": params, "loss": float(loss.detach()),
            "out": out, "x": x}


@pytest.mark.parametrize("build", [nest_rnn, seq_output, classifier],
                         ids=lambda b: b.__name__)
def test_nested_group_matches_jax(build):
    feed_np = nest_np(3)
    want = jax_side(build, feed_np)
    got = port_side(build, feed_np, want["tree"])
    assert got["topo"].param_shapes().keys() == want["tree"].keys()
    assert [n.name for n in got["topo"].order] \
        == [n.name for n in want["topo"].order]
    _close(got["loss"], want["loss"], "loss")
    _close(value_data(got["out"]).detach().numpy(), jax_value(want["out"]),
           "output")
    _lengths_equal(got["out"], want["out"])
    for k in want["tree"]:
        for n in want["tree"][k]:
            _close(got["params"][k][n].grad.numpy(), want["gp"][k][n],
                   f"grad {k}/{n}", GRAD_TOL)
    _close(got["x"].grad.numpy(), want["gx"], "grad x", GRAD_TOL)


def _final_rows(out):
    """Each sample's output at its last valid step, and the loss over
    them (tests/test_nested_rnn.py's)."""
    d = value_data(out)
    fin = d[torch.arange(d.shape[0]), out.lengths.long() - 1]
    return fin, torch.sum(fin ** 2)


def nested_vs_flat(nested_build):
    """(value error, gradient error) of ``nested_build`` against the flat
    group, each against its largest entry: values at every sub-sequence
    end, the gradient of the shared weights of the final rows' squares."""
    data, outer, inner = nest_np(4)
    fdata, flens = flat_np(data, outer, inner)
    L.reset_names()
    topo_f = L.Topology(flat_rnn(L))
    params = topo_f.init(torch.Generator().manual_seed(0), device="cpu")
    L.reset_names()
    topo_n = L.Topology(nested_build(L))
    assert topo_n.param_shapes() == topo_f.param_shapes()
    grads, outs = [], []
    for topo, feed in (
            (topo_n, NestedSequenceBatch(torch.tensor(data),
                                         torch.tensor(outer),
                                         torch.tensor(inner))),
            (topo_f, SequenceBatch(torch.tensor(fdata),
                                   torch.tensor(flens)))):
        p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
             for k, v in params.items()}
        out = topo.apply(p, {"x": feed}, mode="test")
        _final_rows(out)[1].backward()
        outs.append(value_data(out).detach().numpy())
        grads.append({n: t.grad.numpy() for n, t in p["rnnfc"].items()})
    dn, df = outs
    val_err = 0.0
    for b in range(len(outer)):
        ends = np.cumsum(inner[b, :outer[b]]) - 1
        for j, e in enumerate(ends):
            val_err = max(val_err, float(np.abs(dn[b, j] - df[b, e]).max()))
    val_err /= float(np.abs(df).max())
    grad_err = max(float(np.abs(grads[0][n] - grads[1][n]).max())
                   / float(np.abs(grads[1][n]).max()) for n in grads[1])
    return val_err, grad_err


def test_nested_equals_flat_and_the_unbooted_control_does_not():
    val_err, grad_err = nested_vs_flat(nest_rnn)
    assert val_err <= TOL and grad_err <= GRAD_TOL, (val_err, grad_err)
    val_err, grad_err = nested_vs_flat(nest_rnn_unbooted)
    assert val_err > TOL and grad_err > GRAD_TOL, (val_err, grad_err)


def test_sequence_step_output_is_a_nested_batch():
    data, outer, inner = nest_np(5)
    L.reset_names()
    topo = L.Topology(seq_output(L))
    params = topo.init(torch.Generator().manual_seed(0), device="cpu")
    val = topo.apply(params, {"x": NestedSequenceBatch(
        torch.tensor(data), torch.tensor(outer), torch.tensor(inner))},
        mode="test")
    assert isinstance(val, NestedSequenceBatch)
    assert val.data.shape == data.shape[:3] + (HID,)
    np.testing.assert_array_equal(val.outer_lengths.numpy(), outer)
    np.testing.assert_array_equal(val.inner_lengths.numpy(), inner)
    mask = val.inner_mask().numpy()
    assert np.all(val.data.numpy()[mask == 0] == 0.0)
    assert np.all(np.abs(val.data.numpy()[mask == 1]).sum(-1) > 0)


@pytest.mark.parametrize("build", [nest_rnn, classifier],
                         ids=lambda b: b.__name__)
def test_padding_invariance(build):
    """Wider outer and longer inner padding filled with loud garbage
    changes neither the valid outputs nor any gradient."""
    L.reset_names()
    topo = L.Topology(build(L))
    params = topo.init(torch.Generator().manual_seed(1), device="cpu")
    res = []
    for extra, pad in ((0, 0.0), (2, 7.5)):
        data, outer, inner = nest_np(6, extra_s=extra, extra_t=extra + 1,
                                     pad=pad)
        p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
             for k, v in params.items()}
        out = topo.apply(p, {"x": NestedSequenceBatch(
            torch.tensor(data), torch.tensor(outer), torch.tensor(inner))},
            mode="test")
        d = value_data(out)
        if isinstance(out, SequenceBatch):
            d = d[:, :int(outer.max())]
        torch.sum(d * _cot(tuple(d.shape), torch)).backward()
        res.append((d.detach().numpy(),
                    {(k, n): t.grad.numpy() for k, v in p.items()
                     for n, t in v.items()}))
    _close(res[1][0], res[0][0], "valid outputs")
    for key, g in res[0][1].items():
        _close(res[1][1][key], g, f"grad {key}", GRAD_TOL)


def test_refusals_match_jax():
    for M, err in ((L, ConfigError), (JL, JaxConfigError)):
        (L.reset_names if M is L else jax_reset_names)()
        x = M.data_layer("x", size=DIM, is_seq=True)
        y = M.data_layer("y", size=DIM, is_seq=True)
        with pytest.raises(err, match="cannot mix SubsequenceInput"):
            M.recurrent_group(lambda a, b: M.fc_layer([M.last_seq(a), b],
                                                      size=HID),
                              [M.SubsequenceInput(x), y])
    L.reset_names()
    topo = L.Topology(nest_rnn(L))
    params = topo.init(torch.Generator().manual_seed(0), device="cpu")
    fdata, flens = flat_np(*nest_np(0))
    with pytest.raises(ConfigError, match="needs a NestedSequenceBatch"):
        topo.apply(params, {"x": SequenceBatch(torch.tensor(fdata),
                                               torch.tensor(flens))})
    jax_reset_names()
    jtopo = JL.Topology(nest_rnn(JL))
    with pytest.raises(JaxConfigError, match="needs a NestedSequenceBatch"):
        jtopo.apply(jtopo.init(jax.random.PRNGKey(0)),
                    {"x": JaxSeq(jnp.asarray(fdata), jnp.asarray(flens))})


def test_text_dsl_nested_group_matches_jax():
    """models/text_dsl's nested_group classifier (narrowed) on imdb
    reviews read as sentences, loss and every gradient against the same
    network in JAX's DSL from JAX's init."""
    from paddle_tpu.core.sequence import NestedSequenceBatch as JN
    from paddle_tpu.data.datasets import imdb as jax_imdb
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_dsl
    hid, emb = 8, 6

    def jax_net():
        jax_reset_names()
        words = JL.data_layer("words", size=jax_imdb.WORD_DIM, is_seq=True)
        label = JL.data_layer("label", size=1)
        e = JL.embedding_layer(words, size=emb)

        def sentence_step(sentence):
            doc = JL.memory(name="doc_state", size=hid)
            lstm = JL.lstmemory(JL.fc_layer(sentence, size=hid * 4, act=None,
                                            bias_attr=False), size=hid)
            return JL.fc_layer([JL.last_seq(lstm), doc], size=hid,
                               act="tanh", name="doc_state")

        doc = JL.recurrent_group(sentence_step, JL.SubsequenceInput(e))
        out = JL.fc_layer(JL.last_seq(doc), size=2, act="softmax")
        return JL.classification_cost(out, label)

    jtopo = JL.Topology(jax_net())
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(1)))
    cost, _ = text_dsl.build("nested_group", hid=hid, emb=emb)
    topo = L.Topology(cost)
    assert [n.name for n in topo.order] == [n.name for n in jtopo.order]
    params = L.params_from_numpy(topo, tree, "cpu")
    it = text_dsl.sentences(text_dsl.imdb.train())()
    batch = [next(it) for _ in range(6)]
    tf = DataFeeder(text_dsl.feeding(model="nested_group"),
                    device="cpu")(batch)
    w = tf["words"]
    jf = {"words": JN(jnp.asarray(w.data.numpy()),
                      jnp.asarray(w.outer_lengths.numpy()),
                      jnp.asarray(w.inner_lengths.numpy())),
          "label": jnp.asarray(tf["label"].numpy())}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(jtopo.apply(p, jf, mode="train"))))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    for v in params.values():
        for t in v.values():
            t.requires_grad_(True)
    loss = torch.mean(topo.apply(params, tf, mode="train"))
    loss.backward()
    _close(float(loss.detach()), float(jl), "loss")
    for k, v in tree.items():
        for n in v:
            _close(params[k][n].grad.numpy(), jg[k][n], f"grad {k}/{n}",
                   GRAD_TOL)


def test_dropout_in_an_inner_step_draws_per_outer_step():
    """A dropout inside the inner group's step: in train mode the outer
    engine hands each outer step its own generator (the inner group
    counts as drawing), so the masks differ across sub-sequences; in
    test mode nothing draws."""
    L.reset_names()
    x = L.data_layer("x", size=64, is_seq=True)

    def outer_step(subseq):
        return L.recurrent_group(lambda y: L.dropout_layer(y, 0.5), subseq)

    topo = L.Topology(L.recurrent_group(outer_step, L.SubsequenceInput(x)))
    data = np.ones((1, 3, 4, 64), np.float32)
    feed = {"x": NestedSequenceBatch(torch.tensor(data),
                                     torch.tensor([3], dtype=torch.int32),
                                     torch.full((1, 3), 4,
                                                dtype=torch.int32))}
    out = topo.apply({}, feed, mode="train",
                     generator=torch.Generator().manual_seed(0)).data
    kept = [out[0, j] != 0 for j in range(3)]
    assert not torch.equal(kept[0], kept[1])
    assert not torch.equal(kept[1], kept[2])
    assert torch.equal(topo.apply({}, feed, mode="test").data,
                       torch.tensor(data))
