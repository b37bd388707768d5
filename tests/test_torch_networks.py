"""The port's ``dropout_layer`` and ``layers/networks.py`` against the
JAX package's on the CPU, and the image_classification demo's vgg config
(``models/image_dsl.vgg_bn_drop``).

- ``dropout_layer``: the identity in test mode; in train mode every kept
  entry is the input over (1 - rate), every other one 0, and the kept
  share lies within 6 binomial standard deviations of 1 - rate.  The two
  packages draw different masks, so masks are not compared.
- Each ported ``networks`` function, built with both DSLs, on JAX's init
  carried across (``params_from_numpy``): the output in test mode; for
  the recurrent composites and ``simple_attention`` also the gradient of
  every parameter (of the sum of the valid outputs times a seeded
  cotangent), over ragged sequences.
- The four composites built on ``recurrent_group`` run (held in
  tests/test_torch_recurrent_units.py); over a ``SubsequenceInput``
  they build JAX's nested group and, as JAX's, refuse a whole
  sub-sequence at apply (``sequence_conv_pool`` is held in
  tests/test_torch_mixed.py).
- ``vgg_bn_drop`` at the demo's rates in test mode, against the JAX DSL
  with ``num_channels=64`` given after the dropout (JAX's
  ``dropout_layer`` drops the image metadata: ROADMAP C13); and in train
  mode at drop rate 0 against JAX's own ``img_conv_group``, in float64 on
  both sides (x64 and both packages' float64 policy): the loss, every
  gradient leaf and the new moving stats.

Tolerances: float32 on both sides in other summation orders, outputs at
1e-5 absolute and relative (TOL), each gradient leaf within 1e-5 of its
largest entry (GRAD_TOL); the float64 step within 1e-9 of each leaf's
largest entry (F64_TOL; its rounding is ~1e-15) plus 1e-14 (NOISE64: a
conv's bias ahead of a batch norm has no gradient, the mean takes it
out, so its leaves are float64 rounding, ~1e-16 in size).
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu.core import dtypes as jax_dtypes
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.models import image_dsl
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

TOL = 1e-5
GRAD_TOL = 1e-5
F64_TOL = 1e-9
NOISE64 = 1e-14
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, DIN, H = 4, 7, 10, 8
LENGTHS = np.array([7, 3, 5, 1], np.int32)


def _reset(M):
    (jax_reset_names if M is JL else L.reset_names)()


# ------------------------------------------------------------ dropout

def test_dropout_layer_identity_in_test_mode_scaled_in_train_mode():
    rate = 0.3
    L.reset_names()
    x = L.data_layer("x", size=256)
    topo = L.Topology(L.dropout_layer(x, rate))
    assert topo.init(torch.Generator(), device="cpu") == {}
    data = torch.tensor(np.random.RandomState(0).uniform(
        0.5, 1.5, (64, 256)).astype(np.float32))
    assert torch.equal(topo.apply({}, {"x": data}, mode="test"), data)
    out = topo.apply({}, {"x": data}, mode="train",
                     generator=torch.Generator().manual_seed(1))
    kept = out != 0
    torch.testing.assert_close(out[kept], data[kept] / (1.0 - rate),
                               rtol=0, atol=0)
    share, n = float(kept.float().mean()), data.numel()
    assert abs(share - (1.0 - rate)) <= 6 * np.sqrt(rate * (1 - rate) / n)
    # a sequence keeps its lengths; train mode needs a generator
    seq = SequenceBatch(data[:, None, :].expand(64, 3, 256).contiguous(),
                        torch.full((64,), 3, dtype=torch.int32))
    L.reset_names()
    sx = L.data_layer("x", size=256, is_seq=True)
    st = L.Topology(L.dropout_layer(sx, rate))
    sout = st.apply({}, {"x": seq}, mode="train",
                    generator=torch.Generator().manual_seed(2))
    assert isinstance(sout, SequenceBatch) and sout.lengths is seq.lengths
    with pytest.raises(ConfigError, match="generator"):
        st.apply({}, {"x": seq}, mode="train")


# ------------------------------------------------------------ networks

def _image(M, hw=8):
    return M.data_layer("image", size=3 * hw * hw, height=hw, width=hw)


def _seq(M):
    return M.data_layer("x", size=DIN, is_seq=True)


IMAGE_NETS = {
    "simple_img_conv_pool": (8, lambda M, img: M.networks.simple_img_conv_pool(
        img, filter_size=3, num_filters=4, pool_size=2, num_channels=3,
        pool_stride=2)),
    "img_conv_group": (8, lambda M, img: M.networks.img_conv_group(
        img, [4, 5], pool_size=2, num_channels=3, conv_with_batchnorm=True)),
    "img_conv_group_plain": (8, lambda M, img: M.networks.img_conv_group(
        img, [4], pool_size=3, num_channels=3, conv_act="tanh",
        pool_type="avg")),
    "img_conv_bn_pool": (8, lambda M, img: M.networks.img_conv_bn_pool(
        img, filter_size=3, num_filters=4, pool_size=2, num_channels=3,
        pool_stride=2, conv_padding=1)),
    "vgg_16_network": (32, lambda M, img: M.networks.vgg_16_network(
        img, num_channels=3, num_classes=10)),
    "small_vgg": (32, lambda M, img: M.networks.small_vgg(
        img, num_channels=3, num_classes=10)),
}

SEQ_NETS = {
    "simple_lstm": lambda M, x: M.networks.simple_lstm(x, H),
    "simple_lstm_reverse": lambda M, x: M.networks.simple_lstm(
        x, H, reverse=True, name="rev"),
    "simple_gru": lambda M, x: M.networks.simple_gru(x, H),
    "simple_gru_biased": lambda M, x: M.networks.simple_gru(
        x, H, reverse=True, mixed_bias_param_attr=True),
    "simple_gru2": lambda M, x: M.networks.simple_gru2(x, H),
    "bidirectional_lstm": lambda M, x: M.networks.bidirectional_lstm(x, H),
    "bidirectional_lstm_seq": lambda M, x: M.networks.bidirectional_lstm(
        x, H, return_seq=True),
    "bidirectional_gru": lambda M, x: M.networks.bidirectional_gru(x, H),
    "bidirectional_gru_seq": lambda M, x: M.networks.bidirectional_gru(
        x, H, name="bi", return_seq=True),
}


def _build(M, name):
    _reset(M)
    if name in IMAGE_NETS:
        hw, fn = IMAGE_NETS[name]
        return fn(M, _image(M, hw))
    if name == "simple_attention":
        enc = _seq(M)
        proj = M.fc_layer(enc, size=6, act=None, bias_attr=False)
        dec = M.data_layer("dec", size=5)
        return M.networks.simple_attention(enc, proj, dec)
    return SEQ_NETS[name](M, _seq(M))


def _feeds(name, seed=0):
    """The same values as a JAX feed and a port feed."""
    rng = np.random.RandomState(seed)
    if name in IMAGE_NETS:
        hw = IMAGE_NETS[name][0]
        x = rng.standard_normal((2, 3 * hw * hw)).astype(np.float32)
        return {"image": jnp.asarray(x)}, {"image": torch.tensor(x)}
    x = rng.standard_normal((B, T, DIN)).astype(np.float32)
    jf = {"x": JaxSeq(jnp.asarray(x), jnp.asarray(LENGTHS))}
    tf = {"x": SequenceBatch(torch.tensor(x), torch.tensor(LENGTHS))}
    if name == "simple_attention":
        d = rng.standard_normal((B, 5)).astype(np.float32)
        jf["dec"], tf["dec"] = jnp.asarray(d), torch.tensor(d)
    return jf, tf


def _valid(value, lengths):
    """A layer value's data, zero past each row's length if a sequence."""
    if isinstance(value, (SequenceBatch, JaxSeq)):
        data = value.data
        mask = (np.arange(data.shape[1])[None, :] < lengths[:, None])
        m = mask.astype(np.float32)[..., None]
        return data * (torch.tensor(m) if isinstance(data, torch.Tensor)
                       else jnp.asarray(m))
    return value


def _pair(name):
    """Both topologies, JAX's init (seed 0) as numpy and the port's
    params carried from it."""
    jtopo = JL.Topology(_build(JL, name))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(0)))
    ttopo = L.Topology(_build(L, name))
    assert [n.name for n in ttopo.order] == [n.name for n in jtopo.order]
    return jtopo, ttopo, tree, L.params_from_numpy(ttopo, tree, "cpu")


@pytest.mark.parametrize("name", sorted(IMAGE_NETS) + sorted(SEQ_NETS)
                         + ["simple_attention"])
def test_network_matches_jax_in_test_mode(name):
    jtopo, ttopo, tree, params = _pair(name)
    jf, tf = _feeds(name)
    want = _valid(jtopo.apply(tree, jf, mode="test",
                              state=jtopo.init_state()), LENGTHS)
    with torch.no_grad():
        got = _valid(ttopo.apply(params, tf, mode="test",
                                 state=ttopo.init_state("cpu")), LENGTHS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(SEQ_NETS) + ["simple_attention"])
def test_network_gradients_match_jax(name):
    jtopo, ttopo, tree, params = _pair(name)
    jf, tf = _feeds(name, seed=1)
    out_shape = np.shape(_valid(jtopo.apply(tree, jf, mode="train"),
                                LENGTHS))
    cot = np.random.RandomState(2).standard_normal(out_shape).astype(
        np.float32)

    def jloss(p):
        return jnp.sum(_valid(jtopo.apply(p, jf, mode="train"), LENGTHS)
                       * cot)

    jl, jg = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray,
                                                              tree))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = torch.sum(_valid(ttopo.apply(params, tf, mode="train"), LENGTHS)
                     * torch.tensor(cot))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL,
                               atol=TOL)
    loss.backward()
    for got, want in zip(tree_leaves(params), jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        assert np.abs(got.grad.numpy() - want).max() \
            <= GRAD_TOL * np.abs(want).max()


def test_inputs_and_outputs():
    L.reset_names()
    x = _seq(L)
    a, b = L.last_seq(x), L.first_seq(x)
    assert L.networks.inputs([x]) is None
    assert L.networks.outputs(a) is a
    assert L.networks.outputs([a], b) == [a, b]
    assert L.networks.__all__ == JL.networks.__all__


@pytest.mark.parametrize("ctor", ["gru_unit", "gru_group", "lstmemory_unit",
                                  "lstmemory_group"])
def test_refusals_name_a10b(ctor):
    """The four composites run (tests/test_torch_recurrent_units.py).
    Over a SubsequenceInput, since nested groups run (ROADMAP A10·b
    item 1b), each builds the nested group JAX's builds, layer for
    layer, and its step unit refuses a whole sub-sequence as JAX's
    does: a shape error at apply."""
    from paddle_tpu.core.sequence import NestedSequenceBatch as JaxNest
    from paddle_tpu_torch.core.sequence import NestedSequenceBatch
    width = (3 if ctor.startswith("gru") else 4) * H
    data = np.ones((2, 3, 4, width), np.float32)
    outer, inner = np.array([3, 2], np.int32), np.full((2, 3), 4, np.int32)
    names = []
    for M in (L, JL):
        (L.reset_names if M is L else jax_reset_names)()
        sub = M.SubsequenceInput(M.data_layer("x", size=width, is_seq=True))
        fn = getattr(M.networks, ctor)
        node = fn(sub, size=H) if ctor.endswith("_group") \
            else M.recurrent_group(lambda x: fn(x, size=H), sub)
        assert node.cfg["n_sub"] == 1 and node.cfg["n_seq"] == 0
        topo = M.Topology(node)
        names.append([n.name for n in topo.order]
                     + [n.name for n in node.cfg["sub_topo"].order])
        if M is L:
            with pytest.raises(RuntimeError, match="must match the size"):
                topo.apply(topo.init(torch.Generator().manual_seed(0),
                                     device="cpu"),
                           {"x": NestedSequenceBatch(
                               torch.tensor(data), torch.tensor(outer),
                               torch.tensor(inner))})
        else:
            with pytest.raises(ValueError, match="Incompatible shapes"):
                topo.apply(topo.init(jax.random.PRNGKey(0)),
                           {"x": JaxNest(jnp.asarray(data),
                                         jnp.asarray(outer),
                                         jnp.asarray(inner))})
    assert names[0] == names[1]


# ------------------------------------------------------------ vgg_bn_drop

def _demo_vgg():
    spec = importlib.util.spec_from_file_location(
        "image_classification_train", os.path.join(
            ROOT, "demo", "image_classification", "train.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo.vgg_bn_drop


def test_jax_dropout_layer_drops_image_metadata():
    """ROADMAP C13: after JAX's ``dropout_layer`` the demo's second conv
    reads one channel of 256x256; the port's dropout keeps the channels,
    as the reference's (an addto layer) does, so it reads 64 of 32x32."""
    jax_reset_names()
    jnet = _demo_vgg()(_image(JL, 32))
    jconv = jnet.inputs[0].inputs[0]
    assert jconv.layer_type == "conv"
    assert (jconv.cfg["channels"], jconv.cfg["in_shape"]) == (1, (256, 256))
    cost, _ = image_dsl.cifar_vgg()
    conv = cost.inputs[0].inputs[0].inputs[0].inputs[0]
    assert conv.layer_type == "conv"
    assert (conv.cfg["channels"], conv.cfg["in_shape"]) == (64, (32, 32))
    assert conv.inputs[0].layer_type == "dropout"


def _jax_vgg_bn_drop():
    """The demo's vgg model in the JAX DSL, ``num_channels=64`` on the
    conv after the dropout (C13)."""
    jax_reset_names()
    img = _image(JL, 32)
    label = JL.data_layer("label", size=1)
    net = JL.img_conv_layer(img, filter_size=3, num_filters=64,
                            num_channels=3, padding=1, act=None)
    net = JL.dropout_layer(JL.batch_norm_layer(net, act="relu"), 0.3)
    net = JL.img_conv_layer(net, filter_size=3, num_filters=64,
                            num_channels=64, padding=1, act=None)
    net = JL.batch_norm_layer(net, act="relu")
    net = JL.img_pool_layer(net, pool_size=2, stride=2, num_channels=64)
    out = JL.fc_layer(net, size=10, act="softmax")
    return JL.classification_cost(out, label), out


def _cifar_batch(n):
    from paddle_tpu_torch.data.datasets import cifar
    it = cifar.train10()()
    samples = [next(it) for _ in range(n)]
    x = np.stack([s[0] for s in samples])
    y = np.array([[s[1]] for s in samples], np.int32)
    return x, y


def test_vgg_bn_drop_matches_jax_in_test_mode():
    jcost, jout = _jax_vgg_bn_drop()
    jtopo = JL.Topology(jout)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(4)))
    _, out = image_dsl.cifar_vgg()
    ttopo = L.Topology(out)
    params = L.params_from_numpy(ttopo, tree, "cpu")
    x, _ = _cifar_batch(2)
    state = {k: tuple(np.random.RandomState(5).uniform(0.5, 1.5, np.shape(
        v[0])).astype(np.float32) for _ in v)
        for k, v in jtopo.init_state().items()}
    want = jtopo.apply(tree, {"image": jnp.asarray(x)}, mode="test",
                       state=state)
    with torch.no_grad():
        got = ttopo.apply(params, {"image": torch.tensor(x)}, mode="test",
                          state=tree_map(torch.tensor, state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@contextlib.contextmanager
def _float64():
    jax.config.update("jax_enable_x64", True)
    jax_dtypes.set_policy("float64", "float64")
    dtypes.set_policy("float64", "float64")
    try:
        yield
    finally:
        dtypes.set_policy("float32", None)
        jax_dtypes.set_policy("float32", None)
        jax.config.update("jax_enable_x64", False)


def test_vgg_bn_drop_train_step_float64_at_rate_0():
    """Train mode (batch norm on the batch's statistics) with both
    dropout rates 0, where JAX's ``img_conv_group`` adds no dropout layer
    and builds the demo's network: the loss, every gradient leaf and the
    new moving stats, float64 on both sides."""
    jax_reset_names()
    img, label = _image(JL, 32), JL.data_layer("label", size=1)
    jout = JL.fc_layer(JL.networks.img_conv_group(
        img, [64, 64], pool_size=2, num_channels=3, conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=[0.0, 0.0]), size=10, act="softmax")
    jtopo = JL.Topology(JL.classification_cost(jout, label))
    cost, _ = image_dsl.cifar_vgg(drop_rates=(0.0, 0.0))
    ttopo = L.Topology(cost)
    assert [n.name for n in ttopo.order] == [n.name for n in jtopo.order]
    x, y = _cifar_batch(2)
    x = x.astype(np.float64)
    # float32 draws, widened on both sides
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(6)))
    with _float64():
        jstate = jtopo.init_state()

        def jloss(p):
            c, st = jtopo.apply(p, {"image": jnp.asarray(x),
                                    "label": jnp.asarray(y)}, mode="train",
                                state=jstate, return_state=True)
            return jnp.mean(c), st

        (jl, jst), jg = jax.value_and_grad(jloss, has_aux=True)(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   tree))
        params = tree_map(torch.Tensor.double,
                          L.params_from_numpy(ttopo, tree, "cpu"))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        c, st = ttopo.apply(params, {"image": torch.tensor(x),
                                     "label": torch.tensor(y)},
                            mode="train", state=tree_map(
                                torch.Tensor.double,
                                ttopo.init_state("cpu")),
                            return_state=True)
        loss = torch.mean(c)
        loss.backward()
    assert loss.dtype == torch.float64 and jl.dtype == np.float64
    assert abs(float(loss.detach()) - float(jl)) <= F64_TOL * abs(float(jl))
    got = [p.grad for p in tree_leaves(params)] + tree_leaves(st)
    want = jax.tree_util.tree_leaves(jg) + jax.tree_util.tree_leaves(jst)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.detach().double().numpy() - w).max() \
            <= F64_TOL * np.abs(w).max() + NOISE64
