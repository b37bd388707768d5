"""The port's vision DSL layers (``paddle_tpu_torch/layers/vision.py``),
``data_layer(height=, width=)``, ``addto_layer`` and batch norm's state
through ``trainer.SGD`` against the JAX package on the CPU: one graph
holding every layer, in train mode (outputs and the new moving stats)
and in test mode (on those stats), on the JAX init carried across; the
``demo/mnist`` config's first SGD steps; the ``demo/image_classification``
DSL ResNet (``models/image_dsl.resnet_cifar``) at depth 8 -- two SGD
steps, the moving stats, a test pass, and checkpoints loaded across the
packages both ways.

Tolerances: float32 on both sides in other summation orders, 1e-5
absolute and relative for a layer's output (TOL); the trainers' losses
at 1e-5 relative, each parameter, momentum and moving-stat leaf within
1e-4 of its largest entry after the steps (STEP_TOL: two steps of a
deep conv stack compound the orders' differences) plus 1e-8 (NOISE, the
size of a leaf that is rounding alone).
"""

import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.data import dense_vector as jax_dense_vector
from paddle_tpu.data import integer_value as jax_integer_value
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.trainer import SGD as JaxSGD
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data import dense_vector, integer_value
from paddle_tpu_torch.models import image_dsl
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves

TOL = 1e-5
STEP_TOL = 1e-4
# a conv's bias ahead of a batch norm has no gradient (the mean takes it
# out): its leaves and momenta are float32 rounding, 1e-9 in size
NOISE = 1e-8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset(M):
    (jax_reset_names if M is JL else L.reset_names)()


def _zoo(M):
    """Every vision layer on one 3x8x8 image (the same ctor calls in
    either DSL): the outputs, in a fixed order."""
    _reset(M)
    img = M.data_layer("image", size=3 * 8 * 8, height=8, width=8)
    c1 = M.img_conv_layer(img, filter_size=3, num_filters=6, num_channels=3,
                          padding=1, act="relu")
    c2 = M.img_conv_layer(c1, filter_size=(3, 2), num_filters=6, stride=2,
                          groups=2, act=None)
    pool_ceil = M.img_pool_layer(c1, pool_size=3, stride=2, padding=1)
    pool_avg = M.img_pool_layer(c1, pool_size=3, stride=2, pool_type="avg",
                                ceil_mode=False)
    pool_avg_ceil = M.img_pool_layer(c1, pool_size=3, stride=2,
                                     pool_type="avg")
    bn = M.batch_norm_layer(c1, act="relu", moving_average_fraction=0.8)
    bn_global = M.batch_norm_layer(c2, use_global_stats=True)
    lrn = M.img_cmrnorm_layer(c1, size=5, scale=0.01)
    ccn = M.cross_channel_norm_layer(c1)
    mo = M.maxout_layer(c1, groups=2)
    up = M.bilinear_interp_layer(c1, out_size_x=11, out_size_y=10)
    down = M.bilinear_interp_layer(c1, out_size_x=5, out_size_y=3)
    pad = M.pad_layer(c1, pad_c=(1, 0), pad_h=(0, 1), pad_w=(2, 1))
    spp = M.spp_layer(c1, pyramid_height=2, pool_type="avg")
    trans = M.img_conv_layer(c1, filter_size=3, num_filters=6, stride=2,
                             padding=1, trans=True, act=None)
    fc = M.fc_layer(pool_ceil, size=5, act=None)
    bn_fc = M.batch_norm_layer(fc, act="tanh")
    dn = M.data_norm_layer(fc)
    add = M.addto_layer([bn, lrn], act="relu")
    prior = M.priorbox_layer(c1, img, min_size=[2.0], max_size=[4.0],
                             aspect_ratio=[2.0])
    blocks = M.block_expand_layer(c1, block_x=2, block_y=2, stride_x=2,
                                  stride_y=2)
    return [c1, c2, pool_ceil, pool_avg, pool_avg_ceil, bn, bn_global, lrn,
            ccn, mo, up, down, pad, spp, trans, fc, bn_fc, dn, add, prior,
            blocks]


def _np(v):
    if isinstance(v, SequenceBatch) or hasattr(v, "lengths"):
        return np.asarray(v.data), np.asarray(v.lengths)
    return np.asarray(v)


@pytest.fixture(scope="module")
def zoo_jax():
    """The JAX graph's init (as numpy), its feed, and its outputs and
    state in train mode then in test mode on the new state."""
    outs = _zoo(JL)
    topo = JL.Topology(outs)
    params = topo.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).standard_normal((4, 3 * 8 * 8)).astype(
        np.float32)
    train, state = topo.apply(params, {"image": jnp.asarray(x)},
                              mode="train", state=topo.init_state(),
                              return_state=True)
    test = topo.apply(params, {"image": jnp.asarray(x)}, mode="test",
                      state=state)
    host = jax.tree_util.tree_map
    return {"params": host(np.asarray, params), "x": x,
            "train": [_np(v) for v in train], "test": [_np(v) for v in test],
            "state": host(np.asarray, state),
            "init_state": host(np.asarray, topo.init_state()),
            "names": [n.name for n in outs],
            "shapes": [(n.size, n.num_filters, n.img_shape) for n in outs]}


def _compare(got, want, names):
    for name, g, w in zip(names, got, want):
        if isinstance(w, tuple):
            np.testing.assert_allclose(g.data.numpy(), w[0], rtol=TOL,
                                       atol=TOL, err_msg=name)
            np.testing.assert_array_equal(g.lengths.numpy(), w[1])
        else:
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=TOL,
                                       atol=TOL, err_msg=name)


def test_vision_layers_match_jax(zoo_jax):
    """Names, sizes and image metadata as JAX's; each layer's output in
    train mode, the moving stats it puts, and each output in test mode
    on those stats."""
    outs = _zoo(L)
    assert [n.name for n in outs] == zoo_jax["names"]
    got = [(n.size, n.num_filters, n.img_shape) for n in outs]
    want = list(zoo_jax["shapes"])
    # the addto keeps its inputs' image metadata (JAX's drops it: C11)
    add = zoo_jax["names"].index(outs[18].name)
    assert want[add] == (outs[18].size, None, None)
    want[add] = (outs[18].size, 6, (8, 8))
    assert got == want
    topo = L.Topology(outs)
    params = L.params_from_numpy(topo, zoo_jax["params"], device="cpu")
    feed = {"image": torch.tensor(zoo_jax["x"])}
    state0 = topo.init_state(device="cpu")
    assert set(state0) == set(zoo_jax["init_state"])
    train, state = topo.apply(params, feed, mode="train", state=state0,
                              return_state=True)
    _compare(train, zoo_jax["train"], zoo_jax["names"])
    assert set(state) == set(zoo_jax["state"])
    for name, (mean, var) in state.items():
        want_mean, want_var = zoo_jax["state"][name]
        np.testing.assert_allclose(mean.numpy(), want_mean, rtol=TOL,
                                   atol=TOL, err_msg=name)
        np.testing.assert_allclose(var.numpy(), want_var, rtol=TOL,
                                   atol=TOL, err_msg=name)
    test = topo.apply(params, feed, mode="test", state=state)
    _compare(test, zoo_jax["test"], zoo_jax["names"])


def test_mixed_layer_parts_raise():
    img = L.data_layer("image", size=3 * 8 * 8, height=8, width=8)
    with pytest.raises(ConfigError, match="mixed_layer"):
        L.conv_projection(img, filter_size=3, num_filters=4, num_channels=3)
    with pytest.raises(ConfigError, match="mixed_layer"):
        L.conv_operator(img, img, filter_size=3, num_filters=4)


# ----------------------------------------------------------- mnist demo

MNIST_FEEDING = {"pixel": dense_vector(784), "label": integer_value(10)}
JAX_MNIST_FEEDING = {"pixel": jax_dense_vector(784),
                     "label": jax_integer_value(10)}


def _jax_lenet():
    """demo/mnist/train.py's network, as the JAX demo writes it."""
    jax_reset_names()
    img = JL.data_layer("pixel", size=784, height=28, width=28)
    label = JL.data_layer("label", size=1)
    conv1 = JL.img_conv_layer(img, filter_size=5, num_filters=20,
                              num_channels=1, act="relu")
    pool1 = JL.img_pool_layer(conv1, pool_size=2, stride=2, ceil_mode=False)
    conv2 = JL.img_conv_layer(pool1, filter_size=5, num_filters=50,
                              act="relu")
    pool2 = JL.img_pool_layer(conv2, pool_size=2, stride=2, ceil_mode=False)
    fc1 = JL.fc_layer(pool2, size=500, act="relu")
    out = JL.fc_layer(fc1, size=10, act="softmax")
    return JL.classification_cost(out, label)


def _mnist_batches(n, batch=8):
    from paddle_tpu_torch.data.datasets import mnist
    samples = []
    for sample in mnist.train()():
        samples.append(sample)
        if len(samples) == n * batch:
            break
    return [samples[i * batch:(i + 1) * batch] for i in range(n)]


def _leaves_close(got, want):
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert np.abs(g - w).max() <= STEP_TOL * np.abs(w).max() + NOISE


def test_mnist_demo_sgd_steps_match_jax():
    """The demo/mnist config (image_dsl.lenet) on the mnist loader's
    batches: two Momentum steps against paddle_tpu.trainer.SGD's from
    the same weights."""
    batches = _mnist_batches(2)
    jt = JaxSGD(_jax_lenet(), update_equation=jax_optim.Momentum(
        learning_rate=0.01, momentum=0.9), seed=5)
    start = jax.tree_util.tree_map(np.asarray, jt.parameters)
    want = [float(jt.train_one_batch(b, feeder=JAX_MNIST_FEEDING))
            for b in batches]
    cost, _ = image_dsl.lenet()
    trainer = SGD(cost, parameters=start, update_equation=optim.Momentum(
        learning_rate=0.01, momentum=0.9), device="cpu")
    got = [float(trainer.train_one_batch(b, feeder=MNIST_FEEDING))
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=TOL)
    _leaves_close(tree_leaves(trainer.parameters),
                  jax.tree_util.tree_leaves(jt.parameters))


# ------------------------------------------------------ DSL resnet_cifar

CIFAR_FEEDING = {"image": dense_vector(3 * 32 * 32),
                 "label": integer_value(10)}
JAX_CIFAR_FEEDING = {"image": jax_dense_vector(3 * 32 * 32),
                     "label": jax_integer_value(10)}


def _jax_resnet_cifar(depth):
    """demo/image_classification/train.py's resnet_cifar in the JAX DSL,
    ``num_channels=`` given on each layer after an ``addto_layer`` (the
    JAX node drops its inputs' channels: ROADMAP C11)."""
    jax_reset_names()
    img = JL.data_layer("image", size=3 * 32 * 32, height=32, width=32)
    label = JL.data_layer("label", size=1)
    n = (depth - 2) // 6
    net = JL.img_conv_layer(img, filter_size=3, num_filters=16,
                            num_channels=3, padding=1, act=None)
    net = JL.batch_norm_layer(net, act="relu")
    filters, chans = 16, None
    for stage, nf in enumerate((16, 32, 64)):
        for block in range(n):
            stride = 2 if (stage > 0 and block == 0) else 1
            conv1 = JL.img_conv_layer(net, filter_size=3, num_filters=nf,
                                      stride=stride, padding=1, act=None,
                                      num_channels=chans)
            bn1 = JL.batch_norm_layer(conv1, act="relu")
            conv2 = JL.img_conv_layer(bn1, filter_size=3, num_filters=nf,
                                      padding=1, act=None)
            bn2 = JL.batch_norm_layer(conv2, act=None)
            if stride == 2 or filters != nf:
                proj = JL.img_conv_layer(net, filter_size=1, num_filters=nf,
                                         stride=stride, act=None,
                                         num_channels=chans)
                net = JL.addto_layer([bn2, proj], act="relu")
            else:
                net = JL.addto_layer([bn2, net], act="relu")
            filters, chans = nf, nf
    net = JL.img_pool_layer(net, pool_size=8, stride=1, pool_type="avg",
                            num_channels=chans)
    out = JL.fc_layer(net, size=10, act="softmax")
    return JL.classification_cost(out, label)


def test_jax_demo_resnet_cifar_needs_channels_after_addto():
    """ROADMAP C11: the JAX demo's resnet_cifar, as written, raises at
    its first stride-2 block (the conv after an addto reads 1 channel);
    the port's addto keeps its inputs' channels, so the same code
    builds (models/image_dsl.resnet_cifar)."""
    spec = importlib.util.spec_from_file_location(
        "image_classification_train", os.path.join(
            ROOT, "demo", "image_classification", "train.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    jax_reset_names()
    img = JL.data_layer("image", size=3 * 32 * 32, height=32, width=32)
    with pytest.raises(JaxConfigError, match="cannot infer square image"):
        demo.resnet_cifar(img, depth=8)
    cost, _ = image_dsl.cifar_resnet(depth=8)
    assert cost.inputs[0].inputs[0].img_shape == (1, 1)


@pytest.fixture(scope="module")
def resnet_jax(tmp_path_factory):
    """The JAX trainer on the DSL ResNet at depth 8: its init, two
    Momentum steps' losses, params, momentum and moving stats, a test
    pass, and a checkpoint of its state."""
    from paddle_tpu_torch.data.datasets import cifar
    samples = []
    for sample in cifar.train10()():
        samples.append(sample)
        if len(samples) == 12:
            break
    batches = [samples[:6], samples[6:]]
    jt = JaxSGD(_jax_resnet_cifar(8), update_equation=jax_optim.Momentum(
        learning_rate=0.01, momentum=0.9, l2=1e-4), seed=7)
    start = jax.tree_util.tree_map(np.asarray, jt.parameters)
    losses = [float(jt.train_one_batch(b, feeder=JAX_CIFAR_FEEDING))
              for b in batches]
    test = jt.test(lambda: iter([batches[0]]), feeding=JAX_CIFAR_FEEDING)
    save = tmp_path_factory.mktemp("jax_ckpt")
    jt.save(str(save), 0)
    host = jax.tree_util.tree_map
    return {"batches": batches, "start": start, "losses": losses,
            "test": test, "params": host(np.asarray, jt.parameters),
            "mom": host(np.asarray, jt.opt_state["slots"]["mom"]),
            "state": host(np.asarray, jt.model_state), "save": str(save)}


def _port_resnet(parameters=None):
    cost, _ = image_dsl.cifar_resnet(depth=8)
    return SGD(cost, parameters=parameters, update_equation=optim.Momentum(
        learning_rate=0.01, momentum=0.9, l2=1e-4), device="cpu")


def test_dsl_resnet_cifar_trains_like_jax(resnet_jax):
    """Two SGD steps of the DSL ResNet at depth 8 from the JAX weights:
    losses, every param, momentum and moving-stat leaf; then a test pass
    on the moving stats."""
    trainer = _port_resnet(resnet_jax["start"])
    assert set(trainer.model_state) == set(resnet_jax["state"])
    losses = [float(trainer.train_one_batch(b, feeder=CIFAR_FEEDING))
              for b in resnet_jax["batches"]]
    np.testing.assert_allclose(losses, resnet_jax["losses"], rtol=TOL)
    _leaves_close(tree_leaves(trainer.parameters)
                  + tree_leaves(trainer.opt_state["slots"]["mom"]),
                  jax.tree_util.tree_leaves(resnet_jax["params"])
                  + jax.tree_util.tree_leaves(resnet_jax["mom"]))
    for name, (mean, var) in trainer.model_state.items():
        _leaves_close([mean, var], resnet_jax["state"][name])
    test = trainer.test(lambda: iter([resnet_jax["batches"][0]]),
                        feeding=CIFAR_FEEDING)
    np.testing.assert_allclose(test, resnet_jax["test"], rtol=STEP_TOL)


def test_moving_stats_cross_checkpoints_both_ways(resnet_jax, tmp_path):
    """A JAX pass dir loads into the port with its moving stats (tuples
    of (mean, var)), and the port's save loads back into a JAX trainer
    with the same stats bit for bit."""
    trainer = _port_resnet()
    trainer.load(resnet_jax["save"])
    for name, stats in trainer.model_state.items():
        assert isinstance(stats, tuple)
        for got, want in zip(stats, resnet_jax["state"][name]):
            np.testing.assert_array_equal(got.numpy(), want)
    trainer.train_one_batch(resnet_jax["batches"][1], feeder=CIFAR_FEEDING)
    trainer.save(str(tmp_path), 3)
    jt = JaxSGD(_jax_resnet_cifar(8), update_equation=jax_optim.Momentum(
        learning_rate=0.01, momentum=0.9, l2=1e-4))
    jt.load(str(tmp_path))
    for name, stats in trainer.model_state.items():
        for got, want in zip(stats, jt.model_state[name]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
