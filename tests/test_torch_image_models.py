"""The port's image models (``paddle_tpu_torch/models``: lenet, smallnet,
resnet at a CIFAR and a bottleneck depth, alexnet, googlenet) and the
image loaders (``data/datasets``: mnist, cifar) against the JAX package
on the CPU, from the same weights (carried by ``params_from_numpy``):
forward, loss, every gradient leaf and the new batch-norm state; the
ResNet's remat step against its plain step; AlexNet and GoogLeNet
forward at batch 1; the loaders' arrays element for element.

Tolerances: float32 on both sides in other summation orders -- logits
and losses at 1e-5 absolute and relative (TOL), each gradient leaf
within 1e-4 of its largest entry (GRAD_TOL: through up to 50 conv and
batch-norm layers), the moving stats at TOL.  The remat step is the
plain step's arithmetic recomputed, held at 1e-6.  The bottleneck
ResNet's train step also runs in float64 on both sides (JAX's x64 and
both packages' float64 policy), its loss, gradients and new state each
within 1e-9 of their largest entry (F64_TOL; float64 rounding through
50 layers is ~1e-13).
"""

import contextlib

import numpy as np
import pytest
import jax
import torch

from paddle_tpu.core import dtypes as jax_dtypes
from paddle_tpu.data.datasets import cifar as jax_cifar
from paddle_tpu.data.datasets import mnist as jax_mnist
from paddle_tpu.models import alexnet as jax_alexnet
from paddle_tpu.models import googlenet as jax_googlenet
from paddle_tpu.models import lenet as jax_lenet
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.models import smallnet as jax_smallnet
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.data.datasets import cifar, mnist
from paddle_tpu_torch.models import alexnet, googlenet, lenet, resnet, \
    smallnet
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

TOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
F64_TOL = 1e-9


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy_init(tmod, *args, **kw):
    """The port's init on the CPU as numpy: the weights both packages
    start from (JAX's eager inits of these trees take seconds each on
    the CPU; the trees share keys and shapes, which ``params_from_numpy``
    checks on the way back)."""
    out = tmod.init(torch.Generator().manual_seed(0), *args, device="cpu",
                    **kw)
    host = lambda t: tree_map(lambda a: a.numpy(), t)  # noqa: E731
    return tuple(host(t) for t in out) if isinstance(out, tuple) \
        else host(out)


def _grads_close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-6), err


def _leaves_require_grad(params):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _backward(loss, params):
    loss.backward()
    return tree_map(lambda p: p.grad, params)


def test_lenet_forward_loss_and_grads():
    rng = np.random.RandomState(0)
    jp = _numpy_init(lenet)
    x = np.tanh(rng.standard_normal((3, 784))).astype(np.float32)
    y = rng.randint(0, 10, 3).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(jax_lenet.loss))(jp, x, y)
    p = _leaves_require_grad(lenet.params_from_numpy(_host(jp), "cpu"))
    np.testing.assert_allclose(
        lenet.forward(p, torch.tensor(x)).detach().numpy(),
        np.asarray(jax_lenet.forward(jp, x)), rtol=TOL, atol=TOL)
    loss = lenet.loss(p, torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    _grads_close(_backward(loss, p), jg)


def test_params_from_numpy_refuses_another_config():
    jp = _numpy_init(lenet, num_classes=7)
    with pytest.raises(ValueError, match="does not fit"):
        lenet.params_from_numpy(jp, "cpu")
    assert lenet.params_from_numpy(jp, "cpu", num_classes=7)["f2"]["w"] \
        .shape == (500, 7)


def _stateful_case(jmod, tmod, jp, js, x, y, jkw, tkw, tp=None, ts=None):
    """(loss, grads, new state) of JAX's ``loss`` and the port's on the
    carried weights, compared."""
    (jl, jst), jg = jax.jit(jax.value_and_grad(
        lambda p, s: jmod.loss(p, s, x, y, **jkw), has_aux=True))(jp, js)
    p = tp if tp is not None else tmod.params_from_numpy(_host(jp), "cpu")
    p = _leaves_require_grad(p)
    s = ts if ts is not None else {}
    loss, st = tmod.loss(p, s, torch.tensor(x), torch.tensor(y), **tkw)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    _grads_close(_backward(loss, p), jg)
    for got, want in zip(tree_leaves(st), jax.tree_util.tree_leaves(jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    return p, st


def test_smallnet_forward_loss_and_grads():
    rng = np.random.RandomState(1)
    jp, js = _numpy_init(smallnet)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    y = rng.randint(0, 10, 2).astype(np.int32)
    np.testing.assert_allclose(
        smallnet.forward(smallnet.params_from_numpy(_host(jp), "cpu"), {},
                         torch.tensor(x))[0].detach().numpy(),
        np.asarray(jax_smallnet.forward(jp, js, x)[0]), rtol=TOL, atol=TOL)
    _stateful_case(jax_smallnet, smallnet, jp, js, x, y, {}, {})


@pytest.fixture(scope="module")
def resnet20():
    rng = np.random.RandomState(2)
    jp, js = _numpy_init(resnet, depth=20, num_classes=10)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 10, 2).astype(np.int32)
    return jp, js, x, y


def _resnet_port(jp, js, depth, **kw):
    return (resnet.params_from_numpy(_host(jp), "cpu", depth=depth, **kw),
            resnet.params_from_numpy(_host(js), "cpu", depth=depth,
                                     state=True, **kw))


def test_resnet_cifar_depth_train_and_infer(resnet20):
    """ResNet-20 (CIFAR: basic blocks, 16/32/64 wide) at 16x16: the train
    step's loss, gradients and new moving stats; test-mode logits on the
    new stats; ``features`` equal to the forward's pooled tensor."""
    jp, js, x, y = resnet20
    kw = {"depth": 20}
    tp, ts = _resnet_port(jp, js, 20, num_classes=10)
    _, st = _stateful_case(jax_resnet, resnet, jp, js, x, y, kw, kw, tp, ts)
    _, jst = jax_resnet.loss(jp, js, x, y, depth=20)
    want = jax_resnet.forward(jp, jst, x, depth=20, train=False)[0]
    with torch.no_grad():
        got, same = resnet.forward(tp, st, torch.tensor(x), depth=20,
                                   train=False)
        assert all(a is b for a, b in zip(tree_leaves(same),
                                          tree_leaves(st)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        feats = resnet.features(tp, st, torch.tensor(x), depth=20)
        pooled, _ = resnet.forward(tp, st, torch.tensor(x), depth=20,
                                   train=False, return_pool=True)
    assert torch.equal(feats, pooled)
    np.testing.assert_allclose(
        feats.numpy(), np.asarray(jax_resnet.features(jp, jst, x, depth=20)),
        rtol=TOL, atol=TOL)


def test_resnet_remat_matches_the_plain_step(resnet20):
    """``remat=True`` (each block checkpointed): the same loss, gradients
    and new moving stats as the plain step; the stats update once."""
    jp, js, x, y = resnet20
    out = []
    for remat in (False, True):
        tp, ts = _resnet_port(jp, js, 20, num_classes=10)
        _leaves_require_grad(tp)
        loss, st = resnet.loss(tp, ts, torch.tensor(x), torch.tensor(y),
                               depth=20, remat=remat)
        out.append((float(loss.detach()), _backward(loss, tp), st))
    (l0, g0, s0), (l1, g1, s1) = out
    assert abs(l0 - l1) <= REMAT_TOL * abs(l0)
    for a, b in zip(tree_leaves(g0) + tree_leaves(s0),
                    tree_leaves(g1) + tree_leaves(s1)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=REMAT_TOL,
                                   atol=REMAT_TOL)
    _, jst = jax_resnet.loss(jp, js, x, y, depth=20)
    for got, want in zip(tree_leaves(s1), jax.tree_util.tree_leaves(jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.fixture(scope="module")
def bottleneck():
    rng = np.random.RandomState(3)
    jp, js = _numpy_init(resnet, depth=50, num_classes=10)
    x = rng.standard_normal((2, 64, 64, 3))
    y = rng.randint(0, 10, 2).astype(np.int32)
    return jp, js, x, y


def test_resnet_bottleneck_depth(bottleneck):
    """ResNet-50's bottleneck blocks (the ImageNet stem, 7x7 s2 and a 3x3
    s2 max pool) at 64x64, 10 classes, batch 2, in float32.  The train
    step's loss at TOL and its new moving stats within GRAD_TOL of their
    largest entry (the stats of the deepest stage carry the same
    amplification); the gradients in test mode (batch norm on the moving
    stats) at GRAD_TOL.  In train mode the last stage normalizes 8
    values a channel, which multiplies the two sides' float32 rounding
    differences until some ReLU decisions flip, each flip moving its
    channel's gradients by O(1); the train-mode gradients are held in
    float64 below."""
    jp, js, x, y = bottleneck
    x = x.astype(np.float32)
    tp, ts = _resnet_port(jp, js, 50, num_classes=10)
    _leaves_require_grad(tp)
    jl, jst = jax.jit(lambda p, s: jax_resnet.loss(p, s, x, y, depth=50))(
        jp, js)
    loss, st = resnet.loss(tp, ts, torch.tensor(x), torch.tensor(y),
                           depth=50)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    for got, want in zip(tree_leaves(st), jax.tree_util.tree_leaves(jst)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() \
            <= GRAD_TOL * np.abs(want).max()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_resnet.loss(p, js, x, y, depth=50, train=False),
        has_aux=True))(jp)
    loss, _ = resnet.loss(tp, ts, torch.tensor(x), torch.tensor(y),
                          depth=50, train=False)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    _grads_close(_backward(loss, tp), jg)


@contextlib.contextmanager
def _float64():
    """JAX's x64 and both packages' float64 policy (parameters and
    compute) for the block."""
    jax.config.update("jax_enable_x64", True)
    jax_dtypes.set_policy("float64", "float64")
    dtypes.set_policy("float64", "float64")
    try:
        yield
    finally:
        dtypes.set_policy("float32", None)
        jax_dtypes.set_policy("float32", None)
        jax.config.update("jax_enable_x64", False)


def test_resnet_bottleneck_train_step_float64(bottleneck):
    """The bottleneck ResNet's train step (batch norm on the batch's
    statistics) in float64 on both sides, where no ReLU or max-pool
    decision lies within rounding of its kink: the loss, every gradient
    leaf and the new moving stats within F64_TOL of their largest
    entry."""
    jp, js, x, y = bottleneck
    with _float64():
        (jl, jst), jg = jax.jit(jax.value_and_grad(
            lambda p, s: jax_resnet.loss(p, s, x, y, depth=50),
            has_aux=True))(*(jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), t) for t in (jp, js)))
        tp, ts = (tree_map(torch.Tensor.double, t)
                  for t in _resnet_port(jp, js, 50, num_classes=10))
        _leaves_require_grad(tp)
        loss, st = resnet.loss(tp, ts, torch.tensor(x), torch.tensor(y),
                               depth=50)
        grads = _backward(loss, tp)
    assert loss.dtype == torch.float64 and jl.dtype == np.float64
    assert abs(float(loss.detach()) - float(jl)) <= F64_TOL * abs(float(jl))
    for got, want in zip(tree_leaves(grads) + tree_leaves(st),
                         jax.tree_util.tree_leaves(jg)
                         + jax.tree_util.tree_leaves(jst)):
        want = np.asarray(want)
        assert got.dtype == torch.float64
        assert np.abs(got.detach().numpy() - want).max() \
            <= F64_TOL * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("name", ["alexnet", "googlenet"])
def test_forward_at_batch_1(name):
    """AlexNet (227x227) and GoogLeNet (224x224) forward at batch 1 in
    test mode: the logits; with a generator, train mode draws dropout
    from it, and without one it is the identity, as JAX's."""
    jmod, tmod, hw = {"alexnet": (jax_alexnet, alexnet, 227),
                      "googlenet": (jax_googlenet, googlenet, 224)}[name]
    jp, js = _numpy_init(tmod, num_classes=10)
    x = np.random.RandomState(4).standard_normal((1, hw, hw, 3)).astype(
        np.float32)
    tp = tmod.params_from_numpy(jp, "cpu", num_classes=10)
    want = np.asarray(jax.jit(lambda p: jmod.forward(p, js, x,
                                                     train=False)[0])(jp))
    with torch.no_grad():
        got = tmod.forward(tp, {}, torch.tensor(x), train=False)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        plain = tmod.forward(tp, {}, torch.tensor(x), train=True)[0]
        assert torch.equal(plain, got)
        drop = tmod.forward(tp, {}, torch.tensor(x), train=True,
                            rng=torch.Generator().manual_seed(0))[0]
        assert not torch.equal(drop, got) and torch.isfinite(drop).all()


@pytest.mark.parametrize("name", ["alexnet", "googlenet"])
def test_train_step_float64(name):
    """AlexNet's and GoogLeNet's train step at batch 2 (train mode with no
    dropout generator, so dropout is the identity on both sides) in
    float64 on both sides: the loss and every gradient leaf within
    F64_TOL of their largest entry.  In float32 GoogLeNet's ReLU and
    max-pool decisions flip between the packages (its worst leaf reads
    ~3e-3), so the step is held in float64."""
    jmod, tmod, hw = {"alexnet": (jax_alexnet, alexnet, 227),
                      "googlenet": (jax_googlenet, googlenet, 224)}[name]
    jp, js = _numpy_init(tmod, num_classes=10)
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, hw, hw, 3))
    y = rng.randint(0, 10, 2).astype(np.int32)
    with _float64():
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jmod.loss(p, js, x, y, train=True), has_aux=True))(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jp))
        tp = _leaves_require_grad(tree_map(
            torch.Tensor.double,
            tmod.params_from_numpy(jp, "cpu", num_classes=10)))
        loss, _ = tmod.loss(tp, {}, torch.tensor(x), torch.tensor(y),
                            train=True)
        grads = _backward(loss, tp)
    assert loss.dtype == torch.float64 and jl.dtype == np.float64
    assert abs(float(loss.detach()) - float(jl)) <= F64_TOL * abs(float(jl))
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jax.tree_util.tree_leaves(jg))
    for got, want in zip(leaves, jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        assert got.dtype == torch.float64
        assert np.abs(got.detach().numpy() - want).max() \
            <= F64_TOL * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("loader", ["mnist.train", "mnist.test",
                                    "cifar.train10", "cifar.test100"])
def test_loaders_give_jax_arrays(loader):
    """The synthetic fallback (no files under PADDLE_TPU_DATA_DIR) yields
    JAX's samples, element for element."""
    mod, fn = loader.split(".")
    mine = getattr({"mnist": mnist, "cifar": cifar}[mod], fn)()
    theirs = getattr({"mnist": jax_mnist, "cifar": jax_cifar}[mod], fn)()
    n = 0
    for (x, y), (jx, jy) in zip(mine(), theirs()):
        np.testing.assert_array_equal(x, jx)
        assert y == jy
        n += 1
    assert n == {"train": 4096, "test": 512, "train10": 4096,
                 "test100": 512}[fn]
