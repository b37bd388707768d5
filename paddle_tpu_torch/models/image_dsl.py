"""The image demos' networks as layer-DSL configs: the trunks that
``trainer.SGD`` and ``python -m paddle_tpu_torch train`` run on images.

``lenet`` is ``demo/mnist/train.py:19-28`` (the reference's
demo/mnist api_train_v2.py): a 28x28 gray image -> conv 20@5 relu ->
max pool 2s2 -> conv 50@5 relu -> max pool 2s2 -> fc 500 relu -> fc 10
softmax -> classification cost, trained with Momentum (lr 0.01,
momentum 0.9) on ``data.datasets.mnist``.

``resnet_cifar`` is ``demo/image_classification/train.py:20-44``: a
3x32x32 image -> conv 16@3 + batch norm relu -> 3 stages of (depth - 2)
// 6 basic blocks of conv + batch norm, each summed with its input (or
a strided 1x1 conv of it) by ``addto_layer`` -> 8x8 average pool -> fc
10 softmax, trained with Momentum (lr 0.01, momentum 0.9, l2 1e-4) on
``data.datasets.cifar``.  Its batch norms keep moving stats, which the
trainer threads through its steps and checkpoints.  The JAX package
runs both unchanged (its ``resnet_cifar`` with ``num_channels=`` on the
layers after each sum: ROADMAP C11).

``vgg_bn_drop`` is the same demo's vgg model
(``demo/image_classification/train.py:14-17``):
``networks.img_conv_group([64, 64], pool_size=2, num_channels=3,
conv_with_batchnorm=True, conv_batchnorm_drop_rate=[0.3, 0.0])`` -- conv
64@3 + batch norm relu + dropout 0.3, conv 64@3 + batch norm relu, max
pool 2s2 -- then fc 10 softmax, with the resnet model's optimizer.  The
port's ``dropout_layer`` keeps its input's image metadata, as the
reference's does, so the second conv reads 64 channels of 32x32; JAX's
drops it, and its second conv reads one channel of 256x256 (ROADMAP
C13).

``get_config()`` selects the model as the demo's does: ``python -m
paddle_tpu_torch train --config paddle_tpu_torch/models/image_dsl.py
--config_args model=vgg`` (or ``model=resnet``, the default;
``batches=N`` stops a pass after N batches).
"""

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.datasets import cifar, mnist
from paddle_tpu_torch.data.provider import dense_vector, integer_value
from paddle_tpu_torch.optim import Momentum

MNIST_BATCH, CIFAR_BATCH = 128, 128


def lenet():
    """(cost, output) of the mnist demo, with a fresh layer-name
    registry (every build mints the same parameter keys)."""
    L.reset_names()
    img = L.data_layer("pixel", size=784, height=28, width=28)
    label = L.data_layer("label", size=1)
    conv1 = L.img_conv_layer(img, filter_size=5, num_filters=20,
                             num_channels=1, act="relu")
    pool1 = L.img_pool_layer(conv1, pool_size=2, stride=2, ceil_mode=False)
    conv2 = L.img_conv_layer(pool1, filter_size=5, num_filters=50,
                             act="relu")
    pool2 = L.img_pool_layer(conv2, pool_size=2, stride=2, ceil_mode=False)
    fc1 = L.fc_layer(pool2, size=500, act="relu")
    out = L.fc_layer(fc1, size=10, act="softmax")
    return L.classification_cost(out, label), out


def resnet_cifar(img, depth=32):
    """The demo's DSL ResNet over the image layer ``img``."""
    n = (depth - 2) // 6
    net = L.img_conv_layer(img, filter_size=3, num_filters=16,
                           num_channels=3, padding=1, act=None)
    net = L.batch_norm_layer(net, act="relu")
    filters = 16
    for stage, nf in enumerate((16, 32, 64)):
        for block in range(n):
            stride = 2 if (stage > 0 and block == 0) else 1
            conv1 = L.img_conv_layer(net, filter_size=3, num_filters=nf,
                                     stride=stride, padding=1, act=None)
            bn1 = L.batch_norm_layer(conv1, act="relu")
            conv2 = L.img_conv_layer(bn1, filter_size=3, num_filters=nf,
                                     padding=1, act=None)
            bn2 = L.batch_norm_layer(conv2, act=None)
            if stride == 2 or filters != nf:
                proj = L.img_conv_layer(net, filter_size=1, num_filters=nf,
                                        stride=stride, act=None)
                net = L.addto_layer([bn2, proj], act="relu")
            else:
                net = L.addto_layer([bn2, net], act="relu")
            filters = nf
    return L.img_pool_layer(net, pool_size=8, stride=1, pool_type="avg")


def cifar_resnet(depth=32):
    """(cost, output) of the image_classification demo's resnet model,
    with a fresh layer-name registry."""
    L.reset_names()
    img = L.data_layer("image", size=3 * 32 * 32, height=32, width=32)
    label = L.data_layer("label", size=1)
    out = L.fc_layer(resnet_cifar(img, depth), size=10, act="softmax")
    return L.classification_cost(out, label), out


def vgg_bn_drop(img, drop_rates=(0.3, 0.0)):
    """The demo's vgg trunk over the image layer ``img``; ``drop_rates``
    are the two convs' dropout rates (the demo's (0.3, 0.0))."""
    return L.networks.img_conv_group(
        img, [64, 64], pool_size=2, num_channels=3, conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=list(drop_rates))


def cifar_vgg(drop_rates=(0.3, 0.0)):
    """(cost, output) of the image_classification demo's vgg model, with
    a fresh layer-name registry."""
    L.reset_names()
    img = L.data_layer("image", size=3 * 32 * 32, height=32, width=32)
    label = L.data_layer("label", size=1)
    out = L.fc_layer(vgg_bn_drop(img, drop_rates), size=10, act="softmax")
    return L.classification_cost(out, label), out


def _batched(reader, batch, n_batches):
    """The first ``n_batches`` batches of ``batch`` samples of
    ``reader`` (all of them for None)."""
    return reader_mod.firstn(reader_mod.batch(reader, batch), n_batches)


def mnist_config(n_batches=8, batch=MNIST_BATCH):
    """The dict a ``get_config()`` returns for the trainer CLI: the
    mnist demo on its loader's first ``n_batches`` batches (the
    synthetic fallback where no files are present)."""
    cost, out = lenet()
    return {"cost": cost, "output": out,
            "optimizer": Momentum(learning_rate=0.01, momentum=0.9),
            "feeding": {"pixel": dense_vector(784),
                        "label": integer_value(10)},
            "train_reader": _batched(mnist.train(), batch, n_batches),
            "test_reader": _batched(mnist.test(), batch, 2)}


def cifar_config(depth=32, n_batches=8, batch=CIFAR_BATCH, model="resnet"):
    """The image_classification demo's ``model`` (vgg, or else resnet at
    ``depth``, as the demo selects) as a trainer config on the cifar
    loader's first ``n_batches`` batches (all of them for None)."""
    cost, out = cifar_vgg() if model == "vgg" else cifar_resnet(depth)
    return {"cost": cost, "output": out,
            "optimizer": Momentum(learning_rate=0.01, momentum=0.9,
                                  l2=1e-4),
            "feeding": {"image": dense_vector(3 * 32 * 32),
                        "label": integer_value(10)},
            "train_reader": _batched(cifar.train10(), batch, n_batches),
            "test_reader": _batched(cifar.test10(), batch, 2)}


def get_config():
    """The demo's ``get_config`` (``demo/image_classification/train.py:
    47-65``): ``CONFIG_ARGS`` ``model`` (resnet, the default, or vgg) and
    ``batches`` (a pass's length; every batch of the loader by
    default)."""
    args = globals().get("CONFIG_ARGS", {})
    n = int(args["batches"]) if "batches" in args else None
    return cifar_config(model=args.get("model", "resnet"), n_batches=n)
