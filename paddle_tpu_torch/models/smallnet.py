"""SmallNet — the reference's CIFAR-quick benchmark config
(``paddle_tpu/models/smallnet.py``; benchmark/paddle/image/
smallnet_mnist_cifar.py: 3x32x32, conv 32@5p2 + maxpool3s2p1, conv
32@5p2 + avgpool3s2p1, conv 64@3p1 + avgpool3s2p1, fc64, fc10; its
K40m time in BASELINE.md is the reference's own), NHWC with HWIO
weights; the fc reads rows flattened NHWC, as the JAX model's."""

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import _image
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import linear, losses


def _conv(gen, k, cin, cout):
    return {"w": _image.he_conv(gen, k, k, cin, cout),
            "b": torch.zeros(cout)}


def init(generator, num_classes=10, in_channels=3, device=None):
    """(params, state): the JAX ``init``'s rules on ``generator``'s draws
    (He-normal convs, fcs normal with std 0.1, zero biases); no state."""
    dev = _device.resolve(device)
    gen = generator
    params = {
        "c1": _conv(gen, 5, in_channels, 32),
        "c2": _conv(gen, 5, 32, 32),
        "c3": _conv(gen, 3, 32, 64),
        # 32 -> pool s2 p1 -> 16 -> 8 -> 4
        "fc1": {"w": _image.normal(gen, 0.1, (4 * 4 * 64, 64)),
                "b": torch.zeros(64)},
        "out": {"w": _image.normal(gen, 0.1, (64, num_classes)),
                "b": torch.zeros(num_classes)},
    }
    return _image.on_device(params, dev), {}


def params_from_numpy(tree, device=None, num_classes=10, in_channels=3):
    return _image.from_numpy(tree, init(torch.Generator().manual_seed(0),
                                        num_classes, in_channels,
                                        device="cpu")[0], device)


def forward(params, state, images, train=True, rng=None):
    """images: [B, 32, 32, 3] NHWC.  Returns (logits, state)."""
    x = conv_ops.conv2d(images, params["c1"]["w"], params["c1"]["b"],
                        padding=(2, 2), act="relu")
    x = conv_ops.max_pool2d(x, (3, 3), (2, 2), (1, 1))
    x = conv_ops.conv2d(x, params["c2"]["w"], params["c2"]["b"],
                        padding=(2, 2), act="relu")
    x = conv_ops.avg_pool2d(x, (3, 3), (2, 2), (1, 1))
    x = conv_ops.conv2d(x, params["c3"]["w"], params["c3"]["b"],
                        padding=(1, 1), act="relu")
    x = conv_ops.avg_pool2d(x, (3, 3), (2, 2), (1, 1))
    x = x.reshape(x.shape[0], -1)
    x = linear.fc(x, params["fc1"]["w"], params["fc1"]["b"], act="relu")
    return linear.fc(x, params["out"]["w"], params["out"]["b"]), state


def loss(params, state, images, labels, train=True, rng=None):
    logits, new_state = forward(params, state, images, train=train, rng=rng)
    return torch.mean(losses.classification_cost(logits, labels)), new_state
