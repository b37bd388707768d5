"""LeNet-ish MNIST CNN (``paddle_tpu/models/lenet.py``; reference
demo/mnist: conv-pool x2 + fc), NHWC with HWIO weights as the JAX
model's.

    {"c1": {"w": [5, 5, 1, 20], "b": [20]},
     "c2": {"w": [5, 5, 20, 50], "b": [50]},
     "f1": {"w": [4*4*50, 500], "b": [500]},   # rows flattened NHWC
     "f2": {"w": [500, C], "b": [C]}}
"""

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import _image
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import initializers, linear, losses


def init(generator, num_classes=10, device=None):
    """The JAX ``init``'s rules (conv_default for the convs, normal with
    std 1/sqrt(fan_in) for the fcs, zero biases) on ``generator``'s
    draws, placed on ``device`` (the card unless "cpu")."""
    dev = _device.resolve(device)
    gen = generator
    cinit, ninit = initializers.conv_default(), initializers.normal()
    params = {
        "c1": {"w": cinit(gen, (5, 5, 1, 20)), "b": torch.zeros(20)},
        "c2": {"w": cinit(gen, (5, 5, 20, 50)), "b": torch.zeros(50)},
        "f1": {"w": ninit(gen, (4 * 4 * 50, 500)), "b": torch.zeros(500)},
        "f2": {"w": ninit(gen, (500, num_classes)),
               "b": torch.zeros(num_classes)},
    }
    return _image.on_device(params, dev)


def params_from_numpy(tree, device=None, num_classes=10):
    """The JAX tree as numpy arrays -> the port's, float32 on ``device``."""
    return _image.from_numpy(tree, init(torch.Generator().manual_seed(0),
                                        num_classes, device="cpu"), device)


def forward(params, images):
    """images: [B, 784] in [-1, 1] -> logits [B, C]."""
    x = images.reshape(-1, 28, 28, 1)
    x = conv_ops.conv2d(x, params["c1"]["w"], params["c1"]["b"], act="relu")
    x = conv_ops.max_pool2d(x, (2, 2))
    x = conv_ops.conv2d(x, params["c2"]["w"], params["c2"]["b"], act="relu")
    x = conv_ops.max_pool2d(x, (2, 2))
    x = x.reshape(x.shape[0], -1)
    x = linear.fc(x, params["f1"]["w"], params["f1"]["b"], act="relu")
    return linear.fc(x, params["f2"]["w"], params["f2"]["b"])


def loss(params, images, labels):
    return torch.mean(losses.classification_cost(forward(params, images),
                                                 labels))
