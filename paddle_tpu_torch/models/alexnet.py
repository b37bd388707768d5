"""AlexNet — the reference's image benchmark config
(``paddle_tpu/models/alexnet.py``; benchmark/paddle/image/alexnet.py:
3x227x227, conv1 96@11s4p1 + cmrnorm + pool, conv2 256@5p2 + cmrnorm +
pool, conv3/4 384@3p1, conv5 256@3p1 + pool, fc4096 x2 with dropout
0.5, fc1000), NHWC with HWIO weights; the fc reads rows flattened NHWC.
Dropout draws from ``rng`` (a ``torch.Generator``) and is skipped
without one, as the JAX model's without a key."""

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import _image
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import linear, losses

_CONVS = [
    # name, k, cin, cout, stride, pad, lrn_after, pool_after
    ("c1", 11, 3, 96, 4, 1, True, True),
    ("c2", 5, 96, 256, 1, 2, True, True),
    ("c3", 3, 256, 384, 1, 1, False, False),
    ("c4", 3, 384, 384, 1, 1, False, False),
    ("c5", 3, 384, 256, 1, 1, False, True),
]


def init(generator, num_classes=1000, fc_dim=4096, device=None):
    """(params, state): He-normal convs, fcs normal with std 0.01, zero
    biases, on ``generator``'s draws; no state."""
    dev = _device.resolve(device)
    gen = generator
    params = {}
    for name, k, cin, cout, *_ in _CONVS:
        params[name] = {"w": _image.he_conv(gen, k, k, cin, cout),
                        "b": torch.zeros(cout)}
    # 227 -> conv s4 p1 -> 55 -> pool3s2 -> 27 -> pool -> 13 -> pool -> 6
    flat = 6 * 6 * 256
    for name, shape in (("fc1", (flat, fc_dim)), ("fc2", (fc_dim, fc_dim)),
                        ("out", (fc_dim, num_classes))):
        params[name] = {"w": _image.normal(gen, 0.01, shape),
                        "b": torch.zeros(shape[1])}
    return _image.on_device(params, dev), {}


def params_from_numpy(tree, device=None, num_classes=1000, fc_dim=4096):
    return _image.from_numpy(tree, init(torch.Generator().manual_seed(0),
                                        num_classes, fc_dim,
                                        device="cpu")[0], device)


def forward(params, state, images, train=True, rng=None, drop_rate=0.5):
    """images: [B, 227, 227, 3] NHWC.  Returns (logits, state)."""
    x = images
    for name, k, cin, cout, stride, pad, lrn, pool in _CONVS:
        p = params[name]
        x = conv_ops.conv2d(x, p["w"], p["b"], stride=(stride, stride),
                            padding=(pad, pad), act="relu")
        if lrn:
            x = conv_ops.lrn_cross_map(x, size=5, scale=1e-4, power=0.75)
        if pool:
            x = conv_ops.max_pool2d(x, (3, 3), (2, 2))
    x = x.reshape(x.shape[0], -1)
    for fc in ("fc1", "fc2"):
        x = linear.fc(x, params[fc]["w"], params[fc]["b"], act="relu")
        if train:
            x = _image.dropout(x, drop_rate, rng)
    return linear.fc(x, params["out"]["w"], params["out"]["b"]), state


def loss(params, state, images, labels, train=True, rng=None):
    logits, new_state = forward(params, state, images, train=train, rng=rng)
    return torch.mean(losses.classification_cost(logits, labels)), new_state
