"""GoogleNet (Inception v1) — the reference's heaviest image benchmark
(``paddle_tpu/models/googlenet.py``; benchmark/paddle/image/
googlenet.py: 3x224x224, stem 7x7s2 + pools, nine inception modules
3a..5b, global average pool, fc1000), NHWC with HWIO weights.  The four
branches of a module are independent convs concatenated on the channel
axis; no batch norm and no auxiliary classifiers, as the reference's
config.  Dropout before the head draws from ``rng`` and is skipped
without one."""

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import _image
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import linear, losses

# name -> (1x1, 3x3reduce, 3x3, 5x5reduce, 5x5, poolproj)
_INCEPTION = [
    ("3a", 64, 96, 128, 16, 32, 32),
    ("3b", 128, 128, 192, 32, 96, 64),
    ("pool3",),
    ("4a", 192, 96, 208, 16, 48, 64),
    ("4b", 160, 112, 224, 24, 64, 64),
    ("4c", 128, 128, 256, 24, 64, 64),
    ("4d", 112, 144, 288, 32, 64, 64),
    ("4e", 256, 160, 320, 32, 128, 128),
    ("pool4",),
    ("5a", 256, 160, 320, 32, 128, 128),
    ("5b", 384, 192, 384, 48, 128, 128),
]


def _conv(gen, k, cin, cout):
    return {"w": _image.he_conv(gen, k, k, cin, cout),
            "b": torch.zeros(cout)}


def init(generator, num_classes=1000, device=None):
    """(params, state): He-normal convs, the head normal with std 0.01,
    zero biases, on ``generator``'s draws; no state."""
    dev = _device.resolve(device)
    gen = generator
    params = {"stem1": _conv(gen, 7, 3, 64), "stem2": _conv(gen, 1, 64, 64),
              "stem3": _conv(gen, 3, 64, 192)}
    cin = 192
    for row in _INCEPTION:
        if len(row) == 1:
            continue
        name, c1, c3r, c3, c5r, c5, cp = row
        params[name] = {
            "b1": _conv(gen, 1, cin, c1), "b3r": _conv(gen, 1, cin, c3r),
            "b3": _conv(gen, 3, c3r, c3), "b5r": _conv(gen, 1, cin, c5r),
            "b5": _conv(gen, 5, c5r, c5), "bp": _conv(gen, 1, cin, cp)}
        cin = c1 + c3 + c5 + cp
    params["head"] = {"w": _image.normal(gen, 0.01, (cin, num_classes)),
                      "b": torch.zeros(num_classes)}
    return _image.on_device(params, dev), {}


def params_from_numpy(tree, device=None, num_classes=1000):
    return _image.from_numpy(tree, init(torch.Generator().manual_seed(0),
                                        num_classes, device="cpu")[0],
                             device)


def _cv(x, p, stride=1, pad=0):
    return conv_ops.conv2d(x, p["w"], p["b"], stride=(stride, stride),
                           padding=(pad, pad), act="relu")


def _inception(x, p):
    b1 = _cv(x, p["b1"])
    b3 = _cv(_cv(x, p["b3r"]), p["b3"], pad=1)
    b5 = _cv(_cv(x, p["b5r"]), p["b5"], pad=2)
    bp = _cv(conv_ops.max_pool2d(x, (3, 3), (1, 1), (1, 1)), p["bp"])
    return torch.cat([b1, b3, b5, bp], dim=-1)


def forward(params, state, images, train=True, rng=None, drop_rate=0.4):
    """images: [B, 224, 224, 3] NHWC.  Returns (logits, state)."""
    x = _cv(images, params["stem1"], stride=2, pad=3)
    x = conv_ops.max_pool2d(x, (3, 3), (2, 2), (1, 1))
    x = _cv(x, params["stem2"])
    x = _cv(x, params["stem3"], pad=1)
    x = conv_ops.max_pool2d(x, (3, 3), (2, 2), (1, 1))
    for row in _INCEPTION:
        if len(row) == 1:
            x = conv_ops.max_pool2d(x, (3, 3), (2, 2), (1, 1))
        else:
            x = _inception(x, params[row[0]])
    x = torch.mean(x, dim=(1, 2))
    if train:
        x = _image.dropout(x, drop_rate, rng)
    return linear.fc(x, params["head"]["w"], params["head"]["b"]), state


def loss(params, state, images, labels, train=True, rng=None):
    logits, new_state = forward(params, state, images, train=train, rng=rng)
    return torch.mean(losses.classification_cost(logits, labels)), new_state
