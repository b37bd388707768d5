"""ResNet family (``paddle_tpu/models/resnet.py``; reference
demo/image_classification resnet configs, and ``BASELINE.json``'s
"ResNet-50 images/sec/chip"): NHWC with HWIO weights, batch norm as
explicit state, the downsample a strided 1x1 conv.  CIFAR depths 20 /
32 / 56 / 110 (3 stages of n basic blocks) and the bottleneck depths 50
/ 101 / 152.

    params: {"stem": {"w", "bn": {"gamma", "beta"}},
             "s{i}b{j}": {"c1", "c2"[, "c3"][, "proj"]: {"w", "bn"}},
             "head": {"w": [D, C], "b": [C]}}
    state:  the same keys with {"mean", "var"} for every "bn"

Convolutions follow the dtype policy (``ops/conv``: float32 out);
``remat=True`` recomputes each residual block in the backward
(``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations; the block's new moving stats come from its one forward
run, so they update once a step either way.
"""

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import _image
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import linear, losses
from paddle_tpu_torch.ops.norm import batch_norm_train, batch_norm_infer

BOTTLENECK = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
CIFAR = {20: 3, 32: 5, 56: 9, 110: 18}


def _bn_params(c):
    return {"gamma": torch.ones(c), "beta": torch.zeros(c)}


def _bn_state(c):
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def _apply_bn(x, p, s, train, momentum=0.9):
    if train:
        y, (nm, nv) = batch_norm_train(x, p["gamma"], p["beta"], s["mean"],
                                       s["var"], momentum)
        return y, {"mean": nm, "var": nv}
    return batch_norm_infer(x, p["gamma"], p["beta"], s["mean"],
                            s["var"]), s


def _imagenet(depth, imagenet):
    return imagenet if imagenet is not None else depth in BOTTLENECK


def init(generator, depth=50, num_classes=1000, in_channels=3, imagenet=None,
         device=None):
    """(params, state) by the JAX ``init``'s rules (He-normal convs, the
    head normal with std 0.01, BN gamma 1 / beta 0, moving stats 0 / 1)
    on ``generator``'s draws, placed on ``device`` (the card unless
    "cpu")."""
    dev = _device.resolve(device)
    gen = generator
    params, state = {}, {}

    def conv(k, cin, cout):
        return {"w": _image.he_conv(gen, k, k, cin, cout),
                "bn": _bn_params(cout)}

    if _imagenet(depth, imagenet):
        params["stem"], state["stem"] = conv(7, in_channels, 64), \
            _bn_state(64)
        cin = 64
        for si, (n, w) in enumerate(zip(BOTTLENECK[depth],
                                        (256, 512, 1024, 2048))):
            mid = w // 4
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                blk = {"c1": conv(1, cin, mid), "c2": conv(3, mid, mid),
                       "c3": conv(1, mid, w)}
                st = {"c1": _bn_state(mid), "c2": _bn_state(mid),
                      "c3": _bn_state(w)}
                if cin != w or stride != 1:
                    blk["proj"], st["proj"] = conv(1, cin, w), _bn_state(w)
                params[f"s{si}b{bi}"], state[f"s{si}b{bi}"] = blk, st
                cin = w
    else:
        params["stem"], state["stem"] = conv(3, in_channels, 16), \
            _bn_state(16)
        cin = 16
        for si, w in enumerate((16, 32, 64)):
            for bi in range(CIFAR[depth]):
                stride = 2 if (bi == 0 and si > 0) else 1
                blk = {"c1": conv(3, cin, w), "c2": conv(3, w, w)}
                st = {"c1": _bn_state(w), "c2": _bn_state(w)}
                if cin != w or stride != 1:
                    blk["proj"], st["proj"] = conv(1, cin, w), _bn_state(w)
                params[f"s{si}b{bi}"], state[f"s{si}b{bi}"] = blk, st
                cin = w
    params["head"] = {"w": _image.normal(gen, 0.01, (cin, num_classes)),
                      "b": torch.zeros(num_classes)}
    return _image.on_device(params, dev), _image.on_device(state, dev)


def params_from_numpy(tree, device=None, depth=50, num_classes=1000,
                      in_channels=3, imagenet=None, state=False):
    """The JAX params tree (or, ``state=True``, its state tree) as numpy
    arrays -> the port's, float32 on ``device``; keys and shapes must be
    the config's."""
    want = init(torch.Generator().manual_seed(0), depth, num_classes,
                in_channels, imagenet, device="cpu")[1 if state else 0]
    return _image.from_numpy(tree, want, device)


def _bottleneck(x, blk, st, stride, train):
    new_st = {}
    y = conv_ops.conv2d(x, blk["c1"]["w"], stride=(1, 1))
    y, new_st["c1"] = _apply_bn(y, blk["c1"]["bn"], st["c1"], train)
    y = torch.relu(y)
    y = conv_ops.conv2d(y, blk["c2"]["w"], stride=(stride, stride),
                        padding=(1, 1))
    y, new_st["c2"] = _apply_bn(y, blk["c2"]["bn"], st["c2"], train)
    y = torch.relu(y)
    y = conv_ops.conv2d(y, blk["c3"]["w"], stride=(1, 1))
    y, new_st["c3"] = _apply_bn(y, blk["c3"]["bn"], st["c3"], train)
    if "proj" in blk:
        x = conv_ops.conv2d(x, blk["proj"]["w"], stride=(stride, stride))
        x, new_st["proj"] = _apply_bn(x, blk["proj"]["bn"], st["proj"],
                                      train)
    return torch.relu(x + y), new_st


def _basic(x, blk, st, stride, train):
    new_st = {}
    y = conv_ops.conv2d(x, blk["c1"]["w"], stride=(stride, stride),
                        padding=(1, 1))
    y, new_st["c1"] = _apply_bn(y, blk["c1"]["bn"], st["c1"], train)
    y = torch.relu(y)
    y = conv_ops.conv2d(y, blk["c2"]["w"], stride=(1, 1), padding=(1, 1))
    y, new_st["c2"] = _apply_bn(y, blk["c2"]["bn"], st["c2"], train)
    if "proj" in blk:
        x = conv_ops.conv2d(x, blk["proj"]["w"], stride=(stride, stride))
        x, new_st["proj"] = _apply_bn(x, blk["proj"]["bn"], st["proj"],
                                      train)
    return torch.relu(x + y), new_st


def _block(fn, remat):
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward(params, state, images, depth=50, train=True, imagenet=None,
            return_pool=False, remat=False):
    """images: NHWC float.  depth / imagenet must match ``init``'s.
    Returns (logits, new_state); with ``return_pool=True`` the first
    element is the global-average-pooled features [N, D] instead (the
    layer the reference's model_zoo classify.py --job=extract dumps)."""
    imagenet = _imagenet(depth, imagenet)
    bottleneck = _block(_bottleneck, remat)
    basic = _block(_basic, remat)
    new_state = {}
    x = images
    if imagenet:
        x = conv_ops.conv2d(x, params["stem"]["w"], stride=(2, 2),
                            padding=(3, 3))
        x, new_state["stem"] = _apply_bn(x, params["stem"]["bn"],
                                         state["stem"], train)
        x = torch.relu(x)
        x = conv_ops.max_pool2d(x, (3, 3), (2, 2), (1, 1))
        for si, n in enumerate(BOTTLENECK[depth]):
            for bi in range(n):
                nm = f"s{si}b{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                x, new_state[nm] = bottleneck(x, params[nm], state[nm],
                                              stride, train)
    else:
        x = conv_ops.conv2d(x, params["stem"]["w"], padding=(1, 1))
        x, new_state["stem"] = _apply_bn(x, params["stem"]["bn"],
                                         state["stem"], train)
        x = torch.relu(x)
        for si in range(3):
            for bi in range(CIFAR[depth]):
                nm = f"s{si}b{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                x, new_state[nm] = basic(x, params[nm], state[nm], stride,
                                         train)
    x = torch.mean(x, dim=(1, 2))
    if return_pool:
        return x, new_state
    return linear.fc(x, params["head"]["w"], params["head"]["b"]), new_state


def features(params, state, images, depth=50, imagenet=None):
    """The global-average-pooled features before the head (reference
    demo/model_zoo/resnet/classify.py --job=extract), in test mode."""
    feats, _ = forward(params, state, images, depth, train=False,
                       imagenet=imagenet, return_pool=True)
    return feats


def loss(params, state, images, labels, depth=50, train=True, imagenet=None,
         remat=False):
    logits, new_state = forward(params, state, images, depth, train,
                                imagenet, remat=remat)
    return torch.mean(losses.classification_cost(logits, labels)), new_state
