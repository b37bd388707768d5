"""Vision layer ctors (``paddle_tpu/layers/vision.py``): conv, pool,
norm and image utility layers (reference ExpandConvLayer /
CudnnConvLayer, PoolLayer, the BatchNorm family, NormProjectionLayer
(LRN), MaxOutLayer, BilinearInterpLayer, BlockExpandLayer,
SpatialPyramidPoolLayer, PadLayer, PriorBox; sizes from
math/MathUtils.cpp outputSize).

Row convention, as the reference's and JAX's: values between layers are
flat rows [B, C*H*W], channel-major.  Each layer reshapes its rows to
NHWC for ``ops/conv`` (``_to_nhwc``) and flattens back (``_to_rows``),
so an fc after a conv reads the same [C, H, W] order in both packages
and the carried fc weights match; the (h, w) metadata rides on
``LayerOutput.img_shape``.

``batch_norm_layer`` keeps its moving stats as the graph's state
(``Context.get_state`` / ``put_state``, seeded by
``Topology.init_state``): per channel over an image, per feature over
fc rows, the stats updated in train mode unless ``use_global_stats``,
read in test mode.  ``conv_projection`` and ``conv_operator`` are
``mixed_layer`` parts (``api._MixedImpl`` runs them through
``ops/conv``).
"""

import math

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.api import _Part, _maybe_bias
from paddle_tpu_torch.layers.graph import (
    LayerOutput, register_layer, auto_name, map_rows, value_data)
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops.norm import batch_norm_train, batch_norm_infer
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.logging import logger

__all__ = [
    "img_conv_layer", "img_pool_layer", "batch_norm_layer",
    "img_cmrnorm_layer", "cross_channel_norm_layer", "maxout_layer",
    "bilinear_interp_layer", "block_expand_layer", "spp_layer", "pad_layer",
    "priorbox_layer", "data_norm_layer", "conv_projection", "conv_operator",
]


def _to_nhwc(d, c, h, w):
    return d.reshape(d.shape[0], c, h, w).permute(0, 2, 3, 1)


def _to_rows(x):
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def _channels(input, num_channels):
    """Channel inference (reference v1 semantics: num_channels defaults to
    the input layer's num_filters; a raw data layer with height/width set
    implies channels = size / (h*w))."""
    if num_channels:
        return num_channels
    if input.num_filters:
        return input.num_filters
    if input.img_shape:
        h, w = input.img_shape
        if h * w and input.size % (h * w) == 0:
            return input.size // (h * w)
    return 1


def _img_shape(node, channels):
    if node.img_shape is not None:
        return node.img_shape
    hw = int(round(math.sqrt(node.size // channels)))
    if hw * hw * channels != node.size:
        raise ConfigError(
            f"cannot infer square image shape for layer {node.name} "
            f"(size {node.size}, channels {channels}); pass height/width")
    return (hw, hw)


def _image_rows(cfg, fn):
    """A row-wise layer body: rows -> NHWC -> ``fn`` -> rows."""
    c, (h, w) = cfg["channels"], cfg["in_shape"]
    return lambda d: _to_rows(fn(_to_nhwc(d, c, h, w)))


class _ConvImpl:
    def infer(self, cfg, in_sizes):
        return cfg["out_size"]

    def init(self, gen, cfg, in_sizes):
        kh, kw = cfg["filter"]
        cin, cout, groups = cfg["channels"], cfg["num_filters"], cfg["groups"]
        fan_in = (cin // groups) * kh * kw
        std = (cfg.get("param_attr") or {}).get("initial_std",
                                                1.0 / math.sqrt(fan_in))
        p = {"w": std * torch.randn((kh, kw, cin // groups, cout),
                                    generator=gen, device=gen.device)}
        b = _maybe_bias(gen, cfg.get("bias_attr", True), cout)
        if b is not None:
            p["b"] = b
        return p

    def apply(self, ctx, cfg, params, x):
        if cfg.get("trans"):
            def conv(img):
                return conv_ops.conv2d_transpose(
                    img, params["w"], params.get("b"), stride=cfg["stride"],
                    padding=cfg["padding"])
        else:
            def conv(img):
                return conv_ops.conv2d(
                    img, params["w"], params.get("b"), stride=cfg["stride"],
                    padding=cfg["padding"], groups=cfg["groups"])
        act = activations.get(cfg.get("act"))
        return map_rows(_image_rows(cfg, lambda img: act(conv(img))), x)


register_layer("conv")(_ConvImpl)


def img_conv_layer(input, filter_size, num_filters, num_channels=None,
                   stride=1, padding=0, groups=1, act="relu", name=None,
                   bias_attr=True, param_attr=None, trans=False,
                   filter_size_y=None, stride_y=None, padding_y=None,
                   layer_attr=None, shared_biases=True, layer_type=None):
    """Reference img_conv_layer (ExpandConvLayer / CudnnConvLayer: one
    path).  filter_size / stride / padding are the X (width) dimension
    -- the tuple form is (x, y) -- and the *_y ones the height."""
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    if isinstance(filter_size, (tuple, list)):
        filter_size, filter_size_y = filter_size
    if isinstance(stride, (tuple, list)):
        stride, stride_y = stride
    if isinstance(padding, (tuple, list)):
        padding, padding_y = padding
    fh, fw = filter_size_y or filter_size, filter_size
    sh, sw = stride_y or stride, stride
    ph, pw = (padding_y if padding_y is not None else padding), padding
    if trans:
        oh = (in_shape[0] - 1) * sh - 2 * ph + fh
        ow = (in_shape[1] - 1) * sw - 2 * pw + fw
    else:
        oh = conv_ops.conv_output_size(in_shape[0], fh, sh, ph)
        ow = conv_ops.conv_output_size(in_shape[1], fw, sw, pw)
    out_size = num_filters * oh * ow
    cfg = {"filter": (fh, fw), "stride": (sh, sw), "padding": (ph, pw),
           "groups": groups, "channels": channels, "num_filters": num_filters,
           "in_shape": in_shape, "out_size": out_size, "act": act,
           "bias_attr": bias_attr, "param_attr": param_attr, "trans": trans}
    return LayerOutput(name or auto_name("conv"), "conv", out_size, [input],
                       cfg, num_filters=num_filters, img_shape=(oh, ow))


class _PoolImpl:
    def infer(self, cfg, in_sizes):
        return cfg["out_size"]

    def apply(self, ctx, cfg, params, x):
        (ph, pw), (eh, ew) = cfg["padding"], cfg["extra_pad"]
        pad = ((ph, ph + eh), (pw, pw + ew))
        pool = conv_ops.max_pool2d if cfg["pool_type"] == "max" \
            else conv_ops.avg_pool2d
        return map_rows(_image_rows(cfg, lambda img: pool(
            img, cfg["window"], cfg["stride"], pad)), x)


register_layer("pool")(_PoolImpl)


def img_pool_layer(input, pool_size, stride=1, num_channels=None,
                   pool_type="max", padding=0, name=None, pool_size_y=None,
                   stride_y=None, padding_y=None, ceil_mode=True):
    """Reference img_pool_layer.  ceil_mode matches the reference's
    outputSize with caffeMode=False (ceil division); the overhang it
    asks for beyond the symmetric padding pads the high side only."""
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    if isinstance(pool_size, (tuple, list)):
        pool_size, pool_size_y = pool_size
    if isinstance(stride, (tuple, list)):
        stride, stride_y = stride
    if isinstance(padding, (tuple, list)):
        padding, padding_y = padding
    wh, ww = pool_size_y or pool_size, pool_size
    sh, sw = stride_y or stride, stride
    ph, pw = (padding_y if padding_y is not None else padding), padding
    pt = getattr(pool_type, "name", pool_type)
    pt = "avg" if "avg" in str(pt) else "max"

    def osize(insz, k, s, p):
        if ceil_mode:
            return int(math.ceil((insz + 2 * p - k) / s)) + 1
        return (insz + 2 * p - k) // s + 1

    oh, ow = osize(in_shape[0], wh, sh, ph), osize(in_shape[1], ww, sw, pw)
    out_size = channels * oh * ow
    eh = (oh - 1) * sh + wh - in_shape[0] - 2 * ph
    ew = (ow - 1) * sw + ww - in_shape[1] - 2 * pw
    cfg = {"window": (wh, ww), "stride": (sh, sw),
           "padding": (ph, pw), "extra_pad": (max(eh, 0), max(ew, 0)),
           "channels": channels, "pool_type": pt, "in_shape": in_shape,
           "out_size": out_size}
    return LayerOutput(name or auto_name("pool"), "pool", out_size, [input],
                       cfg, num_filters=channels, img_shape=(oh, ow))


class _BatchNormImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def init(self, gen, cfg, in_sizes):
        n = cfg["size"]
        return {"gamma": torch.ones((n,), device=gen.device),
                "beta": torch.zeros((n,), device=gen.device)}

    def apply(self, ctx, cfg, params, x):
        n, name = cfg["size"], cfg["name"]
        c = cfg.get("channels")
        momentum = cfg.get("moving_average_fraction", 0.9)
        train = ctx.is_train() and not cfg.get("use_global_stats")

        def fn(d):
            mmean, mvar = ctx.get_state(name, lambda: (
                torch.zeros((n,), device=d.device),
                torch.ones((n,), device=d.device)))
            act = activations.get(cfg.get("act"))
            if c and c != d.shape[-1]:
                # an image: per channel over B, H, W
                b = d.shape[0]
                img = d.reshape(b, c, -1).transpose(1, 2).reshape(-1, c)
                g, bt = params["gamma"][:c], params["beta"][:c]
                if train:
                    y, (nm, nv) = batch_norm_train(img, g, bt, mmean[:c],
                                                   mvar[:c], momentum)
                    ctx.put_state(name, (torch.cat([nm, mmean[c:]]),
                                         torch.cat([nv, mvar[c:]])))
                else:
                    y = batch_norm_infer(img, g, bt, mmean[:c], mvar[:c])
                return act(y.reshape(b, -1, c).transpose(1, 2).reshape(b, -1))
            if train:
                y, st = batch_norm_train(d.reshape(-1, d.shape[-1]),
                                         params["gamma"], params["beta"],
                                         mmean, mvar, momentum)
                ctx.put_state(name, st)
                y = y.reshape(d.shape)
            else:
                y = batch_norm_infer(d, params["gamma"], params["beta"],
                                     mmean, mvar)
            return act(y)
        return map_rows(fn, x)


register_layer("batch_norm")(_BatchNormImpl)


def batch_norm_layer(input, act=None, name=None, num_channels=None,
                     bias_attr=True, param_attr=None, use_global_stats=None,
                     moving_average_fraction=0.9, layer_attr=None):
    """Reference batch_norm_layer.  For conv inputs the stats are per
    channel (channels = input.num_filters); for fc inputs per feature."""
    nm = name or auto_name("batch_norm")
    channels = num_channels or input.num_filters
    size = input.size
    stat_size = channels if (channels and input.img_shape) else size
    cfg = {"size": stat_size, "name": nm, "act": act,
           "use_global_stats": use_global_stats,
           "moving_average_fraction": moving_average_fraction,
           "channels": channels if input.img_shape else None}
    return LayerOutput(nm, "batch_norm", size, [input], cfg,
                       num_filters=input.num_filters,
                       img_shape=input.img_shape)


class _CmrNormImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def apply(self, ctx, cfg, params, x):
        return map_rows(_image_rows(cfg, lambda img: conv_ops.lrn_cross_map(
            img, cfg["norm_size"], cfg["scale"], cfg["power"])), x)


register_layer("cmrnorm")(_CmrNormImpl)


def img_cmrnorm_layer(input, size=5, scale=0.0128, power=0.75,
                      num_channels=None, name=None):
    """Reference img_cmrnorm_layer (cross-map LRN; the default scale is
    trainer_config_helpers')."""
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    cfg = {"norm_size": size, "scale": scale, "power": power,
           "channels": channels, "in_shape": in_shape}
    return LayerOutput(name or auto_name("cmrnorm"), "cmrnorm", input.size,
                       [input], cfg, num_filters=channels, img_shape=in_shape)


class _CrossChannelNormImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def init(self, gen, cfg, in_sizes):
        return {"scale": torch.ones((cfg["channels"],), device=gen.device)}

    def apply(self, ctx, cfg, params, x):
        return map_rows(_image_rows(cfg, lambda img: conv_ops
                                    .cross_channel_norm(img, params["scale"])),
                        x)


register_layer("cross_channel_norm")(_CrossChannelNormImpl)


def cross_channel_norm_layer(input, num_channels=None, name=None,
                             param_attr=None):
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    return LayerOutput(name or auto_name("ccn"), "cross_channel_norm",
                       input.size, [input],
                       {"channels": channels, "in_shape": in_shape},
                       num_filters=channels, img_shape=in_shape)


class _MaxoutImpl:
    def infer(self, cfg, in_sizes):
        return cfg["out_size"]

    def apply(self, ctx, cfg, params, x):
        return map_rows(_image_rows(cfg, lambda img: conv_ops.maxout(
            img, cfg["groups"])), x)


register_layer("maxout")(_MaxoutImpl)


def maxout_layer(input, groups, num_channels=None, name=None):
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    return LayerOutput(name or auto_name("maxout"), "maxout",
                       input.size // groups, [input],
                       {"groups": groups, "channels": channels,
                        "in_shape": in_shape, "out_size": input.size // groups},
                       num_filters=channels // groups, img_shape=in_shape)


class _BilinearImpl:
    def infer(self, cfg, in_sizes):
        return cfg["out_size"]

    def apply(self, ctx, cfg, params, x):
        return map_rows(_image_rows(cfg, lambda img: conv_ops.bilinear_interp(
            img, *cfg["out_shape"])), x)


register_layer("bilinear_interp")(_BilinearImpl)


def bilinear_interp_layer(input, out_size_x, out_size_y, num_channels=None,
                          name=None):
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    out_size = channels * out_size_x * out_size_y
    return LayerOutput(name or auto_name("bilinear"), "bilinear_interp",
                       out_size, [input],
                       {"channels": channels, "in_shape": in_shape,
                        "out_shape": (out_size_y, out_size_x),
                        "out_size": out_size},
                       num_filters=channels,
                       img_shape=(out_size_y, out_size_x))


class _BlockExpandImpl:
    def infer(self, cfg, in_sizes):
        return cfg["out_size"]

    def apply(self, ctx, cfg, params, x):
        c, (h, w) = cfg["channels"], cfg["in_shape"]
        d = value_data(x)
        patches = conv_ops.block_expand(_to_nhwc(d, c, h, w), cfg["block"],
                                        cfg["stride"], cfg["padding"])
        return SequenceBatch(data=patches, lengths=torch.full(
            (d.shape[0],), patches.shape[1], dtype=torch.int32,
            device=d.device))


register_layer("block_expand")(_BlockExpandImpl)


def block_expand_layer(input, block_x, block_y, stride_x=1, stride_y=1,
                       padding_x=0, padding_y=0, num_channels=None, name=None):
    """im2col as a sequence: the output is a sequence of patch rows
    (reference BlockExpandLayer, the OCR pipelines' feed into CTC)."""
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    out_size = block_x * block_y * channels
    return LayerOutput(name or auto_name("block_expand"), "block_expand",
                       out_size, [input],
                       {"channels": channels, "in_shape": in_shape,
                        "block": (block_y, block_x),
                        "stride": (stride_y, stride_x),
                        "padding": (padding_y, padding_x),
                        "out_size": out_size}, is_seq=True)


class _SppImpl:
    def infer(self, cfg, in_sizes):
        return cfg["out_size"]

    def apply(self, ctx, cfg, params, x):
        c, (h, w) = cfg["channels"], cfg["in_shape"]
        return map_rows(lambda d: conv_ops.spatial_pyramid_pool(
            _to_nhwc(d, c, h, w), cfg["pyramid_height"], cfg["pool_type"]),
            x)


register_layer("spp")(_SppImpl)


def spp_layer(input, pyramid_height, num_channels=None, pool_type="max",
              name=None):
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    pt = "avg" if "avg" in str(getattr(pool_type, "name", pool_type)) \
        else "max"
    out_size = channels * sum(4 ** i for i in range(pyramid_height))
    return LayerOutput(name or auto_name("spp"), "spp", out_size, [input],
                       {"channels": channels, "in_shape": in_shape,
                        "pyramid_height": pyramid_height, "pool_type": pt,
                        "out_size": out_size}, is_seq=False)


class _PadImpl:
    def infer(self, cfg, in_sizes):
        return cfg["out_size"]

    def apply(self, ctx, cfg, params, x):
        return map_rows(_image_rows(cfg, lambda img: conv_ops.pad_chw(
            img, cfg["pad_c"], cfg["pad_h"], cfg["pad_w"])), x)


register_layer("pad")(_PadImpl)


def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, num_channels=None,
              name=None):
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    pc, ph, pw = (tuple(pad_c or (0, 0)), tuple(pad_h or (0, 0)),
                  tuple(pad_w or (0, 0)))
    oc = channels + pc[0] + pc[1]
    oh = in_shape[0] + ph[0] + ph[1]
    ow = in_shape[1] + pw[0] + pw[1]
    return LayerOutput(name or auto_name("pad"), "pad", oc * oh * ow, [input],
                       {"channels": channels, "in_shape": in_shape,
                        "pad_c": pc, "pad_h": ph, "pad_w": pw,
                        "out_size": oc * oh * ow},
                       num_filters=oc, img_shape=(oh, ow))


class _PriorBoxImpl:
    def infer(self, cfg, in_sizes):
        return cfg["out_size"]

    def apply(self, ctx, cfg, params, x, img):
        boxes = conv_ops.prior_box(cfg["in_shape"], cfg["image_shape"],
                                   cfg["min_sizes"], cfg["max_sizes"],
                                   cfg["aspect_ratios"], cfg["variance"],
                                   device=value_data(x).device)
        return boxes.reshape(1, -1)


register_layer("priorbox")(_PriorBoxImpl)


def priorbox_layer(input, image, min_size, max_size=None, aspect_ratio=(2.0,),
                   variance=(0.1, 0.1, 0.2, 0.2), num_channels=None,
                   name=None):
    channels = _channels(input, num_channels)
    in_shape = _img_shape(input, channels)
    image_shape = _img_shape(image, image.num_filters or 3)
    n_prior = len(min_size) * (2 if max_size else 1) + 2 * len(aspect_ratio)
    out_size = in_shape[0] * in_shape[1] * n_prior * 8
    return LayerOutput(name or auto_name("priorbox"), "priorbox", out_size,
                       [input, image],
                       {"in_shape": in_shape, "image_shape": image_shape,
                        "min_sizes": list(min_size),
                        "max_sizes": list(max_size or []),
                        "aspect_ratios": list(aspect_ratio),
                        "variance": tuple(variance), "out_size": out_size},
                       is_seq=False)


class _DataNormImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def init(self, gen, cfg, in_sizes):
        n = in_sizes[0]
        return {"mean": torch.zeros((n,), device=gen.device),
                "std_inv": torch.ones((n,), device=gen.device),
                "min": torch.zeros((n,), device=gen.device),
                "span_inv": torch.ones((n,), device=gen.device)}

    def apply(self, ctx, cfg, params, x):
        """DataNormLayer: z-score or min-max normalization with
        precomputed stats (JAX's ``math_ops.data_norm``)."""
        if cfg.get("strategy", "z-score") == "min-max":
            return map_rows(lambda d: (d - params["min"])
                            * params["span_inv"], x)
        return map_rows(lambda d: (d - params["mean"]) * params["std_inv"],
                        x)


register_layer("data_norm")(_DataNormImpl)


def data_norm_layer(input, strategy="z-score", name=None):
    return LayerOutput(name or auto_name("data_norm"), "data_norm", input.size,
                       [input], {"strategy": strategy})


# (mixed_layer parts; reference ConvProjection / ConvOperator.cpp:58)

def _xy(x_val, y_val):
    """The reference's conv-geometry convention: a scalar or the tuple's
    first element is the X (width) dimension, *_y (or the second
    element) the height -> (h, w)."""
    if isinstance(x_val, (tuple, list)):
        x_val, y_val = x_val
    return (y_val if y_val is not None else x_val), x_val


def _conv_part_spec(img, filter_size, num_filters, num_channels, stride,
                    padding, filter_size_y=None, stride_y=None,
                    padding_y=None):
    """(spec, output width) of a conv part over ``img``'s rows."""
    channels = _channels(img, num_channels)
    in_shape = _img_shape(img, channels)
    fh, fw = _xy(filter_size, filter_size_y)
    sh, sw = _xy(stride, stride_y)
    ph, pw = _xy(padding, padding_y)
    oh = conv_ops.conv_output_size(in_shape[0], fh, sh, ph)
    ow = conv_ops.conv_output_size(in_shape[1], fw, sw, pw)
    spec = {"filter_size": (fh, fw), "stride": (sh, sw), "padding": (ph, pw),
            "channels": channels, "num_filters": num_filters,
            "in_shape": in_shape}
    return spec, num_filters * oh * ow


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, param_attr=None,
                    filter_size_y=None, stride_y=None, padding_y=None,
                    groups=1, trans=False):
    """A learned-filter conv (weight [fh, fw, C / groups, nf]) as a
    ``mixed_layer`` projection (reference ConvProjection).
    ``trans=True`` is accepted and runs the standard conv, as in the JAX
    package (which logs a warning)."""
    if trans:
        logger.warning("conv_projection(trans=True): transposed projection "
                       "runs as a standard conv projection; numerics differ "
                       "until ConvTransProjection lands")
    spec, out = _conv_part_spec(input, filter_size, num_filters,
                                num_channels, stride, padding,
                                filter_size_y, stride_y, padding_y)
    spec["param_attr"] = param_attr
    spec["groups"] = groups
    return _Part("conv_proj", [input], spec, out)


def conv_operator(img, filter, filter_size, num_filters, num_channels=None,
                  stride=1, padding=0, filter_size_y=None, stride_y=None,
                  padding_y=None, trans=False):
    """A per-sample conv as a ``mixed_layer`` operator: each row of
    ``filter`` is that sample's own filter bank, laid out (nf, C, fh, fw)
    (reference ConvOperator.cpp:58-83).  ``trans=True`` is accepted and
    runs the standard operator, as in the JAX package."""
    if trans:
        logger.warning("conv_operator(trans=True): transposed per-sample "
                       "conv runs as a standard conv_operator graph node; "
                       "numerics differ until ConvTransOperator lands")
    spec, out = _conv_part_spec(img, filter_size, num_filters, num_channels,
                                stride, padding, filter_size_y, stride_y,
                                padding_y)
    return _Part("conv_op", [img, filter], spec, out)
