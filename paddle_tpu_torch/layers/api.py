"""v1-DSL layer ctors (``paddle_tpu/layers/api.py``, all 69 of its
names): the data, fc and embedding layers, ``mixed_layer`` with its
projections and operators, concat, addto, dropout, the elementwise
layers over ``ops/math_ops`` (interpolation, power, scaling, cos_sim,
tensor, prelu, selective_fc, ...), sequence pooling (strided too) and
the sequence layers over ``ops/sequence`` (expand, seq_concat,
seq_reshape, sub_seq, seq_slice, maxid, eos, sampling_id, print), the
cost zoo (classification, regression, self-normalized and binary
cross-entropies, rank, lambda, huber, smooth-L1, sum), the structured
costs (``crf_layer``, ``crf_decoding_layer``, ``ctc_layer``,
``warp_ctc_layer``), the sampled costs over ``ops/sampling``
(``nce_layer``, ``hsigmoid``) and the mixture-of-experts ``moe_layer``.
``layers/vision.py`` holds the conv stack and the conv parts of
``mixed_layer``; ``layers/layer_math.py`` the arithmetic on
``LayerOutput``.  Over a ``NestedSequenceBatch`` the pooling layers pool
within each sub-sequence (``agg_level="seq"``) or over all of it
(``ops/sequence.nested_seq_pool``).

Every ctor returns a LayerOutput graph node; ``graph.Topology`` runs it.
Initializers follow the JAX package's rules (weights normal with std
1/sqrt(fan_in) unless a ParamAttr says otherwise, biases 0) on the
port's own random bits.

``mixed_layer`` runs JAX's own width check (``_MixedImpl.infer``, the
reference MixedLayer's assertion that every part yields the layer size)
when the layer is finalized, so a part of the wrong width raises
``ConfigError`` at config time; JAX never calls ``infer`` and fails at
apply instead (ROADMAP C15).
"""

import math

import torch

from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch
from paddle_tpu_torch.layers.graph import (
    LayerOutput, register_layer, auto_name, map_rows, as_seq, value_data,
    dropout)
from paddle_tpu_torch.ops import activations, linear, losses, math_ops
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import ctc as ctc_ops
from paddle_tpu_torch.ops import moe as moe_ops
from paddle_tpu_torch.ops import sampling as sampling_ops
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.utils.error import ConfigError

__all__ = [
    "data_layer", "fc_layer", "embedding_layer", "dropout_layer",
    "addto_layer", "concat_layer", "interpolation_layer", "power_layer",
    "scaling_layer", "slope_intercept_layer", "linear_comb_layer",
    "convex_comb_layer", "sum_to_one_norm_layer", "cos_sim",
    "out_prod_layer", "trans_layer", "rotate_layer", "tensor_layer",
    "multiplex_layer", "conv_shift_layer", "featmap_expand_layer",
    "resize_layer", "prelu_layer", "selective_fc_layer",
    "pooling_layer", "last_seq", "first_seq", "expand_layer",
    "seq_concat_layer", "seq_reshape_layer", "sub_seq_layer",
    "seq_slice_layer", "maxid_layer", "eos_layer", "sampling_id_layer",
    "print_layer", "mixed_layer", "full_matrix_projection",
    "trans_full_matrix_projection", "identity_projection", "table_projection",
    "dotmul_projection", "scaling_projection", "context_projection",
    "dotmul_operator",
    "classification_cost", "regression_cost", "mse_cost", "cross_entropy",
    "cross_entropy_with_selfnorm", "soft_binary_class_cross_entropy",
    "multi_binary_label_cross_entropy", "rank_cost", "lambda_cost",
    "huber_cost", "smooth_l1_cost", "sum_cost", "crf_layer",
    "crf_decoding_layer", "ctc_layer", "warp_ctc_layer", "nce_layer",
    "hsigmoid", "pooling", "slice_projection",
    "AggregateLevel", "ExpandLevel", "repeat_layer",
    "moe_layer",
]


# ---------------------------------------------------------------- helpers

def _winit(param_attr, default_std=None):
    """Weight initializer from a ParamAttr-style dict (reference
    ParameterAttribute: initial_mean/initial_std, default std
    1/sqrt(fan_in); initial_strategy 1 is uniform)."""
    attr = param_attr or {}
    if callable(attr.get("init")):
        return attr["init"]

    def init(gen, shape):
        std = attr.get("initial_std", default_std)
        mean = attr.get("initial_mean", 0.0)
        if std is None:
            std = 1.0 / math.sqrt(max(shape[0], 1))
        if attr.get("initial_strategy", 0) == 1:  # uniform
            u = torch.rand(shape, generator=gen, device=gen.device)
            return (2.0 * u - 1.0) * std + mean
        return mean + std * torch.randn(shape, generator=gen,
                                        device=gen.device)
    return init


def _maybe_bias(gen, bias_attr, size):
    if bias_attr is False or bias_attr is None:
        return None
    attr = bias_attr if isinstance(bias_attr, dict) else {}
    std = attr.get("initial_std", 0.0)
    b = torch.full((size,), float(attr.get("initial_mean", 0.0)),
                   device=gen.device)
    if std:
        b = b + std * torch.randn((size,), generator=gen, device=gen.device)
    return b


def _dropout(ctx, cfg, value):
    return dropout(ctx, cfg.get("drop_rate", 0.0), value)


def _inputs_list(input):
    return list(input) if isinstance(input, (list, tuple)) else [input]


def _only_layers(ctor, items):
    for item in items:
        if not isinstance(item, LayerOutput):
            raise ConfigError(f"{ctor}: input {item!r} is not a layer; a "
                              "projection goes inside mixed_layer")
    return items


# ---------------------------------------------------------------- data

class _DataImpl:
    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def apply(self, ctx, cfg, params):
        raise RuntimeError("data layers are fed, not applied")


register_layer("data")(_DataImpl)


def data_layer(name, size, is_seq=False, height=None, width=None):
    """Reference data_layer(name, size) (layers.py DataLayer); height and
    width carry the image shape for the conv stack (``layers/vision``),
    which reads rows [B, C*H*W] channel-major."""
    img = (height, width) if height and width else None
    return LayerOutput(name, "data", size, cfg={"size": size}, is_seq=is_seq,
                       img_shape=img)


# ---------------------------------------------------------------- fc

class _FcImpl:
    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        p = {}
        pa = cfg.get("param_attr")
        # one ParamAttr per input is allowed (sentiment's
        # stacked_lstm_net passes [fc_attr, lstm_attr])
        pas = (list(pa) if isinstance(pa, (list, tuple))
               else [pa] * len(in_sizes))
        for i, isz in enumerate(in_sizes):
            p[f"w{i}"] = _winit(pas[i % len(pas)])(gen, (isz, cfg["size"]))
        b = _maybe_bias(gen, cfg.get("bias_attr", True), cfg["size"])
        if b is not None:
            p["b"] = b
        return p

    def apply(self, ctx, cfg, params, *inputs):
        def fn(*datas):
            y = linear.matmul(datas[0], params["w0"])
            for i in range(1, len(datas)):
                y = y + linear.matmul(datas[i], params[f"w{i}"])
            if "b" in params:
                y = y + params["b"]
            return activations.get(cfg.get("act"))(y)
        return _dropout(ctx, cfg, map_rows(fn, *inputs))


register_layer("fc")(_FcImpl)


# ---------------------------------------------------------------- moe

class _MoeImpl:
    """Mixture-of-experts FFN over the row dimension (``ops/moe.py``)."""

    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def init(self, gen, cfg, in_sizes):
        return moe_ops.init_moe(gen, in_sizes[0], cfg["expert_dim"],
                                cfg["n_experts"], device=gen.device)

    def apply(self, ctx, cfg, params, x):
        def fn(d):
            # moe_ffn takes [B, T, D]: any leading dims (a dense [B, D],
            # a sequence's [B, T, D]) flatten to one row and come back
            lead = d.shape[:-1]
            out = moe_ops.moe_ffn(d.reshape(1, -1, d.shape[-1]), params,
                                  top_k=cfg["top_k"])
            return out.reshape(*lead, d.shape[-1])
        return map_rows(fn, x)


register_layer("moe")(_MoeImpl)


def moe_layer(input, n_experts, expert_dim=None, top_k=2, name=None):
    """Gated mixture-of-experts FFN: ``n_experts`` experts of hidden width
    ``expert_dim`` (default 4x the input size), top_k-gated (tanh-GELU
    experts), residual-free.  Output size == input size."""
    ins = _inputs_list(input)
    if len(ins) != 1:
        raise ConfigError("moe_layer takes a single input (got "
                          f"{len(ins)}); concat upstream if needed")
    cfg = {"n_experts": n_experts, "top_k": top_k,
           "expert_dim": expert_dim or 4 * ins[0].size}
    return LayerOutput(name or auto_name("moe"), "moe", ins[0].size, ins, cfg)


def fc_layer(input, size, act="tanh", name=None, bias_attr=True,
             param_attr=None, layer_attr=None):
    ins = _only_layers("fc_layer", _inputs_list(input))
    cfg = {"size": size, "act": act, "bias_attr": bias_attr,
           "param_attr": param_attr}
    cfg.update(layer_attr or {})
    return LayerOutput(name or auto_name("fc"), "fc", size, ins, cfg)


# ---------------------------------------------------------------- embedding

class _EmbeddingImpl:
    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        return {"w": _winit(cfg.get("param_attr"),
                            default_std=1.0 / math.sqrt(cfg["vocab"]))(
            gen, (cfg["vocab"], cfg["size"]))}

    def apply(self, ctx, cfg, params, ids):
        return map_rows(lambda d: emb_ops.embedding_lookup(params["w"], d),
                        ids)


register_layer("embedding")(_EmbeddingImpl)


def embedding_layer(input, size, name=None, param_attr=None,
                    sparse_update=None, sparse_budget=None):
    """input: a data layer of integer ids (its .size = vocab size).
    ``sparse_update``: ``trainer.SGD`` trains the table by its touched
    rows (the row path, ``ops/sparse``), at most ``sparse_budget`` of
    them a step (default: the next power of two of the batch's ids)."""
    if sparse_update is None and isinstance(param_attr, dict):
        sparse_update = param_attr.get("sparse_update", False)
    return LayerOutput(name or auto_name("embedding"), "embedding", size,
                       [input],
                       cfg={"size": size, "vocab": input.size,
                            "param_attr": param_attr,
                            "sparse_update": bool(sparse_update),
                            "sparse_budget": sparse_budget})


def table_projection(input, size=0, param_attr=None):
    """A lookup table as a mixed part; size=0 takes the enclosing mixed
    layer's width (reference table_projection)."""
    return _Part("table", [input], {"param_attr": param_attr}, size)


# ---------------------------------------------------------------- mixed

def _part_width(kind, spec, isz):
    """The width a part yields where it is fixed by its input (None for
    the parts that take the layer's width)."""
    if kind == "identity":
        return spec.get("size") or isz
    if kind in ("dotmul", "scaling", "dotmul_op"):
        return isz
    if kind == "context":
        return isz * spec["context_len"]
    return None


def _arity(kind):
    return 2 if kind in ("dotmul_op", "conv_op") else 1


class _MixedImpl:
    """MixedLayer: the sum of its projections and operators (reference
    MixedLayer.cpp), then the bias, the activation and dropout.
    cfg['parts']: (kind, spec) pairs aligned with the node's inputs (one
    input a part; an operator takes two).  Parameters are ``w{k}`` for
    part k and ``b``, JAX's keys."""

    def infer(self, cfg, in_sizes):
        # the reference MixedLayer asserts every part's width against
        # the layer size (JAX's _MixedImpl.infer, which its Topology
        # never calls; the port calls it in _finalize_mixed)
        size, idx = cfg["size"], 0
        for kind, spec in cfg["parts"]:
            isz = in_sizes[idx] if idx < len(in_sizes) else None
            out = _part_width(kind, spec, isz)
            if out is not None and out != size:
                raise ConfigError(
                    f"mixed_layer(size={size}): {kind} projection yields "
                    f"size {out} — all parts must produce the layer size")
            idx += _arity(kind)
        return size

    def init(self, gen, cfg, in_sizes):
        p, idx, size = {}, 0, cfg["size"]
        for k, (kind, spec) in enumerate(cfg["parts"]):
            isz = in_sizes[idx]
            winit = _winit(spec.get("param_attr"))
            if kind == "full_matrix":
                p[f"w{k}"] = winit(gen, (isz, size))
            elif kind == "trans_full_matrix":
                p[f"w{k}"] = winit(gen, (size, isz))
            elif kind == "table":
                p[f"w{k}"] = winit(gen, (spec["vocab"], size))
            elif kind == "dotmul":
                p[f"w{k}"] = torch.ones((size,), device=gen.device)
            elif kind == "scaling":
                p[f"w{k}"] = torch.ones((1,), device=gen.device)
            elif kind == "context" and spec.get("trainable_padding"):
                start, n = spec["context_start"], spec["context_len"]
                pad_rows = max(0, -start) + max(0, start + n - 1)
                p[f"w{k}"] = winit(gen, (pad_rows, isz))
            elif kind == "conv_proj":
                fh, fw = spec["filter_size"]
                groups = spec.get("groups", 1) or 1
                p[f"w{k}"] = winit(gen, (fh, fw, spec["channels"] // groups,
                                         spec["num_filters"]))
            idx += _arity(kind)
        b = _maybe_bias(gen, cfg.get("bias_attr", False), size)
        if b is not None:
            p["b"] = b
        return p

    def apply(self, ctx, cfg, params, *inputs):
        total, idx = None, 0
        for k, (kind, spec) in enumerate(cfg["parts"]):
            pair = inputs[idx:idx + 2]
            if kind == "dotmul_op":
                part = map_rows(lambda x, y: linear.dotmul_operator(
                    x, y, spec.get("scale", 1.0)), *pair)
            elif kind == "conv_op":
                part = map_rows(lambda im, fl: _conv_operator(spec, im, fl),
                                *pair)
            else:
                part = _project(kind, spec, params.get(f"w{k}"), inputs[idx])
            idx += _arity(kind)
            total = part if total is None else map_rows(
                lambda x, y: x + y, total, part)
        if "b" in params:
            total = map_rows(lambda d: d + params["b"], total)
        out = map_rows(activations.get(cfg.get("act")), total)
        return _dropout(ctx, cfg, out)


# the one-input parts computed row by row: kind -> fn(rows, w)
_ROW_PARTS = {
    "full_matrix": linear.full_matrix_projection,
    "trans_full_matrix": linear.trans_full_matrix_projection,
    "table": lambda d, w: emb_ops.embedding_lookup(w, d),
    "dotmul": linear.dotmul_projection,
    "scaling": linear.scaling_projection,
}


def _project(kind, spec, w, v):
    """A one-input part's value: rows or a SequenceBatch, as ``v``."""
    if kind == "context":
        return seq_ops.context_projection(as_seq(v), spec["context_len"],
                                          spec["context_start"], w)
    if kind == "identity":
        return map_rows(lambda d: linear.identity_projection(
            d, spec.get("offset", 0), spec.get("size")), v)
    if kind == "conv_proj":
        return map_rows(lambda d: _conv_projection(spec, d, w), v)
    if kind not in _ROW_PARTS:
        raise ConfigError(f"unknown mixed part {kind}")
    return map_rows(lambda d: _ROW_PARTS[kind](d, w), v)


def _conv_projection(spec, rows, w):
    """Rows [B, C*H*W] -> NHWC -> ``ops/conv.conv2d`` with the part's
    weight -> rows (reference ConvProjection)."""
    c, (h, wd) = spec["channels"], spec["in_shape"]
    x = rows.reshape(rows.shape[0], c, h, wd).permute(0, 2, 3, 1)
    y = conv_ops.conv2d(x, w, stride=spec["stride"], padding=spec["padding"],
                        groups=spec.get("groups", 1) or 1)
    return y.permute(0, 3, 1, 2).reshape(rows.shape[0], -1)


def _conv_operator(spec, img, filt):
    """Reference ConvOperator.cpp:58-83: each sample convolved with its
    own filter row (nf, c, fh, fw) -- one convolution of the batch's
    channels stacked, grouped by sample (groups = B), where JAX vmaps
    over the samples."""
    c, (h, w) = spec["channels"], spec["in_shape"]
    fh, fw = spec["filter_size"]
    nf, bsz = spec["num_filters"], img.shape[0]
    x = img.reshape(bsz, c, h, w).permute(2, 3, 0, 1).reshape(1, h, w,
                                                                bsz * c)
    wt = filt.reshape(bsz, nf, c, fh, fw).permute(3, 4, 2, 0, 1).reshape(
        fh, fw, c, bsz * nf)
    y = conv_ops.conv2d(x, wt, stride=spec["stride"],
                        padding=spec["padding"], groups=bsz)
    oh, ow = y.shape[1], y.shape[2]
    return y.reshape(oh, ow, bsz, nf).permute(2, 3, 0, 1).reshape(bsz, -1)


register_layer("mixed")(_MixedImpl)


class _Part:
    """A projection or operator awaiting inclusion in a mixed_layer."""

    def __init__(self, kind, input_nodes, spec, out_size):
        self.kind = kind
        self.inputs = input_nodes
        self.spec = spec
        self.out_size = out_size


def full_matrix_projection(input, size=0, param_attr=None):
    return _Part("full_matrix", [input], {"param_attr": param_attr}, size)


def trans_full_matrix_projection(input, size=0, param_attr=None):
    return _Part("trans_full_matrix", [input], {"param_attr": param_attr},
                 size)


def identity_projection(input, offset=None, size=None):
    if offset is None:
        return _Part("identity", [input], {}, input.size)
    out = size if size is not None else input.size - offset
    return _Part("identity", [input], {"offset": offset, "size": out}, out)


def slice_projection(input, slices):
    """One identity part per [start, end) column slice, as JAX builds
    it: the mixed layer sums them (the reference's SliceProjection
    concatenates them)."""
    return [_Part("identity", [input], {"offset": s, "size": e - s}, e - s)
            for s, e in slices]


def dotmul_projection(input, param_attr=None):
    return _Part("dotmul", [input], {"param_attr": param_attr}, input.size)


def scaling_projection(input, param_attr=None):
    return _Part("scaling", [input], {"param_attr": param_attr}, input.size)


def context_projection(input, context_len, context_start=None,
                       padding_attr=False):
    """The sliding window over time (``ops/sequence.context_projection``),
    ``input.size * context_len`` wide; ``padding_attr`` (True or a
    ParamAttr) makes the out-of-range rows trainable."""
    start = context_start if context_start is not None \
        else -(context_len // 2)
    return _Part("context", [input],
                 {"context_len": context_len, "context_start": start,
                  "trainable_padding": bool(padding_attr),
                  "param_attr": padding_attr if isinstance(padding_attr, dict)
                  else None},
                 input.size * context_len)


def dotmul_operator(a, b, scale=1.0):
    return _Part("dotmul_op", [a, b], {"scale": scale}, a.size)


def _collect_parts(input):
    parts = []
    for item in _inputs_list(input):
        if isinstance(item, list):
            parts.extend(item)
        elif isinstance(item, _Part):
            parts.append(item)
        elif isinstance(item, LayerOutput):
            parts.append(identity_projection(item))
        else:
            raise ConfigError(f"bad mixed_layer input {item!r}")
    return parts


def _finalize_mixed(node, parts, size):
    """Fill ``node`` from its parts (size 0 takes the widest part) and
    run the width check."""
    if size == 0:
        size = max(p.out_size for p in parts)
    cfg_parts, nodes = [], []
    for p in parts:
        spec = dict(p.spec)
        if p.kind == "table":
            spec["vocab"] = p.inputs[0].size
        cfg_parts.append((p.kind, spec))
        nodes.extend(p.inputs)
    node.size = int(size)
    node.inputs = nodes
    # the inputs arrive after construction: sequence-ness again
    node.is_seq = any(getattr(n, "is_seq", False) for n in nodes)
    node.cfg.update({"size": size, "parts": cfg_parts})
    _MixedImpl().infer(node.cfg, [n.size for n in nodes])
    return node


class MixedLayer(LayerOutput):
    """The reference's block protocol for a mixed layer:

        with mixed_layer(size=d) as m:
            m += full_matrix_projection(input=a)
            m += identity_projection(input=b)

    The ``as`` target is the LayerOutput used downstream; parts gather
    through ``+=`` and the node is finalized when the block exits."""

    __slots__ = ("_parts", "_decl_size", "_finalized")

    def __init__(self, size, name, act, bias_attr, layer_attr):
        super().__init__(name or auto_name("mixed"), "mixed", max(size, 1),
                         [], {"size": size, "act": act,
                              "bias_attr": bias_attr, "parts": []})
        self.cfg.update(layer_attr or {})
        self._parts = []
        self._decl_size = size
        self._finalized = False

    def __iadd__(self, part):
        if self._finalized:
            raise ConfigError("mixed_layer already finalized")
        self._parts.extend(_collect_parts(part))
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            if not self._parts:
                raise ConfigError("empty mixed_layer: add projections "
                                  "with += inside the with block")
            _finalize_mixed(self, self._parts, self._decl_size)
            self._finalized = True
        return False


def mixed_layer(size=0, input=None, name=None, act=None, bias_attr=False,
                layer_attr=None):
    """The sum of projections and operators (``input=`` a part, a layer
    -- its identity projection -- or a list of them), or with no
    ``input`` a ``MixedLayer`` to fill in a ``with`` block."""
    if input is None:
        return MixedLayer(size, name, act, bias_attr, layer_attr)
    parts = _collect_parts(input)
    cfg = {"size": size, "act": act, "bias_attr": bias_attr, "parts": []}
    cfg.update(layer_attr or {})
    node = LayerOutput(name or auto_name("mixed"), "mixed", max(size, 1),
                       [], cfg)
    return _finalize_mixed(node, parts, size)


# ------------------------------------------------------- concat

class _ConcatImpl:
    def infer(self, cfg, in_sizes):
        return sum(in_sizes)

    def apply(self, ctx, cfg, params, *inputs):
        return map_rows(lambda *ds: torch.cat(ds, dim=-1), *inputs)


register_layer("concat")(_ConcatImpl)


def concat_layer(input, act=None, name=None, bias_attr=False,
                 layer_attr=None):
    ins = _only_layers("concat_layer", _inputs_list(input))
    return LayerOutput(name or auto_name("concat"), "concat",
                       sum(i.size for i in ins), ins, {"act": act})


# ------------------------------------------------------- addto

class _AddtoImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def apply(self, ctx, cfg, params, *inputs):
        return map_rows(lambda *ds: activations.get(cfg.get("act"))(
            sum(ds[1:], ds[0])), *inputs)


register_layer("addto")(_AddtoImpl)


def addto_layer(input, act=None, name=None, bias_attr=False):
    """The elementwise sum of the inputs, then ``act`` (reference
    AddtoLayer; ``bias_attr`` is accepted and unused, as in the JAX
    package).  The output keeps its inputs' image metadata (the last
    input's ``num_filters`` and ``img_shape`` that are set), as the
    reference's ``addto_layer`` passes ``num_filters`` on: a conv after a
    residual sum then reads its channels and shape.  JAX's node drops
    them, so its ``resnet_cifar`` demo needs ``num_channels=`` on the
    layers after each sum (ROADMAP C11)."""
    ins = _only_layers("addto_layer", _inputs_list(input))
    num_filters = img_shape = None
    for node in ins:
        num_filters = node.num_filters or num_filters
        img_shape = node.img_shape or img_shape
    return LayerOutput(name or auto_name("addto"), "addto", ins[0].size, ins,
                       {"act": act}, num_filters=num_filters,
                       img_shape=img_shape)


# ------------------------------------------------------- elementwise

def _simple_layer(type_name, infer_fn, apply_fn):
    """Register a parameter-free layer type from its size rule and its
    apply (JAX's ``_simple_layer``)."""
    class Impl:
        def infer(self, cfg, in_sizes):
            return infer_fn(cfg, in_sizes)

        def apply(self, ctx, cfg, params, *inputs):
            return apply_fn(ctx, cfg, *inputs)
    register_layer(type_name)(Impl)


_simple_layer("interpolation", lambda cfg, s: s[1],
              lambda ctx, cfg, w, a, b: map_rows(math_ops.interpolation,
                                                 w, a, b))


def interpolation_layer(input, weight, name=None):
    """weight * a + (1 - weight) * b, a per-row weight (reference
    InterpolationLayer)."""
    a, b = input
    return LayerOutput(name or auto_name("interpolation"), "interpolation",
                       a.size, [weight, a, b], {})


_simple_layer("power", lambda cfg, s: s[1],
              lambda ctx, cfg, p, x: map_rows(math_ops.power, p, x))


def power_layer(input, weight, name=None):
    """input ** weight, a per-row exponent (reference PowerLayer)."""
    return LayerOutput(name or auto_name("power"), "power", input.size,
                       [weight, input], {})


_simple_layer("scaling", lambda cfg, s: s[1],
              lambda ctx, cfg, w, x: map_rows(math_ops.scaling, w, x))


def scaling_layer(input, weight, name=None):
    """input times a per-row scalar weight (reference ScalingLayer)."""
    return LayerOutput(name or auto_name("scaling"), "scaling", input.size,
                       [weight, input], {})


_simple_layer("slope_intercept", lambda cfg, s: s[0],
              lambda ctx, cfg, x: map_rows(
                  lambda d: math_ops.slope_intercept(d, cfg["slope"],
                                                     cfg["intercept"]), x))


def slope_intercept_layer(input, slope=1.0, intercept=0.0, name=None):
    return LayerOutput(name or auto_name("slope_intercept"),
                       "slope_intercept", input.size, [input],
                       {"slope": slope, "intercept": intercept})


_simple_layer("linear_comb", lambda cfg, s: cfg["size"],
              lambda ctx, cfg, w, x: map_rows(
                  lambda wd, xd: linear.linear_comb(xd, wd, cfg["size"]),
                  w, x))


def linear_comb_layer(weights, vectors, size=None, name=None):
    """The weights [K] combine K vectors of ``size`` held in one row
    [K * size] (reference LinearCombinationLayer); ``size`` defaults to
    vectors.size / weights.size."""
    if size is None:
        if vectors.size % max(weights.size, 1) == 0:
            size = vectors.size // weights.size
        else:
            raise ConfigError("linear_comb_layer needs size")
    return LayerOutput(name or auto_name("linear_comb"), "linear_comb", size,
                       [weights, vectors], {"size": size})


convex_comb_layer = linear_comb_layer


_simple_layer("sum_to_one_norm", lambda cfg, s: s[0],
              lambda ctx, cfg, x: map_rows(math_ops.sum_to_one_norm, x))


def sum_to_one_norm_layer(input, name=None):
    return LayerOutput(name or auto_name("sum_to_one_norm"),
                       "sum_to_one_norm", input.size, [input], {})


_simple_layer("cos_sim", lambda cfg, s: 1,
              lambda ctx, cfg, a, b: map_rows(
                  lambda x, y: math_ops.cos_sim(x, y, cfg.get("scale", 1.0)),
                  a, b))

_simple_layer("cos_sim_vec_mat", lambda cfg, s: cfg["size"],
              lambda ctx, cfg, a, b: map_rows(
                  lambda v, m: math_ops.cos_sim_vec_mat(
                      v, m.reshape(m.shape[0], cfg["size"], -1),
                      cfg.get("scale", 1.0)), a, b))


def cos_sim(a, b, scale=1.0, size=1, name=None):
    """Row-wise cosine similarity times ``scale`` [B, 1]; with size > 1,
    of the vector ``a`` against each of the ``size`` rows that ``b``
    holds (reference CosSimVecMatLayer) [B, size]."""
    if size > 1:
        return LayerOutput(name or auto_name("cos_vm"), "cos_sim_vec_mat",
                           size, [a, b], {"scale": scale, "size": size})
    return LayerOutput(name or auto_name("cos_sim"), "cos_sim", 1, [a, b],
                       {"scale": scale})


_simple_layer("out_prod", lambda cfg, s: s[0] * s[1],
              lambda ctx, cfg, a, b: map_rows(math_ops.outer_prod, a, b))


def out_prod_layer(a, b, name=None):
    return LayerOutput(name or auto_name("out_prod"), "out_prod",
                       a.size * b.size, [a, b], {})


# trans and resize reshape the whole batch matrix, across its rows, as
# JAX's do: not row-local, so no map_rows
_simple_layer("trans", lambda cfg, s: s[0],
              lambda ctx, cfg, x: math_ops.trans(value_data(x)))


def trans_layer(input, name=None):
    """The batch matrix [B, D] transposed to [D, B] (reference
    TransLayer); the node keeps the input's size, as JAX's does."""
    return LayerOutput(name or auto_name("trans"), "trans", input.size,
                       [input], {})


_simple_layer("rotate", lambda cfg, s: s[0],
              lambda ctx, cfg, x: map_rows(
                  lambda d: math_ops.rotate(d, cfg["height"], cfg["width"]),
                  x))


def rotate_layer(input, height, width, name=None):
    return LayerOutput(name or auto_name("rotate"), "rotate", input.size,
                       [input], {"height": height, "width": width})


class _TensorImpl:
    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        return {"w": _winit(cfg.get("param_attr"))(
            gen, (cfg["size"], in_sizes[0], in_sizes[1]))}

    def apply(self, ctx, cfg, params, a, b):
        return map_rows(lambda x, y: math_ops.tensor_product(
            x, y, params["w"], cfg.get("act")), a, b)


register_layer("tensor")(_TensorImpl)


def tensor_layer(a, b, size, act=None, name=None, param_attr=None,
                 bias_attr=False):
    """y_k = a W_k b^T for k < size, then ``act`` (reference TensorLayer;
    w [size, a.size, b.size]; ``bias_attr`` is accepted and unused, as in
    the JAX package)."""
    return LayerOutput(name or auto_name("tensor"), "tensor", size, [a, b],
                       {"size": size, "act": act, "param_attr": param_attr})


_simple_layer("multiplex", lambda cfg, s: s[1],
              lambda ctx, cfg, idx, *xs: map_rows(math_ops.multiplex,
                                                  idx, *xs))


def multiplex_layer(input, name=None):
    """input = [index, x_0, x_1, ...]: row i of x_{index[i]} (reference
    MultiplexLayer)."""
    idx, *rest = input
    return LayerOutput(name or auto_name("multiplex"), "multiplex",
                       rest[0].size, [idx] + rest, {})


_simple_layer("conv_shift", lambda cfg, s: s[0],
              lambda ctx, cfg, a, b: map_rows(math_ops.conv_shift, a, b))


def conv_shift_layer(a, b, name=None):
    return LayerOutput(name or auto_name("conv_shift"), "conv_shift", a.size,
                       [a, b], {})


_simple_layer("featmap_expand", lambda cfg, s: s[0] * cfg["num_filters"],
              lambda ctx, cfg, x: map_rows(
                  lambda d: math_ops.feature_map_expand(
                      d, cfg["num_filters"], cfg.get("as_row_vector", True)),
                  x))


def featmap_expand_layer(input, num_filters, as_row_vector=True, name=None):
    return LayerOutput(name or auto_name("featmap_expand"), "featmap_expand",
                       input.size * num_filters, [input],
                       {"num_filters": num_filters,
                        "as_row_vector": as_row_vector})


_simple_layer("resize", lambda cfg, s: cfg["size"],
              lambda ctx, cfg, x: math_ops.resize(value_data(x), cfg["size"]))


def resize_layer(input, size, name=None):
    """The batch's values re-read as rows of ``size`` (reference
    ResizeLayer): [B, D] -> [B * D / size, size]."""
    return LayerOutput(name or auto_name("resize"), "resize", size, [input],
                       {"size": size}, is_seq=False)


_simple_layer("repeat", lambda cfg, s: s[0] * cfg["n"],
              lambda ctx, cfg, v: map_rows(
                  lambda d: d.repeat((1,) * (d.dim() - 1) + (cfg["n"],)), v))


def repeat_layer(input, num_repeats, name=None, layer_attr=None):
    """y = [x, x, ..., x], ``num_repeats`` copies side by side (reference
    repeat_layer, layers.py:1514)."""
    return LayerOutput(name or auto_name("repeat"), "repeat",
                       input.size * num_repeats, [input], {"n": num_repeats})


class _PreluImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def init(self, gen, cfg, in_sizes):
        n = cfg.get("partial_sum", 1)
        return {"alpha": torch.full(
            (in_sizes[0] // n if n else in_sizes[0],), 0.25,
            device=gen.device)}

    def apply(self, ctx, cfg, params, x):
        n = cfg.get("partial_sum", 1)
        alpha = torch.repeat_interleave(params["alpha"], n) if n > 1 \
            else params["alpha"]
        return map_rows(lambda d: math_ops.prelu(d, alpha), x)


register_layer("prelu")(_PreluImpl)


def prelu_layer(input, partial_sum=1, name=None, param_attr=None):
    """Parametric ReLU (reference ParameterReluLayer): one learned slope
    ``alpha`` (0.25 at init) for each ``partial_sum`` adjacent entries."""
    return LayerOutput(name or auto_name("prelu"), "prelu", input.size,
                       [input], {"partial_sum": partial_sum,
                                 "param_attr": param_attr})


class _SelectiveFcImpl:
    """Reference SelectiveFullyConnectedLayer: the fc over the whole
    class matrix, then, with a selection input, each row times its 0/1
    selection (JAX's dense form)."""

    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        p = {"w": _winit(cfg.get("param_attr"))(gen,
                                                (in_sizes[0], cfg["size"]))}
        b = _maybe_bias(gen, cfg.get("bias_attr", True), cfg["size"])
        if b is not None:
            p["b"] = b
        return p

    def apply(self, ctx, cfg, params, x, sel=None):
        def fn(d):
            y = linear.matmul(d, params["w"])
            if "b" in params:
                y = y + params["b"]
            return activations.get(cfg.get("act"))(y)
        out = map_rows(fn, x)
        if sel is not None:
            out = map_rows(lambda o, s: o * s, out, sel)
        return out


register_layer("selective_fc")(_SelectiveFcImpl)


def selective_fc_layer(input, size, select=None, act="tanh", name=None,
                       param_attr=None, bias_attr=True):
    ins = [input] + ([select] if select is not None else [])
    return LayerOutput(name or auto_name("selective_fc"), "selective_fc",
                       size, ins, {"size": size, "act": act,
                                   "param_attr": param_attr,
                                   "bias_attr": bias_attr})


# ------------------------------------------------------- dropout

class _DropoutImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def apply(self, ctx, cfg, params, x):
        return _dropout(ctx, cfg, x)


register_layer("dropout")(_DropoutImpl)


def dropout_layer(input, dropout_rate, name=None):
    """Inverted dropout at ``dropout_rate`` in train mode (kept entries
    scaled by 1 / (1 - rate)), the identity in test mode; the mask is
    drawn from the apply's generator (``Context.uniform``), so its
    bits are PyTorch's, not JAX's."""
    return LayerOutput(name or auto_name("dropout"), "dropout", input.size,
                       [input], {"drop_rate": dropout_rate},
                       num_filters=input.num_filters,
                       img_shape=input.img_shape)


# ------------------------------------------------------- sequence pooling

class _SeqPoolImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def apply(self, ctx, cfg, params, x):
        if isinstance(x, NestedSequenceBatch):
            # within each sub-sequence at agg_level "seq", else over the
            # whole (flattened) nested sequence
            return seq_ops.nested_seq_pool(
                x, cfg["pooling"], each_sequence=cfg.get("agg_level") == "seq")
        stride = cfg.get("stride", -1)
        if stride and stride > 0:
            return seq_ops.seq_strided_pool(as_seq(x), cfg["pooling"],
                                            int(stride))
        return seq_ops.seq_pool(as_seq(x), cfg["pooling"])


register_layer("seq_pool")(_SeqPoolImpl)


class pooling:
    """Pooling type markers (reference poolings.py MaxPooling/AvgPooling...)."""
    class Max:  # noqa: N801
        name = "max"

    class Avg:  # noqa: N801
        name = "avg"

    class Sum:  # noqa: N801
        name = "sum"

    class SqrtN:  # noqa: N801
        name = "sqrt"


def pooling_layer(input, pooling_type=None, name=None, agg_level=None):
    """Pool each sequence to one row; agg_level='seq' over a nested input
    pools each sub-sequence (a sequence of pooled rows)."""
    pt = getattr(pooling_type, "name", pooling_type) or "max"
    return LayerOutput(name or auto_name("seq_pool"), "seq_pool", input.size,
                       [input], {"pooling": pt, "agg_level": agg_level},
                       is_seq=agg_level == "seq")


def last_seq(input, name=None, agg_level=None, stride=-1):
    """The last valid step of each sequence; with stride > 0 (reference
    seqlastins stride) the last valid step of each window of ``stride``
    steps, a shorter sequence (``ops/sequence.seq_strided_pool``).
    agg_level='seq' over a nested input: each sub-sequence's last."""
    return LayerOutput(name or auto_name("last_seq"), "seq_pool", input.size,
                       [input], {"pooling": "last", "stride": stride,
                                 "agg_level": agg_level},
                       is_seq=stride > 0 or agg_level == "seq")


def first_seq(input, name=None, agg_level=None, stride=-1):
    """The first step; with stride > 0 the first of each window."""
    return LayerOutput(name or auto_name("first_seq"), "seq_pool", input.size,
                       [input], {"pooling": "first", "stride": stride,
                                 "agg_level": agg_level},
                       is_seq=stride > 0 or agg_level == "seq")


class AggregateLevel:
    """Reference AggregateLevel (layers.py:227)."""
    EACH_TIMESTEP = "non-seq"
    EACH_SEQUENCE = "seq"
    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"


class ExpandLevel:
    """Reference ExpandLevel (layers.py:1456)."""
    FROM_TIMESTEP = AggregateLevel.EACH_TIMESTEP
    FROM_SEQUENCE = AggregateLevel.EACH_SEQUENCE
    FROM_NO_SEQUENCE = AggregateLevel.EACH_TIMESTEP


# ------------------------------------------------------- sequence layers

_simple_layer("expand", lambda cfg, s: s[0],
              lambda ctx, cfg, vec, like: seq_ops.expand(value_data(vec),
                                                         as_seq(like)))


def expand_layer(input, expand_as, name=None, expand_level=None):
    """Each row of ``input`` repeated over the steps of its sequence in
    ``expand_as`` (reference ExpandLayer; ``expand_level`` is accepted
    and unused, as in the JAX package)."""
    return LayerOutput(name or auto_name("expand"), "expand", input.size,
                       [input, expand_as], {}, is_seq=True)


_simple_layer("seq_concat", lambda cfg, s: s[0],
              lambda ctx, cfg, a, b: seq_ops.seq_concat(as_seq(a),
                                                        as_seq(b)))


def seq_concat_layer(a, b, name=None):
    return LayerOutput(name or auto_name("seq_concat"), "seq_concat", a.size,
                       [a, b], {}, is_seq=True)


_simple_layer("seq_reshape", lambda cfg, s: cfg["size"],
              lambda ctx, cfg, x: seq_ops.seq_reshape(as_seq(x),
                                                      cfg["size"]))


def seq_reshape_layer(input, reshape_size, name=None):
    return LayerOutput(name or auto_name("seq_reshape"), "seq_reshape",
                       reshape_size, [input], {"size": reshape_size},
                       is_seq=True)


def _ids(v):
    """A per-row integer input (offsets, sizes, starts, ends) as int32
    [B]."""
    return value_data(v).reshape(-1).to(torch.int32)


class _SubSeqImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def apply(self, ctx, cfg, params, x, offsets, sizes):
        sb = as_seq(x)
        return seq_ops.sub_seq(sb, _ids(offsets), _ids(sizes), sb.max_len)


register_layer("sub_seq")(_SubSeqImpl)


def sub_seq_layer(input, offsets, sizes, name=None):
    """Steps [offset, offset + size) of each sequence (reference
    SubSequenceLayer)."""
    return LayerOutput(name or auto_name("sub_seq"), "sub_seq", input.size,
                       [input, offsets, sizes], {}, is_seq=True)


class _SeqSliceImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def apply(self, ctx, cfg, params, x, *rest):
        rest = list(rest)
        starts = _ids(rest.pop(0)) if cfg["has_starts"] else None
        ends = _ids(rest.pop(0)) if cfg["has_ends"] else None
        return seq_ops.seq_slice(as_seq(x), starts, ends)


register_layer("seq_slice")(_SeqSliceImpl)


def seq_slice_layer(input, starts=None, ends=None, name=None):
    """Steps [start, end) of each sequence, from 0 and to its length
    where ``starts`` / ``ends`` are not given."""
    ins = [input] + [x for x in (starts, ends) if x is not None]
    return LayerOutput(name or auto_name("seq_slice"), "seq_slice",
                       input.size, ins,
                       {"has_starts": starts is not None,
                        "has_ends": ends is not None}, is_seq=True)


_simple_layer("maxid", lambda cfg, s: 1,
              lambda ctx, cfg, x: map_rows(seq_ops.max_id, x))


def maxid_layer(input, name=None):
    return LayerOutput(name or auto_name("maxid"), "maxid", 1, [input], {})


_simple_layer("eos", lambda cfg, s: 1,
              lambda ctx, cfg, x: map_rows(
                  lambda d: seq_ops.eos_check(d, cfg["eos_id"]), x))


def eos_layer(input, eos_id, name=None):
    return LayerOutput(name or auto_name("eos"), "eos", 1, [input],
                       {"eos_id": eos_id})


class _SamplingIdImpl:
    def infer(self, cfg, in_sizes):
        return 1

    def apply(self, ctx, cfg, params, x):
        return map_rows(lambda d: seq_ops.sampling_id(
            ctx.uniform(d.shape[:-1], d.device), d), x)


register_layer("sampling_id")(_SamplingIdImpl)


def sampling_id_layer(input, name=None):
    """An id per row drawn from the row's distribution, from the apply's
    generator (``Context.uniform``), so its bits are PyTorch's."""
    return LayerOutput(name or auto_name("sampling_id"), "sampling_id", 1,
                       [input], {})


class _PrintImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def apply(self, ctx, cfg, params, x):
        print(cfg.get("format", "{}").format(value_data(x)), flush=True)
        return x


register_layer("print")(_PrintImpl)


def print_layer(input, format=None, name=None):
    """Prints its input's value on the host (a device sync) and returns
    it."""
    return LayerOutput(name or auto_name("print"), "print", input.size,
                       [input], {"format": format or "{}"})


# ------------------------------------------------------- cost layers

def _seq_or_row_mean(loss, like):
    """Per-token losses on sequences average over valid tokens per
    sample."""
    if isinstance(like, SequenceBatch):
        return losses.masked_seq_mean(loss, like.mask(loss.dtype))
    return loss


def _register_cost(type_name, fn):
    class Impl:
        def infer(self, cfg, in_sizes):
            return 1

        def apply(self, ctx, cfg, params, *ins):
            if cfg.get("weighted"):
                # a per-sample weight input (reference CostLayer weights)
                *core, w = ins
                val = fn(ctx, cfg, *core)
                wd = value_data(w)
                return val * wd.reshape(wd.shape[0], -1)[:, 0]
            return fn(ctx, cfg, *ins)
    register_layer(type_name)(Impl)


def _ce_cost(ctx, cfg, pred, label):
    pd, ld = value_data(pred), value_data(label)
    ids = ld.reshape(ld.shape[:-1]) if ld.dim() > 1 and ld.shape[-1] == 1 \
        else ld
    per = losses.classification_cost(pd, ids,
                                     from_logits=cfg.get("from_logits", True))
    return _seq_or_row_mean(per, pred)


_register_cost("classification_cost", _ce_cost)


def _logits_view(node):
    """If ``node`` is a softmax-activated layer, a logits alias: the same
    type, inputs and parameters (shared through param_name) with
    act=None, so the cost fuses softmax and CE as log_softmax(logits) —
    the reference's MultiClassCrossEntropy backward writes (p - y) into
    the softmax layer the same way.  A softmax layer with dropout keeps
    the probability path (dropout runs after the activation)."""
    if node.cfg.get("act") != "softmax" or node.cfg.get("drop_rate"):
        return None
    cfg = dict(node.cfg)
    cfg["act"] = None
    # the alias key must match Topology._param_key exactly
    if "param_name" in node.cfg:
        key = node.cfg["param_name"]
    else:
        pa = node.cfg.get("param_attr")
        key = pa["name"] if isinstance(pa, dict) and pa.get("name") \
            else node.name
    cfg["param_name"] = key
    return LayerOutput(auto_name(node.name + "_logits"), node.layer_type,
                       node.size, node.inputs, cfg, is_seq=node.is_seq)


def classification_cost(input, label, weight=None, name=None, evaluator=None,
                        from_logits=False):
    """Reference classification_cost: input is the softmax output; on a
    softmax layer the cost reads its logits (``_logits_view``).  weight:
    an optional per-sample cost weight layer.  ``evaluator`` is accepted
    and unused, as in the JAX package."""
    if not from_logits:
        logits = _logits_view(input)
        if logits is not None:
            input, from_logits = logits, True
    ins = [input, label] + ([weight] if weight is not None else [])
    return LayerOutput(name or auto_name("cost"), "classification_cost", 1,
                       ins, {"from_logits": from_logits,
                             "weighted": weight is not None},
                       is_seq=False)


def cross_entropy(input, label, name=None, from_logits=False):
    return classification_cost(input, label, name=name,
                               from_logits=from_logits)


def _last_dim_1(d):
    """[..., 1] -> [...]: a value column as one per row or step."""
    return d[..., 0] if d.dim() == 3 else d


_register_cost("mse", lambda ctx, cfg, p, l: _seq_or_row_mean(
    losses.square_error(value_data(p), value_data(l)), p))


def regression_cost(input, label, weight=None, name=None):
    """Half the squared error, summed over the row (reference
    SumOfSquaresCostLayer); ``weight``: an optional per-sample weight
    layer."""
    ins = [input, label] + ([weight] if weight is not None else [])
    return LayerOutput(name or auto_name("mse"), "mse", 1, ins,
                       {"weighted": weight is not None}, is_seq=False)


mse_cost = regression_cost


_register_cost("ce_selfnorm", lambda ctx, cfg, p, l: _seq_or_row_mean(
    losses.cross_entropy_with_selfnorm(
        value_data(p), value_data(l).reshape(value_data(p).shape[:-1]),
        cfg.get("alpha", 0.1)), p))


def cross_entropy_with_selfnorm(input, label, alpha=0.1, name=None):
    return LayerOutput(name or auto_name("ce_selfnorm"), "ce_selfnorm", 1,
                       [input, label], {"alpha": alpha}, is_seq=False)


_register_cost("soft_bce", lambda ctx, cfg, p, l: _seq_or_row_mean(
    losses.soft_binary_class_cross_entropy(value_data(p), value_data(l)), p))


def soft_binary_class_cross_entropy(input, label, name=None):
    return LayerOutput(name or auto_name("soft_bce"), "soft_bce", 1,
                       [input, label], {}, is_seq=False)


_register_cost("multi_bce", lambda ctx, cfg, p, l: _seq_or_row_mean(
    losses.multi_binary_label_cross_entropy(value_data(p), value_data(l)),
    p))


def multi_binary_label_cross_entropy(input, label, name=None):
    return LayerOutput(name or auto_name("multi_bce"), "multi_bce", 1,
                       [input, label], {}, is_seq=False)


_register_cost("rank", lambda ctx, cfg, left, right, label, *w:
               losses.rank_cost(value_data(left), value_data(right),
                                value_data(label),
                                value_data(w[0]) if w else None))


def rank_cost(left, right, label, weight=None, name=None):
    ins = [left, right, label] + ([weight] if weight is not None else [])
    return LayerOutput(name or auto_name("rank"), "rank", 1, ins, {},
                       is_seq=False)


_register_cost("lambda", lambda ctx, cfg, score, rel: losses.lambda_cost(
    _last_dim_1(value_data(score)), _last_dim_1(value_data(rel)),
    as_seq(score).mask(), cfg.get("ndcg_num", 5)))


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, name=None):
    """LambdaRank over a sequence of documents: ``input`` the model's
    scores, ``score`` the relevance (``max_sort_size`` is accepted and
    unused, as in the JAX package)."""
    return LayerOutput(name or auto_name("lambda"), "lambda", 1,
                       [input, score], {"ndcg_num": NDCG_num}, is_seq=False)


_register_cost("huber", lambda ctx, cfg, p, l: losses.huber_classification(
    value_data(p), value_data(l)))


def huber_cost(input, label, name=None):
    """The two-class huber cost (reference HuberTwoClassification)."""
    return LayerOutput(name or auto_name("huber"), "huber", 1, [input, label],
                       {}, is_seq=False)


_register_cost("smooth_l1", lambda ctx, cfg, p, l: _seq_or_row_mean(
    losses.smooth_l1(value_data(p), value_data(l)), p))


def smooth_l1_cost(input, label, name=None):
    return LayerOutput(name or auto_name("smooth_l1"), "smooth_l1", 1,
                       [input, label], {}, is_seq=False)


_register_cost("sum_cost", lambda ctx, cfg, x: losses.sum_cost(value_data(x)))


def sum_cost(input, name=None):
    return LayerOutput(name or auto_name("sum_cost"), "sum_cost", 1, [input],
                       {}, is_seq=False)


# ------------------------------------------------------- structured costs

def _crf_init(gen, cfg, in_sizes):
    n = cfg["size"]
    return {"w": _winit(cfg.get("param_attr"), default_std=0.1)(
        gen, (n + 2, n))}


class _CrfImpl:
    def infer(self, cfg, in_sizes):
        return 1

    init = staticmethod(_crf_init)

    def apply(self, ctx, cfg, params, emissions, label):
        sb = as_seq(emissions)
        return crf_ops.crf_log_likelihood(
            sb.data, _last_dim_1(value_data(label)), sb.lengths, params["w"])


register_layer("crf")(_CrfImpl)


def crf_layer(input, label, size=None, param_attr=None, name=None,
              weight=None, layer_attr=None):
    """The linear-chain CRF's negative log-likelihood of ``label`` over
    the emission sequence ``input`` (N = ``size`` tags).  Its [N+2, N]
    weight is keyed by the ParamAttr's name, else ``name``, else a fresh
    ``crf_w`` name, so ``crf_decoding_layer(param_name=...)`` shares it
    (``weight`` is accepted and unused, as in the JAX package)."""
    n = size or input.size
    pa_name = param_attr.get("name") if isinstance(param_attr, dict) else None
    return LayerOutput(name or auto_name("crf"), "crf", 1, [input, label],
                       {"size": n, "param_attr": param_attr,
                        "param_name": pa_name or name or auto_name("crf_w")},
                       is_seq=False)


class _CrfDecodingImpl:
    def infer(self, cfg, in_sizes):
        return 1

    init = staticmethod(_crf_init)

    def apply(self, ctx, cfg, params, emissions, label=None):
        sb = as_seq(emissions)
        tags, _ = crf_ops.crf_decode(sb.data, sb.lengths, params["w"])
        if label is not None:
            # with a label, the reference CRFDecodingLayer emits the
            # per-position 0/1 error indicator instead of the tags
            lab = as_seq(label).data
            lab = lab.reshape(lab.shape[0], lab.shape[1], -1)[..., 0]
            err = (tags != lab).to(torch.float32) * sb.mask(torch.float32)
            return SequenceBatch(data=err[..., None], lengths=sb.lengths)
        return SequenceBatch(data=tags[..., None], lengths=sb.lengths)


register_layer("crf_decoding")(_CrfDecodingImpl)


def crf_decoding_layer(input, size=None, label=None, param_attr=None,
                       name=None, param_name=None, layer_attr=None):
    """Viterbi tags [B, T, 1] (int32) of the emission sequence, or with
    ``label`` the per-position error indicator; ``param_name`` (or a
    ParamAttr name) shares the weight ``crf_layer`` learns."""
    n = size or input.size
    cfg = {"size": n, "param_attr": param_attr}
    pa_name = param_attr.get("name") if isinstance(param_attr, dict) else None
    if param_name or pa_name:
        cfg["param_name"] = param_name or pa_name
    ins = [input] + ([label] if label is not None else [])
    return LayerOutput(name or auto_name("crf_decoding"), "crf_decoding", 1,
                       ins, cfg, is_seq=True)


def _ctc_cost(ctx, cfg, probs, label):
    sb, lab = as_seq(probs), as_seq(label)
    logp = torch.log_softmax(sb.data, dim=-1) if cfg.get("from_logits") \
        else torch.log(torch.clamp(sb.data, min=1e-20))
    return ctc_ops.ctc_loss(logp, sb.lengths, _last_dim_1(lab.data),
                            lab.lengths, blank=cfg.get("blank", 0))


_register_cost("ctc", _ctc_cost)


def ctc_layer(input, label, size=None, blank=None, norm_by_times=False,
              name=None):
    """CTC over probabilities (reference CTCLayer): blank = size - 1
    unless given (``norm_by_times`` is accepted and unused, as in the
    JAX package)."""
    n = size or input.size
    return LayerOutput(name or auto_name("ctc"), "ctc", 1, [input, label],
                       {"blank": blank if blank is not None else n - 1},
                       is_seq=False)


def warp_ctc_layer(input, label, size=None, blank=0, norm_by_times=False,
                   name=None):
    """CTC over logits (reference WarpCTCLayer: a log-softmax first),
    blank 0 unless given."""
    return LayerOutput(name or auto_name("warp_ctc"), "ctc", 1,
                       [input, label], {"blank": blank, "from_logits": True},
                       is_seq=False)


# ------------------------------------------------------- sampled costs

class _NceImpl:
    def infer(self, cfg, in_sizes):
        return 1

    def init(self, gen, cfg, in_sizes):
        return {"w": _winit(cfg.get("param_attr"))(
            gen, (cfg["num_classes"], in_sizes[0])),
            "b": torch.zeros((cfg["num_classes"],), device=gen.device)}

    def apply(self, ctx, cfg, params, x, label):
        xd, ld = value_data(x), value_data(label)
        ids = ld.reshape(ld.shape[0]).to(torch.int32)
        n = cfg["num_classes"]
        u = ctx.uniform((xd.shape[0], cfg.get("num_neg_samples", 10)),
                        xd.device)
        # uniform ids from the context's draws (floor(u * n): float32 u
        # steps by 2^-24, so each id's share is 1/n within n * 2^-24)
        neg = torch.clamp((u * n).long(), max=n - 1).to(torch.int32)
        return sampling_ops.nce_loss(xd, params["w"], params["b"], ids, neg,
                                     n)


register_layer("nce")(_NceImpl)


def nce_layer(input, label, num_classes, num_neg_samples=10, name=None,
              param_attr=None):
    """Noise-contrastive estimation over ``num_classes`` (reference
    NCELayer): w [num_classes, input.size] and b; ``num_neg_samples``
    uniform negatives a row, drawn from the apply's generator
    (``Context.uniform``)."""
    return LayerOutput(name or auto_name("nce"), "nce", 1, [input, label],
                       {"num_classes": num_classes,
                        "num_neg_samples": num_neg_samples,
                        "param_attr": param_attr}, is_seq=False)


class _HsigmoidImpl:
    def infer(self, cfg, in_sizes):
        return 1

    def init(self, gen, cfg, in_sizes):
        return {"w": _winit(cfg.get("param_attr"))(
            gen, (cfg["num_classes"] - 1, in_sizes[0])),
            "b": torch.zeros((cfg["num_classes"] - 1,), device=gen.device)}

    def apply(self, ctx, cfg, params, x, label):
        xd, ld = value_data(x), value_data(label)
        ids = ld.reshape(ld.shape[0]).to(torch.int32)
        return sampling_ops.hsigmoid_loss(xd, params["w"], params["b"], ids,
                                          cfg["num_classes"])


register_layer("hsigmoid")(_HsigmoidImpl)


def hsigmoid(input, label, num_classes, name=None, param_attr=None,
             bias_attr=True):
    """The hierarchical sigmoid cost over ``num_classes`` (reference
    HierarchicalSigmoidLayer): w [num_classes - 1, input.size] and b
    (``bias_attr`` is accepted and unused, as in the JAX package)."""
    return LayerOutput(name or auto_name("hsigmoid"), "hsigmoid", 1,
                       [input, label],
                       {"num_classes": num_classes, "param_attr": param_attr},
                       is_seq=False)
