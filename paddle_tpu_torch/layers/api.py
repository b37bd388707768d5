"""v1-DSL layer ctors (``paddle_tpu/layers/api.py``): the data, fc and
embedding layers, ``mixed_layer`` with its projections and operators,
sequence pooling, concat, addto, dropout, the cost zoo (classification,
regression, self-normalized and binary cross-entropies, rank, lambda,
huber, smooth-L1, sum), the structured costs (``crf_layer``,
``crf_decoding_layer``, ``ctc_layer``, ``warp_ctc_layer``) and the
mixture-of-experts ``moe_layer``.  ``layers/vision.py`` holds the conv
stack and the conv parts of ``mixed_layer``.  The elementwise and
sequence layers, ``nce_layer`` and ``hsigmoid`` wait for ROADMAP A10·b.

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

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.graph import (
    LayerOutput, register_layer, auto_name, map_rows, as_seq, value_data,
    dropout)
from paddle_tpu_torch.ops import activations, linear, losses
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import ctc as ctc_ops
from paddle_tpu_torch.ops import moe as moe_ops
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.utils.error import ConfigError

__all__ = [
    "data_layer", "fc_layer", "moe_layer", "embedding_layer",
    "concat_layer", "addto_layer", "dropout_layer",
    "pooling_layer", "pooling", "last_seq", "first_seq",
    "mixed_layer", "full_matrix_projection", "trans_full_matrix_projection",
    "identity_projection", "table_projection", "slice_projection",
    "dotmul_projection", "scaling_projection", "context_projection",
    "dotmul_operator",
    "classification_cost", "regression_cost", "mse_cost", "cross_entropy",
    "cross_entropy_with_selfnorm", "soft_binary_class_cross_entropy",
    "multi_binary_label_cross_entropy", "rank_cost", "lambda_cost",
    "huber_cost", "smooth_l1_cost", "sum_cost", "crf_layer",
    "crf_decoding_layer", "ctc_layer", "warp_ctc_layer",
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
    ``sparse_update`` is kept in the config; ``trainer.SGD`` refuses it
    (the sparse row path is ROADMAP A9·f)."""
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
    drawn from the apply's generator (``Context.rand_like``), so its
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


def _whole_sequence(ctor, agg_level, stride=-1):
    if agg_level == "seq" or (stride and stride > 0):
        raise ConfigError(f"{ctor}: agg_level='seq' and stride > 0 pool "
                          "nested or strided sequences, not ported yet "
                          "(ROADMAP A10·b)")


def pooling_layer(input, pooling_type=None, name=None, agg_level=None):
    _whole_sequence("pooling_layer", agg_level)
    pt = getattr(pooling_type, "name", pooling_type) or "max"
    return LayerOutput(name or auto_name("seq_pool"), "seq_pool", input.size,
                       [input], {"pooling": pt, "agg_level": agg_level},
                       is_seq=False)


def last_seq(input, name=None, agg_level=None, stride=-1):
    _whole_sequence("last_seq", agg_level, stride)
    return LayerOutput(name or auto_name("last_seq"), "seq_pool", input.size,
                       [input], {"pooling": "last", "stride": stride,
                                 "agg_level": agg_level},
                       is_seq=False)


def first_seq(input, name=None, agg_level=None, stride=-1):
    _whole_sequence("first_seq", agg_level, stride)
    return LayerOutput(name or auto_name("first_seq"), "seq_pool", input.size,
                       [input], {"pooling": "first", "stride": stride,
                                 "agg_level": agg_level},
                       is_seq=False)


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
