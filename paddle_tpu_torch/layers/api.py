"""v1-DSL layer ctors (``paddle_tpu/layers/api.py``): the data, fc and
embedding layers, sequence pooling, concat and the classification cost —
the layers of the reference's RNN text classifier and the two DSL demos
(quick_start, sentiment) — and the mixture-of-experts ``moe_layer``.
The rest of ``api.py`` (mixed layers and projections, the elementwise
and cost zoo, crf, ctc, nce, hsigmoid) waits for ROADMAP A10·b.

Every ctor returns a LayerOutput graph node; ``graph.Topology`` runs it.
Initializers follow the JAX package's rules (weights normal with std
1/sqrt(fan_in) unless a ParamAttr says otherwise, biases 0) on the
port's own random bits.
"""

import math

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.graph import (
    LayerOutput, register_layer, auto_name, map_rows, as_seq, value_data,
    dropout)
from paddle_tpu_torch.ops import activations, linear, losses
from paddle_tpu_torch.ops import moe as moe_ops
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.utils.error import ConfigError

__all__ = [
    "data_layer", "fc_layer", "moe_layer", "embedding_layer",
    "concat_layer",
    "pooling_layer", "pooling", "last_seq", "first_seq",
    "classification_cost",
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
            raise ConfigError(f"{ctor}: input {item!r} is not a layer; "
                              "projections need mixed_layer, not ported yet "
                              "(ROADMAP A10·b)")
    return items


# ---------------------------------------------------------------- data

class _DataImpl:
    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def apply(self, ctx, cfg, params):
        raise RuntimeError("data layers are fed, not applied")


register_layer("data")(_DataImpl)


def data_layer(name, size, is_seq=False, height=None, width=None):
    """Reference data_layer(name, size).  Image shapes (height, width)
    wait for the vision layers (ROADMAP A10·b)."""
    if height or width:
        raise ConfigError("data_layer(height=, width=) feeds the vision "
                          "layers, not ported yet (ROADMAP A10·b)")
    return LayerOutput(name, "data", size, cfg={"size": size}, is_seq=is_seq)


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

