"""Layer-graph IR and its evaluator (``paddle_tpu/layers/graph.py``).

The DSL's ctors (``fc_layer``, ``recurrent_layer``, ...) return
``LayerOutput`` nodes (name, type, size, inputs, cfg).  ``Topology``
orders the nodes reachable from its outputs and:

  Topology.init(generator)       -> params {param_key: {param: tensor}}
  Topology.apply(params, feed)   -> the outputs' values, eagerly

Parameter keys are the JAX package's (``_param_key``: an explicit
``param_name``, else a ParamAttr name, else the layer name), and the
names ``auto_name`` mints follow the same counters, so one config gives
the same keys in both packages and a JAX parameter tree or checkpoint
maps onto the port's (``params_from_numpy``).  Values flowing between
layers are tensors [B, D] (one row per sample) or ``SequenceBatch``es
(padded [B, T, D] + lengths) or ``NestedSequenceBatch``es (padded
[B, S, T, D] + outer and inner lengths); row-wise layers accept all
three (``map_rows``).  Where JAX jits the whole graph, the port walks the
nodes in Python on every call; autograd takes the gradient.

Container layers (``recurrent_group``) hold a step sub-graph in
``cfg["sub_topo"]``: ``init`` draws its parameters into the same
top-level dict under their own sharing keys, as JAX's ``_init_into``
does, the container applies it against ``Context.params`` on every
step, and ``apply(precomputed=)`` takes the values the group hoisted
out of its loop.  ``_NODE_OBSERVERS`` see every node built, so the
group's tracer finds step nodes that are not ancestors of its outputs.

Each layer type registers a LayerImpl:
  infer(cfg, in_sizes) -> output size
  init(generator, cfg, in_sizes) -> param dict (may be {})
  apply(ctx, cfg, params, *inputs) -> output value
"""

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_map

_LAYER_IMPLS: Dict[str, "LayerImpl"] = {}
_NAME_COUNTERS: Dict[str, int] = {}

# called with every LayerOutput built: the recurrent_group tracer sees the
# step nodes that CONSUME the step's outputs (a memory may link one, e.g.
# last_seq(inner_out, name="outer_rnn_state"))
_NODE_OBSERVERS: List[Callable] = []


@dataclasses.dataclass
class LayerImpl:
    type: str
    infer: Callable            # (cfg, in_sizes) -> int
    init: Callable             # (generator, cfg, in_sizes) -> dict
    apply: Callable            # (ctx, cfg, params, *inputs) -> value


def register_layer(type_name):
    def deco(cls_or_fns):
        impl = cls_or_fns() if isinstance(cls_or_fns, type) else cls_or_fns
        _LAYER_IMPLS[type_name] = LayerImpl(
            type=type_name,
            infer=getattr(impl, "infer"),
            init=getattr(impl, "init", lambda gen, cfg, in_sizes: {}),
            apply=getattr(impl, "apply"))
        return cls_or_fns
    return deco


def get_impl(type_name) -> LayerImpl:
    try:
        return _LAYER_IMPLS[type_name]
    except KeyError:
        raise ConfigError(f"no layer impl registered for type {type_name!r}")


def auto_name(prefix):
    n = _NAME_COUNTERS.get(prefix, 0)
    _NAME_COUNTERS[prefix] = n + 1
    return f"__{prefix}_{n}__"


def reset_names():
    _NAME_COUNTERS.clear()


class LayerOutput:
    """A node in the layer graph (reference: the LayerOutput returned by
    every trainer_config_helpers ctor)."""

    __slots__ = ("name", "layer_type", "size", "inputs", "cfg", "is_seq",
                 "num_filters", "img_shape")

    def __init__(self, name, layer_type, size, inputs=(), cfg=None,
                 is_seq=None, num_filters=None, img_shape=None):
        self.name = name
        self.layer_type = layer_type
        self.size = int(size)
        self.inputs: List[LayerOutput] = list(inputs)
        self.cfg = dict(cfg or {})
        # sequence-ness propagates: seq in -> seq out unless overridden
        if is_seq is None:
            is_seq = any(getattr(i, "is_seq", False) for i in self.inputs)
        self.is_seq = is_seq
        self.num_filters = num_filters      # conv image metadata
        self.img_shape = img_shape          # (h, w) after this layer
        for obs in _NODE_OBSERVERS:
            obs(self)

    def __repr__(self):
        return (f"LayerOutput({self.name}, {self.layer_type}, size={self.size}"
                f"{', seq' if self.is_seq else ''})")


class Context:
    """Per-apply execution context: the mode, an explicit
    ``torch.Generator`` for the layers that draw (dropout, nce,
    sampling_id: ``uniform``), the mutable-state collection a layer
    reads (``state_in``) and writes (``state_out``, returned by
    ``Topology.apply(return_state=True)``), a scratch dict (``aux``: a
    recurrent_group's outputs for ``get_output_layer``) and the whole
    top-level params (``params``), which a container layer applies its
    step sub-graph against."""

    def __init__(self, mode="train", generator=None, state=None,
                 params=None):
        self.mode = mode                  # "train" | "test"
        self.generator = generator
        self.state_in = state or {}       # {layer_name: value}
        self.state_out = {}
        self.aux = {}
        self.params = params

    def is_train(self):
        return self.mode == "train"

    def get_state(self, name, default_fn):
        if name in self.state_in:
            return self.state_in[name]
        return default_fn()

    def put_state(self, name, value):
        self.state_out[name] = value

    def uniform(self, shape, device):
        """U[0, 1) of ``shape`` drawn from the context's generator, on
        ``device``: dropout's masks, ``nce_layer``'s negatives and
        ``sampling_id_layer``'s ids."""
        if self.generator is None:
            raise ConfigError("this graph draws (dropout, nce_layer, "
                              "sampling_id_layer); pass generator= to "
                              "Topology.apply")
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device).to(device)


class _ErrorClip(torch.autograd.Function):
    """Identity forward; the backward clips the incoming gradient to
    [-threshold, threshold] elementwise (reference ExtraLayerAttribute
    error_clipping_threshold)."""

    @staticmethod
    def forward(ctx, x, threshold):
        ctx.threshold = threshold
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -ctx.threshold, ctx.threshold), None


def value_data(v):
    return v.data if isinstance(v, (SequenceBatch, NestedSequenceBatch)) \
        else v


def map_rows(fn, *values):
    """A row-wise fn over values that may be (nested) SequenceBatches or
    tensors; if any input is a sequence, the output keeps its lengths
    (both levels of a nested one)."""
    seq = next((v for v in values
                if isinstance(v, (SequenceBatch, NestedSequenceBatch))), None)
    out = fn(*(value_data(v) for v in values))
    if isinstance(seq, NestedSequenceBatch):
        return NestedSequenceBatch(data=out, outer_lengths=seq.outer_lengths,
                                   inner_lengths=seq.inner_lengths)
    if seq is not None:
        return SequenceBatch(data=out, lengths=seq.lengths)
    return out


def as_seq(v) -> SequenceBatch:
    if not isinstance(v, SequenceBatch):
        raise ConfigError(f"expected a sequence input, got tensor "
                          f"{tuple(getattr(v, 'shape', ()))}")
    return v


def dropout(ctx, rate, value):
    """Inverted dropout at ``rate`` in train mode, drawn from the
    context's generator."""
    if not rate or not ctx.is_train():
        return value

    def drop(x):
        keep = ctx.uniform(x.shape, x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), 0.0)
    return map_rows(drop, value)


# ---------------------------------------------------------------- topology

class Topology:
    """Compiled graph over one or more output layers (reference:
    v2/topology.py Topology walking cost layers -> ModelConfig)."""

    def __init__(self, outputs):
        if isinstance(outputs, LayerOutput):
            outputs = [outputs]
        self.outputs = list(outputs)
        self.order = self._topo_sort(self.outputs)
        self.data_layers = {n.name: n for n in self.order
                            if n.layer_type == "data"}

    @staticmethod
    def _topo_sort(outputs):
        seen, order = set(), []

        def visit(node, stack):
            if id(node) in seen:
                return
            if id(node) in stack:
                raise ConfigError(f"cycle through layer {node.name}")
            stack = stack | {id(node)}
            for dep in node.inputs:
                visit(dep, stack)
            seen.add(id(node))
            order.append(node)

        for out in outputs:
            visit(out, frozenset())
        return order

    def init(self, generator, device=None):
        """Initialize all parameters, drawn from ``generator`` (the
        port's own random bits, with the JAX package's rules), then
        placed on ``device`` (the card unless "cpu"): {param_key:
        {param_name: tensor}}.  Layers sharing a key share the entry."""
        dev = _device.resolve(device)
        params = {}
        self._init_into(params, generator)
        return tree_map(lambda t: t.to(dev), params)

    def _init_into(self, params, generator):
        """Each node's params into ``params`` under its sharing key (the
        first node of a key decides), a container's step sub-graph
        before the container itself."""
        for node in self.order:
            sub = node.cfg.get("sub_topo")
            if isinstance(sub, Topology):
                sub._init_into(params, generator)
            p = get_impl(node.layer_type).init(
                generator, node.cfg, [i.size for i in node.inputs])
            if p:
                params.setdefault(self._param_key(node), p)

    def _param_key(self, node):
        """Parameter-sharing key: explicit cfg['param_name'], else a
        ParamAttr name, else the layer name."""
        if "param_name" in node.cfg:
            return node.cfg["param_name"]
        pa = node.cfg.get("param_attr")
        if isinstance(pa, dict) and pa.get("name"):
            return pa["name"]
        return node.name

    def apply(self, params, feed, mode="train", generator=None, state=None,
              return_state=False, extra_outputs=(), precomputed=None):
        """Run the graph.  feed: {data_layer_name: tensor|SequenceBatch}.
        Returns the outputs' values (one, or a tuple), then the values of
        those ``extra_outputs`` the graph computed, and with
        ``return_state`` also the state the layers put.  precomputed:
        {node_name: value}, nodes whose values were computed elsewhere
        (the recurrent_group hoist), taken as they are."""
        ctx = Context(mode=mode, generator=generator, state=state,
                      params=params)
        cache = {}
        # with precomputed values, only the nodes still needed run (the
        # hoisted nodes' own ancestors are dead, as XLA drops them)
        live = self._live(list(self.outputs) + list(extra_outputs),
                          precomputed) if precomputed else None
        for node in self.order:
            if precomputed and node.name in precomputed:
                cache[id(node)] = precomputed[node.name]
                continue
            if live is not None and id(node) not in live:
                continue
            # recurrent_group feeds its step-input, memory and static
            # placeholders by name on every step
            if node.layer_type.startswith("__") and node.name in feed:
                cache[id(node)] = feed[node.name]
                continue
            if node.layer_type == "data":
                if node.name not in feed:
                    raise ConfigError(
                        f"missing feed for data layer {node.name!r}")
                cache[id(node)] = feed[node.name]
                continue
            impl = get_impl(node.layer_type)
            ins = [cache[id(i)] for i in node.inputs]
            p = params.get(self._param_key(node), {})
            try:
                val = impl.apply(ctx, node.cfg, p, *ins)
                # reference ExtraLayerAttribute(drop_rate=...) applies to
                # any layer's output; fc, mixed and dropout apply it inside
                # their impls, everything else here
                if node.layer_type not in ("fc", "mixed", "dropout"):
                    val = dropout(ctx, node.cfg.get("drop_rate", 0.0), val)
                ect = node.cfg.get("error_clipping_threshold")
                if ect:
                    val = map_rows(lambda d: _ErrorClip.apply(d, float(ect)),
                                   val)
                cache[id(node)] = val
            except Exception as e:
                # name the failing layer, as the reference's layer-name
                # stack does on FATAL
                e.add_note(f"while applying layer {node.name!r} "
                           f"(type {node.layer_type!r})")
                raise
        outs = [cache[id(o)] for o in self.outputs]
        outs += [cache[id(o)] for o in extra_outputs if id(o) in cache]
        result = outs[0] if len(outs) == 1 else tuple(outs)
        if return_state:
            return result, ctx.state_out
        return result

    @staticmethod
    def _live(outputs, precomputed):
        """ids of the nodes ``outputs`` need, a precomputed node ending
        its branch."""
        live, stack = set(), list(outputs)
        while stack:
            node = stack.pop()
            if id(node) in live:
                continue
            live.add(id(node))
            if node.name not in precomputed:
                stack.extend(node.inputs)
        return live

    def init_state(self, device=None):
        """Initial mutable state of the layers that keep one: each batch
        norm layer's moving stats, (zeros, ones) of its stat size, as
        JAX's; float32 on ``device`` (the card unless "cpu")."""
        dev = _device.resolve(device)
        state = {}
        for node in self.order:
            if node.layer_type == "batch_norm":
                size = node.cfg["size"]
                state[node.name] = (torch.zeros(size, device=dev),
                                    torch.ones(size, device=dev))
        return state

    def param_shapes(self):
        """{param_key: {param_name: shape}} of ``init``'s result (drawn
        on the CPU from a throwaway generator): each key's first node
        decides, step sub-graphs included, as in ``init``."""
        params = {}
        self._init_into(params, torch.Generator().manual_seed(0))
        return {key: {k: tuple(v.shape) for k, v in p.items()}
                for key, p in params.items()}


def params_from_numpy(topology, tree, device=None):
    """A JAX ``Topology.init`` output as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``) -> the port's
    params for ``topology``, float32 on ``device`` (the card unless
    "cpu").  Keys and shapes must be the topology's own."""
    dev = _device.resolve(device)
    want = topology.param_shapes()
    got = {k: {n: tuple(np.shape(a)) for n, a in v.items()}
           for k, v in tree.items()}
    if got != want:
        raise ValueError(f"parameter tree does not fit the topology: got "
                         f"{got}, want {want}")
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=dev), tree)
