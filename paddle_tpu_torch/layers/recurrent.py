"""Recurrent layers (``paddle_tpu/layers/recurrent.py``): the
whole-sequence ``lstmemory``, ``grumemory`` and ``recurrent_layer``, the
``recurrent_group`` / ``memory`` engine with its step layers, and the
2-D ``mdlstmemory``.

Reference: trainer_config_helpers layers.py lstmemory / grumemory /
recurrent_layer / recurrent_group / memory / lstm_step_layer /
gru_step_layer / get_output_layer / mdlstmemory (LstmLayer,
GatedRecurrentLayer, RecurrentLayer, RecurrentGradientMachine,
MDLstmLayer).

The whole-sequence layers are thin on ``ops/rnn.lstm``, ``.gru`` and
``.simple_rnn``, whose fused routes run the LSTM, GRU and vanilla-RNN
kernels on the card.  A ``recurrent_group``'s step function is traced
once at config time into a sub-graph over placeholders (step inputs,
memories, static inputs); ``ops/rnn.recurrent_group`` runs it once a
time step, as JAX's ``lax.scan`` does, with finished rows' memories
frozen.  The step layers call ``ops/rnn.lstm_cell`` / ``gru_cell``, so a
group runs no kernel of its own, as JAX's runs none.  With
``HOIST_SCAN_INVARIANTS`` the step graph's memory-free row-wise prefix
runs once over the whole padded sequence before the loop (one product
over [B·T, ·] in place of T small ones).  A group over
``SubsequenceInput``s runs ``ops/rnn.nested_recurrent_group``: its step
sees a whole sub-sequence, over which an inner group may run.

``prev_batch_state=True`` on a whole-sequence layer carries its final
state into the next batch through the context's state (the channel of
batch norm's statistics, which ``trainer.SGD`` threads and checkpoints
keep), detached, as JAX's functional state is a constant of the next
step.  A carried LSTM takes the masked scan, as JAX's rule routes an
``init_state``; the first batch, with nothing carried yet, may take
the kernel.  JAX's global ``FLAGS.prev_batch_state`` waits for the
port's ``utils/flags`` (ROADMAP A5).
"""

import math

import torch

from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch
from paddle_tpu_torch.layers import graph as _graph
from paddle_tpu_torch.layers.api import _winit
from paddle_tpu_torch.layers.graph import (
    LayerOutput, Topology, register_layer, auto_name, as_seq, value_data)
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.utils.error import ConfigError

__all__ = [
    "lstmemory", "grumemory", "recurrent_layer", "recurrent_group", "memory",
    "StaticInput", "SubsequenceInput", "lstm_step_layer", "gru_step_layer",
    "gru_step_naive_layer", "get_output_layer", "mdlstmemory",
]


def _check_carry(name, reverse, prev_batch_state):
    """The ctor's check of ``prev_batch_state`` (reference
    --prev_batch_state, "batch is continue with next batch"): a reversed
    layer's final state is its sequence's start, so carrying it is a
    contradiction JAX refuses too."""
    if prev_batch_state and reverse:
        raise ConfigError(
            f"{name}: prev_batch_state cannot carry state for a reverse "
            "RNN (the final state of a reversed scan is the sequence "
            "START)")


def _prev_batch_init(ctx, cfg, bsz):
    """The state the previous batch left (None on the first batch or
    without ``prev_batch_state``)."""
    if not cfg.get("prev_batch_state"):
        return None
    carry = ctx.state_in.get(cfg["name"] + "/carry")
    if carry is not None and carry.shape[0] != bsz:
        raise ConfigError(
            f"{cfg['name']}: prev_batch_state carries a state of batch "
            f"{carry.shape[0]} into a batch of {bsz}; carried batches "
            "must keep their size")
    return carry


def _prev_batch_save(ctx, cfg, final):
    if cfg.get("prev_batch_state"):
        ctx.put_state(cfg["name"] + "/carry", final.detach())


def _zeros(gen, size):
    return torch.zeros((size,), device=gen.device)


class _LstmImpl:
    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        d = cfg["size"]
        if in_sizes[0] != 4 * d:
            raise ConfigError(
                f"lstmemory input must be 4*size={4 * d} wide (a mixed/fc "
                f"projection), got {in_sizes[0]} — reference LstmLayer "
                "semantics")
        p = {"w": _winit(cfg.get("param_attr"), 1.0 / math.sqrt(d))(
            gen, (d, 4 * d))}
        # bias layout (reference LstmLayer): 4*size gate bias + 3*size
        # peepholes
        if cfg.get("bias_attr", True) is not False:
            p["b"] = _zeros(gen, 7 * d)
        return p

    def apply(self, ctx, cfg, params, x):
        d = cfg["size"]
        b = params.get("b")
        x = as_seq(x)
        init = _prev_batch_init(ctx, cfg, x.data.shape[0])
        if init is not None:
            init = rnn_ops.LstmState(h=init[..., :d], c=init[..., d:])
        out, final = rnn_ops.lstm(
            x, params["w"],
            bias=b[:4 * d] if b is not None else None,
            check_i=b[4 * d:5 * d] if b is not None else None,
            check_f=b[5 * d:6 * d] if b is not None else None,
            check_o=b[6 * d:] if b is not None else None,
            reverse=cfg.get("reverse", False), act=cfg.get("act", "tanh"),
            gate_act=cfg.get("gate_act", "sigmoid"),
            state_act=cfg.get("state_act", "tanh"), init_state=init)
        _prev_batch_save(ctx, cfg, torch.cat([final.h, final.c], dim=-1))
        return out


register_layer("lstmemory")(_LstmImpl)


def lstmemory(input, size=None, reverse=False, act="tanh",
              gate_act="sigmoid", state_act="tanh", name=None,
              bias_attr=True, param_attr=None, prev_batch_state=False):
    d = size or input.size // 4
    nm = name or auto_name("lstmemory")
    _check_carry(nm, reverse, prev_batch_state)
    return LayerOutput(nm, "lstmemory", d, [input],
                       {"size": d, "name": nm, "reverse": reverse,
                        "act": act, "gate_act": gate_act,
                        "state_act": state_act, "bias_attr": bias_attr,
                        "param_attr": param_attr,
                        "prev_batch_state": prev_batch_state},
                       is_seq=True)


class _GruImpl:
    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        d = cfg["size"]
        if in_sizes[0] != 3 * d:
            raise ConfigError(
                f"grumemory input must be 3*size={3 * d} wide, got "
                f"{in_sizes[0]}")
        wi = _winit(cfg.get("param_attr"), 1.0 / math.sqrt(d))
        p = {"w_gate": wi(gen, (d, 2 * d)), "w_state": wi(gen, (d, d))}
        if cfg.get("bias_attr", True) is not False:
            p["b"] = _zeros(gen, 3 * d)
        return p

    def apply(self, ctx, cfg, params, x):
        x = as_seq(x)
        out, final = rnn_ops.gru(
            x, params["w_gate"], params["w_state"], bias=params.get("b"),
            init_state=_prev_batch_init(ctx, cfg, x.data.shape[0]),
            reverse=cfg.get("reverse", False), act=cfg.get("act", "tanh"),
            gate_act=cfg.get("gate_act", "sigmoid"))
        _prev_batch_save(ctx, cfg, final)
        return out


register_layer("grumemory")(_GruImpl)


def grumemory(input, size=None, reverse=False, act="tanh",
              gate_act="sigmoid", name=None, bias_attr=True, param_attr=None,
              prev_batch_state=False):
    d = size or input.size // 3
    nm = name or auto_name("grumemory")
    _check_carry(nm, reverse, prev_batch_state)
    return LayerOutput(nm, "grumemory", d, [input],
                       {"size": d, "name": nm, "reverse": reverse,
                        "act": act, "gate_act": gate_act,
                        "bias_attr": bias_attr, "param_attr": param_attr,
                        "prev_batch_state": prev_batch_state}, is_seq=True)


class _SimpleRnnImpl:
    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        d = cfg["size"]
        p = {"w": _winit(cfg.get("param_attr"), 1.0 / math.sqrt(d))(
            gen, (d, d))}
        if cfg.get("bias_attr", True) is not False:
            p["b"] = _zeros(gen, d)
        return p

    def apply(self, ctx, cfg, params, x):
        x = as_seq(x)
        out, final = rnn_ops.simple_rnn(
            x, params["w"], bias=params.get("b"),
            init_state=_prev_batch_init(ctx, cfg, x.data.shape[0]),
            reverse=cfg.get("reverse", False), act=cfg.get("act", "tanh"))
        _prev_batch_save(ctx, cfg, final)
        return out


register_layer("recurrent")(_SimpleRnnImpl)


def recurrent_layer(input, act="tanh", reverse=False, name=None,
                    bias_attr=True, param_attr=None, prev_batch_state=False):
    """Reference RecurrentLayer: h_t = act(x_t + h_{t-1} W)."""
    nm = name or auto_name("recurrent")
    _check_carry(nm, reverse, prev_batch_state)
    return LayerOutput(nm, "recurrent", input.size, [input],
                       {"size": input.size, "name": nm, "act": act,
                        "reverse": reverse, "bias_attr": bias_attr,
                        "param_attr": param_attr,
                        "prev_batch_state": prev_batch_state},
                       is_seq=True)


# ----------------------------------------------------- recurrent_group

class StaticInput:
    """A whole layer visible unchanged at every step (reference
    StaticInput; the encoder context of simple_attention).  is_seq: the
    step sees the whole sequence."""

    def __init__(self, input, is_seq=False):
        self.input = input
        self.is_seq = is_seq


class SubsequenceInput:
    """A two-level sequence input whose sub-sequences a nested
    recurrent_group iterates (reference SubsequenceInput): the outer
    group's step sees each sub-sequence as a whole SequenceBatch and
    may run an inner recurrent_group over it."""

    def __init__(self, input):
        self.input = input


class _GroupBuildCtx:
    current = None

    def __init__(self):
        self.memories = []  # (placeholder, link name, boot, boot const)


def resolve_memory_links(sub_topo, memories, extra_nodes=()):
    """Match memory() links to step-graph layers by name.  extra_nodes:
    nodes built during the step trace that are NOT ancestors of the step
    outputs (a memory may link a consumer of an output)."""
    by_name = {n.name: n for n in extra_nodes}
    by_name.update({n.name: n for n in sub_topo.order})
    links = []
    for ph, link_name, boot, boot_const in memories:
        if link_name not in by_name:
            raise ConfigError(
                f"memory(name={link_name!r}) has no matching layer in the "
                f"step function (have {sorted(by_name)})")
        links.append((ph, by_name[link_name], boot, boot_const))
    return links


class _MemoryPlaceholder(LayerOutput):
    """memory()'s value; ``set_input(layer)`` binds a ``name=None``
    memory late (the reference's memory(name=None) + set_input)."""

    __slots__ = ()

    def set_input(self, layer):
        g = _GroupBuildCtx.current
        if g is None:
            raise ConfigError("set_input() must be called inside the step")
        for i, (ph, _, boot, boot_const) in enumerate(g.memories):
            if ph is self:
                g.memories[i] = (ph, layer.name, boot, boot_const)
                return
        raise ConfigError("set_input on a memory not in this group")


def memory(name, size, boot_layer=None, boot_with_const_id=None,
           is_seq=False):
    """The previous step's output of the step layer called ``name``
    (reference memory(), RecurrentGradientMachine memory frames): zeros
    at the first step, or ``boot_layer``'s value, or a float full of
    ``boot_with_const_id``.  With name=None the link is bound later by
    ``.set_input(layer)``."""
    g = _GroupBuildCtx.current
    if g is None:
        raise ConfigError(
            "memory() must be called inside recurrent_group's step")
    ph = _MemoryPlaceholder(auto_name(f"mem_{name}"), "__memory__", size, [],
                            {"link": name}, is_seq=False)
    g.memories.append((ph, name, boot_layer, boot_with_const_id))
    return ph


def recurrent_group(step, input, reverse=False, name=None):
    """Trace ``step`` once over placeholders into the group's sub-graph
    (see the module doc).

    input: one or a list of sequence LayerOutputs and/or StaticInputs,
    or SubsequenceInputs (a nested group; not mixed with flat sequence
    inputs).  step: fn(*step_inputs) -> a LayerOutput or a tuple of
    them; the group's value is the first, ``get_output_layer`` reads
    the others.  reverse runs over the padded time (or outer) axis from
    its end."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    seq_inputs, sub_inputs, static_inputs, step_args = [], [], [], []
    for item in ins:
        if isinstance(item, StaticInput):
            ph = LayerOutput(auto_name("static_in"), "__static__",
                             item.input.size, [], {}, is_seq=item.is_seq)
            static_inputs.append((ph, item))
        elif isinstance(item, SubsequenceInput):
            # the step sees each sub-sequence as a whole SequenceBatch
            ph = LayerOutput(auto_name("subseq_in"), "__step_input__",
                             item.input.size, [], {}, is_seq=True)
            sub_inputs.append((ph, item))
        else:
            if not item.is_seq:
                raise ConfigError(
                    f"recurrent_group input {item.name} is not a "
                    "sequence; wrap non-sequence inputs in StaticInput (a "
                    "v1 config's promotion of such an input waits for "
                    "ROADMAP A11)")
            ph = LayerOutput(auto_name("step_in"), "__step_input__",
                             item.size, [], {}, is_seq=False)
            seq_inputs.append((ph, item))
        step_args.append(ph)
    if sub_inputs and seq_inputs:
        raise ConfigError("recurrent_group cannot mix SubsequenceInput with "
                          "flat sequence inputs (reference nested groups "
                          "iterate subsequences only)")
    if not seq_inputs and not sub_inputs:
        raise ConfigError("recurrent_group needs at least one sequence "
                          "input to iterate")

    g, prev = _GroupBuildCtx(), _GroupBuildCtx.current
    _GroupBuildCtx.current = g
    created = []
    _graph._NODE_OBSERVERS.append(created.append)
    try:
        outs = step(*step_args)
    finally:
        _GroupBuildCtx.current = prev
        _graph._NODE_OBSERVERS.remove(created.append)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]

    sub_topo = Topology(outs)
    links = resolve_memory_links(sub_topo, g.memories, extra_nodes=created)
    # a link target that is not an ancestor of the outputs must still be
    # computed every step: it joins the sub-graph's outputs
    in_graph = {id(n) for n in sub_topo.order}
    extra_outs = []
    for _, ln, _, _ in links:
        if id(ln) not in in_graph and all(ln is not e for e in extra_outs):
            extra_outs.append(ln)
    if extra_outs:
        sub_topo = Topology(outs + extra_outs)

    group_inputs = ([real for _, real in seq_inputs]
                    + [s.input for _, s in sub_inputs]
                    + [s.input for _, s in static_inputs]
                    + [b for _, _, b, _ in links
                       if isinstance(b, LayerOutput)])
    cfg = {
        "sub_topo": sub_topo,
        "outs": outs,
        "seq_phs": [ph for ph, _ in seq_inputs],
        "sub_phs": [ph for ph, _ in sub_inputs],
        "static_phs": [ph for ph, _ in static_inputs],
        "links": links,
        "reverse": reverse,
        "n_seq": len(seq_inputs),
        "n_sub": len(sub_inputs),
        "n_static": len(static_inputs),
    }
    node = LayerOutput(name or auto_name("recurrent_group"),
                       "recurrent_group", outs[0].size, group_inputs, cfg,
                       is_seq=True)
    node.cfg["self_name"] = node.name
    return node


# The scan hoist: the step-graph nodes that depend only on the per-step
# sequence inputs (no memory, no static input) through row-wise layers
# are computed ONCE over the whole padded sequence before the loop, one
# product over [B·T, ·] in place of T small ones (the reference's
# SequenceToBatch trick for whole-sequence layers, for any step graph).
# Tests toggle it to hold the two equal.
HOIST_SCAN_INVARIANTS = True

# layer types whose apply maps rows independently, so [B, T, ...] data
# gives what [B, ...] rows give; anything sequence-aware stays in the loop
_ROW_WISE_TYPES = {"fc", "embedding", "mixed", "addto", "concat",
                   "slope_intercept"}
_ROW_WISE_MIXED_PARTS = {"full_matrix", "trans_full_matrix", "identity",
                         "dotmul", "scaling", "table"}


def _hoistable_frontier(sub_topo, seq_phs, mode):
    """The maximal step-graph nodes computable before the loop: every
    ancestor path ends in a per-step sequence placeholder and every node
    on it is row-wise (and, in train mode, dropout-free, so masks stay
    per step).  Only the frontier: the hoistable nodes a live node (or
    an output) consumes."""
    seq_ph_ids = {id(ph) for ph in seq_phs}
    ok = {}
    for node in sub_topo.order:
        if id(node) in seq_ph_ids:
            ok[id(node)] = True
            continue
        if node.layer_type.startswith("__") or node.layer_type == "data":
            ok[id(node)] = False
            continue
        if not node.inputs or not all(ok.get(id(i), False)
                                      for i in node.inputs):
            ok[id(node)] = False
            continue
        row_wise = node.layer_type in _ROW_WISE_TYPES
        if node.layer_type == "mixed":
            row_wise = all(kind in _ROW_WISE_MIXED_PARTS
                           for kind, _ in node.cfg["parts"])
        if mode == "train" and (node.cfg.get("drop_rate")
                                or node.layer_type == "dropout"):
            row_wise = False
        ok[id(node)] = row_wise
    consumed_by_live = {id(out) for out in sub_topo.outputs}
    for node in sub_topo.order:
        if not ok.get(id(node), False):
            consumed_by_live.update(id(i) for i in node.inputs)
    return [n for n in sub_topo.order
            if ok.get(id(n), False) and id(n) in consumed_by_live
            and id(n) not in seq_ph_ids]


def _is_plain_tuple(v):
    # SequenceBatch and NestedSequenceBatch are NamedTuples: one
    # sequence-valued value must not be unpacked field by field
    return isinstance(v, tuple) and not isinstance(
        v, (SequenceBatch, NestedSequenceBatch))


class _RecurrentGroupImpl:
    def infer(self, cfg, in_sizes):
        return cfg["outs"][0].size

    def init(self, gen, cfg, in_sizes):
        # the step layers' params live at top level (Topology._init_into)
        return {}

    def apply(self, ctx, cfg, params, *inputs):
        sub_topo = cfg["sub_topo"]
        n_static, n_sub = cfg["n_static"], cfg.get("n_sub", 0)
        nested = n_sub > 0
        n_lead = n_sub if nested else cfg["n_seq"]
        if nested:
            for v in inputs[:n_sub]:
                if not isinstance(v, NestedSequenceBatch):
                    raise ConfigError(
                        "SubsequenceInput needs a NestedSequenceBatch feed "
                        f"(got {type(v).__name__})")
            seqs = list(inputs[:n_sub])
        else:
            seqs = [as_seq(v) for v in inputs[:n_lead]]
        statics = list(inputs[n_lead:n_lead + n_static])
        boots = iter(inputs[n_lead + n_static:])
        sub_params = ctx.params
        ref = seqs[0]
        bsz, dev = ref.data.shape[0], ref.data.device

        boot_vals = []
        for ph, _, boot, boot_const in cfg["links"]:
            if isinstance(boot, LayerOutput):
                boot_vals.append(value_data(next(boots)))
            elif boot_const is not None:
                boot_vals.append(torch.full((bsz, ph.size), float(boot_const),
                                            device=dev))
            else:
                boot_vals.append(torch.zeros((bsz, ph.size), device=dev))

        mode = ctx.mode
        link_nodes = [ln for _, ln, _, _ in cfg["links"]]
        n_out, n_links = len(cfg["outs"]), len(cfg["links"])
        seq_phs = cfg["sub_phs"] if nested else cfg["seq_phs"]

        # the hoist (flat groups): the memory-free row-wise prefix over
        # the whole padded sequence, its values scanned beside the step
        # inputs; no generator, the frontier is dropout-free by
        # construction
        hoisted = []
        if not nested and HOIST_SCAN_INVARIANTS:
            frontier = _hoistable_frontier(sub_topo, seq_phs, mode)
            if frontier:
                pre = Topology(frontier).apply(
                    sub_params, {ph.name: s for ph, s in zip(seq_phs, seqs)},
                    mode=mode)
                pre = pre if _is_plain_tuple(pre) else (pre,)
                hoisted = [n.name for n in frontier]
                seqs = seqs + [as_seq(v) for v in pre]

        def step_fn(mems, frames, step_gen=None):
            feed = {ph.name: f for ph, f in zip(seq_phs, frames)}
            feed.update((ph.name, s)
                        for ph, s in zip(cfg["static_phs"], statics))
            feed.update((ph.name, m) for (ph, _, _, _), m in
                        zip(cfg["links"], mems))
            pre = dict(zip(hoisted, frames[len(seq_phs):]))
            # the link values come back as extra outputs of the same apply
            vals = sub_topo.apply(sub_params, feed, mode=mode,
                                  generator=step_gen,
                                  extra_outputs=link_nodes, precomputed=pre)
            vals = vals if _is_plain_tuple(vals) else (vals,)
            # layout: [step outputs | consumer-link outputs | link
            # values]: the memories are always the last n_links entries
            new_mems = tuple(value_data(v)
                             for v in vals[len(vals) - n_links:]) \
                if n_links else ()
            # a nested group keeps sequence-valued step outputs whole,
            # for the engine to stack into a NestedSequenceBatch
            return new_mems, tuple(
                v if nested and isinstance(v, SequenceBatch)
                else value_data(v) for v in vals[:n_out])

        engine = (rnn_ops.nested_recurrent_group if nested
                  else rnn_ops.recurrent_group)
        outs, _ = engine(
            step_fn, tuple(seqs), tuple(boot_vals), reverse=cfg["reverse"],
            generator=ctx.generator if _draws(sub_topo, mode) else None)
        result = outs[0] if len(outs) == 1 else outs
        ctx.aux[cfg["self_name"] + "/outputs"] = result
        return result[0] if _is_plain_tuple(result) else result


def _draws(sub_topo, mode):
    """Whether a step of ``sub_topo`` draws random bits in ``mode``
    (dropout in train mode; nce and sampling_id always; an inner group's
    step counts): only then does the engine split the context's
    generator into per-step streams."""
    return any(n.layer_type in ("nce", "sampling_id")
               or (mode == "train" and (n.cfg.get("drop_rate")
                                        or n.layer_type == "dropout"))
               or (isinstance(n.cfg.get("sub_topo"), Topology)
                   and _draws(n.cfg["sub_topo"], mode))
               for n in sub_topo.order)


register_layer("recurrent_group")(_RecurrentGroupImpl)


class _PlaceholderImpl:
    def infer(self, cfg, in_sizes):
        return 0

    def apply(self, ctx, cfg, params, *ins):
        raise RuntimeError("step placeholders are fed by the group engine")


register_layer("__memory__")(_PlaceholderImpl)
register_layer("__step_input__")(_PlaceholderImpl)
register_layer("__static__")(_PlaceholderImpl)


def get_output_layer(input, arg_name=None, name=None, index=1):
    """A secondary output of a recurrent_group (reference
    GetOutputLayer): ``index`` picks among the step's outputs."""
    return LayerOutput(name or auto_name("get_output"), "get_output",
                       input.cfg["outs"][index].size, [input],
                       {"index": index, "group": input.cfg["self_name"]},
                       is_seq=True)


class _GetOutputImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def apply(self, ctx, cfg, params, group_out):
        outs = ctx.aux.get(cfg["group"] + "/outputs")
        if not _is_plain_tuple(outs):
            raise ConfigError("get_output_layer: group has a single output")
        return outs[cfg["index"]]


register_layer("get_output")(_GetOutputImpl)


# ----------------------------------------------------- step layers

class _LstmStepImpl:
    """One LSTM step as a layer (reference LstmStepLayer): inputs the
    gate input [B, 4D], the recurrent product already in it, and the
    previous state [B, 2D] = [h | c]; the output is the new [h | c]
    (the node is 2D wide; JAX's ``infer`` says D, which its graph never
    calls)."""

    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        if cfg.get("bias_attr", True) is False:
            return {}
        return {"b": _zeros(gen, 7 * cfg["size"])}

    def apply(self, ctx, cfg, params, x4, prev_state):
        d = cfg["size"]
        b = params.get("b")
        x4d, prev = value_data(x4), value_data(prev_state)
        if b is not None:
            x4d = x4d + b[:4 * d]
        st = rnn_ops.lstm_cell(
            x4d, rnn_ops.LstmState(h=prev[..., :d], c=prev[..., d:]), None,
            check_i=b[4 * d:5 * d] if b is not None else None,
            check_f=b[5 * d:6 * d] if b is not None else None,
            check_o=b[6 * d:] if b is not None else None,
            act=cfg.get("act", "tanh"), gate_act=cfg.get("gate_act",
                                                         "sigmoid"),
            state_act=cfg.get("state_act", "tanh"))
        return torch.cat([st.h, st.c], dim=-1)


register_layer("lstm_step")(_LstmStepImpl)


def lstm_step_layer(input, state, size=None, act="tanh", gate_act="sigmoid",
                    state_act="tanh", name=None, bias_attr=True):
    d = size or input.size // 4
    return LayerOutput(name or auto_name("lstm_step"), "lstm_step", 2 * d,
                       [input, state],
                       {"size": d, "act": act, "gate_act": gate_act,
                        "state_act": state_act, "bias_attr": bias_attr})


class _GruStepImpl:
    """One GRU step as a layer (reference GruStepLayer): the gate input
    [B, 3D] and the previous output [B, D]; w_gate [D, 2D], w_state
    [D, D], b [3D]."""

    def infer(self, cfg, in_sizes):
        return cfg["size"]

    def init(self, gen, cfg, in_sizes):
        d = cfg["size"]
        wi = _winit(cfg.get("param_attr"), 1.0 / math.sqrt(d))
        p = {"w_gate": wi(gen, (d, 2 * d)), "w_state": wi(gen, (d, d))}
        if cfg.get("bias_attr", True) is not False:
            p["b"] = _zeros(gen, 3 * d)
        return p

    def apply(self, ctx, cfg, params, x3, prev):
        x3d = value_data(x3)
        if "b" in params:
            x3d = x3d + params["b"]
        return rnn_ops.gru_cell(x3d, value_data(prev), params["w_gate"],
                                params["w_state"], act=cfg.get("act", "tanh"),
                                gate_act=cfg.get("gate_act", "sigmoid"))


register_layer("gru_step")(_GruStepImpl)


def gru_step_layer(input, output_mem, size=None, act="tanh",
                   gate_act="sigmoid", name=None, bias_attr=True,
                   param_attr=None):
    d = size or input.size // 3
    return LayerOutput(name or auto_name("gru_step"), "gru_step", d,
                       [input, output_mem],
                       {"size": d, "act": act, "gate_act": gate_act,
                        "bias_attr": bias_attr, "param_attr": param_attr})


def gru_step_naive_layer(input, output_mem, size=None, act="tanh",
                         gate_act="sigmoid", name=None, bias_attr=True,
                         param_attr=None, layer_attr=None):
    """Reference gru_step_naive_layer: the GRU step built from mixed
    layers so that error clipping and dropout attributes apply; the same
    computation as ``gru_step_layer``, as in JAX."""
    return gru_step_layer(input, output_mem, size=size, act=act,
                          gate_act=gate_act, name=name, bias_attr=bias_attr,
                          param_attr=param_attr)


# ----------------------------------------------------- mdlstmemory

class _MDLstmImpl:
    """The 2-D multi-dimensional LSTM over an image-shaped input
    (reference MDLstmLayer): ``ops/rnn.md_lstm_2d``."""

    def infer(self, cfg, in_sizes):
        return cfg["size"] * cfg["h"] * cfg["w"]

    def init(self, gen, cfg, in_sizes):
        d = cfg["size"]
        wi = _winit(cfg.get("param_attr"), 1.0 / math.sqrt(d))
        p = {"w_row": wi(gen, (d, 5 * d)), "w_col": wi(gen, (d, 5 * d))}
        if cfg.get("bias_attr", True) is not False:
            # 5d gate bias + 5d peepholes (i_row, i_col, f_row, f_col, o)
            p["b"] = _zeros(gen, 10 * d)
        return p

    def apply(self, ctx, cfg, params, x):
        d, h, w = cfg["size"], cfg["h"], cfg["w"]
        xd = value_data(x).reshape(-1, h, w, 5 * d)
        b = params.get("b")
        checks = [None] * 5
        if b is not None:
            xd = xd + b[:5 * d]
            checks = [b[(5 + k) * d:(6 + k) * d] for k in range(5)]
        out = rnn_ops.md_lstm_2d(
            xd, params["w_row"], params["w_col"],
            check_i_row=checks[0], check_i_col=checks[1],
            check_f_row=checks[2], check_f_col=checks[3], check_o=checks[4],
            act=cfg.get("act", "tanh"), gate_act=cfg.get("gate_act",
                                                         "sigmoid"),
            state_act=cfg.get("state_act", "tanh"))
        return out.reshape(out.shape[0], -1)


register_layer("mdlstmemory")(_MDLstmImpl)


def mdlstmemory(input, size=None, height=None, width=None, act="tanh",
                gate_act="sigmoid", state_act="tanh", name=None,
                bias_attr=True, param_attr=None):
    """input: an image-shaped layer of 5*size channels (the gates,
    projected); height / width default to the input's img_shape."""
    if height is None or width is None:
        if input.img_shape is None:
            raise ConfigError("mdlstmemory needs height/width (or an input "
                              "with img_shape)")
        height, width = input.img_shape
    d = size or input.size // (5 * height * width)
    return LayerOutput(name or auto_name("mdlstm"), "mdlstmemory",
                       d * height * width, [input],
                       {"size": d, "h": height, "w": width, "act": act,
                        "gate_act": gate_act, "state_act": state_act,
                        "bias_attr": bias_attr, "param_attr": param_attr},
                       is_seq=False, num_filters=d, img_shape=(height, width))
