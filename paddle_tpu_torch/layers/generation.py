"""Sequence generation over a DSL step (``paddle_tpu/layers/
generation.py``): ``GeneratedInput`` and the ``beam_search`` /
``greedy_generation`` layers.

Reference: the v1 DSL's beam_search / GeneratedInput
(trainer_config_helpers layers.py BaseGeneratedInput, GeneratedInput,
beam_search), run there by RecurrentGradientMachine::generateSequence /
beamSearch in generation mode.

The step function is traced once into a sub-graph, as ``recurrent_group``
traces it, and driven by ``ops/beam.beam_search``: static lanes, each
batch row's K lanes lane-major ([B·K, ...]), the state reindexed by the
surviving lanes every step.  The step layers' parameters live at top
level under their own sharing keys and the generated word's table under
the ``GeneratedInput``'s ``embedding_name``, so a decoder trained as a
``recurrent_group`` with the same step decodes with its trained weights.
"""

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers import recurrent as rec
from paddle_tpu_torch.layers.api import _winit
from paddle_tpu_torch.layers.graph import (
    LayerOutput, Topology, auto_name, register_layer, value_data)
from paddle_tpu_torch.layers.recurrent import SubsequenceInput  # noqa: F401
from paddle_tpu_torch.ops import beam as beam_ops
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["BaseGeneratedInput", "GeneratedInput", "SubsequenceInput",
           "beam_search", "greedy_generation"]


class BaseGeneratedInput:
    pass


class GeneratedInput(BaseGeneratedInput):
    """The previously generated token, embedded (reference
    GeneratedInput): ``size`` the vocabulary, ``embedding_name`` and
    ``embedding_size`` the lookup table, shared by name with the
    training graph's target embedding."""

    def __init__(self, size, embedding_name, embedding_size,
                 bos_id=0, eos_id=1):
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size
        self.bos_id = bos_id
        self.eos_id = eos_id


class _SharedTableImpl:
    """A parameter-only node: the generated word's table, keyed by the
    GeneratedInput's ``embedding_name`` (cfg ``param_name``), so the
    training graph's ``embedding_layer(param_attr={"name":
    embedding_name})`` and the decoder share it."""

    def infer(self, cfg, in_sizes):
        return cfg["emb_size"]

    def init(self, gen, cfg, in_sizes):
        return {"w": _winit(cfg.get("param_attr"),
                            1.0 / cfg["vocab"] ** 0.5)(
            gen, (cfg["vocab"], cfg["emb_size"]))}

    def apply(self, ctx, cfg, params):
        return params["w"]


register_layer("shared_table")(_SharedTableImpl)


def _lanes(v, k):
    """Each batch row repeated k times, lane-major (JAX's ``jnp.repeat``
    on axis 0): a SequenceBatch's data and lengths alike."""
    if isinstance(v, SequenceBatch):
        return SequenceBatch(data=v.data.repeat_interleave(k, 0),
                             lengths=v.lengths.repeat_interleave(k, 0))
    return v.repeat_interleave(k, 0)


class _BeamSearchImpl:
    def infer(self, cfg, in_sizes):
        return 1   # the value's rows are generated token ids

    def init(self, gen, cfg, in_sizes):
        # the step layers' params live at top level (Topology._init_into)
        return {}

    def apply(self, ctx, cfg, params, emb_w, *inputs):
        gen = cfg["gen"]
        sub_topo = cfg["sub_topo"]
        statics = list(inputs[:cfg["n_static"]])
        boots = iter(inputs[cfg["n_static"]:])
        if statics:
            ref = value_data(statics[0])
        elif cfg["n_static"] < len(inputs):
            ref = value_data(inputs[cfg["n_static"]])
        else:
            raise ConfigError("beam_search needs at least one StaticInput or "
                              "boot memory to derive the batch size")
        bsz, dev = ref.shape[0], ref.device
        k = cfg["beam_size"]
        statics = [_lanes(s, k) for s in statics]
        boot_vals = []
        for ph, _, boot, boot_const in cfg["links"]:
            if isinstance(boot, LayerOutput):
                boot_vals.append(_lanes(value_data(next(boots)), k))
            elif boot_const is not None:
                boot_vals.append(torch.full((bsz * k, ph.size),
                                            float(boot_const), device=dev))
            else:
                boot_vals.append(torch.zeros((bsz * k, ph.size), device=dev))

        link_nodes = [ln for _, ln, _, _ in cfg["links"]]
        n_out = len(cfg["outs"])

        def step_fn(mems, prev_ids):
            feed = {cfg["gen_ph"].name: emb_ops.embedding_lookup(emb_w,
                                                                  prev_ids)}
            feed.update((ph.name, s)
                        for ph, s in zip(cfg["static_phs"], statics))
            feed.update((ph.name, m) for (ph, _, _, _), m in
                        zip(cfg["links"], mems))
            # the link values come back as extra outputs of the same apply
            vals = sub_topo.apply(ctx.params, feed, mode=ctx.mode,
                                  generator=ctx.generator,
                                  extra_outputs=link_nodes)
            vals = vals if rec._is_plain_tuple(vals) else (vals,)
            probs = value_data(vals[0])
            return (torch.log(torch.clamp(probs, min=1e-20)),
                    tuple(value_data(v) for v in vals[n_out:]))

        result = beam_ops.beam_search(
            step_fn, tuple(boot_vals), batch_size=bsz, beam_size=k,
            max_len=cfg["max_length"], bos_id=gen.bos_id, eos_id=gen.eos_id,
            length_penalty=cfg.get("length_penalty", 0.0),
            candidate_adjust=cfg.get("candidate_adjust"),
            drop_callback=cfg.get("drop_callback"))
        ctx.aux[cfg["self_name"] + "/result"] = result
        return result


register_layer("beam_search_gen")(_BeamSearchImpl)


def _trace_step(step, input, bos_id, eos_id):
    """The step-graph tracing beam_search and greedy_generation share."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    gen = gen_ph = None
    static_inputs, step_args = [], []
    for item in ins:
        if isinstance(item, BaseGeneratedInput):
            if gen is not None:
                raise ConfigError("beam_search takes exactly one "
                                  "GeneratedInput")
            gen = item
            gen_ph = LayerOutput(auto_name("gen_word"), "__step_input__",
                                 item.embedding_size, [], {}, is_seq=False)
            step_args.append(gen_ph)
            continue
        if not isinstance(item, rec.StaticInput):   # a bare layer: static
            item = rec.StaticInput(item, item.is_seq)
        ph = LayerOutput(auto_name("static_in"), "__static__",
                         item.input.size, [], {}, is_seq=item.is_seq)
        static_inputs.append((ph, item))
        step_args.append(ph)
    if gen is None:
        raise ConfigError("beam_search needs a GeneratedInput")
    # explicit bos_id= / eos_id= win; None keeps the GeneratedInput's own
    if bos_id is not None:
        gen.bos_id = bos_id
    if eos_id is not None:
        gen.eos_id = eos_id

    g, prev = rec._GroupBuildCtx(), rec._GroupBuildCtx.current
    rec._GroupBuildCtx.current = g
    try:
        outs = step(*step_args)
    finally:
        rec._GroupBuildCtx.current = prev
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]

    sub_topo = Topology(outs)
    links = rec.resolve_memory_links(sub_topo, g.memories)
    # the first input: the shared table, its param keyed by embedding_name
    table = LayerOutput(auto_name(f"table_{gen.embedding_name}"),
                        "shared_table", gen.embedding_size, [],
                        {"vocab": gen.size, "emb_size": gen.embedding_size,
                         "param_name": gen.embedding_name})
    group_inputs = ([table] + [s.input for _, s in static_inputs]
                    + [b for _, _, b, _ in links
                       if isinstance(b, LayerOutput)])
    return {
        "gen": gen, "gen_ph": gen_ph, "sub_topo": sub_topo, "outs": outs,
        "static_phs": [ph for ph, _ in static_inputs],
        "links": links, "n_static": len(static_inputs),
    }, group_inputs


def beam_search(step, input, bos_id=None, eos_id=None, beam_size=5,
                max_length=100, length_penalty=0.0, name=None,
                candidate_adjust=None, drop_callback=None):
    """DSL beam search (reference layers.py beam_search).

    step(generated_word_embedding, *statics) -> a softmax LayerOutput
    over the vocabulary; the decoder's state is carried by ``memory``
    links, as in recurrent_group.  The layer's value is a
    ``ops/beam.BeamResult`` (tokens [B, K, T] best first, scores,
    lengths); its size is 1.  bos / eos default to the GeneratedInput's.
    ``candidate_adjust(log_probs)`` and ``drop_callback(tokens, t,
    cand)`` are the reference's per-step hooks, passed to
    ``ops/beam.beam_search``."""
    cfg, group_inputs = _trace_step(step, input, bos_id, eos_id)
    cfg.update({"beam_size": beam_size, "max_length": max_length,
                "length_penalty": length_penalty,
                "candidate_adjust": candidate_adjust,
                "drop_callback": drop_callback})
    node = LayerOutput(name or auto_name("beam_search"), "beam_search_gen",
                       1, group_inputs, cfg, is_seq=True)
    node.cfg["self_name"] = node.name
    return node


class _GreedyGenImpl(_BeamSearchImpl):
    def apply(self, ctx, cfg, params, emb_w, *inputs):
        res = super().apply(ctx, {**cfg, "beam_size": 1}, params, emb_w,
                            *inputs)
        return SequenceBatch(data=res.tokens[:, 0, :],
                             lengths=res.lengths[:, 0])


register_layer("greedy_gen")(_GreedyGenImpl)


def greedy_generation(step, input, bos_id=None, eos_id=None, max_length=100,
                      name=None):
    """Reference oneWaySearch (greedy) as a layer: its value is a
    SequenceBatch of generated token ids (size 1); bos / eos default to
    the GeneratedInput's."""
    cfg, group_inputs = _trace_step(step, input, bos_id, eos_id)
    cfg.update({"max_length": max_length})
    node = LayerOutput(name or auto_name("greedy_gen"), "greedy_gen",
                       1, group_inputs, cfg, is_seq=True)
    node.cfg["self_name"] = node.name
    return node
