"""Whole-sequence recurrent layers (``paddle_tpu/layers/recurrent.py``):
``lstmemory``, ``grumemory`` and ``recurrent_layer``, thin on
``ops/rnn.lstm``, ``.gru`` and ``.simple_rnn`` — whose fused routes run
the LSTM, GRU and vanilla-RNN kernels on the card.

Reference: trainer_config_helpers layers.py lstmemory / grumemory /
recurrent_layer (LstmLayer, GatedRecurrentLayer, RecurrentLayer).
``recurrent_group``, ``memory`` and the step layers wait for ROADMAP
A10·b; the ``prev_batch_state`` carry (the final state fed to the next
batch) raises naming it.
"""

import math

import torch

from paddle_tpu_torch.layers.api import _winit
from paddle_tpu_torch.layers.graph import (
    LayerOutput, register_layer, auto_name, as_seq)
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["lstmemory", "grumemory", "recurrent_layer"]


def _no_carry(prev_batch_state):
    if prev_batch_state:
        raise ConfigError("prev_batch_state=True (the final state carried "
                          "into the next batch) is not ported yet (ROADMAP "
                          "A10·b)")


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
        out, _ = rnn_ops.lstm(
            as_seq(x), params["w"],
            bias=b[:4 * d] if b is not None else None,
            check_i=b[4 * d:5 * d] if b is not None else None,
            check_f=b[5 * d:6 * d] if b is not None else None,
            check_o=b[6 * d:] if b is not None else None,
            reverse=cfg.get("reverse", False), act=cfg.get("act", "tanh"),
            gate_act=cfg.get("gate_act", "sigmoid"),
            state_act=cfg.get("state_act", "tanh"))
        return out


register_layer("lstmemory")(_LstmImpl)


def lstmemory(input, size=None, reverse=False, act="tanh",
              gate_act="sigmoid", state_act="tanh", name=None,
              bias_attr=True, param_attr=None, prev_batch_state=False):
    _no_carry(prev_batch_state)
    d = size or input.size // 4
    nm = name or auto_name("lstmemory")
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
        out, _ = rnn_ops.gru(as_seq(x), params["w_gate"], params["w_state"],
                             bias=params.get("b"),
                             reverse=cfg.get("reverse", False),
                             act=cfg.get("act", "tanh"),
                             gate_act=cfg.get("gate_act", "sigmoid"))
        return out


register_layer("grumemory")(_GruImpl)


def grumemory(input, size=None, reverse=False, act="tanh",
              gate_act="sigmoid", name=None, bias_attr=True, param_attr=None,
              prev_batch_state=False):
    _no_carry(prev_batch_state)
    d = size or input.size // 3
    nm = name or auto_name("grumemory")
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
        out, _ = rnn_ops.simple_rnn(as_seq(x), params["w"],
                                    bias=params.get("b"),
                                    reverse=cfg.get("reverse", False),
                                    act=cfg.get("act", "tanh"))
        return out


register_layer("recurrent")(_SimpleRnnImpl)


def recurrent_layer(input, act="tanh", reverse=False, name=None,
                    bias_attr=True, param_attr=None, prev_batch_state=False):
    """Reference RecurrentLayer: h_t = act(x_t + h_{t-1} W)."""
    _no_carry(prev_batch_state)
    nm = name or auto_name("recurrent")
    return LayerOutput(nm, "recurrent", input.size, [input],
                       {"size": input.size, "name": nm, "act": act,
                        "reverse": reverse, "bias_attr": bias_attr,
                        "param_attr": param_attr,
                        "prev_batch_state": prev_batch_state},
                       is_seq=True)
