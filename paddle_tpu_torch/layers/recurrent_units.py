"""Pre-built recurrent step units for custom recurrent groups
(``paddle_tpu/layers/recurrent_units.py``; reference
python/paddle/trainer/recurrent_units.py).

``lstm_recurrent_unit`` / ``gated_recurrent_unit`` assemble an LSTM / GRU
step out of mixed projections and step layers, for use inside a
recurrent_group (parameters shared by ``para_prefix``, JAX's names);
the ``*_layer_group`` wrappers build the whole group, equivalent to
``lstmemory`` / ``grumemory`` (the reference's own claim).  The input
transform is one mixed projection outside the group, one product over
every time step; only the recurrent projection and the cell run per
step.
"""

from paddle_tpu_torch.layers.api import (full_matrix_projection,
                                         identity_projection, mixed_layer)
from paddle_tpu_torch.layers.recurrent import (gru_step_layer,
                                               lstm_step_layer, memory,
                                               recurrent_group)

__all__ = [
    "lstm_recurrent_unit", "lstm_recurrent_layer_group",
    "gated_recurrent_unit", "gated_recurrent_layer_group",
]


def _as_parts(inputs, prefix, what):
    """LayerOutputs become full-matrix projections with prefix-shared
    parameter names; projections pass through."""
    parts = []
    for i, item in enumerate(inputs if isinstance(inputs, (list, tuple))
                             else [inputs]):
        if hasattr(item, "kind"):          # already a projection (_Part)
            parts.append(item)
        else:
            parts.append(full_matrix_projection(
                item, param_attr={"name": f"{prefix}_{what}{i}.w"}))
    return parts


def lstm_recurrent_unit(name, size, input, act="tanh", gate_act="sigmoid",
                        state_act="tanh", para_prefix=None, bias_attr=True):
    """One LSTM step assembled from DSL pieces (reference LstmRecurrentUnit):
    mixed(inputs + W_r @ h_prev) -> lstm_step_layer carrying [h | c].
    Call inside a recurrent_group step; returns the step's h [B, size].

    Parameter layout matches lstmemory: the step bias is [4*size gate bias |
    3*size peepholes], the recurrent projection is [size, 4*size]."""
    prefix = para_prefix or name
    hc = memory(name=name + "_hc", size=2 * size)
    h_prev = mixed_layer(size=size,
                         input=[identity_projection(hc, offset=0, size=size)],
                         act=None, bias_attr=False,
                         name=name + "_prev_h")
    x4 = mixed_layer(
        size=4 * size,
        input=_as_parts(input, prefix, "input_recurrent") + [
            full_matrix_projection(
                h_prev,
                param_attr={"name": prefix + "_input_recurrent.w"})],
        act=None, bias_attr=False, name=name + "_input_recurrent")
    hc_next = lstm_step_layer(x4, hc, size=size, act=act, gate_act=gate_act,
                              state_act=state_act, bias_attr=bias_attr,
                              name=name + "_hc")
    return mixed_layer(size=size,
                       input=[identity_projection(hc_next, offset=0,
                                                  size=size)],
                       act=None, bias_attr=False, name=name)


def gated_recurrent_unit(name, size, input, act="tanh", gate_act="sigmoid",
                         para_prefix=None, bias_attr=True, out_memory=None):
    """One GRU step (reference GatedRecurrentUnit): gru_step_layer over the
    3*size transformed input and the output memory."""
    prefix = para_prefix or name
    mem = out_memory if out_memory is not None \
        else memory(name=name, size=size)
    parts = _as_parts(input, prefix, "transform_input")
    if len(parts) == 1 and getattr(parts[0], "kind", "") == "identity" \
            and parts[0].out_size == 3 * size:
        x3 = parts[0].inputs[0]
    else:
        x3 = mixed_layer(size=3 * size, input=parts, act=None,
                         bias_attr=False, name=name + "_transform_input")
    return gru_step_layer(x3, mem, size=size, act=act, gate_act=gate_act,
                          bias_attr=bias_attr,
                          param_attr={"name": prefix + "_gate.w"}, name=name)


def lstm_recurrent_layer_group(name, size, input, act="tanh",
                               gate_act="sigmoid", state_act="tanh",
                               para_prefix=None, seq_reversed=False,
                               bias_attr=True):
    """Whole-sequence LSTM built as a layer group (reference
    LstmRecurrentLayerGroup — equivalent to lstmemory).  The input transform
    runs once over the whole sequence outside the scan."""
    prefix = para_prefix or name
    proj = mixed_layer(
        size=4 * size, input=_as_parts(input, prefix, "transform_input"),
        act=None, bias_attr=False, name=name + "_transform_input")

    def step(x):
        return lstm_recurrent_unit(
            name=name, size=size, input=[identity_projection(x)],
            act=act, gate_act=gate_act, state_act=state_act,
            para_prefix=prefix, bias_attr=bias_attr)

    return recurrent_group(step, proj, reverse=seq_reversed,
                           name=name + "_group")


def gated_recurrent_layer_group(name, size, input, act="tanh",
                                gate_act="sigmoid", para_prefix=None,
                                seq_reversed=False, bias_attr=True):
    """Whole-sequence GRU layer group (reference GatedRecurrentLayerGroup —
    equivalent to grumemory)."""
    prefix = para_prefix or name
    proj = mixed_layer(
        size=3 * size, input=_as_parts(input, prefix, "transform_input"),
        act=None, bias_attr=False, name=name + "_transform_input")

    def step(x):
        return gated_recurrent_unit(
            name=name, size=size, input=[identity_projection(x)],
            act=act, gate_act=gate_act, para_prefix=prefix,
            bias_attr=bias_attr)

    return recurrent_group(step, proj, reverse=seq_reversed,
                           name=name + "_group")
