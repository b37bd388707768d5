"""Composite networks (``paddle_tpu/layers/networks.py``; reference
trainer_config_helpers/networks.py): the image blocks
(``simple_img_conv_pool``, ``img_conv_group``, ``img_conv_bn_pool``,
``vgg_16_network``, ``small_vgg``), the whole-sequence recurrent
composites (``simple_lstm``, ``simple_gru``, ``simple_gru2``,
``bidirectional_lstm``, ``bidirectional_gru``), the step composites
(``gru_unit``, ``gru_group``, ``lstmemory_unit``, ``lstmemory_group``),
Bahdanau ``simple_attention`` with its ``attention_context_layer``, and
``inputs`` / ``outputs``, under the JAX names and ``__all__``.

``text_conv_pool`` = ``sequence_conv_pool`` builds the reference's
context window, fc and pool (ROADMAP C14).  The step composites on
``recurrent_group`` (``gru_unit`` / ``gru_group`` over ``gru_step_layer``,
``lstmemory_unit`` / ``lstmemory_group`` over a mixed layer and
``lstm_step_layer``) compute what ``grumemory`` / ``lstmemory`` compute,
one time step at a time, on the same weights.
"""

from paddle_tpu_torch.layers import api, recurrent
from paddle_tpu_torch.layers.api import (
    _winit, concat_layer, dropout_layer, fc_layer)
from paddle_tpu_torch.layers.graph import (
    LayerOutput, as_seq, auto_name, register_layer, value_data)
from paddle_tpu_torch.layers.recurrent import grumemory, lstmemory
from paddle_tpu_torch.layers.vision import (
    batch_norm_layer, img_conv_layer, img_pool_layer)
from paddle_tpu_torch.ops import attention as attn_ops

__all__ = [
    "simple_img_conv_pool", "img_conv_group", "img_conv_bn_pool",
    "vgg_16_network", "small_vgg",
    "simple_lstm", "simple_gru", "simple_gru2", "gru_unit", "gru_group",
    "lstmemory_unit", "lstmemory_group",
    "bidirectional_lstm", "bidirectional_gru", "simple_attention",
    "text_conv_pool", "sequence_conv_pool", "inputs", "outputs",
]


# ---------------------------------------------------------------- images

def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         num_channels=None, pool_stride=1, act="relu",
                         conv_padding=0, pool_type="max", name=None):
    conv = img_conv_layer(input, filter_size=filter_size,
                          num_filters=num_filters, num_channels=num_channels,
                          padding=conv_padding, act=act,
                          name=name and f"{name}_conv")
    return img_pool_layer(conv, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type, name=name and f"{name}_pool")


def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act="relu",
                   conv_with_batchnorm=False, pool_stride=2,
                   pool_type="max", conv_batchnorm_drop_rate=None):
    """VGG-style conv block (reference img_conv_group): each conv (then
    batch norm with ``conv_act`` and dropout at its rate, where asked),
    then one pool."""
    tmp = input
    drops = conv_batchnorm_drop_rate or [0.0] * len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        tmp = img_conv_layer(tmp, filter_size=conv_filter_size,
                             num_filters=nf,
                             num_channels=num_channels if i == 0 else None,
                             padding=conv_padding,
                             act=None if conv_with_batchnorm else conv_act)
        if conv_with_batchnorm:
            tmp = batch_norm_layer(tmp, act=conv_act)
            if drops[i]:
                tmp = dropout_layer(tmp, drops[i])
    return img_pool_layer(tmp, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type)


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     num_channels=None, pool_stride=1, act="relu",
                     conv_padding=0, pool_type=None, name=None):
    """conv -> batch_norm -> pool (reference img_conv_bn_pool)."""
    conv = img_conv_layer(input, filter_size=filter_size,
                          num_filters=num_filters, num_channels=num_channels,
                          padding=conv_padding, act=None, bias_attr=False,
                          name=name and f"{name}_conv")
    bn = batch_norm_layer(conv, act=act, name=name and f"{name}_bn")
    return img_pool_layer(bn, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type, name=name and f"{name}_pool")


def vgg_16_network(input_image, num_channels, num_classes=1000):
    """Reference vgg_16_network."""
    tmp = img_conv_group(input_image, [64, 64], 2, num_channels=num_channels)
    tmp = img_conv_group(tmp, [128, 128], 2)
    tmp = img_conv_group(tmp, [256, 256, 256], 2)
    tmp = img_conv_group(tmp, [512, 512, 512], 2)
    tmp = img_pool_layer(tmp, pool_size=2, stride=2)
    tmp = fc_layer(tmp, size=4096, act="relu")
    tmp = dropout_layer(tmp, 0.5)
    tmp = fc_layer(tmp, size=4096, act="relu")
    tmp = dropout_layer(tmp, 0.5)
    return fc_layer(tmp, size=num_classes, act="softmax")


def small_vgg(input_image, num_channels, num_classes=10):
    """Reference small_vgg (CIFAR configs): 4 conv groups then fc."""
    def group(ipt, num_filter, times):
        return img_conv_group(ipt, conv_num_filter=[num_filter] * times,
                              pool_size=2, num_channels=None,
                              conv_filter_size=3, conv_act="relu",
                              conv_with_batchnorm=True, pool_stride=2)
    tmp = img_conv_group(input_image, conv_num_filter=[64, 64], pool_size=2,
                         num_channels=num_channels, conv_filter_size=3,
                         conv_act="relu", conv_with_batchnorm=True,
                         pool_stride=2)
    tmp = group(tmp, 128, 2)
    tmp = group(tmp, 256, 3)
    tmp = group(tmp, 512, 3)
    tmp = dropout_layer(tmp, 0.5)
    tmp = fc_layer(tmp, size=512, act=None)
    tmp = batch_norm_layer(tmp, act="relu")
    tmp = fc_layer(tmp, size=512, act="relu")
    return fc_layer(tmp, size=num_classes, act="softmax")


# ---------------------------------------------------------------- recurrent

def simple_lstm(input, size, reverse=False, act="tanh", gate_act="sigmoid",
                state_act="tanh", name=None, mat_param_attr=None,
                bias_param_attr=True, inner_param_attr=None):
    """Reference simple_lstm: fc (4*size) -> lstmemory."""
    mix = fc_layer(input, size=size * 4, act=None, bias_attr=False,
                   param_attr=mat_param_attr,
                   name=name and f"{name}_transform")
    return lstmemory(mix, size=size, reverse=reverse, act=act,
                     gate_act=gate_act, state_act=state_act, name=name,
                     bias_attr=bias_param_attr, param_attr=inner_param_attr)


def simple_gru(input, size, reverse=False, act="tanh", gate_act="sigmoid",
               name=None, mixed_param_attr=None, mixed_bias_param_attr=None,
               mixed_layer_attr=None, gru_bias_attr=True,
               gru_param_attr=None, gru_layer_attr=None, naive=False):
    """Reference simple_gru: fc (3*size) -> grumemory.  ``naive`` (the
    reference's gru_step_naive) computes the same function and is
    accepted, as in the JAX package."""
    mix = fc_layer(input, size=size * 3, act=None,
                   bias_attr=(mixed_bias_param_attr
                              if mixed_bias_param_attr is not None else False),
                   param_attr=mixed_param_attr,
                   layer_attr=mixed_layer_attr,
                   name=name and f"{name}_transform")
    node = grumemory(mix, size=size, reverse=reverse, act=act or "tanh",
                     gate_act=gate_act or "sigmoid", name=name,
                     bias_attr=gru_bias_attr, param_attr=gru_param_attr)
    if gru_layer_attr:
        node.cfg.update(gru_layer_attr)
    return node


def simple_gru2(input, size, reverse=False, act="tanh", gate_act="sigmoid",
                name=None, mixed_param_attr=None, gru_param_attr=None):
    """Reference simple_gru2: simple_gru's function with the reference's
    original parameter layout."""
    mix = fc_layer(input, size=size * 3, act=None, bias_attr=False,
                   param_attr=mixed_param_attr,
                   name=name and f"{name}_transform")
    return grumemory(mix, size=size, reverse=reverse, act=act,
                     gate_act=gate_act, param_attr=gru_param_attr, name=name)


def bidirectional_lstm(input, size, name=None, return_seq=False):
    """Reference bidirectional_lstm: concat(fwd lstm, bwd lstm)."""
    fwd = simple_lstm(input, size, reverse=False, name=name and f"{name}_fwd")
    bwd = simple_lstm(input, size, reverse=True, name=name and f"{name}_bwd")
    if return_seq:
        return concat_layer([fwd, bwd])
    return concat_layer([api.last_seq(fwd), api.first_seq(bwd)])


def bidirectional_gru(input, size, name=None, return_seq=False):
    """Reference bidirectional_gru: concat(fwd gru, bwd gru)."""
    fwd = simple_gru(input, size, reverse=False, name=name and f"{name}_fwd")
    bwd = simple_gru(input, size, reverse=True, name=name and f"{name}_bwd")
    if return_seq:
        return concat_layer([fwd, bwd])
    return concat_layer([api.last_seq(fwd), api.first_seq(bwd)])


def gru_unit(input, size=None, name=None, act="tanh", gate_act="sigmoid",
             memory_boot=None, gru_bias_attr=None, gru_param_attr=None,
             naive=False, gru_layer_attr=None):
    """One GRU step for custom recurrent groups (reference gru_unit):
    creates the output memory link itself."""
    size = size or input.size // 3
    mem = recurrent.memory(name=name or "gru_unit_out", size=size,
                           boot_layer=memory_boot)
    step = (recurrent.gru_step_naive_layer if naive
            else recurrent.gru_step_layer)
    return step(input, mem, size=size, act=act, gate_act=gate_act,
                bias_attr=True if gru_bias_attr is None else gru_bias_attr,
                param_attr=gru_param_attr, name=name or "gru_unit_out")


def gru_group(input, size=None, name=None, reverse=False, act="tanh",
              gate_act="sigmoid", memory_boot=None, gru_bias_attr=None,
              gru_param_attr=None, naive=False, gru_layer_attr=None):
    """GRU as an explicit recurrent_group (reference gru_group) — same
    numbers as grumemory, built from the step primitive."""
    def step(x3):
        return gru_unit(x3, size=size, name=name and f"{name}_out",
                        act=act, gate_act=gate_act, memory_boot=memory_boot,
                        gru_bias_attr=gru_bias_attr,
                        gru_param_attr=gru_param_attr, naive=naive)
    return recurrent.recurrent_group(step, input=input, reverse=reverse,
                                     name=name)


def lstmemory_unit(input, size=None, name=None, act="tanh",
                   gate_act="sigmoid", state_act="tanh", memory_boot=None,
                   param_attr=None, mixed_bias_attr=None,
                   lstm_bias_attr=None, mixed_layer_attr=None,
                   lstm_layer_attr=None, get_output_layer_attr=None):
    """One LSTM step for custom groups (reference lstmemory_unit,
    networks.py:616-723): gates = identity(input) + W_r @ h_prev via a step
    mixed layer (param_attr names/shares W_r), then one lstm_step.  The
    [h|c] pair rides in one memory of width 2*size.  A reference-style
    memory_boot of width `size` boots h; c boots to zero (matching the
    reference, whose state memory boots zero unless given its own layer)."""
    size = size or input.size // 4
    nm = name or "lstm_unit"
    state_name = nm + "_state"
    if memory_boot is not None and memory_boot.size == size:
        # widen [B, size] h-boot to [B, 2*size] = [h | 0]
        zeros = api.slope_intercept_layer(memory_boot, slope=0.0,
                                          intercept=0.0)
        memory_boot = concat_layer([memory_boot, zeros])
    state = recurrent.memory(name=state_name, size=2 * size,
                             boot_layer=memory_boot)
    h_prev = api.mixed_layer(
        size=size, input=[api.identity_projection(state, offset=0,
                                                  size=size)],
        act=None, bias_attr=False, name=nm + "_prev_h")
    # the recurrent projection the reference puts in "%s_input_recurrent"
    gates = api.mixed_layer(
        size=4 * size,
        input=[api.identity_projection(input),
               api.full_matrix_projection(h_prev, param_attr=param_attr)],
        act=None,
        bias_attr=False if mixed_bias_attr is None else mixed_bias_attr,
        name=nm + "_input_recurrent")
    hc = recurrent.lstm_step_layer(
        gates, state, size=size, act=act, gate_act=gate_act,
        state_act=state_act,
        bias_attr=True if lstm_bias_attr is None else lstm_bias_attr,
        name=state_name)
    return api.mixed_layer(
        size=size, input=[api.identity_projection(hc, offset=0, size=size)],
        act=None, bias_attr=False, name=nm)


def lstmemory_group(input, size=None, name=None, reverse=False, act="tanh",
                    gate_act="sigmoid", state_act="tanh", memory_boot=None,
                    param_attr=None, mixed_bias_attr=None,
                    lstm_bias_attr=None, mixed_layer_attr=None,
                    lstm_layer_attr=None, get_output_layer_attr=None):
    """LSTM as an explicit recurrent_group (reference lstmemory_group) —
    exactly the lstmemory math with per-step state access."""
    def step(x4):
        return lstmemory_unit(x4, size=size, name=name and f"{name}_unit",
                              act=act, gate_act=gate_act,
                              state_act=state_act, memory_boot=memory_boot,
                              param_attr=param_attr,
                              mixed_bias_attr=mixed_bias_attr,
                              lstm_bias_attr=lstm_bias_attr)
    return recurrent.recurrent_group(step, input=input, reverse=reverse,
                                     name=name)


def text_conv_pool(input, context_len, hidden_size, context_start=None,
                   pool_type=None, act="relu", name=None):
    """Reference sequence_conv_pool / text_conv_pool: a context mixed
    layer ``input.size * context_len`` wide (the window's rows, zero out
    of range), an fc of ``hidden_size`` with a bias and ``act``, then the
    sequence pool (max unless ``pool_type``).  JAX's puts the window into
    a mixed layer of ``hidden_size`` with no weight, which fails at apply
    (ROADMAP C14); this is the reference's network, under JAX's
    signature."""
    conv = api.mixed_layer(
        size=input.size * context_len, name=name and f"{name}_conv_proj",
        input=[api.context_projection(input, context_len=context_len,
                                      context_start=context_start)])
    fc = fc_layer(conv, size=hidden_size, act=act,
                  name=name and f"{name}_conv_fc")
    return api.pooling_layer(fc, pooling_type=pool_type or api.pooling.Max,
                             name=name and f"{name}_pool")


sequence_conv_pool = text_conv_pool


# ---------------------------------------------------------------- attention

def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     name=None):
    """Bahdanau attention (reference networks.py:1273 simple_attention):
    score_t = v . tanh(enc_proj_t + W s); context = sum softmax * enc."""
    decoder_proj = fc_layer(decoder_state, size=encoded_proj.size, act=None,
                            bias_attr=False, param_attr=transform_param_attr,
                            name=name and f"{name}_transform")
    return attention_context_layer(encoded_sequence, encoded_proj,
                                   decoder_proj,
                                   param_attr=softmax_param_attr, name=name)


class _AttnContextImpl:
    def infer(self, cfg, in_sizes):
        return in_sizes[0]

    def init(self, gen, cfg, in_sizes):
        return {"v": _winit(cfg.get("param_attr"))(gen, (cfg["att_size"],))}

    def apply(self, ctx, cfg, params, enc, enc_proj, dec_proj):
        scores = attn_ops.additive_attention_scores(
            as_seq(enc_proj), value_data(dec_proj), params["v"])
        return attn_ops.attention_context(scores, as_seq(enc))


register_layer("attention_context")(_AttnContextImpl)


def attention_context_layer(encoded_sequence, encoded_proj, decoder_proj,
                            param_attr=None, name=None):
    return LayerOutput(name or auto_name("attention"), "attention_context",
                       encoded_sequence.size,
                       [encoded_sequence, encoded_proj, decoder_proj],
                       {"att_size": encoded_proj.size,
                        "param_attr": param_attr},
                       is_seq=False)


# ---------------------------------------------------------------- config

def inputs(layers, *args):
    """Reference inputs(): declares the data layers' order; with the
    feed-dict API it is a no-op kept for config compatibility."""
    return None


def outputs(layers, *args):
    """Reference outputs(): marks the output layers, returned so that a
    config can end with ``return outputs(...)``."""
    out = list(layers if isinstance(layers, (list, tuple)) else [layers])
    out += list(args)
    return out[0] if len(out) == 1 else out
