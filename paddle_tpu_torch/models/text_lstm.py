"""LSTM text classifier — the reference's RNN benchmark model
(``paddle_tpu/models/text_lstm.py``; benchmark/paddle/rnn/rnn.py: IMDB,
embedding 128 -> N stacked LSTM h=H -> max-pool over time -> fc 2).

Parameters are a nested dict with the JAX tree's keys:

    {"emb": [V, E],
     "l{i}": {"w_in": [d_in, 4H], "w_r": [H, 4H],
              "b": [7H] = bias [4H] | check_i | check_f | check_o},
     "out": {"w": [H, C], "b": [C]}}

Each layer's input projection for all steps is one ``torch.matmul``;
the recurrence is ``ops/rnn.lstm``, whose fused route runs the LSTM
kernels on the card.
"""

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import initializers, linear, losses, rnn
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.utils.tree import tree_map


def init(generator, vocab=30000, emb_dim=128, hidden=512, num_layers=2,
         num_classes=2, device=None):
    """Random parameters drawn from ``generator`` (the port's own init,
    not JAX's random bits): embedding U(-0.1, 0.1), weights normal with
    std 1/sqrt(fan_in), biases and peepholes 0 — the JAX ``init``'s
    rules.  Placed on ``device`` (the card unless "cpu")."""
    dev = _device.resolve(device)
    gen = generator
    ninit, zeros = initializers.normal(), initializers.constant(0.0)
    params = {"emb": initializers.uniform(0.1)(gen, (vocab, emb_dim))}
    d_in = emb_dim
    for i in range(num_layers):
        params[f"l{i}"] = {"w_in": ninit(gen, (d_in, 4 * hidden)),
                           "w_r": ninit(gen, (hidden, 4 * hidden)),
                           "b": zeros(gen, (7 * hidden,))}
        d_in = hidden
    params["out"] = {"w": ninit(gen, (hidden, num_classes)),
                     "b": zeros(gen, (num_classes,))}
    return tree_map(lambda t: t.to(dev), params)


def params_from_numpy(tree, device=None):
    """The JAX tree as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    params)``) -> the port's dict, same keys, float32 on ``device``."""
    dev = _device.resolve(device)
    layers = sorted(k for k in tree if k.startswith("l"))
    if set(tree) != {"emb", "out", *layers} \
            or layers != [f"l{i}" for i in range(len(layers))]:
        raise ValueError(f"not a text_lstm tree: keys {sorted(tree)}")
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=dev), tree)


def forward(params, ids: SequenceBatch, num_layers=2, hidden=512):
    """ids: SequenceBatch of token ids [B, T] -> logits [B, C]."""
    x = emb_ops.embedding_lookup(params["emb"], ids.data)
    sb = SequenceBatch(data=x, lengths=ids.lengths)
    d = hidden
    for i in range(num_layers):
        p = params[f"l{i}"]
        proj = linear.matmul(sb.data, p["w_in"])
        sb, _ = rnn.lstm(SequenceBatch(proj, sb.lengths), p["w_r"],
                         bias=p["b"][:4 * d], check_i=p["b"][4 * d:5 * d],
                         check_f=p["b"][5 * d:6 * d], check_o=p["b"][6 * d:])
    pooled = seq_ops.seq_max_pool(sb)
    return linear.fc(pooled, params["out"]["w"], params["out"]["b"])


def loss(params, ids, labels, num_layers=2, hidden=512):
    logits = forward(params, ids, num_layers, hidden)
    return torch.mean(losses.classification_cost(logits, labels))
