"""demo/moe as a layer-DSL config (``demo/moe/train.py``): a 4-expert
top-2 mixture of experts that classifies which quadrant a 2-D point lies
in, run by ``trainer.SGD`` and ``python -m paddle_tpu_torch train``.

``fc_layer(32, tanh) -> moe_layer(4 experts, top 2, expert_dim 64) ->
fc_layer(4, softmax)`` with ``classification_cost``; Adam lr 0.01 at
batch 64 over the demo's 4096 uniform points of ``RandomState(0)``.
``quadrant_accuracy`` is the demo's end check: the argmax on 512 fresh
points of ``RandomState(1)`` in test mode.  The experts run through
``ops/moe`` (PyTorch products and the top-2 gate, as XLA's in JAX); no
kernel of the port's own is on this path.

``python -m paddle_tpu_torch train --config
paddle_tpu_torch/models/moe_dsl.py`` (``--config_args batches=N`` stops
a pass after N batches).
"""

import numpy as np
import torch

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.provider import dense_vector, integer_value
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.utils.tree import tree_leaves

N_POINTS = 4096
BATCH = 64
CHECK_POINTS = 512


def points(n=N_POINTS, seed=0):
    """The demo's data: ``n`` uniform points in [-1, 1]^2 and their
    quadrant (2 * (x > 0) + (y > 0))."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    label = (x[:, 0] > 0).astype(np.int32) * 2 \
        + (x[:, 1] > 0).astype(np.int32)
    return x, label


def samples(n=N_POINTS, seed=0):
    x, label = points(n, seed)

    def reader():
        for i in range(n):
            yield x[i], int(label[i])
    return reader


def build():
    """(cost, output) of the demo's network, with a fresh layer-name
    registry."""
    L.reset_names()
    x = L.data_layer("x", size=2)
    y = L.data_layer("y", size=4)
    h = L.fc_layer(x, size=32, act="tanh")
    m = L.moe_layer(h, n_experts=4, top_k=2, expert_dim=64, name="moe")
    pred = L.fc_layer(m, size=4, act="softmax", name="out")
    return L.classification_cost(pred, y), pred


def optimizer():
    return Adam(learning_rate=0.01)


def feeding():
    return {"x": dense_vector(2), "y": integer_value(4)}


def train_reader(n_batches=None):
    batches = reader_mod.batch(samples(), BATCH)
    if n_batches is None:
        return batches
    return lambda: (b for _, b in zip(range(n_batches), batches()))


def config(n_batches=None):
    cost, output = build()
    return {"cost": cost, "output": output, "optimizer": optimizer(),
            "train_reader": train_reader(n_batches), "feeding": feeding()}


def quadrant_accuracy(output, parameters):
    """The demo's end check: the share of CHECK_POINTS fresh points of
    ``RandomState(1)`` whose argmax is their quadrant (on the
    parameters' device)."""
    xq, want = points(CHECK_POINTS, seed=1)
    dev = tree_leaves(parameters)[0].device
    with torch.no_grad():
        probs = L.Topology([output]).apply(
            parameters, {"x": torch.as_tensor(xq, device=dev)},
            mode="test")
    return float((probs.argmax(-1).cpu().numpy() == want).mean())


def get_config():
    """The CLI's entry: ``CONFIG_ARGS`` ``batches``."""
    args = globals().get("CONFIG_ARGS", {})
    return config(int(args["batches"]) if "batches" in args else None)
