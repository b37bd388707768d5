"""demo/traffic_prediction as a layer-DSL config
(``demo/traffic_prediction/train.py``; the reference's
demo/traffic_prediction trainer_config.py): multi-task speed-bucket
forecasting that ``trainer.SGD`` and ``python -m paddle_tpu_torch
train`` run.

The last ``TERM_NUM`` (24) speeds of a road link, dense, feed 24 heads,
one per 5-minute horizon.  Every head's ``fc_layer(16, tanh)`` embeds
the window with ONE shared weight (``param_attr={"name":
"_link_vec.w"}``, the reference's ``_link_vec.w``: its gradient is the
sum over the 24 heads; each head keeps its own bias), then a softmax
``fc`` of the 4 buckets and a ``classification_cost``; the 24 costs sum.
RMSProp lr 1e-3 at batch 128 over a 4096-sample shuffle.  No kernel of
the port's own is on this path: the products and RMSProp are PyTorch
calls, as they are XLA's in JAX.

The data is the demo's: a real CSV under ``$PADDLE_TPU_DATA_DIR/
traffic/speeds.csv`` (rows of "id,speed,speed,...") if present, else 24
synthetic periodic-plus-noise series of 400 points from
``_synth.rng_for("traffic", "train")``, bucketized to 1..4 and cut into
sliding windows (copied from the demo, which imports JAX).

``python -m paddle_tpu_torch train --config
paddle_tpu_torch/models/traffic_dsl.py`` (``--config_args batches=N``
stops a pass after N batches).
"""

import os

import numpy as np

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.datasets._synth import local_path, rng_for
from paddle_tpu_torch.data.provider import dense_vector, integer_value
from paddle_tpu_torch.optim import RMSProp

TERM_NUM = 24          # past time points fed as the feature window
FORECASTING_NUM = 24   # future points to predict (multi-task heads)
LABEL_VALUE_NUM = 4    # speed buckets
EMB_SIZE = 16
BATCH = 128
SHUFFLE = 4096


def speed_rows():
    """Real CSV rows if present, else the demo's synthetic series."""
    path = local_path("traffic", "speeds.csv")
    if os.path.exists(path):
        with open(path) as f:
            next(f)  # header
            for line in f:
                yield [int(v) for v in line.rstrip("\r\n").split(",")[1:]]
        return
    rng = rng_for("traffic", "train")
    for _ in range(24):
        t = np.arange(400)
        base = 2.5 + 1.4 * np.sin(2 * np.pi * t / 96.0 + rng.rand() * 6.28)
        noisy = np.clip(np.round(base + 0.3 * rng.randn(t.size)), 1,
                        LABEL_VALUE_NUM)
        yield [int(v) for v in noisy]


def samples():
    """Sliding windows (reference dataprovider.process): feature = the
    previous TERM_NUM speeds (float), labels = the next FORECASTING_NUM
    buckets - 1."""
    for speeds in speed_rows():
        for i in range(TERM_NUM, len(speeds) - FORECASTING_NUM):
            feat = [float(v) for v in speeds[i - TERM_NUM:i]]
            labels = [v - 1 for v in speeds[i:i + FORECASTING_NUM]]
            yield tuple([feat] + labels)


def build():
    """(costs, outputs) of the demo's 24 heads, with a fresh layer-name
    registry."""
    L.reset_names()
    link_encode = L.data_layer("link_encode", size=TERM_NUM)
    costs, outputs = [], []
    for i in range(FORECASTING_NUM):
        link_vec = L.fc_layer(link_encode, size=EMB_SIZE, act="tanh",
                              param_attr={"name": "_link_vec.w"})
        score = L.fc_layer(link_vec, size=LABEL_VALUE_NUM, act="softmax",
                           name=f"score_{(i + 1) * 5}min")
        label = L.data_layer(f"label_{(i + 1) * 5}min", size=1)
        costs.append(L.classification_cost(input=score, label=label,
                                           name=f"cost_{(i + 1) * 5}min"))
        outputs.append(score)
    return costs, outputs


def optimizer():
    return RMSProp(learning_rate=1e-3)


def feeding():
    out = {"link_encode": dense_vector(TERM_NUM)}
    for i in range(FORECASTING_NUM):
        out[f"label_{(i + 1) * 5}min"] = integer_value(LABEL_VALUE_NUM)
    return out


def train_reader(n_batches=None):
    batches = reader_mod.batch(reader_mod.shuffle(samples, SHUFFLE, seed=0),
                               BATCH)
    if n_batches is None:
        return batches
    return lambda: (b for _, b in zip(range(n_batches), batches()))


def config(n_batches=None):
    costs, outputs = build()
    return {"cost": costs, "outputs": outputs, "optimizer": optimizer(),
            "train_reader": train_reader(n_batches), "feeding": feeding()}


def get_config():
    """The CLI's entry: ``CONFIG_ARGS`` ``batches``."""
    args = globals().get("CONFIG_ARGS", {})
    return config(int(args["batches"]) if "batches" in args else None)
