"""The headline training benchmark: ``bench.py``'s ``bench_lstm``, ported.

    python -m paddle_tpu_torch.scripts.bench

Trains the LSTM text classifier at the reference's benchmark config
(vocab 30000, embedding 128, 2 stacked LSTMs h=512, batch 64, length
100, Momentum lr 0.01 m 0.9) on one fixed random batch, and prints one
JSON line: ms/batch as the median of STEPS timed steps after WARMUP, the
card's name and power limit as nvidia-smi gives them, and the LSTM
kernel launches.  Runs on the card and raises without one.
"""

import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.models import text_lstm
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optim import Momentum
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

NUM_LAYERS, EMB_DIM = 2, 128
WARMUP, STEPS = 5, 30
# the reference's own baseline for this config, on its K40m
# (docs/perf.md:3-6, BASELINE.md) -- not a number of this port
REFERENCE_K40M_MS = 184.0


class LstmBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    opt_state: dict
    ids: SequenceBatch
    labels: torch.Tensor
    hidden: int


def bench_lstm(batch=64, seq_len=100, hidden=512, vocab=30000, device=None):
    """The config, data and optimizer of ``bench.py:324-333`` (data from
    ``np.random.RandomState(0)``, params from a generator seeded 0).
    ``train_step()`` zeroes the grads, runs ``text_lstm.loss``, calls
    ``backward()``, applies Momentum in place and returns the loss."""
    dev = _device.resolve(device)
    params = text_lstm.init(torch.Generator().manual_seed(0), vocab=vocab,
                            emb_dim=EMB_DIM, hidden=hidden,
                            num_layers=NUM_LAYERS, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Momentum(learning_rate=0.01, momentum=0.9)
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)
    ids = SequenceBatch(
        data=torch.tensor(rng.randint(0, vocab, (batch, seq_len)),
                          dtype=torch.int32, device=dev),
        lengths=torch.full((batch,), seq_len, dtype=torch.int32, device=dev))
    labels = torch.tensor(rng.randint(0, 2, (batch,)), dtype=torch.int32,
                          device=dev)

    def train_step():
        for p in leaves:
            p.grad = None
        loss = text_lstm.loss(params, ids, labels, NUM_LAYERS, hidden)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return LstmBench(train_step, params, opt_state, ids, labels, hidden)


def main():
    bench = bench_lstm(device=_device.resolve("cuda"))
    for _ in range(WARMUP):
        bench.train_step()
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = bench.train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    print(json.dumps({
        "bench": "lstm_textclass", "card": _device.card(),
        "config": {"vocab": 30000, "emb": EMB_DIM, "hidden": bench.hidden,
                   "layers": NUM_LAYERS, "batch": 64, "seq_len": 100,
                   "optimizer": "Momentum lr 0.01 m 0.9"},
        "steps": STEPS, "ms_per_batch": float(np.median(times)),
        "ms_per_batch_p90": float(np.percentile(times, 90)),
        "loss_first_last": [losses[0], losses[-1]],
        "launches": {"lstm_fwd": kernels.lstm.launches_fwd,
                     "lstm_bwd": kernels.lstm.launches_bwd},
        "reference_k40m_ms_per_batch": REFERENCE_K40M_MS,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
