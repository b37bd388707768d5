"""The training benchmarks of ``bench.py``, ported: ``bench_lstm`` (the
headline) and ``bench_transformer``.

    python -m paddle_tpu_torch.scripts.bench [--model lstm|transformer]

``lstm`` (the default) trains the LSTM text classifier at the
reference's benchmark config (vocab 30000, embedding 128, 2 stacked LSTMs
h=512, batch 64, length 100, Momentum lr 0.01 m 0.9); ``transformer``
trains the Transformer-base MT model (vocab 32000, d_model 512, 8 heads,
dff 2048, 6+6 layers, batch 32, length 256, Adam lr 1e-4, label
smoothing 0.1, ``full_seq=True``: every attention through the flash
kernels).  Each runs on one fixed random batch and prints one JSON line:
ms/batch as the median of STEPS timed steps after WARMUP (and, for the
transformer, tokens/s = batch * length / s, the bench's headline), the
card's name and power limit as nvidia-smi gives them, and the kernel
launches.  Runs on the card and raises without one.
"""

import argparse
import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.models import text_lstm, transformer
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optim import Adam, Momentum
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


class TransformerBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    opt_state: dict
    src: SequenceBatch
    trg: SequenceBatch
    tokens_per_step: int


def bench_transformer(batch=32, seq_len=256, vocab=32000, d_model=512,
                      dff=2048, layers=6, heads=8, device=None):
    """The config, data and optimizer of ``bench.py:485-542``: source and
    target ids from ``np.random.RandomState(0)`` in [3, vocab), every row
    full length, params from a generator seeded 0, Adam lr 1e-4.
    ``train_step()`` zeroes the grads, runs ``transformer.loss(...,
    full_seq=True)`` with ``trg`` as both the decoder input and the
    labels (as ``bench.py:522`` passes it), calls ``backward()``, applies
    Adam in place and returns the loss."""
    dev = _device.resolve(device)
    params = transformer.init(torch.Generator().manual_seed(0),
                              src_vocab=vocab, trg_vocab=vocab,
                              d_model=d_model, num_heads=heads, dff=dff,
                              enc_layers=layers, dec_layers=layers,
                              max_len=seq_len, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Adam(learning_rate=1e-4)
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)

    def batch_of_ids():
        return SequenceBatch(
            data=torch.tensor(rng.randint(3, vocab, (batch, seq_len)),
                              dtype=torch.int32, device=dev),
            lengths=torch.full((batch,), seq_len, dtype=torch.int32,
                               device=dev))

    src, trg = batch_of_ids(), batch_of_ids()

    def train_step():
        for p in leaves:
            p.grad = None
        loss = transformer.loss(params, src, trg, trg, heads, full_seq=True)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return TransformerBench(train_step, params, opt_state, src, trg,
                            batch * seq_len)


def _timed(train_step):
    """WARMUP steps, then STEPS timed ones (each ending in a synchronize)
    with the launch counters reset before them: (times ms, losses)."""
    for _ in range(WARMUP):
        train_step()
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return times, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("lstm", "transformer"),
                    default="lstm")
    args = ap.parse_args(argv)
    dev = _device.resolve("cuda")
    if args.model == "lstm":
        bench = bench_lstm(device=dev)
        times, losses = _timed(bench.train_step)
        print(json.dumps({
            "bench": "lstm_textclass", "card": _device.card(),
            "config": {"vocab": 30000, "emb": EMB_DIM,
                       "hidden": bench.hidden, "layers": NUM_LAYERS,
                       "batch": 64, "seq_len": 100,
                       "optimizer": "Momentum lr 0.01 m 0.9"},
            "steps": STEPS, "ms_per_batch": float(np.median(times)),
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "loss_first_last": [losses[0], losses[-1]],
            "launches": {"lstm_fwd": kernels.lstm.launches_fwd,
                         "lstm_bwd": kernels.lstm.launches_bwd},
            "reference_k40m_ms_per_batch": REFERENCE_K40M_MS,
        }), flush=True)
        return 0
    bench = bench_transformer(device=dev)
    times, losses = _timed(bench.train_step)
    ms = float(np.median(times))
    fk = kernels.flash_attention
    print(json.dumps({
        "bench": "transformer_mt", "card": _device.card(),
        "config": {"vocab": 32000, "d_model": 512, "heads": 8, "dff": 2048,
                   "layers": "6+6", "batch": 32, "seq_len": 256,
                   "optimizer": "Adam lr 1e-4", "label_smoothing": 0.1,
                   "full_seq": True},
        "steps": STEPS, "ms_per_batch": ms,
        "ms_per_batch_p90": float(np.percentile(times, 90)),
        "tokens_per_s": bench.tokens_per_step / (ms / 1e3),
        "loss_first_last": [losses[0], losses[-1]],
        "launches": {fk.NAME: fk.launches,
                     fk.NAME_BWD_DKV: fk.launches_bwd_dkv,
                     fk.NAME_BWD_DQ: fk.launches_bwd_dq},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
