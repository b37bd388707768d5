"""Where a train step's time goes on the card.

    python -m paddle_tpu_torch.scripts.profile_train \
        [--model lstm|transformer|seq2seq] [--hidden 512|1280|2048]

Builds ``scripts/bench.bench_lstm`` at the reference config (vocab 30000,
embedding 128, 2 x LSTM h=512 or ``--hidden``, batch 64, length 100,
Momentum; the default), ``scripts/bench.bench_transformer`` at the bench's config
(vocab 32000, d_model 512, 8 heads, dff 2048, 6+6 layers, batch 32,
length 256, Adam, full_seq) or ``scripts/bench.bench_seq2seq`` (vocab
30000, emb = h = att 512, batch 64, lengths 30 / 30, Momentum) and runs
its train step on the one fixed batch: WARMUP steps, then STEPS measured
ones.  Prints one JSON line with, per step: the host wall time (each
step ends in a synchronize), the device time between two CUDA events
around it, the device time the profiler attributes to kernels, the
device's idle share (1 - kernel time / wall time), the kernels with the
most device time, and the kernel time by origin: the port's kernels
(the LSTM kernels, resident or gate-blocked by the hidden size; the
flash kernels for the transformer; the GRU kernels for seq2seq),
the library's matrix products and the rest (``profile_step.measure``).
Needs a CUDA device.
"""

import argparse
import json

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.scripts.bench import (bench_lstm, bench_seq2seq,
                                            bench_transformer)
from paddle_tpu_torch.scripts.profile_step import measure

WARMUP = 5
STEPS = {"lstm": 20, "transformer": 10, "seq2seq": 10}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("lstm", "transformer", "seq2seq"),
                    default="lstm")
    ap.add_argument("--hidden", type=int, default=512,
                    help="the LSTM's hidden size (--model lstm)")
    args = ap.parse_args(argv)
    dev = _device.resolve("cuda")
    if args.model == "lstm":
        bench = bench_lstm(hidden=args.hidden, device=dev)
        config = (f"text_lstm vocab 30000, emb 128, 2 x LSTM h={args.hidden}, "
                  "batch 64, length 100, Momentum")
    elif args.model == "seq2seq":
        bench = bench_seq2seq(device=dev)
        config = ("seq2seq attention NMT vocab 30000, emb = h = att 512, "
                  "bi-GRU encoder, batch 64, lengths 30 / 30, Momentum")
    else:
        bench = bench_transformer(device=dev)
        config = ("transformer MT vocab 32000, d_model 512, 8 heads, dff "
                  "2048, 6+6 layers, batch 32, length 256, Adam, full_seq")
    for _ in range(WARMUP):
        bench.train_step()
    torch.cuda.synchronize()
    print(json.dumps({
        "config": config,
        **measure(bench.train_step, STEPS[args.model]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
