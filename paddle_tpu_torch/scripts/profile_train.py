"""Where the headline train step's time goes on the card.

    python -m paddle_tpu_torch.scripts.profile_train

Builds ``scripts/bench.bench_lstm`` at the reference config (vocab 30000,
embedding 128, 2 x LSTM h=512, batch 64, length 100, Momentum) and runs
its train step on the one fixed batch: WARMUP steps, then STEPS measured
ones.  Prints one JSON line with, per
step: the host wall time (each step ends in a synchronize), the device
time between two CUDA events around it, the device time the profiler
attributes to kernels, the device's idle share (1 - kernel time / wall
time), and the kernels with the most device time
(``profile_step.measure``).  Needs a CUDA device.
"""

import json

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.scripts.bench import bench_lstm
from paddle_tpu_torch.scripts.profile_step import measure

WARMUP, STEPS = 5, 20


def main():
    bench = bench_lstm(device=_device.resolve("cuda"))
    for _ in range(WARMUP):
        bench.train_step()
    torch.cuda.synchronize()
    print(json.dumps({
        "config": "text_lstm vocab 30000, emb 128, 2 x LSTM h=512, "
                  "batch 64, length 100, Momentum",
        **measure(bench.train_step, STEPS),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
