"""Where the gate-blocked LSTM forward's time goes on the card.

    python -m paddle_tpu_torch.scripts.probe_lstm_blocked

Builds variants of ``csrc/lstm_blocked.cu`` from edited copies of the
source (into ``_build/probe/``, git-ignored) and times each at the
lstm1280 / lstm2048 train shapes (T 100, B 64, full rows, W_r std
1/sqrt(D)), the variants interleaved, forward and reverse order in
turn, ``ROUNDS`` times:

  kernel     the source as it is
  no_fma     the inner product's FMAs removed (staging, barrier, cell)
  no_copy    the cp.async copies removed (the FMA loop on stale shared
             memory, barrier, cell)
  no_sync    the grid barrier removed
  rm2        two batch rows a thread instead of four (twice the threads)
  kc32s4     32-deep k chunks, a 4-stage ring
  kc128s2    128-deep k chunks, a 2-stage ring

Only ``kernel`` computes the LSTM; its max abs error against the plain
version is printed beside the times (ms, median).  One JSON line per
D.  Needs a CUDA device.
"""

import ctypes
import json
import math
import os
import subprocess

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import lstm as lk

ROUNDS = 6
T, B = 100, 64
HIDDEN = (1280, 2048)
_FMA = "".join(f"                acc[i][g] = fmaf(h.{c}, w[g].{c}, acc[i][g]);\n"
               for c in "xyzw")
EDITS = {
    "kernel": (),
    "no_fma": ((_FMA, ""),),
    "no_copy": (("          if (s < NK) load(s);\n", ""),
                ("          if (kc + kStages - 1 < NK) "
                 "load(kc + kStages - 1);\n", "")),
    "no_sync": (("    if (t + 1 < T) grid.sync();", ""),),
    "rm2": (("B >= 32 ? launch<4>", "B >= 32 ? launch<2>"),),
    "kc32s4": (("constexpr int KC = 64;", "constexpr int KC = 32;"),
               ("constexpr int kStages = 3;", "constexpr int kStages = 4;")),
    "kc128s2": (("constexpr int KC = 64;", "constexpr int KC = 128;"),
                ("constexpr int kStages = 3;",
                 "constexpr int kStages = 2;")),
}


def build():
    """{variant: the typed C entry of its library}, all nvcc in parallel."""
    with open(os.path.join(_build.CSRC, "lstm_blocked.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        code = src
        for old, new in edits:
            if old not in code:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old.strip()!r}")
            code = code.replace(old, new)
        path = os.path.join(out, name)
        with open(f"{path}.cu", "w") as f:
            f.write(code)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", f"{path}.so", f"{path}.cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(out, f"{name}.so")).lstm_blocked_fwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fns[name] = fn
    return fns


def main():
    dev = _device.resolve("cuda")
    fns = build()
    rng = np.random.RandomState(0)
    for d in HIDDEN:
        def tensor(shape, scale):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                                * scale, device=dev)
        xs, w_r = tensor((T, B, 4 * d), 0.3), tensor((d, 4 * d),
                                                     1 / math.sqrt(d))
        checks, mask = tensor((3, d), 0.1), torch.ones(T, B, device=dev)
        outs = [torch.empty(T, B, d, device=dev), torch.empty(B, d, device=dev),
                torch.empty(T, B, d, device=dev), torch.empty_like(xs),
                torch.empty_like(w_r)]
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            _build.check("probe", fn(
                *(x.data_ptr() for x in (xs, mask, w_r, checks, *outs)),
                T, B, d, 1, stream))

        ref = lk.lstm_fwd_plain(xs, mask, w_r, checks, True)[0]
        call(fns["kernel"])
        err = float((outs[0] - ref).abs().max())
        times = {name: [] for name in fns}
        order = list(fns)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(fns[name])
                call(fns[name])
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / 2)
        print(json.dumps({"card": _device.card(), "T": T, "B": B, "D": d,
                          "kernel_max_abs_err": err,
                          "ms": {n: float(np.median(v))
                                 for n, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
