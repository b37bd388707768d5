"""Where the gate-blocked LSTM forward's time goes on the card.

    python -m paddle_tpu_torch.scripts.probe_lstm_blocked

Builds variants of ``csrc/lstm_blocked.cu`` from edited copies of the
source (into ``_build/probe/``, git-ignored), each with ``nvcc -Xptxas
-v`` (registers and spills of every kernel instance printed), and times
each at the lstm1280 / lstm2048 train shapes (T 100, B 64, full rows,
W_r std 1/sqrt(D)), the variants interleaved, forward and reverse order
in turn, ``ROUNDS`` times:

  kernel     the source as it is: 32 warps in four k-groups, 128-row
             chunks through a 2-stage ring, each CTA's W_r columns
             resident in shared memory where they fit beside the ring
             (at D 1280 six of ten chunks, at D 2048 two of sixteen),
             the rest streamed from the wpack scratch every step
  streamed   every W_r chunk streamed from wpack every step (through L2;
             at D 2048, 67 MB, past it)
  no_mma     the products removed (staging, split, barrier, cell)
  no_sync    the grid barrier removed
  s3         a 3-stage ring (2)
  kc64       64-row chunks (128; 256-row ones do not fit at D 2048)
  ks2        16 warps, two k-groups (four)
  first      the first tensor-core design: 8 warps, one k-group, 32-row
             chunks
  chained    each k-step's three products accumulated in the tensor
             cores across k-steps (as it is: a fresh tile a k-step)
  tf32_1x    one TF32 product (a_big b_big), the 3xTF32 terms dropped

Every variant's max abs error against the plain version is printed
beside the times (ms, median; ``no_mma``, ``no_sync`` and ``tf32_1x``
do not compute the LSTM to float32's order), with whether it passes
chip_smoke.py's 3xTF32 gate (1e-5, tighter than the 1e-4 kernel gate,
which one TF32 pass also passes here).  One JSON line for
the build, one per D.  Needs a CUDA device.
"""

import ctypes
import json
import math
import os
import re
import subprocess

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import lstm as lk

ROUNDS = 6
TC_TOL = 1e-5     # chip_smoke.BLK_TC_TOL
T, B = 100, 64
HIDDEN = (1280, 2048)
_MMA = ("if (n < n_cnt) mma3(acc[n], ab, as, wr[n * 8], wr[4 * P + n * 8]);",
        "")
EDITS = {
    "kernel": (),
    "streamed": (("    p.KR = D;\n", "    p.KR = 0;\n"),),
    "no_mma": (_MMA,),
    "no_sync": (("    if (t + 1 < T) grid.sync();", ""),),
    "s3": (("constexpr int kStages = 2;", "constexpr int kStages = 3;"),),
    "kc64": (("constexpr int KC = 128;", "constexpr int KC = 64;"),),
    "ks2": (("constexpr int kKSplit = 4;", "constexpr int kKSplit = 2;"),),
    "first": (("constexpr int kKSplit = 4;", "constexpr int kKSplit = 1;"),
              ("constexpr int KC = 128;", "constexpr int KC = 32;")),
    "chained": (("  float t[4] = {0.f, 0.f, 0.f, 0.f};\n"
                 "  mma_tf32(t, as, bb0, bb1);\n"
                 "  mma_tf32(t, ab, bs0, bs1);\n"
                 "  mma_tf32(t, ab, bb0, bb1);\n"
                 "  d[0] += t[0];\n  d[1] += t[1];\n  d[2] += t[2];\n"
                 "  d[3] += t[3];\n",
                 "  mma_tf32(d, as, bb0, bb1);\n"
                 "  mma_tf32(d, ab, bs0, bs1);\n"
                 "  mma_tf32(d, ab, bb0, bb1);\n"),),
    "tf32_1x": (("  mma_tf32(t, as, bb0, bb1);\n"
                 "  mma_tf32(t, ab, bs0, bs1);\n", ""),),
}
_KERNEL = re.compile(r"lstm_blocked_fwd_kernelILi(\d+)ELb([01])E")


def _ptxas(log):
    """{kernel instance: (registers, spill store bytes)} from ``-Xptxas
    -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _KERNEL.search(m.group(1))
            name = None if k is None else (
                f"ntw{k.group(1)}" + ("/resid" if k.group(2) == "1" else ""))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(name, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def build():
    """{variant: (typed C entry, wpack size entry, ptxas report)}, all
    nvcc in parallel."""
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
            [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o",
             f"{path}.so", f"{path}.cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    logs = {name: proc.communicate()[0].decode(errors="replace")
            for name, proc in procs.items()}     # every nvcc ends first
    libs = {}
    for name, proc in procs.items():
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        fn = lib.lstm_blocked_fwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        size = lib.lstm_blocked_wpack_floats
        size.argtypes, size.restype = [ctypes.c_int], ctypes.c_longlong
        libs[name] = (fn, size, _ptxas(logs[name]))
    return libs


def main():
    dev = _device.resolve("cuda")
    libs = build()
    print(json.dumps({"card": _device.card(), "ptxas": {
        name: rep for name, (_, _, rep) in libs.items()}}), flush=True)
    rng = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    for d in HIDDEN:
        def tensor(shape, scale):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                                * scale, device=dev)
        xs, w_r = tensor((T, B, 4 * d), 0.3), tensor((d, 4 * d),
                                                     1 / math.sqrt(d))
        checks, mask = tensor((3, d), 0.1), torch.ones(T, B, device=dev)
        outs = [torch.empty(T, B, d, device=dev), torch.empty(B, d, device=dev),
                torch.empty(T, B, d, device=dev), torch.empty_like(xs)]
        wpack = {name: torch.empty(size(d), device=dev)
                 for name, (_, size, _) in libs.items()}

        def call(name):
            _build.check("probe", libs[name][0](
                *(x.data_ptr() for x in (xs, mask, w_r, checks, *outs,
                                         wpack[name])),
                T, B, d, 1, stream))

        ref = lk.lstm_fwd_plain(xs, mask, w_r, checks, True)[0]
        errs = {}
        for name in libs:
            call(name)
            torch.cuda.synchronize()
            errs[name] = float((outs[0] - ref).abs().max())
        times = {name: [] for name in libs}
        order = list(libs)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(name)
                call(name)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / 2)
        print(json.dumps({"card": _device.card(), "T": T, "B": B, "D": d,
                          "max_abs_err": errs,
                          "within_tc_gate": {n: e <= TC_TOL
                                             for n, e in errs.items()},
                          "ms": {n: float(np.median(v))
                                 for n, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
