"""Where the vanilla-RNN kernels' time goes on the card.

    python -m paddle_tpu_torch.scripts.probe_simple_rnn

Builds variants of ``csrc/simple_rnn.cu`` from edited copies of the
source (into ``_build/probe_simple_rnn/``, git-ignored), each with
``nvcc -Xptxas -v`` (registers and spills of every kernel printed) and
with one more C entry appended, ``simple_rnn_dw_f32``, which launches
the dW product alone.  Times each at the DSL slice's train shape (T 100,
B 64, D 512, full rows, x * 0.3, W at std 1/sqrt(D) as chip_smoke.py's
simple-RNN checks), the variants interleaved, forward and reverse order
in turn, ``ROUNDS`` times:

  kernel     the source as it is: CTAs of 16 units x 16-row b-blocks, the
             W slice resident, the b-block's rows through a 3-stage ring
             of 128-column chunks, 8 k-groups; dW in 3xTF32 tiles with
             K split across CTAs
  tf32_1x    one TF32 product (a_big b_big), the 3xTF32 terms dropped
  no_mma     the products removed (staging, barrier, cell, and the
             split the compiler then drops)
  no_sync    the recurrences' grid barriers removed
  s2, s4     a 2- or 4-stage ring (3; 4 stages hold every chunk of
             D 512)
  dw_ks1     dW with no K-split (up to 8 splits a tile, 4 at D 512:
             as many as stay co-resident)

For each: the forward and the backward (BPTT + dW, one
``simple_rnn_bwd_f32`` call) in ms, median; dW alone and BPTT =
backward - dW; the max abs error of hs, and of dxs and dW relative to
their largest entry, against the plain versions, with whether each
passes chip_smoke.py's 3xTF32 gate (1e-5; ``no_mma``, ``no_sync`` and
``tf32_1x`` do not compute the RNN to float32's order).  One JSON line
for the build, one for the shape.  Needs a CUDA device.
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
from paddle_tpu_torch.ops.kernels import simple_rnn as rk

ROUNDS = 6
TC_TOL = 1e-5     # chip_smoke.RNN_TC_TOL
T, B, D = 100, 64, 512
_MMA2 = ("  mma_tf32(s0, as, bb0, bb1);\n  mma_tf32(s1, ab, bs0, bs1);\n", "")
_STAGES = "constexpr int kStages = 3;"
_SPLITS = "constexpr int kDwSplits = 8;"
EDITS = {
    "kernel": (),
    "tf32_1x": (_MMA2,),
    "no_mma": (_MMA2, ("  mma_tf32(t, ab, bb0, bb1);\n", "")),
    "no_sync": (("grid.sync();", "(void)grid;"),),
    "s2": ((_STAGES, "constexpr int kStages = 2;"),),
    "s4": ((_STAGES, "constexpr int kStages = 4;"),),
    "dw_ks1": ((_SPLITS, "constexpr int kDwSplits = 1;"),),
}
# the dW product alone, appended to every variant's source
DW_ENTRY = """
extern "C" int simple_rnn_dw_f32(const float* hs, const float* dxs,
                                 float* dw_out, int T, int B, int D,
                                 void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  return dw_product(hs, dxs, dw_out, T, B, D,
                    static_cast<cudaStream_t>(stream));
}
"""
_KERNEL = re.compile(r"simple_rnn_(fwd|bwd|dw)_kernel")


def _ptxas(log):
    """{kernel: {registers, spill_stores}} from ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _KERNEL.search(m.group(1))
            name = k.group(0) if k else None
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


def _typed(lib):
    """(fwd, bwd, dw): the C entries of one variant, typed."""
    fwd = lib.simple_rnn_fwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    bwd = lib.simple_rnn_bwd_f32
    bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    dw = lib.simple_rnn_dw_f32
    dw.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    for fn in (fwd, bwd, dw):
        fn.restype = ctypes.c_int
    return fwd, bwd, dw


def build(names=None):
    """{variant: ((fwd, bwd, dw) typed C entries, ptxas report)} for the
    named variants (every one by default), all nvcc in parallel."""
    with open(os.path.join(_build.CSRC, "simple_rnn.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "probe_simple_rnn")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names or EDITS:
        code = src
        for old, new in EDITS[name]:
            if old not in code:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old.strip()!r}")
            code = code.replace(old, new)
        path = os.path.join(out, name)
        with open(f"{path}.cu", "w") as f:
            f.write(code + DW_ENTRY)
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
        libs[name] = (_typed(lib), _ptxas(logs[name]))
    return libs


class Case:
    """The inputs, outputs and plain results of one (T, B, D) on full
    rows, and the calls of a variant's entries on them."""

    def __init__(self, dev, rng, t, b, d):
        def tensor(shape, scale):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                                * np.float32(scale), device=dev)
        self.t, self.b, self.d = t, b, d
        self.xs = tensor((t, b, d), 0.3)
        self.w = tensor((d, d), 1.0 / math.sqrt(d))
        self.mask = torch.ones(t, b, device=dev)
        self.dh_out = tensor((t, b, d), 1.0)
        self.ref = rk.simple_rnn_fwd_plain(self.xs, self.mask, self.w)
        self.ref_bwd = rk.simple_rnn_bwd_plain(self.ref, self.w, self.mask,
                                               self.dh_out)
        self.hs = torch.empty_like(self.xs)
        self.dxs = torch.empty_like(self.xs)
        self.dw_out = torch.empty_like(self.w)
        self.dh_buf = torch.empty(b, d, device=dev)
        self.stream = torch.cuda.current_stream().cuda_stream

    def fwd(self, entries):
        _build.check("probe_simple_rnn", entries[0](
            self.xs.data_ptr(), self.mask.data_ptr(), self.w.data_ptr(),
            self.hs.data_ptr(), self.t, self.b, self.d, self.stream))

    def bwd(self, entries):
        _build.check("probe_simple_rnn", entries[1](
            *(x.data_ptr() for x in (self.ref, self.w, self.mask,
                                     self.dh_out, self.dxs, self.dw_out,
                                     self.dh_buf)),
            self.t, self.b, self.d, self.stream))

    def dw(self, entries):
        _build.check("probe_simple_rnn", entries[2](
            self.ref.data_ptr(), self.dxs.data_ptr(), self.dw_out.data_ptr(),
            self.t, self.b, self.d, self.stream))

    def outputs(self, entries):
        """(hs, dxs, dW) of one forward and one backward, copied."""
        self.fwd(entries)
        self.bwd(entries)
        torch.cuda.synchronize()
        return self.hs.clone(), self.dxs.clone(), self.dw_out.clone()

    def errors(self, entries):
        """hs's max abs error; dxs's and dW's relative to their largest
        entry (dxs reaches ~10 at the train shape)."""
        hs, dxs, dw = self.outputs(entries)

        def rel(x, y):
            return float((x - y).abs().max() / y.abs().max())

        return {"hs": float((hs - self.ref).abs().max()),
                "dxs_rel": rel(dxs, self.ref_bwd[0]),
                "dW_rel": rel(dw, self.ref_bwd[1])}


def _median_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 2


def main():
    dev = _device.resolve("cuda")
    libs = build()
    print(json.dumps({"card": _device.card(), "ptxas": {
        name: rep for name, (_, rep) in libs.items()}}), flush=True)
    case = Case(dev, np.random.RandomState(0), T, B, D)
    errs = {name: case.errors(entries) for name, (entries, _) in libs.items()}
    parts = [("fwd", case.fwd), ("bwd", case.bwd), ("dw", case.dw)]
    times = {name: {part: [] for part, _ in parts} for name in libs}
    order = list(libs)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            entries = libs[name][0]
            for part, call in parts:
                times[name][part].append(_median_ms(lambda: call(entries)))
    ms = {}
    for name, parts_ms in times.items():
        row = {part: float(np.median(v)) for part, v in parts_ms.items()}
        row["bptt"] = row["bwd"] - row["dw"]
        ms[name] = row
    print(json.dumps({"card": _device.card(), "T": T, "B": B, "D": D,
                      "errors": errs,
                      "within_tc_gate": {n: max(e.values()) <= TC_TOL
                                         for n, e in errs.items()},
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
