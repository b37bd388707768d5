"""Where the resident LSTM kernels' time goes on the card.

    python -m paddle_tpu_torch.scripts.probe_lstm

Builds variants of ``csrc/lstm.cu`` from edited copies of the source
(into ``_build/probe_lstm/``, git-ignored), each with ``nvcc -Xptxas -v``
(registers and spills of every kernel printed), and times each at the
train shape (T 100, B 64, D 512, full rows, x * 0.3, W_r * 0.1 as
chip_smoke.py's LSTM checks), the variants interleaved, forward and
reverse order in turn, ``ROUNDS`` times:

  kernel     the source as it is: CTAs of 16 units x 16-row b-blocks;
             the forward's W_r slice resident, h_{t-1}'s rows through a
             3-stage ring; the backward K-split by unit block into
             partials of dh_prev; 3xTF32 products
  tf32_1x    one TF32 product (a_big b_big), the 3xTF32 terms dropped
  no_mma     the products removed (staging, barrier, cell, and the
             split the compiler then drops)
  no_sync    the grid barriers removed
  s2, s4     a 2- or 4-stage forward ring (3; 4 stages hold every
             chunk of D 512)
  fwd_kg8    the forward in 8 k-groups of 2 warps, 4 n-tiles a warp (4
             k-groups, 2 n-tiles)

For each: the forward (residual-saving) and the backward (BPTT + dW_r,
one ``lstm_bwd_f32`` call) in ms, median; dW_r alone (``lstm_dwr_f32``)
and BPTT = backward - dW_r; the max abs error
of hs / c_fin / cs / acts and of dxs against the plain versions, and
dW_r's and dchecks' relative to their largest entry, with whether each
passes chip_smoke.py's 3xTF32 gate (1e-5; ``no_mma``, ``no_sync`` and
``tf32_1x`` do not compute the LSTM to float32's order).  One JSON line
for the build, one for the shape.  Needs a CUDA device.
"""

import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import lstm as lk

ROUNDS = 6
TC_TOL = 1e-5     # chip_smoke.LSTM_TC_TOL
T, B, D = 100, 64, 512
_MMA2 = ("  mma_tf32(t, as, bb0, bb1);\n  mma_tf32(t, ab, bs0, bs1);\n", "")
EDITS = {
    "kernel": (),
    "tf32_1x": (_MMA2,),
    "no_mma": (_MMA2, ("  mma_tf32(t, ab, bb0, bb1);\n", "")),
    "no_sync": (("grid.sync();", "(void)grid;"),),
    "s2": (("using Fwd = Prod<8, 4, 128, 3>;",
            "using Fwd = Prod<8, 4, 128, 2>;"),),
    "s4": (("using Fwd = Prod<8, 4, 128, 3>;",
            "using Fwd = Prod<8, 4, 128, 4>;"),),
    "fwd_kg8": (("using Fwd = Prod<8, 4, 128, 3>;",
                 "using Fwd = Prod<8, 8, 128, 3>;"),),
}
_KERNEL = re.compile(r"(lstm_fwd_kernel|lstm_bwd_kernel|lstm_dwr_kernel)"
                     r"(?:ILb([01])E)?")


def _ptxas(log):
    """{kernel: {registers, spill_stores}} from ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _KERNEL.search(m.group(1))
            name = None
            if k is not None:
                name = k.group(1) + ("/resid" if k.group(2) == "1" else "")
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
    """(fwd, bwd, dwr): the C entries of one variant, typed."""
    fwd = lib.lstm_fwd_f32
    fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
    bwd = lib.lstm_bwd_f32
    bwd.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    dwr = lib.lstm_dwr_f32
    dwr.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    return fwd, bwd, dwr


def build(names=None):
    """{variant: ((fwd, bwd, dwr) typed C entries, ptxas report)} for the
    named variants (every one by default), all nvcc in parallel."""
    with open(os.path.join(_build.CSRC, "lstm.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "probe_lstm")
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
        libs[name] = (_typed(lib), _ptxas(logs[name]))
    return libs


class Case:
    """The inputs, outputs and plain results of one (T, B, D), and the
    calls of a variant's entries on them."""

    def __init__(self, dev, rng, t, b, d):
        def tensor(shape, scale):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                                * scale, device=dev)
        self.t, self.b, self.d = t, b, d
        self.xs, self.w_r = tensor((t, b, 4 * d), 0.3), tensor((d, 4 * d),
                                                               0.1)
        self.checks = tensor((3, d), 0.1)
        self.mask = torch.ones(t, b, device=dev)
        self.dh_out, self.dcfin = tensor((t, b, d), 1.0), tensor((b, d), 1.0)
        self.ref = lk.lstm_fwd_plain(self.xs, self.mask, self.w_r,
                                     self.checks, True)
        _, _, cs, acts = self.ref
        self.bwd_in = (acts, cs, self.ref[0], self.w_r, self.checks,
                       self.mask, self.dh_out, self.dcfin)
        self.ref_bwd = lk.lstm_bwd_plain(*self.bwd_in)
        self.fwd_out = [torch.empty(t, b, d, device=dev),
                        torch.empty(b, d, device=dev),
                        torch.empty(t, b, d, device=dev),
                        torch.empty_like(self.xs)]
        self.bwd_out = [torch.empty_like(self.xs), torch.empty_like(self.w_r),
                        torch.empty(b, 3 * d, device=dev),
                        torch.empty(b, d, device=dev),
                        torch.empty(b, d, device=dev)]
        self.part = torch.empty(2, d // 16, b, d, device=dev)
        self.stream = torch.cuda.current_stream().cuda_stream

    def fwd(self, entries):
        _build.check("probe_lstm", entries[0](
            *(x.data_ptr() for x in (self.xs, self.mask, self.w_r,
                                     self.checks, *self.fwd_out)),
            self.t, self.b, self.d, 1, self.stream))

    def bwd(self, entries):
        acts, cs, hs, w_r, checks, mask, dh_out, dcfin = self.bwd_in
        dxs, dwr, dchk, dh_c, dc_c = self.bwd_out
        _build.check("probe_lstm", entries[1](
            *(x.data_ptr() for x in (acts, cs, hs, w_r, checks, mask, dh_out,
                                     dcfin, dxs, dwr, dchk, dh_c, dc_c,
                                     self.part)),
            self.t, self.b, self.d, self.stream))

    def dwr(self, entries):
        _build.check("probe_lstm", entries[2](
            self.bwd_in[2].data_ptr(), self.bwd_out[0].data_ptr(),
            self.bwd_out[1].data_ptr(), self.t, self.b, self.d, self.stream))

    def errors(self, entries):
        """Max abs error of the forward's four outputs and of dxs; dW_r's
        and dchecks' relative to their largest entry."""
        self.fwd(entries)
        self.bwd(entries)
        torch.cuda.synchronize()

        def err(x, y):
            return float((x - y).abs().max())

        rdxs, rdwr, rdchk = self.ref_bwd
        dchk = self.bwd_out[2].sum(0).reshape(3, self.d)
        return {"fwd": max(err(x, y) for x, y in zip(self.fwd_out,
                                                     self.ref)),
                "dxs": err(self.bwd_out[0], rdxs),
                "dW_r_rel": err(self.bwd_out[1], rdwr)
                / float(rdwr.abs().max()),
                "dchecks_rel": err(dchk, rdchk) / float(rdchk.abs().max())}


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
    parts = [("fwd", case.fwd), ("bwd", case.bwd), ("dwr", case.dwr)]
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
        row["bptt"] = row["bwd"] - row["dwr"]
        ms[name] = row
    print(json.dumps({"card": _device.card(), "T": T, "B": B, "D": D,
                      "errors": errs,
                      "within_tc_gate": {n: max(e.values()) <= TC_TOL
                                         for n, e in errs.items()},
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
