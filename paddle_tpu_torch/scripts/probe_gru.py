"""Where the GRU kernels' time goes on the card.

    python -m paddle_tpu_torch.scripts.probe_gru

Builds variants of ``csrc/gru.cu`` from edited copies of the source
(into ``_build/probe_gru/``, git-ignored), each with ``nvcc -Xptxas -v``
(registers and spills of every kernel printed) and with one more C entry
appended, ``gru_dw_f32``, which launches the dW_gate / dW_state product
alone.  Times each at the seq2seq encoder's train shape (T 30, B 64,
D 512, full rows, x * 0.3, W_gate and W_state * 0.1 as chip_smoke.py's
GRU checks), the variants interleaved, forward and reverse order in
turn, ``ROUNDS`` times:

  kernel     the source as it is: CTAs of 16 units x 16-row b-blocks, the
             W_gate / W_state slices resident, the b-block's rows through
             a 3-stage ring of 128-column chunks, 8 k-groups; dW in
             3xTF32 tiles with K split across CTAs where they fit
  tf32_1x    one TF32 product (a_big b_big), the 3xTF32 terms dropped
  no_mma     the products removed (staging, barriers, cells, and the
             split the compiler then drops)
  no_sync    the recurrences' grid barriers removed (races: its errors
             mean nothing)
  s2, s4     a 2- or 4-stage ring (3; 4 stages hold every chunk of
             D 512)
  dw_ks1     dW with no K-split
  dw_2cta    dW at 2 CTAs an SM (128 registers), so that 2 splits a tile
             stay co-resident at D 512 (96 tiles)
  bgroup     the recurrences' barriers over one b-group's D / 16 CTAs
             alone (nothing in a step crosses b-blocks): a release add
             and acquire loads on a counter of the b-group whose top bit
             flips once all have arrived, as grid.sync's does.  The
             counters are one static array, so two launches must not
             overlap: a probe of the barrier's cost, not a kernel to ship

For each: the forward and the backward (BPTT + dW, one ``gru_bwd_f32``
call) in ms, median; dW alone and BPTT = backward - dW; the max abs
error of hs and acts, and of dxs, dW_gate and dW_state relative to their
largest entry, against the plain versions, with whether each passes
chip_smoke.py's 3xTF32 gate (1e-5; ``no_mma``, ``no_sync`` and
``tf32_1x`` do not compute the GRU to float32's order).  One JSON line
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
from paddle_tpu_torch.ops.kernels import gru as gk

ROUNDS = 6
TC_TOL = 1e-5     # chip_smoke.GRU_TC_TOL
T, B, D = 30, 64, 512
_MMA2 = ("  mma_tf32(s0, as, bb0, bb1);\n  mma_tf32(s1, ab, bs0, bs1);\n", "")
_STAGES = "constexpr int kStages = 3;"
_SPLITS = "constexpr int kDwSplits = 8;"
_BGROUP = """
__device__ unsigned int g_bgroup_bar[1024];

// every CTA of b-group blockIdx.x / nu arrives; the group's first adds
// 2^31 - (nu - 1), the others 1, so the top bit flips once all have
__device__ __forceinline__ void bgroup_sync(int nu) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* bar = g_bgroup_bar + blockIdx.x / nu;
    const unsigned int inc = blockIdx.x % nu == 0 ? 0x80000000u - (nu - 1) : 1u;
    unsigned int old, cur;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(inc) : "memory");
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(cur) : "l"(bar) : "memory");
    } while (((old ^ cur) & 0x80000000u) == 0);
  }
  __syncthreads();
}

"""
_SIGMOID = "__device__ __forceinline__ float sigmoid"
EDITS = {
    "kernel": (),
    "tf32_1x": (_MMA2,),
    "no_mma": (_MMA2, ("  mma_tf32(t, ab, bb0, bb1);\n", "")),
    "no_sync": (("grid.sync();", "(void)grid;"),),
    "s2": ((_STAGES, "constexpr int kStages = 2;"),),
    "s4": ((_STAGES, "constexpr int kStages = 4;"),),
    "dw_ks1": ((_SPLITS, "constexpr int kDwSplits = 1;"),),
    "dw_2cta": (("__launch_bounds__(256) gru_dw_kernel",
                 "__launch_bounds__(256, 2) gru_dw_kernel"),),
    "bgroup": ((_SIGMOID, _BGROUP + _SIGMOID),
               ("grid.sync();  //", "bgroup_sync(nu);  //"),
               ("grid.sync();                     //",
                "bgroup_sync(nu);                 //")),
}
# the dW product alone, appended to every variant's source
DW_ENTRY = """
extern "C" int gru_dw_f32(const float* hs, const float* dxs, const float* s_all,
                          float* dwg, float* dws, int T, int B, int D,
                          void* stream) {
  if (!shape_ok(T, B, D)) return static_cast<int>(cudaErrorInvalidValue);
  return dw_product(hs, dxs, s_all, dwg, dwg, dws, dws, T, B, D,
                    static_cast<cudaStream_t>(stream));
}
"""
# the float32 instances (template arguments <float, float, ...>)
_KERNEL = re.compile(r"gru_(fwd|bwd|dw)_kernel(?=Iff)")


def _ptxas(log):
    """{kernel: {registers, spill_stores}} from ``-Xptxas -v`` output
    (the forward's two instances under one name: the last one read)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _KERNEL.search(m.group(1))
            name = k.group(0) if k else None
            if name == "gru_fwd_kernel":
                name += "_resid" if "ILb1E" in m.group(1) else "_lean"
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
    fwd = lib.gru_fwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    bwd = lib.gru_bwd_f32
    bwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    dw = lib.gru_dw_f32
    dw.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    for fn in (fwd, bwd, dw):
        fn.restype = ctypes.c_int
    return fwd, bwd, dw


def build(names=None):
    """{variant: ((fwd, bwd, dw) typed C entries, ptxas report)} for the
    named variants (every one by default), all nvcc in parallel."""
    with open(os.path.join(_build.CSRC, "gru.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "probe_gru")
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
            [_build._nvcc(), *_build.FLAGS, *_build.F32_PART, "-Xptxas",
             "-v", "-o", f"{path}.so", f"{path}.cu"],
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
    rows, and the calls of a variant's entries on them.  The backward
    takes the plain forward's residuals, so that its check stands
    alone."""

    def __init__(self, dev, rng, t, b, d):
        def tensor(shape, scale):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                                * np.float32(scale), device=dev)
        self.t, self.b, self.d = t, b, d
        self.xs = tensor((t, b, 3 * d), 0.3)
        self.w_gate = tensor((d, 2 * d), 0.1)
        self.w_state = tensor((d, d), 0.1)
        self.mask = torch.ones(t, b, device=dev)
        self.dh_out = tensor((t, b, d), 1.0)
        self.ref = gk.gru_fwd_plain(self.xs, self.mask, self.w_gate,
                                    self.w_state, True)
        self.ref_bwd = gk.gru_bwd_plain(self.ref[1], self.ref[0], self.w_gate,
                                        self.w_state, self.mask, self.dh_out)
        self.hs = torch.empty(t, b, d, device=dev)
        self.acts = torch.empty_like(self.xs)
        self.dxs = torch.empty_like(self.xs)
        self.dwg = torch.empty_like(self.w_gate)
        self.dws = torch.empty_like(self.w_state)
        self.scratch = torch.empty(t + 1, b, d, device=dev)
        self.stream = torch.cuda.current_stream().cuda_stream

    def fwd(self, entries):
        _build.check("probe_gru", entries[0](
            *(x.data_ptr() for x in (self.xs, self.mask, self.w_gate,
                                     self.w_state, self.hs, self.hs,
                                     self.acts, self.scratch[1])),
            self.t, self.b, self.d, 1, self.stream))

    def bwd(self, entries):
        _build.check("probe_gru", entries[1](
            *(x.data_ptr() for x in (self.ref[1], self.ref[0], self.w_gate,
                                     self.w_state, self.mask, self.dh_out,
                                     self.dxs, self.dwg, self.dws,
                                     self.scratch[0], self.scratch[1],
                                     self.scratch[2:], self.dxs, self.dwg,
                                     self.dws)),
            self.t, self.b, self.d, self.stream))

    def dw(self, entries):
        """dW alone, on the s_all operand the last ``bwd`` wrote."""
        _build.check("probe_gru", entries[2](
            *(x.data_ptr() for x in (self.ref[0], self.dxs, self.scratch[2:],
                                     self.dwg, self.dws)),
            self.t, self.b, self.d, self.stream))

    def errors(self, entries):
        """hs's and acts' max abs error; dxs's, dW_gate's and dW_state's
        relative to their largest entry."""
        self.fwd(entries)
        self.bwd(entries)
        torch.cuda.synchronize()

        def rel(x, y):
            return float((x - y).abs().max() / y.abs().max())

        return {"hs": float((self.hs - self.ref[0]).abs().max()),
                "acts": float((self.acts - self.ref[1]).abs().max()),
                "dxs_rel": rel(self.dxs, self.ref_bwd[0]),
                "dW_gate_rel": rel(self.dwg, self.ref_bwd[1]),
                "dW_state_rel": rel(self.dws, self.ref_bwd[2])}


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
