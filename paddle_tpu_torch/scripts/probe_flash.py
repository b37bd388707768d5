"""Build report and tile choices of the tensor-core flash kernels.

    python -m paddle_tpu_torch.scripts.probe_flash [--rounds N]

Builds variants of ``csrc/flash_attention.cu`` from edited copies of the
source (into ``_build/probe_flash/``, git-ignored), each with ``nvcc
-Xptxas -v``, and prints what ptxas reports for every kernel instance
(registers, spill stores and loads, stack) beside the dynamic shared
memory a launch takes:

  kernel     the source as it is
  fwd_q128   forward: 8 warps, 128 q rows a CTA (64 as it is)
  fwd_s3     forward: a 3-stage K/V ring (2)
  bwd_q64    dK/dV: 64-row q tiles below dh 128 (32 as it is)
  bwd_s3     dK/dV: a 3-stage q-side ring (2)
  fwd_mb3    forward: registers capped for 3 CTAs an SM below dh 128
             (__launch_bounds__ min blocks; none as it is)
  bwd_mb3    dK/dV: the same
  split5     both parts rounded to TF32 in registers (5 operations an
             element) instead of leaving the low 13 bits to the tensor
             cores, which truncate them (3 operations, as it is)
  chained    each product accumulated in the tensor cores across k-steps
             (as it is: a fresh tile a k-step, added in float32)
  tf32_1x    one TF32 product (a_big b_big), the 3xTF32 terms dropped
  dq_regs    dQ: the warp's q and dO A fragments held in registers (as
             it is: read from the staged tile in shared memory at every
             k-step)
  dq_q32     dQ: 2 warps, 32 q rows a CTA (64 as it is)
  dq_s3      dQ: a 3-stage K/V ring (2)
  dq_mb3     dQ: registers capped for 3 CTAs an SM below dh 128

Then every variant's forward, dK/dV and dQ kernel is held against the
plain versions at the MT train shape (B 32, H 8, T 256, dh 64), causal
and not (forward: max abs err of o and lse; dK/dV and dQ: relative to
the largest entry, dQ's delta too), and timed there and at the prefill
shape (B 32, H 8, T 32, dh 64, causal), the variants interleaved, in
forward and reverse order in turn, ``--rounds`` times, beside
scaled_dot_product_attention's float32 forward and backward (dq, dk, dv)
on the same inputs.  Times are medians in ms.  One JSON line for the
build, one per shape.  Needs a CUDA device.
"""

import argparse
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
from paddle_tpu_torch.ops.kernels import flash_attention as fk

_FRESH = ("  float t[4] = {0.f, 0.f, 0.f, 0.f};\n"
          "  mma_tf32(t, as, bb0, bb1);\n"
          "  mma_tf32(t, ab, bs0, bs1);\n"
          "  mma_tf32(t, ab, bb0, bb1);\n"
          "  d[0] += t[0];\n  d[1] += t[1];\n  d[2] += t[2];\n"
          "  d[3] += t[3];\n")
_SPLIT5 = ("  big = __float_as_uint(x) + 0x1000u;\n"
           "  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));"
           "\n",
           "  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
           "  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u)"
           " & 0xffffe000u;\n")
_LHI = "  const float l_hi = r_hi < Tq ? lse[bh * Tq + r_hi] : 0.f;\n"
_DQ_REGS = (
    (_LHI, _LHI + "  float qa[kD8][4], da[kD8][4];\n"
     "#pragma unroll\n  for (int kk = 0; kk < kD8; ++kk) {\n"
     "    qa[kk][0] = qw[kk * 8];\n    qa[kk][1] = qw[8 * kP + kk * 8];\n"
     "    qa[kk][2] = qw[kk * 8 + 4];\n"
     "    qa[kk][3] = qw[8 * kP + kk * 8 + 4];\n"
     "    da[kk][0] = dw[kk * 8];\n    da[kk][1] = dw[8 * kP + kk * 8];\n"
     "    da[kk][2] = dw[kk * 8 + 4];\n"
     "    da[kk][3] = dw[8 * kP + kk * 8 + 4];\n  }\n"),
    ("      split4(qw[kk * 8], qw[8 * kP + kk * 8], qw[kk * 8 + 4],\n"
     "             qw[8 * kP + kk * 8 + 4], qb_, qs_);\n"
     "      split4(dw[kk * 8], dw[8 * kP + kk * 8], dw[kk * 8 + 4],\n"
     "             dw[8 * kP + kk * 8 + 4], db_, ds_);\n",
     "      split4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], qb_, qs_);\n"
     "      split4(da[kk][0], da[kk][1], da[kk][2], da[kk][3], db_, ds_);\n"))
EDITS = {
    "kernel": (),
    "fwd_q128": (("constexpr int kFwdWarps = 4;",
                  "constexpr int kFwdWarps = 8;"),),
    "fwd_s3": (("constexpr int kFwdStages = 2;",
                "constexpr int kFwdStages = 3;"),),
    "bwd_q64": (("  return 32;\n}", "  return DH >= 128 ? 32 : 64;\n}"),),
    "bwd_s3": (("constexpr int kBwdStages = 2;",
                "constexpr int kBwdStages = 3;"),),
    "fwd_mb3": (("__launch_bounds__(kFwdThreads)",
                 "__launch_bounds__(kFwdThreads, DH >= 128 ? 1 : 3)"),),
    "bwd_mb3": (("__launch_bounds__(kBwdThreads)",
                 "__launch_bounds__(kBwdThreads, DH >= 128 ? 1 : 3)"),),
    "split5": (_SPLIT5,),
    "chained": ((_FRESH, "  mma_tf32(d, as, bb0, bb1);\n"
                 "  mma_tf32(d, ab, bs0, bs1);\n"
                 "  mma_tf32(d, ab, bb0, bb1);\n"),),
    "tf32_1x": (("  mma_tf32(t, as, bb0, bb1);\n"
                 "  mma_tf32(t, ab, bs0, bs1);\n", ""),),
    "dq_regs": _DQ_REGS,
    "dq_q32": (("constexpr int kDqWarps = 4;",
                "constexpr int kDqWarps = 2;"),),
    "dq_s3": (("constexpr int kDqStages = 2;",
               "constexpr int kDqStages = 3;"),),
    "dq_mb3": (("__launch_bounds__(kDqThreads)",
                "__launch_bounds__(kDqThreads, DH >= 128 ? 1 : 3)"),),
}
SHAPES = (("train", 32, 8, 256, 64, False), ("train", 32, 8, 256, 64, True),
          ("prefill", 32, 8, 32, 64, True))
# mangled instance names: the forward's <DH, kInt8, kLow>, the backward
# kernels' <DH, kLow>
_KERNEL = re.compile(
    r"flash_(fwd|bwd_dkv|bwd_dq)(_wide)?_kernelILi(\d+)E(Lb([01])E)?"
    r"(Lb([01])E)?")


def _ptxas(log):
    """{kernel instance: {registers, spill_stores, spill_loads, stack}}
    from ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _KERNEL.search(m.group(1))
            name = None
            if k is not None:
                bools = [b for b in (k.group(5), k.group(7)) if b]
                int8 = k.group(1) == "fwd" and bools[0] == "1"
                name = (f"{k.group(1)}/dh{k.group(3)}"
                        + ("/int8" if int8 else "")
                        + ("/bf16" if bools[-1] == "1" else ""))
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def build(names=None):
    """{variant: (CDLL, ptxas report)} for the named variants (every one
    by default), all nvcc in parallel."""
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "probe_flash")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names or EDITS:
        code = src
        for old, new in EDITS[name]:
            if old not in code:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            code = code.replace(old, new)
        path = os.path.join(out, name)
        with open(f"{path}.cu", "w") as f:
            f.write(code)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, *_build.F32_PART, "-Xptxas",
             "-v", "-o", f"{path}.so", f"{path}.cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    logs = {name: proc.communicate()[0].decode(errors="replace")
            for name, proc in procs.items()}     # every nvcc ends first
    for name, proc in procs.items():
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    return {name: (ctypes.CDLL(os.path.join(out, f"{name}.so")),
                   _ptxas(logs[name])) for name in procs}


def entries(lib):
    """(forward, dK/dV, dQ, shared-memory bytes) entries of one
    library."""
    fwd, dkv = lib.flash_attention_fwd_f32, lib.flash_attention_bwd_dkv_f32
    dq = lib.flash_attention_bwd_dq_f32
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + tail
    dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + tail
    dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + tail
    smem = lib.flash_attention_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    return fwd, dkv, dq, smem


def timed(fn, reps=10):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    dev = _device.resolve("cuda")
    libs = build()
    calls = {name: entries(lib) for name, (lib, _) in libs.items()}
    print(json.dumps({
        "card": _device.card(),
        "ptxas": {name: rep for name, (_, rep) in libs.items()},
        "dynamic_smem_bytes": {
            name: {f"{kind}/dh{dh}": smem(which, dh)
                   for which, kind in ((0, "fwd"), (1, "bwd_dkv"),
                                       (2, "bwd_dq"))
                   for dh in (16, 32, 64, 128, 256, 384, 512)}
            for name, (_, _, _, smem) in calls.items()}}), flush=True)

    rng = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for what, b, h, t, dh, causal in SHAPES:
        q, k, v, do = (torch.tensor(rng.standard_normal((b, h, t, dh))
                                    .astype(np.float32), device=dev)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(dh)
        o_ref, lse_ref = fk.flash_attention_plain(q, k, v, scale, causal)
        delta = (do * o_ref).sum(-1)
        dq_ref, dk_ref, dv_ref = fk.flash_attention_bwd_plain(
            q, k, v, o_ref, lse_ref, do, scale, causal)
        o, lse = torch.empty_like(q), torch.empty_like(lse_ref)
        dk, dv, dq = torch.empty_like(k), torch.empty_like(v), \
            torch.empty_like(q)
        dl = torch.empty_like(delta)

        def fwd_call(fn):
            _build.check("probe_flash", fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b * h, t, t, dh, scale, int(causal), stream))

        def dkv_call(fn):
            _build.check("probe_flash", fn(
                *(x.data_ptr() for x in (q, k, v, do, lse_ref, delta, dk,
                                         dv)),
                b * h, t, t, dh, scale, int(causal), stream))

        def dq_call(fn):
            _build.check("probe_flash", fn(
                *(x.data_ptr() for x in (q, k, v, do, o_ref, lse_ref, dl,
                                         dq)),
                b * h, t, t, dh, scale, int(causal), stream))

        errs = {}
        fns = {}
        for name, (fwd, dkv, dqf, _) in calls.items():
            fwd_call(fwd)
            dkv_call(dkv)
            dq_call(dqf)
            torch.cuda.synchronize()
            errs[name] = {
                "fwd_max_abs_err": max(float((o - o_ref).abs().max()),
                                       float((lse - lse_ref).abs().max())),
                "dkv_rel_err": max(
                    float((dk - dk_ref).abs().max() / dk_ref.abs().max()),
                    float((dv - dv_ref).abs().max() / dv_ref.abs().max())),
                "dq_rel_err": max(
                    float((dq - dq_ref).abs().max() / dq_ref.abs().max()),
                    float((dl - delta).abs().max() / delta.abs().max()))}
            fns[f"{name}/fwd"] = (lambda f=fwd: fwd_call(f))
            if what == "train":
                fns[f"{name}/dkv"] = (lambda f=dkv: dkv_call(f))
                fns[f"{name}/dq"] = (lambda f=dqf: dq_call(f))
        fns["sdpa/fwd"] = lambda: sdpa(q, k, v, is_causal=causal)
        if what == "train":
            qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
            out = sdpa(qg, kg, vg, is_causal=causal)
            fns["sdpa/bwd"] = lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True)
        for fn in fns.values():             # warm-up
            fn()
        torch.cuda.synchronize()
        times = {name: [] for name in fns}
        order = list(fns)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(timed(fns[name]))
        print(json.dumps({
            "card": _device.card(), "shape": {
                "what": what, "B": b, "H": h, "T": t, "dh": dh,
                "causal": causal},
            "errors": errs,
            "ms": {n: float(np.median(v)) if v else None
                   for n, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
