"""Where the chunked decode-attention kernels' time goes on the card.

    python -m paddle_tpu_torch.scripts.probe_decode

Builds variants of ``csrc/decode_attention.cu`` from edited copies of
the source (into ``_build/probe_decode/``, git-ignored), each with
``nvcc -Xptxas -v`` (registers and spills printed) and with four more C
entries appended, ``parent_{slab,paged}_chunk_{f32,i8}``, which launch
the Tq=1 template ``attn_kernel`` at K lanes: the chunked kernels'
design before the split-KV one.  Times each by device time alone (calls
captured in a CUDA graph and replayed), the variants interleaved,
forward and reverse order in turn, ``ROUNDS`` times (each time
chip_smoke.py's ``graph_ms``):

  kernel     the source as it is: splits of 128 columns (dh <= 128), 4
             query vectors a CTA, the split's K and V tiles in flight
             through cp.async while q's scores and softmax run, the dot
             and P.V cut into items that fill the CTA, the last CTA of a
             (row, KV head) merging the splits' records in split order
  split32, split64  splits of 32 or 64 columns at dh <= 128
  sync       synchronous 16- and 4-byte loads in place of cp.async
  vecs8, vecs2  8 or 2 query vectors a CTA (4): a chunk row's vectors
             over fewer or more CTAs, each reading the split's K and V
  warp_vec   the dot and P.V items left whole (P = G = 1): a decode
             row's scores on 64 threads and its P.V on 16, about one warp
             a vector, as attn_kernel had it
  parent     attn_kernel at K lanes, from the ``kernel`` build

and, to show where the time goes (their outputs are not computed, so
their errors mean nothing):

  positions  every CTA returns once it has read its row's positions
  loads      every live CTA returns once its split's q, K and V landed
  no_compute the scores, softmax and P.V skipped (loads and the merge
             kept)
  no_merge   a row's CTAs return once their records are written (no
             fence, ticket or merge)

Cases: the slab and the paged chunk kernel, float32 and int8, at
chip_smoke.py's main path shape (S 8, K 8, T 256, D 512, H = Hkv = 8,
its ``chunk_qpos`` rows; the paged over its 129-block pool of 16-position
blocks, ``paged_tables``), and the float32 slab kernel over a long span
(T 2048, the same row kinds: its longest rows 16 splits).  For each: the
max abs error against the plain version, whether each int8 instance
equals its float32 instance on the dequantized cache bit for bit, and
the median device ms a call.  One JSON line for the build, one for the
times.  Needs a CUDA device; run from the repository's root.
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
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.quant.kv import dequantize_heads

ROUNDS = 6
LONG_T = 2048
_SPLIT = "return width <= 128 ? 128 : width == 256 ? 32 : 16;"
_VECS = "constexpr int kVecs = 4;"
_CP16 = ("""  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s),
               "l"(src)
               : "memory");""",
         """  (void)s;
  *static_cast<int4*>(dst) = *static_cast<const int4*>(src);""")
_CP4 = ("""  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(s),
               "l"(src)
               : "memory");""",
        """  (void)s;
  *static_cast<int*>(dst) = *static_cast<const int*>(src);""")
EDITS = {
    "kernel": (),
    "split32": ((_SPLIT, _SPLIT.replace("? 128 :", "? 32 :")),),
    "split64": ((_SPLIT, _SPLIT.replace("? 128 :", "? 64 :")),),
    "sync": (_CP16, _CP4),
    "vecs8": ((_VECS, _VECS.replace("4", "8")),),
    "vecs2": ((_VECS, _VECS.replace("4", "2")),),
    "warp_vec": (
        ("  while (2 * P * nin <= kThreads && 2 * P <= kC4) P *= 2;\n", ""),
        ("  while (2 * G * nc <= kThreads && 2 * G <= nin) G *= 2;\n", "")),
    # where the time goes (outputs not computed: their errors mean
    # nothing); -7 is a value the tests never take, so that the compiler
    # keeps what comes before
    "positions": (("  if (split >= nsplit) return;\n",
                   "  if (split >= nsplit || hi != -7) return;\n"),),
    "loads": (("  cp_async_wait<1>();\n  __syncthreads();\n",
               "  cp_async_wait<0>();\n  __syncthreads();\n"
               "  if (nv != -7) return;\n"),),
    "no_compute": (
        ("for (int it = tid; it < nin * P; it += kThreads) {",
         "for (int it = tid; it < 0 * nin * P; it += kThreads) {"),
        ("  if (warp < nv) {\n", "  if (warp < 0) {\n"),
        ("for (int it = tid; it < nc * G; it += kThreads) {",
         "for (int it = tid; it < 0 * nc * G; it += kThreads) {")),
    "no_merge": (("  __syncthreads();\n  if (tid == 0) {\n    __threadfence();",
                  "  if (nv != -7) return;\n  __syncthreads();\n"
                  "  if (tid == 0) {\n    __threadfence();"),),
}
# attn_kernel at K lanes, appended to every variant's source
PARENT_ENTRIES = """
extern "C" int parent_slab_chunk_f32(
    const float* q, const float* k, const float* v, const int* qpos,
    float* out, int S, int K, int T, int H, int Hkv, int dh, float scale,
    void* stream) {
  return launch<false, false>(q, k, v, nullptr, nullptr, qpos, nullptr, out,
                              S, K, T, 1, 1, H, Hkv, dh, scale, stream);
}
extern "C" int parent_slab_chunk_i8(
    const float* q, const int8_t* k, const int8_t* v, const float* ks,
    const float* vs, const int* qpos, float* out, int S, int K, int T, int H,
    int Hkv, int dh, float scale, void* stream) {
  return launch<false, true>(q, k, v, ks, vs, qpos, nullptr, out, S, K, T, 1,
                             1, H, Hkv, dh, scale, stream);
}
extern "C" int parent_paged_chunk_f32(
    const float* q, const float* k, const float* v, const int* qpos,
    const int* tables, float* out, int S, int K, int bs, int nb_row, int H,
    int Hkv, int dh, float scale, void* stream) {
  return launch<true, false>(q, k, v, nullptr, nullptr, qpos, tables, out, S,
                             K, nb_row * bs, bs, nb_row, H, Hkv, dh, scale,
                             stream);
}
extern "C" int parent_paged_chunk_i8(
    const float* q, const int8_t* k, const int8_t* v, const float* ks,
    const float* vs, const int* qpos, const int* tables, float* out, int S,
    int K, int bs, int nb_row, int H, int Hkv, int dh, float scale,
    void* stream) {
  return launch<true, true>(q, k, v, ks, vs, qpos, tables, out, S, K,
                            nb_row * bs, bs, nb_row, H, Hkv, dh, scale,
                            stream);
}
"""
_KERNEL = re.compile(r"(split_kernel|attn_kernel)")


def _ptxas(log):
    """{kernel: {max_registers, spill_stores}} over the instances of
    ``split_kernel`` and ``attn_kernel`` in ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _KERNEL.search(m.group(1))
            name = k.group(0) if k else None
            continue
        if name is None:
            continue
        row = out.setdefault(name, {"max_registers": 0, "spill_stores": 0})
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            row["spill_stores"] += int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["max_registers"] = max(row["max_registers"],
                                       int(m.group(1)))
    return out


def _typed(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build(names=None):
    """{variant: (ctypes library, ptxas report)} for the named variants
    (every one by default), all nvcc in parallel."""
    with open(os.path.join(_build.CSRC, "decode_attention.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "probe_decode")
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
            f.write(code + PARENT_ENTRIES)
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
        libs[name] = (ctypes.CDLL(os.path.join(out, f"{name}.so")),
                      _ptxas(logs[name]))
    return libs


class Case:
    """One kernel's inputs at one shape, its plain result, and a call of
    a variant's C entry on them (the parent's entry takes no scratch)."""

    def __init__(self, cs, dev, rng, paged, int8, t):
        s, kk, d, h = 8, cs.CHUNK, cs.D_MODEL, cs.HEADS
        self.paged, self.int8 = paged, int8
        self.h, self.dh = h, d // h
        qpos_np = cs.chunk_qpos(t)
        self.q = torch.tensor(cs.normal(rng, (s, kk, d)), device=dev)
        self.qpos = torch.tensor(qpos_np, device=dev)
        shape = (cs.PAGE_BLOCKS, cs.PAGE_BS, d) if paged else (s, t, d)
        if paged:
            self.tables = torch.tensor(cs.paged_tables(
                rng, qpos_np[:, -1].astype(np.int64), t // cs.PAGE_BS,
                cs.PAGE_BLOCKS), device=dev)
            self.bs, self.nb_row = cs.PAGE_BS, t // cs.PAGE_BS
            self.span = t
        else:
            self.span = t
        if int8:
            (self.k, self.ks), (self.v, self.vs) = (
                cs.quantized(torch, dev, rng, shape, h) for _ in range(2))
            self.kw = dequantize_heads(self.k, self.ks)
            self.vw = dequantize_heads(self.v, self.vs)
        else:
            self.k, self.v = (torch.tensor(cs.normal(rng, shape), device=dev)
                              for _ in range(2))
        kw = self.kw if int8 else self.k
        vw = self.vw if int8 else self.v
        if paged:
            self.ref = dk.decode_attention_paged_chunk_plain(
                self.q, kw, vw, self.qpos, self.tables, h)
        else:
            self.ref = dk.decode_attention_slab_chunk_plain(
                self.q, kw, vw, self.qpos, h)
        self.out = torch.empty_like(self.q)
        self._ops = {}

    def _operands(self, lib):
        """(scratch, tickets) sized by this variant's own split."""
        if id(lib) not in self._ops:
            s, kk = self.q.shape[:2]
            scr = lib.decode_attention_chunk_scratch
            scr.argtypes = [ctypes.c_int] * 6
            scr.restype = ctypes.c_longlong
            tck = lib.decode_attention_chunk_tickets
            tck.argtypes = [ctypes.c_int] * 4
            tck.restype = ctypes.c_longlong
            n = scr(s, kk, self.span, self.h, self.h, self.dh)
            part = torch.empty(max(n, 1), device=self.q.device)
            tickets = torch.zeros(tck(s, kk, self.h, self.h),
                                  dtype=torch.int32, device=self.q.device)
            self._ops[id(lib)] = (part, tickets)
        return self._ops[id(lib)]

    def call(self, lib, parent=False, widened=False):
        """One launch of the variant's entry (``parent``: attn_kernel at
        K lanes; ``widened``: the float32 entry on the dequantized
        cache)."""
        int8 = self.int8 and not widened
        k, v = (self.kw, self.vw) if widened else (self.k, self.v)
        kind = "paged" if self.paged else "slab"
        suffix = "i8" if int8 else "f32"
        name = (f"parent_{kind}_chunk_{suffix}" if parent
                else f"decode_attention_{kind}_chunk_{suffix}")
        ptrs = [self.q, k, v] + ([self.ks, self.vs] if int8 else []) \
            + [self.qpos] + ([self.tables] if self.paged else []) \
            + [self.out]
        if not parent:
            ptrs += list(self._operands(lib))
        s, kk = self.q.shape[:2]
        ints = [s, kk] + ([self.bs, self.nb_row] if self.paged
                          else [self.span]) + [self.h, self.h, self.dh]
        fn = _typed(lib, name, len(ptrs), len(ints))
        _build.check(name, fn(*(p.data_ptr() for p in ptrs), *ints,
                              1.0 / np.sqrt(self.dh),
                              torch.cuda.current_stream().cuda_stream))

    def error(self, lib, parent=False):
        """(max abs error vs the plain version, int8 == float32 on the
        dequantized cache bit for bit, or None on a float32 case)."""
        self.call(lib, parent)
        torch.cuda.synchronize()
        got = self.out.clone()
        err = float((got - self.ref).abs().max())
        if not self.int8:
            return err, None
        self.call(lib, parent, widened=True)
        torch.cuda.synchronize()
        return err, bool(torch.equal(got, self.out))


def main():
    import chip_smoke as cs
    dev = _device.resolve("cuda")
    libs = build()
    print(json.dumps({"card": _device.card(), "ptxas": {
        name: rep for name, (_, rep) in libs.items()}}), flush=True)
    rng = np.random.RandomState(0)
    cases = {
        "slab_f32": Case(cs, dev, rng, False, False, cs.SERVE_MAX_LEN),
        "slab_i8": Case(cs, dev, rng, False, True, cs.SERVE_MAX_LEN),
        "paged_f32": Case(cs, dev, rng, True, False, cs.SERVE_MAX_LEN),
        "paged_i8": Case(cs, dev, rng, True, True, cs.SERVE_MAX_LEN),
        f"slab_f32_T{LONG_T}": Case(cs, dev, rng, False, False, LONG_T)}
    # (variant, library, parent?) in the order timed
    runs = [(name, lib, False) for name, (lib, _) in libs.items()]
    runs.append(("parent", libs["kernel"][0], True))
    errs = {name: {c: case.error(lib, parent)
                   for c, case in cases.items()}
            for name, lib, parent in runs}
    graphs = {}
    for name, lib, parent in runs:
        for c, case in cases.items():
            graphs[name, c] = (lambda case=case, lib=lib, parent=parent:
                               case.call(lib, parent))
    times = {key: [] for key in graphs}
    for r in range(ROUNDS):
        for name, _, _ in (runs if r % 2 == 0 else runs[::-1]):
            for c in cases:
                times[name, c].append(
                    cs.graph_ms(torch, graphs[name, c], replays=10))
    ms = {name: {c: float(np.median(times[name, c])) for c in cases}
          for name, _, _ in runs}
    print(json.dumps({
        "card": _device.card(), "cases": sorted(cases),
        "max_abs_err": {n: {c: e[0] for c, e in row.items()}
                        for n, row in errs.items()},
        "int8_equals_f32_on_dequantized": {
            n: {c: e[1] for c, e in row.items() if e[1] is not None}
            for n, row in errs.items()},
        "device_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
