"""Where the decode-attention kernels' time goes on the card.

    python -m paddle_tpu_torch.scripts.probe_decode [--parent REV_OR_DIR]
        [--rounds N]

Builds variants of ``csrc/decode_attention.cu`` from edited copies of
the source (into ``_build/probe_decode/``, git-ignored), each with
``nvcc -Xptxas -v`` (registers and spills printed), and ``parent``: the
parent's source as it is (``--parent``: a git revision whose copy
``git show`` gives, HEAD by default, or the root of a checkout of it),
whose Tq=1 entries launch the design before the split-KV one
(``attn_kernel``).  Times each by device time alone (calls captured in
a CUDA graph and replayed), the variants interleaved, forward and
reverse order in turn, ``--rounds`` times (each time chip_smoke.py's
``graph_ms``):

  kernel     the source as it is: splits of 128 columns (dh <= 128), 4
             query vectors a CTA (1 where a (row, KV head) has one: a
             Tq=1 kernel at H = Hkv), the
             split's K and V tiles in flight through cp.async
             while q's scores and softmax run, the dot and P.V cut into
             items that fill the CTA, the last CTA of a (row, KV head)
             merging the splits' records in split order
  split32, split64  splits of 32 or 64 columns
  sync       synchronous 16- and 4-byte loads in place of cp.async
  vecs8, vecs2, vecs1  8, 2 or 1 query vectors a CTA (4)
  tq1_vecs4  a Tq=1 kernel at H = Hkv with the chunked kernels' 4
  threads128  128 threads a CTA (256)
  warp_vec   the dot and P.V items left whole (P = G = 1): a decode
             row's scores on 64 threads and its P.V on 16, about one warp
             a vector, as attn_kernel had it
  parent     the parent's source

and, to show where the time goes (their outputs are not computed, so
their errors mean nothing):

  positions  every CTA returns once it has read its row's positions
  loads      every live CTA returns once its split's q, K and V landed
  no_compute the scores, softmax and P.V skipped (loads and the merge
             kept)
  no_merge   a row's CTAs return once their records are written (no
             fence, ticket or merge)

Cases at chip_smoke.py's main path shape (S 8, T 256, D 512, H = Hkv =
8; the paged over its 129-block pool of 16-position blocks,
``paged_tables``): the Tq=1 kernels (one query a row at ``chunk_qpos``'
last positions), slab and paged, float32 and int8, and the float32 slab
one over a long span (T 2048, its longest rows 16 splits of 128); the
chunked float32 slab and paged kernels at ``chunk_qpos``.  For each:
the max abs error against the plain version, whether each int8 instance
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
SOURCE = "paddle_tpu_torch/csrc/decode_attention.cu"
_SPLIT = ("constexpr int split_cols(int width) {\n"
          "  return width <= 128 ? 128 :")
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
    "vecs1": ((_VECS, _VECS.replace("4", "1")),),
    "tq1_vecs4": (("  return K * (H / Hkv) == 1 ? 1 : kVecs;",
                   "  return kVecs;"),),
    "threads128": (("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 128;"),),
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


def parent_source(where):
    """The parent's decode_attention.cu: ``where`` a checkout's root, or
    a git revision of this repository."""
    if os.path.isdir(where):
        with open(os.path.join(where, SOURCE)) as f:
            return f.read()
    return subprocess.run(["git", "show", f"{where}:{SOURCE}"], check=True,
                          capture_output=True, text=True).stdout


def build(names=None, parent=None):
    """{variant: (ctypes library, ptxas report)} for the named variants
    (every one by default) and, given the ``parent`` source, "parent";
    all nvcc in parallel."""
    with open(os.path.join(_build.CSRC, "decode_attention.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "probe_decode")
    os.makedirs(out, exist_ok=True)
    codes = {}
    for name in names or EDITS:
        code = src
        for old, new in EDITS[name]:
            if old not in code:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old.strip()!r}")
            code = code.replace(old, new)
        codes[name] = code
    if parent is not None:
        codes["parent"] = parent
    procs = {}
    for name, code in codes.items():
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
        # entries that take the operand dtypes' bits before the scale
        lib.takes_dts = "int dts, float scale" in codes[name]
        libs[name] = (lib, _ptxas(logs[name]))
    return libs


class Case:
    """One kernel's inputs at one shape, its plain result, and a call of
    a variant's C entry on them (``tq1``: the Tq=1 kernel, one query a
    row at chunk_qpos' last positions; else the chunked one)."""

    def __init__(self, cs, dev, rng, paged, int8, t, tq1):
        s, kk, d, h = 8, cs.CHUNK, cs.D_MODEL, cs.HEADS
        self.paged, self.int8, self.tq1 = paged, int8, tq1
        self.h, self.dh = h, d // h
        qpos_np = cs.chunk_qpos(t)
        if tq1:
            qpos_np = qpos_np[:, -1].copy()
            self.q = torch.tensor(cs.normal(rng, (s, d)), device=dev)
        else:
            self.q = torch.tensor(cs.normal(rng, (s, kk, d)), device=dev)
        self.qpos = torch.tensor(qpos_np, device=dev)
        last = qpos_np if tq1 else qpos_np[:, -1]
        shape = (cs.PAGE_BLOCKS, cs.PAGE_BS, d) if paged else (s, t, d)
        self.span = t
        if paged:
            self.tables = torch.tensor(cs.paged_tables(
                rng, last.astype(np.int64), t // cs.PAGE_BS,
                cs.PAGE_BLOCKS), device=dev)
            self.bs, self.nb_row = cs.PAGE_BS, t // cs.PAGE_BS
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
        plain = {(False, False): dk.decode_attention_slab_chunk_plain,
                 (False, True): dk.decode_attention_slab_plain,
                 (True, False): dk.decode_attention_paged_chunk_plain,
                 (True, True): dk.decode_attention_paged_plain}[paged, tq1]
        args = (self.tables,) if paged else ()
        self.ref = plain(self.q, kw, vw, self.qpos, *args, h)
        self.out = torch.empty_like(self.q)
        self._ops = {}

    def _operands(self, lib):
        """(scratch, tickets) sized by this variant's own split."""
        if id(lib) not in self._ops:
            s = self.q.shape[0]
            kk = 1 if self.tq1 else self.q.shape[1]
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
        """One launch of the variant's entry (``parent``: the parent's
        library, whose Tq=1 entries take no scratch; ``widened``: the
        float32 entry on the dequantized cache)."""
        int8 = self.int8 and not widened
        k, v = (self.kw, self.vw) if widened else (self.k, self.v)
        kind = "paged" if self.paged else "slab"
        name = (f"decode_attention_{kind}{'' if self.tq1 else '_chunk'}_"
                f"{'i8' if int8 else 'f32'}")
        ptrs = [self.q, k, v] + ([self.ks, self.vs] if int8 else []) \
            + [self.qpos] + ([self.tables] if self.paged else []) \
            + [self.out]
        if not (parent and self.tq1):
            ptrs += list(self._operands(lib))
        s = self.q.shape[0]
        ints = [s] + ([] if self.tq1 else [self.q.shape[1]]) \
            + ([self.bs, self.nb_row] if self.paged else [self.span]) \
            + [self.h, self.h, self.dh] + ([0] if lib.takes_dts else [])
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


def main(argv=None):
    import argparse
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="HEAD",
                    help="the parent: a git revision or a checkout's root")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    dev = _device.resolve("cuda")
    libs = build(parent=parent_source(args.parent))
    print(json.dumps({"card": _device.card(), "ptxas": {
        name: rep for name, (_, rep) in libs.items()}}), flush=True)
    rng = np.random.RandomState(0)
    t = cs.SERVE_MAX_LEN
    cases = {
        "tq1_slab_f32": Case(cs, dev, rng, False, False, t, True),
        "tq1_slab_i8": Case(cs, dev, rng, False, True, t, True),
        "tq1_paged_f32": Case(cs, dev, rng, True, False, t, True),
        "tq1_paged_i8": Case(cs, dev, rng, True, True, t, True),
        f"tq1_slab_f32_T{LONG_T}": Case(cs, dev, rng, False, False, LONG_T,
                                         True),
        "chunk_slab_f32": Case(cs, dev, rng, False, False, t, False),
        "chunk_paged_f32": Case(cs, dev, rng, True, False, t, False)}
    runs = [(name, lib, name == "parent") for name, (lib, _) in libs.items()]
    errs = {name: {c: case.error(lib, parent)
                   for c, case in cases.items()}
            for name, lib, parent in runs}
    graphs = {}
    for name, lib, parent in runs:
        for c, case in cases.items():
            graphs[name, c] = (lambda case=case, lib=lib, parent=parent:
                               case.call(lib, parent))
    times = {key: [] for key in graphs}
    for r in range(args.rounds):
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
