"""Where the serving step's time goes on the card.

    python -m paddle_tpu_torch.scripts.profile_step [--seed N] [--steps N]
        [--kv-layout slab|paged] [--kv-dtype float32|int8] [--ladder]
        [--quant-weights] [--speculate-k K [--draft-layers N]]

Builds the full-width Transformer-base trunk (vocab 32000, d_model 512,
8 heads, dff 2048, 6 layers; random weights from --seed) behind the
serving engine's step (8 slots, max_len 256, chunk K = 8) and runs the
step on a fixed slot mix: six decode rows spread over the cache and two
rows ingesting full 8-token prompt chunks.  On the paged layout (block
size 16, the slab-equivalent pool of 129 blocks) each slot holds a
private chain covering its positions, and a step is the engine's
``prepare_step`` (the host's block provisioning) plus the step with its
block tables uploaded.  ``--kv-dtype int8`` runs the same step over an
int8 KV cache (the int8 kernels; the paged auto pool then has 257
blocks).  ``--ladder`` runs the legacy ladder's step instead
(``prefill_chunk=0``: one token a slot through the Tq=1 kernels), all
eight slots decode rows at the mix's positions.  ``--quant-weights``
serves the trunk's int8 weights (``quant/weights.quantize_lm``: each
step dequantizes them).  ``--speculate-k K`` makes each step a
speculating one: the draft (the target's first ``--draft-layers``
blocks, default 2) ingests each decode row's last token and rolls K
drafts out (``DecodeEngine.speculate``: one chunk and K - 1 Tq=1 passes
of the draft, ending in the drafts' copy to the host), then the target
verifies every lane (``all_lanes``); the prompt rows' chunk feeds the
draft too.  Prints one JSON line with,
per step: the host wall time (the step ends in its one host sync), the
device time between two CUDA events around it, the device time the
profiler attributes to kernels, the device's idle share (1 - kernel
time / wall time), and the kernels with the most device time.  Needs a
CUDA device.
"""

import argparse
import glob
import json
import os
import re
import time

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.quant.weights import quantize_lm
from paddle_tpu_torch.serving.server import BASE_LM
from paddle_tpu_torch.serving.decode_engine import DecodeEngine
from paddle_tpu_torch.serving.speculative import make_draft

SLOTS, MAX_LEN, CHUNK, BLOCK_SIZE = 8, 256, 8, 16


def slot_mix():
    """(tokens [S, K], positions [S], lengths [S]) for the fixed mix."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(3, BASE_LM["vocab"], (SLOTS, CHUNK)).astype(np.int32)
    pos = np.asarray([40, 70, 100, 130, 160, 200, 16, 120], np.int32)
    lens = np.asarray([1, 1, 1, 1, 1, 1, CHUNK, CHUNK], np.int32)
    return tokens, pos, lens


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")


def port_kernels():
    """The names of the port's kernels: every ``__global__`` function
    in ``csrc/*.cu``."""
    names = set()
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return names


# the profiler's name of a kernel in csrc/*.cu, each in a top-level
# anonymous namespace (a template's name carries "void " and its
# arguments, a plain function's starts at the namespace); PyTorch's own
# kernels sit in namespaces of their own
_ANON = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def _is_port(key, names):
    m = _ANON.match(key)
    return m is not None and m.group(1) in names


def measure(step, steps):
    """Per-step timings of ``step()`` (already warmed up) over ``steps``
    calls, each ending in a synchronize: host wall p50/p99, device time
    between CUDA events, and — from a second, profiled run — the kernel
    time and launches by name, the kernel time by origin (the port's
    own kernels, ``port_kernels()``; the library's matrix products; the
    rest) and the device's idle share."""
    walls, device_ms = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))

    # device activity only: kernel times per name (the profiler's own
    # host cost inflates the wall clock, so the idle share below is taken
    # against the unprofiled step wall time)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        t = evt.self_device_time_total
        if t > 0 and getattr(evt, "device_type", None) \
                == torch.autograd.DeviceType.CUDA:
            kernels.append((t / 1e3 / steps, evt.count / steps, evt.key))
    kernels.sort(reverse=True)
    busy = sum(t for t, _, _ in kernels)
    wall = float(np.median(walls))
    by_origin = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    names = port_kernels()
    for t, _, key in kernels:
        # cuBLAS names its Hopper bf16 products nvjet_*
        gemm = "gemm" in key or key.startswith("nvjet")
        by_origin["port_kernels" if _is_port(key, names)
                  else "gemm" if gemm else "other"] += t
    return {
        "card": _device.card(), "steps": steps,
        "step_wall_ms": {"p50": wall,
                         "p99": float(np.percentile(walls, 99))},
        "step_event_ms_p50": float(np.median(device_ms)),
        "kernel_ms_per_step": busy,
        "kernel_launches_per_step": sum(n for _, n, _ in kernels),
        "device_idle_share": 1.0 - busy / wall,
        "top_kernels": [{"ms_per_step": t, "launches_per_step": n,
                         "name": k[:80]} for t, n, k in kernels[:14]],
        "kernel_ms_per_step_by_origin": by_origin,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--kv-layout", default="slab", choices=("slab", "paged"))
    ap.add_argument("--kv-dtype", default="float32",
                    choices=("float32", "int8"))
    ap.add_argument("--ladder", action="store_true",
                    help="the ladder's Tq=1 step (prefill_chunk=0)")
    ap.add_argument("--quant-weights", action="store_true",
                    help="serve the trunk's int8 weights")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="draft lanes a decode row (0 = no speculation)")
    ap.add_argument("--draft-layers", type=int, default=2)
    args = ap.parse_args(argv)
    if args.speculate_k and args.ladder:
        ap.error("--speculate-k needs the chunked step (drop --ladder)")
    dev = _device.resolve("cuda")
    params = transformer.init_lm(
        torch.Generator().manual_seed(args.seed), BASE_LM["vocab"],
        BASE_LM["d_model"], BASE_LM["num_heads"], BASE_LM["dff"],
        BASE_LM["layers"], MAX_LEN, device=dev)
    if args.quant_weights:
        params = quantize_lm(params)
    spec = args.speculate_k
    engine = DecodeEngine(params, num_heads=BASE_LM["num_heads"],
                          num_slots=SLOTS, max_len=MAX_LEN,
                          prefill_chunk=0 if args.ladder else CHUNK,
                          kv_layout=args.kv_layout,
                          kv_block_size=BLOCK_SIZE, kv_dtype=args.kv_dtype,
                          speculate_k=spec,
                          draft=(make_draft(params, args.draft_layers)
                                 if spec else None),
                          device=dev)
    tokens, pos, lens = slot_mix()
    if args.ladder:             # one token a slot, no lanes
        tokens, lens = tokens[:, 0].copy(), np.ones(SLOTS, np.int32)
    # every slot active at the mix's positions (paged: a private chain
    # covering the positions this step writes)
    engine._free = []
    engine._pos[:] = pos
    if not args.ladder:         # the ladder's engine keeps no lengths
        engine._len[:] = lens
    if engine._paged is not None:
        for slot in range(SLOTS):
            engine._paged.seat_fresh(slot, int(pos[slot] + lens[slot]))

    decode_rows = [s for s in range(SLOTS) if lens[s] == 1]

    def step():
        engine.prepare_step()
        engine._run(tokens, pos, None if args.ladder else lens)

    def spec_step():
        # the same mix each step: a decode row's draft feed is its last
        # committed token, a prompt row's its chunk
        engine._tokens[:] = 0
        engine._tokens[:, :CHUNK] = tokens
        engine._len[:] = lens
        for slot in range(SLOTS):
            engine._d_pos[slot] = pos[slot]
            engine._d_feed[slot] = tokens[slot, :lens[slot]].tolist()
        engine.speculate({slot: MAX_LEN for slot in decode_rows})
        engine.prepare_step()
        engine._run(engine._tokens, pos, engine._len)

    if spec:
        step = spec_step

    for _ in range(10):
        step()
    print(json.dumps({
        "slots": SLOTS, "max_len": MAX_LEN,
        "chunk": 0 if args.ladder else CHUNK,
        "kv_layout": args.kv_layout, "kv_dtype": args.kv_dtype,
        "quant_weights": args.quant_weights, "speculate_k": spec,
        **({"draft_layers": args.draft_layers} if spec else {}),
        "mix": ("8 decode rows (the ladder's Tq=1 step)" if args.ladder
                else "6 decode rows + 2 rows of 8 prompt lanes"
                + (f", each decode row verifying {spec} draft lanes"
                   if spec else "")),
        **measure(step, args.steps),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
