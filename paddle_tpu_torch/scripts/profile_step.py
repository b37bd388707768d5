"""Where the serving step's time goes on the card.

    python -m paddle_tpu_torch.scripts.profile_step [--seed N] [--steps N]
        [--kv-layout slab|paged] [--kv-dtype float32|int8]

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
blocks).  Prints one JSON line with,
per step: the host wall time (the step ends in its one host sync), the
device time between two CUDA events around it, the device time the
profiler attributes to kernels, the device's idle share (1 - kernel
time / wall time), and the kernels with the most device time.  Needs a
CUDA device.
"""

import argparse
import json
import time

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.serving.server import BASE_LM
from paddle_tpu_torch.serving.decode_engine import DecodeEngine

SLOTS, MAX_LEN, CHUNK, BLOCK_SIZE = 8, 256, 8, 16


def slot_mix():
    """(tokens [S, K], positions [S], lengths [S]) for the fixed mix."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(3, BASE_LM["vocab"], (SLOTS, CHUNK)).astype(np.int32)
    pos = np.asarray([40, 70, 100, 130, 160, 200, 16, 120], np.int32)
    lens = np.asarray([1, 1, 1, 1, 1, 1, CHUNK, CHUNK], np.int32)
    return tokens, pos, lens


def measure(step, steps):
    """Per-step timings of ``step()`` (already warmed up) over ``steps``
    calls, each ending in a synchronize: host wall p50/p99, device time
    between CUDA events, and — from a second, profiled run — the kernel
    time and launches by name and the device's idle share."""
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
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--kv-layout", default="slab", choices=("slab", "paged"))
    ap.add_argument("--kv-dtype", default="float32",
                    choices=("float32", "int8"))
    args = ap.parse_args(argv)
    dev = _device.resolve("cuda")
    params = transformer.init_lm(
        torch.Generator().manual_seed(args.seed), BASE_LM["vocab"],
        BASE_LM["d_model"], BASE_LM["num_heads"], BASE_LM["dff"],
        BASE_LM["layers"], MAX_LEN, device=dev)
    engine = DecodeEngine(params, num_heads=BASE_LM["num_heads"],
                          num_slots=SLOTS, max_len=MAX_LEN,
                          prefill_chunk=CHUNK, kv_layout=args.kv_layout,
                          kv_block_size=BLOCK_SIZE, kv_dtype=args.kv_dtype,
                          device=dev)
    tokens, pos, lens = slot_mix()
    # every slot active at the mix's positions (paged: a private chain
    # covering the positions this step writes)
    engine._free = []
    engine._pos[:] = pos
    engine._len[:] = lens
    if engine._paged is not None:
        for slot in range(SLOTS):
            engine._paged.seat_fresh(slot, int(pos[slot] + lens[slot]))

    def step():
        engine.prepare_step()
        engine._run(tokens, pos, lens)

    for _ in range(10):
        step()
    print(json.dumps({
        "slots": SLOTS, "max_len": MAX_LEN, "chunk": CHUNK,
        "kv_layout": args.kv_layout, "kv_dtype": args.kv_dtype,
        "mix": "6 decode rows + 2 rows of 8 prompt lanes",
        **measure(step, args.steps),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
