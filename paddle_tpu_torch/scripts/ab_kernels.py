"""Time the kernels of two checkouts on one card.

    python -m paddle_tpu_torch.scripts.ab_kernels OTHER_CHECKOUT [ROUNDS]
        [--rnn | --gru]

Runs ``chip_smoke.py``'s kernel checks in a fresh process per run, each
building its checkout's kernels, in the order other, this, this, other,
repeated ROUNDS times (default ``ROUNDS``): kernel times move between
processes on one card, so two checkouts are compared only alternating
within one call.  By default the decode-attention kernels
(``check_decode_kernel`` at H = Hkv, and ``check_paged_kernels`` where
the checkout has it); with ``--rnn`` the simple-RNN forward and backward
(BPTT + dW) at the DSL slice's train shape (``check_rnn_kernels``), with
cuDNN's RNN_TANH timed beside them in the same process (the same
function in both checkouts: its pairs show the call's noise); with
``--gru`` the GRU forward and backward (BPTT + dW) at the seq2seq
encoder's train shape (``gru_pair`` on full rows, timed as
``check_gru_kernels`` times them).  Prints
one JSON line per run with the kernel times in ms (``check_*``'s, which
time the wrappers back to back and so hold the host's launch path too,
and the device time alone, ``graph:``, from calls captured in a CUDA
graph and replayed, of the slab and paged kernels, Tq=1 and chunked,
and of both int8 chunk instances, at chip_smoke.py's main path shapes),
then one summary line: for each kernel
and checkout the median, least and largest time, and the median and
range of the 2 x ROUNDS paired differences this - other (each run of
this beside the run of other next to it).  Needs a CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys

ROUNDS = 5

_RUN = r'''
import json, numpy as np, torch
import chip_smoke as cs
dev, rng = torch.device("cuda"), np.random.RandomState(0)
ms = {"decode_attention_slab_chunk":
      cs.check_decode_kernel(torch, dev, rng, cs.HEADS)["ms"]}
if hasattr(cs, "check_paged_kernels"):
    rows = cs.check_paged_kernels(torch, dev, rng, cs.HEADS)
    ms.update({name: row["ms"] for name, row in rows.items()})

# the slab kernels' device time alone: calls captured in a CUDA graph
# and replayed, so the host's launch path is out of the reading
def graph_ms(fn, calls=20, replays=30):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))

from paddle_tpu_torch.ops.kernels import decode_attention as dk
s, kk, t, d, h = 8, cs.CHUNK, cs.SERVE_MAX_LEN, cs.D_MODEL, cs.HEADS
q = torch.tensor(cs.normal(rng, (s, kk, d)), device=dev)
k, v = (torch.tensor(cs.normal(rng, (s, t, d)), device=dev)
        for _ in range(2))
qpos_np = cs.chunk_qpos(t)
qpos = torch.tensor(qpos_np, device=dev)
q1, pos = q[:, 0].contiguous(), qpos[:, 0].contiguous()
# the paged kernels over chip_smoke's pool; the int8 instances over
# quantized caches of the same shapes
pool = (cs.PAGE_BLOCKS, cs.PAGE_BS, d)
pk, pv = (torch.tensor(cs.normal(rng, pool), device=dev) for _ in range(2))
tables = torch.tensor(cs.paged_tables(rng, qpos_np[:, -1].astype(np.int64),
                                      t // cs.PAGE_BS, cs.PAGE_BLOCKS),
                      device=dev)
(k8, ks8), (v8, vs8) = (cs.quantized(torch, dev, rng, (s, t, d), h)
                        for _ in range(2))
(p8, ps8), (w8, ws8) = (cs.quantized(torch, dev, rng, pool, h)
                        for _ in range(2))
graphs = {
    "decode_attention_slab_chunk":
        lambda: dk.decode_attention_slab_chunk(q, k, v, qpos, h),
    "decode_attention_slab":
        lambda: dk.decode_attention_slab(q1, k, v, pos, h),
    "decode_attention_paged_chunk":
        lambda: dk.decode_attention_paged_chunk(q, pk, pv, qpos, tables, h),
    "decode_attention_paged":
        lambda: dk.decode_attention_paged(q1, pk, pv, pos, tables, h),
    "decode_attention_slab_chunk_int8":
        lambda: dk.decode_attention_slab_chunk(q, k8, v8, qpos, h,
                                               kscale=ks8, vscale=vs8),
    "decode_attention_paged_chunk_int8":
        lambda: dk.decode_attention_paged_chunk(q, p8, w8, qpos, tables, h,
                                                kscale=ps8, vscale=ws8)}
try:
    for name, fn in graphs.items():
        ms[f"graph:{name}"] = graph_ms(fn)
except RuntimeError as e:     # a reading, not the port's path
    ms["graph_error"] = str(e)[:500]
print(json.dumps(ms))
'''

_RUN_RNN = r'''
import json, numpy as np, torch
import chip_smoke as cs
dev, rng = torch.device("cuda"), np.random.RandomState(0)
(fwd, bwd), _ = cs.check_rnn_kernels(torch, dev, rng)
print(json.dumps({"simple_rnn_fwd": fwd["ms"], "simple_rnn_bwd": bwd["ms"],
                  "cudnn_rnn_tanh_fwd": fwd["library_ms"],
                  "cudnn_rnn_tanh_bwd": bwd["library_ms"]}))
'''

_RUN_GRU = r'''
import json, numpy as np, torch
import chip_smoke as cs
dev, rng = torch.device("cuda"), np.random.RandomState(0)
_, calls, _ = cs.gru_pair(torch, dev, rng, cs.GRU_T, cs.GRU_B, cs.GRU_D,
                          False)
print(json.dumps({name: cs.time_ms(torch, call[0], samples=20, reps=5)
                  for name, call in zip(("gru_fwd", "gru_bwd"), calls)}))
'''
_RUNS = {"--rnn": _RUN_RNN, "--gru": _RUN_GRU}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run = next((_RUNS[a] for a in argv if a in _RUNS), _RUN)
    argv = [a for a in argv if a not in _RUNS]
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    rounds = int(argv[1]) if len(argv) == 2 else ROUNDS
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = {"other": os.path.abspath(argv[0]), "this": here}
    runs = []
    for _ in range(rounds):
        for name in ("other", "this", "this", "other"):
            r = subprocess.run([sys.executable, "-c", run], cwd=trees[name],
                               capture_output=True, text=True, timeout=600)
            if r.returncode:
                raise SystemExit(f"{name} ({trees[name]}) failed:\n"
                                 f"{r.stderr[-4000:]}")
            runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps({"checkout": name, "ms": runs[-1]}), flush=True)
    print(json.dumps({"summary": summary(runs)}), flush=True)
    return 0


def summary(runs):
    """Per kernel: each checkout's median / least / largest ms and the
    paired differences this - other, from runs in the order other, this,
    this, other, ... (pairs: runs 4i and 4i+1, runs 4i+2 and 4i+3)."""
    out = {}
    for kernel in (k for k, x in runs[0].items() if isinstance(x, float)):
        sides = {"other": [], "this": []}
        diffs = []
        for i in range(0, len(runs), 4):
            o0, t0, t1, o1 = (run.get(kernel) for run in runs[i:i + 4])
            sides["other"] += [o0, o1]
            sides["this"] += [t0, t1]
            diffs += [t0 - o0, t1 - o1]
        out[kernel] = {
            **{side: {"median": statistics.median(v), "min": min(v),
                      "max": max(v)} for side, v in sides.items()},
            "this_minus_other": {"median": statistics.median(diffs),
                                 "min": min(diffs), "max": max(diffs),
                                 "this_faster": sum(d < 0 for d in diffs),
                                 "pairs": len(diffs)}}
    return out


if __name__ == "__main__":
    raise SystemExit(main())
