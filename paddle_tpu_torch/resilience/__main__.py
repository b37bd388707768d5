"""Chaos smoke CLI (``paddle_tpu/resilience/__main__.py``).

    python -m paddle_tpu_torch.resilience --smoke [--device cpu]

Two chaos legs at smoke scale, on the card unless ``--device cpu``, ONE
JSON line, nonzero rc on any failed check (the same contract as the
serving smokes):

1. SERVING under an injected decode-step fault: a tiny generation server
   (HTTP, supervised; JAX's demo LM trunk over the prefill ladder,
   weights from seed 0) first serves every prompt cleanly (greedy
   decode is deterministic — those token lists are the oracle), then
   re-serves them concurrently with a deterministic
   ``serving.decode_step`` fault installed.  The fault must fire, every
   stream must finish BIT-IDENTICAL to its clean run (slot re-prefill
   recovery), and /metrics must report the fault + recovery counters.

2. TRAINING kill -9 + resume: a subprocess victim
   (``--train-victim DIR``, deterministic tiny trainer) SIGKILLs itself
   mid-pass; the parent then resumes with ``train(resume=True)`` and
   asserts the final parameters are bit-identical to an uninterrupted
   run — with any partial ``.tmp-`` checkpoint dir left by the kill
   never picked up.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.resilience import Supervisor, faults
from paddle_tpu_torch.utils.logging import logger


# ------------------------------------------------------------ serving leg


def _chaos_serving(errs, device=None):
    import urllib.request
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.serving import ServingMetrics, make_server
    from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                        GenerationBatcher)

    params = transformer.init_lm(torch.Generator().manual_seed(0), 256, 32,
                                 2, 64, 2, 48, device=device)
    engine = DecodeEngine(params, num_heads=2, num_slots=4, max_len=48,
                          prefill_chunk=0, prefill_buckets=(8, 16),
                          name="chaos_lm", device=device)
    sup = Supervisor(step_deadline_s=2.0, breaker_threshold=5)
    gen = GenerationBatcher(engine, default_max_tokens=8, supervisor=sup)
    httpd = make_server(None, port=0, gen_batcher=gen)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.port}"
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, 3 + 2 * i).tolist() for i in range(6)]

    def post(body):
        req = urllib.request.Request(
            f"{base}/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    out = {"serving_ok": False, "bit_identical": False,
           "faults_fired": 0, "reprefills": 0}
    try:
        # clean pass: greedy determinism makes these the oracle
        ref = [post({"prompt": p, "max_tokens": 8})["tokens"]
               for p in prompts]
        # chaos pass: deterministic mid-flight decode-step fault
        engine.metrics = gen.metrics = ServingMetrics()
        faults.install_spec("serving.decode_step:at=5")
        results = [None] * len(prompts)

        def hit(i):
            try:
                time.sleep(0.004 * i)   # staggered: admissions mid-decode
                results[i] = post({"prompt": prompts[i], "max_tokens": 8})
            except Exception as e:      # noqa: BLE001
                errs.append(f"chaos generate: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        fired = faults.fired_counts().get("serving.decode_step", 0)
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            mtext = r.read().decode()
        faults.clear()
        snap = engine.metrics.snapshot()
        out.update(
            serving_ok=all(r is not None for r in results),
            bit_identical=all(r is not None and r["tokens"] == ref[i]
                              for i, r in enumerate(results)),
            faults_fired=fired,
            reprefills=snap["slot_reprefills_total"],
            metrics_sane='fault_injections_total{'
                         'point="serving.decode_step"}' in mtext
                         and snap["slot_reprefills_total"] >= 1)
    except Exception as e:      # noqa: BLE001 — a leg failure must become
        errs.append(f"serving leg: {type(e).__name__}: {e}")
    finally:
        faults.clear()
        httpd.shutdown()
        httpd.server_close()
        gen.close()
    return out


# ------------------------------------------------------------ training leg


def _build_trainer(device=None):
    """Deterministic tiny classifier trainer — shared by the victim
    subprocess and the parent's resume/uninterrupted runs, so all three
    see identical topology, seed, and per-pass batches."""
    import paddle_tpu_torch.optim as optim
    from paddle_tpu_torch.data.provider import dense_vector, integer_value
    from paddle_tpu_torch.layers import api as L
    from paddle_tpu_torch.layers.graph import reset_names
    from paddle_tpu_torch.trainer.trainer import SGD
    reset_names()
    x = L.data_layer("chaos_x", size=4)
    lab = L.data_layer("chaos_lab", size=1)
    h = L.fc_layer(input=x, size=8, act="tanh")
    y = L.fc_layer(input=h, size=2, act="softmax")
    cost = L.classification_cost(y, lab)
    trainer = SGD(cost=cost,
                  update_equation=optim.Momentum(learning_rate=0.1,
                                                 momentum=0.9),
                  seed=7, device=device)
    feeding = {"chaos_x": dense_vector(4), "chaos_lab": integer_value(2)}

    def reader():
        rng = np.random.RandomState(0)      # fresh per pass: every pass
        xs = rng.randn(24, 4).astype(np.float32)   # sees the same batches
        ys = (xs[:, 0] > 0).astype(np.int64)
        for i in range(0, 24, 8):
            yield [(xs[j], int(ys[j])) for j in range(i, i + 8)]

    return trainer, feeding, reader


def _victim_main(save_dir, device=None):
    """Train 3 passes, checkpointing each — and SIGKILL ourselves mid
    pass 2, after the pass-1 checkpoint landed (kill -9: no atexit, no
    cleanup, exactly the crash the atomic writer must survive)."""
    from paddle_tpu_torch.trainer import checkpoint, events
    trainer, feeding, reader = _build_trainer(device)

    def handler(e):
        if isinstance(e, events.EndIteration) and e.pass_id == 2 \
                and e.batch_id == 1:
            checkpoint.wait_pending()       # pass-1's async save is real
            os.kill(os.getpid(), signal.SIGKILL)

    trainer.train(reader, num_passes=3, feeding=feeding,
                  event_handler=handler, log_period=0, buffered_batches=0,
                  save_dir=save_dir)
    return 1        # unreachable when the kill lands — rc 1 flags it


def _chaos_train(errs, device=None):
    from paddle_tpu_torch.utils.tree import tree_leaves
    out = {"victim_killed": False, "resume_bit_identical": False}
    tmp = tempfile.mkdtemp(prefix="chaos_resume_")
    save_dir = os.path.join(tmp, "ckpt")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.resilience",
             "--train-victim", save_dir]
            + (["--device", str(device)] if device is not None else []),
            capture_output=True, text=True, timeout=600)
        out["victim_killed"] = proc.returncode in (-signal.SIGKILL, 137)
        if not out["victim_killed"]:
            errs.append(f"victim rc={proc.returncode}: "
                        f"{proc.stderr[-500:]}")
        complete = sorted(d for d in os.listdir(save_dir)
                          if d.startswith("pass-"))
        out["complete_passes"] = complete

        # resume: latest complete pass -> bit-identical final params
        trainer, feeding, reader = _build_trainer(device)
        trainer.train(reader, num_passes=3, feeding=feeding, log_period=0,
                      buffered_batches=0, save_dir=save_dir, resume=True)
        clean, feeding, reader = _build_trainer(device)
        clean.train(reader, num_passes=3, feeding=feeding, log_period=0,
                    buffered_batches=0)
        leaves_r = tree_leaves(trainer.parameters)
        leaves_c = tree_leaves(clean.parameters)
        out["resume_bit_identical"] = (
            len(leaves_r) == len(leaves_c)
            and all(torch.equal(a, b) for a, b in zip(leaves_r, leaves_c)))
    except Exception as e:      # noqa: BLE001
        errs.append(f"training leg: {type(e).__name__}: {e}")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------------- CLI


def _smoke(device=None):
    errs = []
    serving = _chaos_serving(errs, device)
    training = _chaos_train(errs, device)
    checks = [
        bool(serving.get("serving_ok")),
        bool(serving.get("bit_identical")) and serving.get("faults_fired",
                                                           0) >= 1
        and bool(serving.get("metrics_sane")),
        bool(training.get("victim_killed")),
        bool(training.get("resume_bit_identical")),
    ]
    out = {
        "metric": "chaos smoke (fault injection + supervised recovery)",
        "value": sum(checks), "unit": f"checks_ok/{len(checks)}",
        "vs_baseline": None,
    }
    out.update(serving)
    out.update(training)
    if errs:
        out["errors"] = errs[:5]
    print(json.dumps(out), flush=True)
    return 0 if all(checks) else 2


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.resilience",
        description="chaos smoke: fault injection + supervised recovery")
    ap.add_argument("--smoke", action="store_true",
                    help="run both chaos legs, print one JSON line, exit")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--train-victim", metavar="SAVE_DIR",
                    help="(internal) train + SIGKILL self mid-pass")
    args = ap.parse_args(argv)
    if args.train_victim:
        return _victim_main(args.train_victim, args.device)
    if args.smoke:
        return _smoke(args.device)
    ap.error("pass --smoke (or the internal --train-victim)")


if __name__ == "__main__":
    logger.setLevel("WARNING")
    sys.exit(main())
