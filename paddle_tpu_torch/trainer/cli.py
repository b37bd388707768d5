"""CLI driver: ``python -m paddle_tpu_torch
train|test|time|checkgrad|merge_model|version``
(``paddle_tpu/trainer/cli.py``; reference trainer/TrainerMain.cpp).

Usage:
  python -m paddle_tpu_torch train --config my_config.py [--num_passes N]
       [--save_dir DIR] [--config_args k=v,...] [--device cpu|cuda]
       [--dtype auto|float32|bfloat16] [--quant-train]
       [--grad_accum_steps N] [--prefetch N]
  python -m paddle_tpu_torch test --config my_config.py --model_dir DIR
  python -m paddle_tpu_torch time --config my_config.py [--num_batches N]
       [--warmup W]
  python -m paddle_tpu_torch checkgrad --config my_config.py [--eps E]
  python -m paddle_tpu_torch merge_model --model_dir DIR --out model.npz
  python -m paddle_tpu_torch version

The config file is a Python script defining ``get_config()`` returning a
dict, with ``CONFIG_ARGS`` (the parsed ``--config_args``) in its
namespace:
  {"cost": LayerOutput, "optimizer": optim optimizer,
   "train_reader": reader, "test_reader": reader (optional),
   "feeding": {name: InputType}, "save_dir": DIR (optional),
   "evaluators": [EvaluatorSpec] (optional)}
Layers are built with ``paddle_tpu_torch.layers``.  A reference-style
v1 config (``from paddle.trainer_config_helpers import *``,
``settings()``, ``define_py_data_sources2``, ``outputs()``) runs
unchanged through ``compat.parse_config`` / ``config_to_runtime``, with
``--config_args`` read by its ``get_config_arg`` and the dict's
``batch_size`` that of its ``settings()`` (its reader is already
batched).  The job runs on the card unless ``--device cpu``, each job
(``version`` names the device, ``merge_model`` touches none) included.
The JAX CLI's mesh and profiling flags wait for their items; its
``--seq_buckets`` / ``--pad_batch``, which bound XLA's compiled shapes,
have no counterpart in an eager port.  ``--prefetch``
defaults, as JAX's, to ``FLAGS.prefetch_depth`` when
``FLAGS.async_load_data`` (else 0), and ``FLAGS.quant_train`` turns
``--quant-train`` on (``utils/flags``; ``trainer.api.init`` sets them).
``time`` synchronizes the card after each step; ``checkgrad`` exits 1
on a mismatch.  ``--dtype`` is the JAX CLI's: any value but
auto sets the process's compute policy (``core/dtypes.set_policy``),
and bfloat16 also casts the parameters and the feed at the step
boundary (``SGD(compute_dtype=torch.bfloat16)``); the masters, the
optimizer and the checkpoints stay float32.
"""

import argparse
import runpy
import sys
import time


def _load_config(path, config_args):
    """A config script's dict: a native config's ``get_config()``, or a
    reference-style v1 config (``from paddle.trainer_config_helpers
    import *`` with ``settings()`` / ``outputs()``) through the config
    compiler (``compat``), unchanged."""
    with open(path) as f:
        src = f.read()
    if "def get_config" in src:
        # fresh layer-name registry per invocation: a second main() in
        # the same process (train then test) must mint the SAME layer
        # names, or loaded params won't match the rebuilt graph (the
        # compat path resets inside parse_config)
        from paddle_tpu_torch.layers.graph import reset_names
        reset_names()
        ns = runpy.run_path(path, init_globals={"CONFIG_ARGS": config_args})
        if "get_config" in ns:
            return ns["get_config"]()
    from paddle_tpu_torch.compat import config_to_runtime, parse_config
    return config_to_runtime(parse_config(path, config_args))


def _resolve_prefetch(args):
    """--prefetch, defaulting to the FLAGS pair the reference shipped:
    async_load_data (DoubleBuffer on/off) x prefetch_depth."""
    p = getattr(args, "prefetch", None)
    if p is not None:
        return p
    from paddle_tpu_torch.utils.flags import FLAGS
    return FLAGS.prefetch_depth if FLAGS.async_load_data else 0


def _parse_config_args(s):
    out = {}
    if s:
        for kv in s.split(","):
            k, _, v = kv.partition("=")
            out[k.strip()] = v.strip()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = parser.add_subparsers(dest="job", required=True)

    def add_device(p):
        p.add_argument("--device", default=None, choices=["cpu", "cuda"],
                       help="where the job runs (default: the card)")

    def add_common(p):
        p.add_argument("--config", required=True)
        p.add_argument("--config_args", default="",
                       help="k=v,k=v passed to the config script")
        add_device(p)
        p.add_argument("--dtype", default="auto",
                       choices=["auto", "float32", "bfloat16"],
                       help="compute dtype for forward+backward; master "
                            "params and the optimizer stay float32.  auto "
                            "= float32 here (the JAX package's auto picks "
                            "bf16 on a TPU only); bfloat16 computes the "
                            "products in bf16 with a float32 accumulator "
                            "and casts params+feeds at the step boundary")

    t = sub.add_parser("train")
    add_common(t)
    t.add_argument("--num_passes", type=int, default=1)
    t.add_argument("--grad_accum_steps", type=int, default=1,
                   help="sum grads over N micro-batches, apply their mean "
                        "every Nth step (large effective batch in fixed "
                        "memory)")
    t.add_argument("--save_dir", default=None)
    t.add_argument("--saving_period", type=int, default=1)
    t.add_argument("--save_only_one", action="store_true")
    t.add_argument("--start_pass", type=int, default=0,
                   help="load pass START_PASS - 1 of --save_dir before "
                        "training")
    t.add_argument("--log_period", type=int, default=100)
    t.add_argument("--test_period", type=int, default=0)
    t.add_argument("--show_parameter_stats_period", type=int, default=0)
    t.add_argument("--prefetch", type=int, default=None,
                   help="overlapped input pipeline: convert + copy N "
                        "batches ahead on a background thread (0 = off).  "
                        "Default from FLAGS: prefetch_depth when "
                        "async_load_data (the reference DoubleBuffer "
                        "default), else 0")
    t.add_argument("--quant-train", dest="quant_train", action="store_true",
                   help="int8 weight-streaming training (SGD(quant_weights="
                        "True)); checkpoints carry the masters and their "
                        "int8 twin")

    te = sub.add_parser("test")
    add_common(te)
    te.add_argument("--model_dir", required=True)
    te.add_argument("--test_pass", type=int, default=None)

    tm = sub.add_parser("time",
                        help="time the train step (reference --job=time, "
                             "TrainerBenchmark.cpp): warm up, then report "
                             "ms/batch over --num_batches")
    add_common(tm)
    tm.add_argument("--num_batches", type=int, default=20)
    tm.add_argument("--warmup", type=int, default=2)

    cg = sub.add_parser("checkgrad",
                        help="finite-difference gradient check "
                             "(reference --job=checkgrad)")
    cg.add_argument("--config", required=True)
    cg.add_argument("--config_args", default="")
    add_device(cg)
    cg.add_argument("--eps", type=float, default=1e-3)

    m = sub.add_parser("merge_model")
    m.add_argument("--model_dir", required=True)
    m.add_argument("--out", required=True)
    m.add_argument("--pass_id", type=int, default=None)
    add_device(m)

    v = sub.add_parser("version")
    add_device(v)

    args = parser.parse_args(argv)

    from paddle_tpu_torch import device as _device
    dev = _device.resolve(args.device)

    if args.job == "version":
        import torch
        from paddle_tpu_torch.version import __version__
        print(f"paddle_tpu_torch {__version__} (torch {torch.__version__})",
              flush=True)
        print(f"devices: {torch.cuda.get_device_name(dev)}"
              if dev.type == "cuda" else "devices: cpu")
        return 0

    if args.job == "merge_model":
        from paddle_tpu_torch.trainer.checkpoint import merge_model
        print("wrote", merge_model(args.model_dir, args.out, args.pass_id))
        return 0

    cfg = _load_config(args.config, _parse_config_args(args.config_args))

    from paddle_tpu_torch.data.feeder import DataFeeder

    def feeder():
        feeding = cfg.get("feeding")
        if isinstance(feeding, DataFeeder) or not feeding:
            return feeding
        return DataFeeder(feeding, device=dev)

    if args.job == "checkgrad":
        from paddle_tpu_torch.layers.graph import Topology
        from paddle_tpu_torch.testing import check_topology_grads
        batch = next(iter(cfg["train_reader"]()))
        fd = feeder()
        costs = cfg["cost"]
        topo = Topology(costs if isinstance(costs, (list, tuple))
                        else [costs])
        results = check_topology_grads(topo, fd(batch) if fd else batch,
                                       device=dev, eps=args.eps,
                                       raise_on_fail=False)
        bad = False
        for path, err, ok in results:
            print(f"  {path}: max rel err {err:.3g}"
                  + ("" if ok else "  MISMATCH"))
            bad = bad or not ok
        print("checkgrad FAILED" if bad else "checkgrad PASSED")
        return 1 if bad else 0

    import torch

    from paddle_tpu_torch import optim
    from paddle_tpu_torch.trainer.trainer import SGD
    optimizer = cfg.get("optimizer")
    if optimizer is None:
        # the JAX CLI's default (its v1 settings() default)
        optimizer = optim.Momentum(learning_rate=1e-3, momentum=0.0)
    if args.dtype != "auto":
        # the op-level policy; bfloat16 also casts params + feeds at the
        # step boundary through SGD(compute_dtype=...)
        from paddle_tpu_torch.core import dtypes
        dtypes.set_policy(compute_dtype=args.dtype)
    from paddle_tpu_torch.utils.flags import FLAGS
    quant_train = bool(getattr(args, "quant_train", False)
                       or FLAGS.quant_train)
    if quant_train:
        FLAGS.quant_train = True
    trainer = SGD(cost=cfg["cost"], update_equation=optimizer,
                  sharding_rules=cfg.get("sharding_rules"),
                  evaluators=cfg.get("evaluators"),
                  compute_dtype=(torch.bfloat16 if args.dtype == "bfloat16"
                                 else None),
                  grad_accum_steps=getattr(args, "grad_accum_steps", 1),
                  quant_weights=quant_train,
                  device=dev)

    if args.job == "train":
        save_dir = args.save_dir or cfg.get("save_dir")
        if args.start_pass:
            if not save_dir:
                raise SystemExit("--start_pass needs --save_dir (or a "
                                 "save_dir in the config)")
            trainer.load(save_dir, args.start_pass - 1)
        trainer.train(cfg["train_reader"], num_passes=args.num_passes,
                      feeding=feeder(), save_dir=save_dir,
                      saving_period=args.saving_period,
                      save_only_one=args.save_only_one,
                      test_reader=cfg.get("test_reader"),
                      test_period=args.test_period,
                      log_period=args.log_period,
                      show_parameter_stats_period=
                      args.show_parameter_stats_period,
                      prefetch=_resolve_prefetch(args))
        return 0

    if args.job == "test":
        trainer.load(args.model_dir, args.test_pass)
        cost = trainer.test(cfg.get("test_reader") or cfg["train_reader"],
                            feeding=feeder())
        print(f"test cost: {cost:.5f}")
        return 0

    # time
    fd = feeder()
    batches = []
    for b in cfg["train_reader"]():
        batches.append(b)
        if len(batches) >= args.num_batches + args.warmup:
            break
    if len(batches) <= args.warmup:
        print(f"time: need more than --warmup={args.warmup} batches, "
              f"reader yielded {len(batches)}", file=sys.stderr)
        return 2
    durs = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        trainer.train_one_batch(b, feeder=fd)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)     # real step time, not enqueue
        if i >= args.warmup:
            durs.append((time.perf_counter() - t0) * 1e3)
    durs.sort()
    n = len(durs)
    if n < 100:
        # with few samples a "p99" is just the max
        print(f"time: {n} batches  min={durs[0]:.2f}ms  "
              f"mean={sum(durs) / n:.2f}ms  max={durs[-1]:.2f}ms")
    else:
        import numpy as np
        p50, p90, p99 = np.percentile(durs, [50, 90, 99])
        print(f"time: {n} batches  p50={p50:.2f}ms  p90={p90:.2f}ms  "
              f"p99={p99:.2f}ms  mean={sum(durs) / n:.2f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
