"""Where a train step's (or a beam decode's) time goes on the card.

    python -m paddle_tpu_torch.scripts.profile_train \
        [--model lstm|transformer|transformer_packed|transformer_moe|
                 seq2seq|rnn|transformer_decode|resnet50|srl|tagging|
                 quick_start_cnn|word2vec|word2vec_softmax|seqtoseq_demo]
        [--hidden 512|1280|2048] [--remat] [--dtype auto|float32|bfloat16]

Builds ``scripts/bench.bench_lstm`` at the reference config (vocab 30000,
embedding 128, 2 x LSTM h=512 or ``--hidden``, batch 64, length 100,
Momentum; the default), ``scripts/bench.bench_transformer`` at the bench's config
(vocab 32000, d_model 512, 8 heads, dff 2048, 6+6 layers, batch 32,
length 256, Adam, full_seq), ``scripts/bench.bench_transformer_packed``
(the decoder-only trunk, 6 layers of the same widths, B 16 packed rows
of 512 slots, Adam), ``scripts/bench.bench_transformer_moe`` (that
trunk with 8-expert top-2 FFNs, B 16, T 512), ``--remat`` recomputing
the transformer models' blocks in the backward,
``scripts/bench.bench_seq2seq`` (vocab 30000, emb = h = att 512, batch 64, lengths 30 / 30, Momentum) or
``scripts/bench.bench_rnn`` (``models/text_rnn``'s DSL config through
``trainer.SGD``: 2 x vanilla RNN h=512, batch 64, length 100, a new
batch each step, the feed included) and runs its train step: WARMUP
steps, then STEPS measured ones.  Prints one JSON line with, per step: the host wall time (each
step ends in a synchronize), the device time between two CUDA events
around it, the device time the profiler attributes to kernels, the
device's idle share (1 - kernel time / wall time), the kernels with the
most device time, and the kernel time by origin: the port's kernels
(the LSTM kernels, resident or gate-blocked by the hidden size; the
flash kernels for the transformer; the GRU kernels for seq2seq),
the library's matrix products and the rest (``profile_step.measure``);
for ``rnn`` also the step's split into feed, forward, backward and
update (``bench.step_split``).  ``transformer_decode`` profiles one
beam decode of ``scripts/bench.bench_transformer_decode`` (the MT
model's KV-cached ``generate_cached``: batch 32, sources of 128 tokens,
128 steps, beam 4) as its "step", and adds the launches and kernel time
per decoded position.  ``--dtype`` sets the compute policy
(``core/dtypes.set_policy``); with ``bfloat16`` the rnn model's
``SGD`` also casts at the step boundary (``compute_dtype``), as the
trainer CLI's ``--dtype bfloat16`` does.  ``resnet50`` profiles
``scripts/bench.bench_resnet50`` (batch 32, 224x224x3, 1000 classes,
Momentum lr 0.1, remat by ``--remat`` or off) and adds the kernel
time by group (``image_group``: cuDNN's convolutions, matrix products,
reductions -- batch norm's statistics and the pools' means --,
pooling, elementwise -- batch norm's normalization, ReLU, the residual
sums and the optimizer's update -- and the rest) and the step's split
into forward, backward and update (``bench.image_step_split``).
``srl``, ``tagging`` and ``quick_start_cnn`` profile
``scripts/bench.bench_dsl``'s step of those demos (the SRL db-LSTM at
hid 128, depth 8, batch 16; the linear CRF at batch 32; quick_start's
cnn at batch 64) and add the step's split (``bench.step_split``) and,
for the CRF configs, the CRF's ms and share of the step by ablation
(``bench.crf_split``: the step against the same step with the CRF cost
summed away), both timed before the profiler runs.  ``word2vec`` and
``word2vec_softmax`` profile demo/word2vec's step the same way (with
the split); ``seqtoseq_demo`` profiles ``scripts/bench.
bench_seqtoseq_demo``'s step (demo/seqToseq at hidden 256, batch 32 of
the wmt14 loader's ragged sources, the feed included), its kernels by
origin with the GRU kernels as the port's.  Needs a CUDA device.
"""

import argparse
import json

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.scripts.bench import (
    DSL_CONFIGS, bench_dsl, bench_lstm, bench_resnet50, bench_rnn,
    bench_seq2seq, bench_seqtoseq_demo, bench_transformer,
    bench_transformer_decode, bench_transformer_moe,
    bench_transformer_packed, crf_split, image_step_split, step_split)
from paddle_tpu_torch.scripts.profile_step import measure

WARMUP = 5
STEPS = {"lstm": 20, "transformer": 10, "transformer_packed": 10,
         "transformer_moe": 10, "seq2seq": 10, "rnn": 20,
         "transformer_decode": 2, "resnet50": 10, "srl": 10, "tagging": 10,
         "quick_start_cnn": 10, "word2vec": 20, "word2vec_softmax": 20,
         "seqtoseq_demo": 10}
# the decode positions of one transformer_decode "step" (its max_len)
DECODE_POSITIONS = 128


# kernel-name markers of each group of an image step (first match wins)
_IMAGE_GROUPS = (
    ("pooling", ("pool",)),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                     "fprop", "winograd", "cutlass", "nhwc", "nchw")),
    ("gemm", ("gemm", "nvjet")),
    ("reduction", ("reduce", "welford")),
    ("elementwise", ("elementwise", "foreach", "multi_tensor")),
)


def image_group(name):
    """The group of an image step's kernel, by its name."""
    low = name.lower()
    for group, marks in _IMAGE_GROUPS:
        if any(m in low for m in marks):
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=tuple(STEPS), default="lstm")
    ap.add_argument("--hidden", type=int, default=512,
                    help="the LSTM's hidden size (--model lstm)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward (the "
                         "transformer models)")
    ap.add_argument("--dtype", default="auto",
                    choices=["auto", "float32", "bfloat16"],
                    help="the compute policy (core/dtypes)")
    args = ap.parse_args(argv)
    if args.dtype != "auto":
        dtypes.set_policy(compute_dtype=args.dtype)
    dev = _device.resolve("cuda")
    remat = True if args.remat else None
    if args.model == "lstm":
        bench = bench_lstm(hidden=args.hidden, device=dev)
        config = (f"text_lstm vocab 30000, emb 128, 2 x LSTM h={args.hidden}, "
                  "batch 64, length 100, Momentum")
    elif args.model == "rnn":
        bf16 = args.dtype == "bfloat16"
        bench = bench_rnn(compute_dtype=torch.bfloat16 if bf16 else None,
                          device=dev)
        config = ("text_rnn DSL config vocab 30000, emb 128, 2 x vanilla RNN "
                  "h=512, batch 64, length 100, Momentum, trainer.SGD")
    elif args.model == "seq2seq":
        bench = bench_seq2seq(device=dev)
        config = ("seq2seq attention NMT vocab 30000, emb = h = att 512, "
                  "bi-GRU encoder, batch 64, lengths 30 / 30, Momentum")
    elif args.model == "transformer_packed":
        bench = bench_transformer_packed(remat=remat, device=dev)
        config = ("packed causal LM vocab 32000, d_model 512, 8 heads, dff "
                  "2048, 6 layers, batch 16 x 512 slots, pack efficiency "
                  f"{bench.pack_efficiency:.3f}, Adam, remat {bench.remat}")
    elif args.model == "transformer_decode":
        bench = bench_transformer_decode(device=dev)
        config = ("transformer MT beam decode (generate_cached) vocab 32000, "
                  "d_model 512, 8 heads, dff 2048, 6+6 layers, batch 32, "
                  "source 128, 128 steps, beam 4")
    elif args.model == "resnet50":
        bench = bench_resnet50(remat=remat, device=dev)
        config = ("ResNet-50 batch 32, 224x224x3, 1000 classes, Momentum "
                  f"lr 0.1 m 0.9, remat {bench.remat}")
    elif args.model == "transformer_moe":
        bench = bench_transformer_moe(remat=remat, device=dev)
        config = ("MoE causal LM vocab 32000, d_model 512, 8 heads, 8 "
                  "experts top 2 of dff 2048, 6 layers, batch 16, length "
                  f"512, Adam, remat {bench.remat}")
    elif args.model == "seqtoseq_demo":
        bench = bench_seqtoseq_demo(device=dev)
        config = ("demo/seqToseq (models/seqtoseq_demo) vocab 3000, emb = h "
                  "256, bi-GRU encoder, batch 32 of wmt14's ragged sources "
                  "(3-29 tokens), Adam lr 5e-4 clip_norm 5, feed included")
    elif args.model in DSL_CONFIGS:
        bench = bench_dsl(args.model, device=dev)
        config = json.dumps({**DSL_CONFIGS[args.model][0],
                             "batch": bench.samples_per_step})
    else:
        bench = bench_transformer(remat=remat, device=dev)
        config = ("transformer MT vocab 32000, d_model 512, 8 heads, dff "
                  "2048, 6+6 layers, batch 32, length 256, Adam, full_seq, "
                  f"remat {bool(args.remat)}")
    step = bench.run if args.model == "transformer_decode" \
        else bench.train_step
    for _ in range(1 if args.model == "transformer_decode" else WARMUP):
        step()
    torch.cuda.synchronize()
    # the DSL demos' split and CRF share, timed before the profiler runs
    extra = {}
    if args.model in DSL_CONFIGS:
        extra["split_ms"] = step_split(bench.trainer, bench.feeder,
                                       bench.batches, STEPS[args.model])
    if args.model in ("srl", "tagging"):
        extra["crf"] = crf_split(bench, STEPS[args.model])
    out = measure(step, STEPS[args.model],
                  group=image_group if args.model == "resnet50" else None)
    if args.model == "resnet50":
        out["split_ms"] = image_step_split(bench, STEPS[args.model])
    if args.model == "rnn":
        out["split_ms"] = step_split(bench.trainer, bench.feeder,
                                     bench.batches, STEPS[args.model])
    out.update(extra)
    if args.model == "transformer_decode":
        out["per_position"] = {
            "positions": DECODE_POSITIONS,
            "wall_ms": out["step_wall_ms"]["p50"] / DECODE_POSITIONS,
            "kernel_ms": out["kernel_ms_per_step"] / DECODE_POSITIONS,
            "kernel_launches": out["kernel_launches_per_step"]
            / DECODE_POSITIONS}
    print(json.dumps({"config": config, "dtype": args.dtype, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
