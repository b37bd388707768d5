#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no final "ok" line:

  device    the card's name, and its name and power limit as nvidia-smi
            reports them (also printed alone on a line)
  build     nvcc builds every kernel library from paddle_tpu_torch/csrc
            (decode attention, flash attention, GRU, LSTM, gate-blocked
            LSTM, simple RNN), one nvcc per source, in parallel; seconds
            taken
  kernels   each kernel at the main path's shapes against its plain
            PyTorch version (max abs error within the stated bound; the
            LSTM pair on a ragged mask with an empty row, timed on the
            train batch's full rows with the backward's BPTT / dW_r split,
            also across the (B, D) its rule admits (D 128 and 256 at
            B 24, D 384 at B 64, D 640 at B 32, B 1448 at D 128, B 168 at
            D 512) and through a reverse LSTM, every check also within
            the 3xTF32 gate, which a one-TF32-pass build of the kernels
            must fail at the train shape; the decode kernels also at
            head dims 6 to 512, the flash forward, its backward pair and
            flash_attention_quant at the same widths (256, 384, 512 on
            the wide instances); the
            paged pair over a 129-block pool with
            shuffled ids, shared leading blocks and a free row on block
            0, and the Tq=1 slab kernel; the Tq=1 kernels on the split-KV
            template (slab and paged, float32 and int8, H = Hkv and GQA)
            bit for bit on a repeat, each row alone (S 1) and inside a
            T 2048 span, a long span against the plain version, int8 bit
            for bit its float32 kernel, with their device time alone
            (CUDA-graph replay) beside SDPA's; the flash forward, dK/dV
            and dQ at dh 256, 384 and 512 (B 4, H 2, T 512, causal and
            full) within the 3xTF32 gate 1e-5, which a one-TF32-pass
            build must fail, timed beside SDPA (naming its backend), and
            flash_attention_quant at dh 256; the int8 instances of the four
            decode kernels at the same shapes and flash_attention_quant
            at B=32, T=32 and a ragged T=200 with Hkv=2, each also held
            bit for bit against its float32 kernel on the dequantized
            cache; the flash forward and its backward pair at the MT
            train shape B=32, H=8, T=256, dh=64, causal and not, the pair
            also ragged and at dh 16/32/128 and repeated bit for bit; the
            GRU pair at the seq2seq train shape T=30, B=64, D=512 on full
            rows and on a ragged mask with an empty row, at D=128 and 640
            (B=64), D=768 (B=8) and the largest B the rule admits at D 128,
            512 and 768 (2536, 392, 16), each also within the 3xTF32 gate
            and bit for bit on a second launch, the gate failed by a
            one-TF32-pass build at the train shape, the backward timed
            with its BPTT / dW split, and through a reverse rnn.gru, with
            the cost of one grid barrier of the forward's grid timed
            alone; the gate-blocked
            LSTM forward, both variants, at T=100, B=64, D=1280 and 2048
            on full rows and on a ragged mask with an empty row, at D=640
            and odd T (B=64), B=256 with D=512, B=8 with D=3456 and
            B=72 with D=2432; a
            reverse rnn.lstm at B=8 through the resident kernels, and
            rnn.lstm at B=5 and with act="relu" through the masked scan
            on the card, held against the CPU, launching no kernel; the
            simple-RNN forward, BPTT and dW at the DSL slice's train shape
            T=100, B=64, D=512 on full rows and on a ragged mask with an
            empty row, at the ends of the rule's range (D 1152 at B 64,
            D 1280 at B 8, B 4736 at D 128) and odd T, each also within
            the 3xTF32 gate and bit for bit on a second launch, the
            gate failed by a one-TF32-pass build at the train shape, the
            backward timed with its BPTT / dW split; a reverse
            rnn.simple_rnn through the kernels and rnn.simple_rnn at B 12
            and with act="relu" through the scan on the card, held
            against the CPU),
            timed with CUDA events beside the plain version, one
            PyTorch library call computing the same function (a
            yardstick the port never calls; none exists for the int8
            kernels) and the least time the card could take (for the
            3xTF32 flash forward, its int8 instance, dK/dV, dQ, the
            gate-blocked LSTM forward, the GRU and the simple-RNN
            kernels at the tensor cores' rate, the float32 SIMT bound
            and the ratio to the library call beside it; for the
            blocked forward also the time W_r takes to
            stream from HBM once a step)
  flash_dh96  the flash forward and backward pair at head dim 96, which
            the wrappers zero-pad to the compiled 128, against the plain
            versions at dh 96 (causal T 256, non-causal Tq 200 / Tk 136),
            and dot_product_attention's flash route at B 2, H 8, T 256:
            one launch of each flash kernel, gradients against autograd
            of the plain forward
  generate  lm_generate on the full-width Transformer-base LM (vocab
            32000, d_model 512, 8 heads, dff 2048, 6 layers), batch 32,
            prompt 32, max_len 160, greedy: the flash kernel launches
            once per layer; two rows are held against the same call on
            the CPU (plain versions)
  serve     the port's HTTP server over the same trunk (8 slots, max_len
            256, chunk 8) answers 12 concurrent staggered /v1/generate
            requests, some streamed: the chunk kernel launches once per
            layer per step; each stream is held against lm_generate on
            the card
  serve_paged  the same server on the paged KV layout (block size 16) with
            a pool a quarter of the slab's size: 12 requests, half sharing
            a 64-token preamble, two exact duplicates, most in one burst.
            The paged chunk kernel launches once per layer per step; the
            prefix cache hits, a shared block is forked (copy-on-write)
            and a dry pool preempts a slot; every stream is held against
            lm_generate
  ladder    the legacy prefill ladder (prefill_chunk=0, buckets 32/64) on
            the slab and the paged layout, 8 staggered requests each: the
            flash kernel launches once per layer per prefill batch, the
            Tq=1 slab / paged kernel once per layer per step; streams are
            held against lm_generate
  generate_int8  lm_generate over an int8 KV cache at the generate phase's
            shape: flash_attention_quant launches once per layer; the int8
            prefill's logits within the budget (0.06) of the float32
            twin's; the greedy prefix shared with the float32 stream is
            reported; two rows are held against the same call on the CPU
  serve_int8  the serve phase over an int8 KV cache: the int8 chunk kernel
            once per layer per step, /metrics shows kv_cache_int8 1,
            streams held against the int8 lm_generate
  serve_paged_int8  the paged layout over an int8 KV cache with the auto
            pool (twice the float32 slab's blocks, fewer bytes): the 12
            serve_paged requests; prefix hits and copy-on-write forks of
            int8 blocks; the pool's KV bytes beside the float32 slab's
  ladder_int8  the ladder phase over an int8 KV cache, both layouts:
            flash_attention_quant once per layer per prefill batch, the
            int8 Tq=1 slab / paged kernel once per layer per step
  serve_w8  the LM's int8 trunk (quant/weights.quantize_lm) behind the
            server in a slab engine over float32 KV and a paged engine
            over int8 KV (the full-quant engine): 12 staggered requests
            each, the chunk kernel of the cache once per layer per step,
            every stream held against lm_generate over the same int8
            tree (whose prefill launches the flash kernel once per layer
            per call); first, the card's int8 tree is held against the
            CPU's on the same weights (codes and scales bit for bit)
            and its prefill logits within 1e-3 of the CPU's; the logit
            error against the float32 tree is reported on both devices
            beside quant/kv's budget (0.06)
  serve_spec  speculative serving (k 4, a 2-layer draft sharing the
            target's embedding) on the slab over float32 KV and the
            paged layout over int8 KV, each beside its non-speculating
            twin, then with another seed's draft and an adversarial one
            (that trunk's embedding scaled by 0.01), and the int8 trunk
            speculating (--quant-weights 1 --speculate-k 4): streams held
            against the twin and lm_generate; every verify run delivers
            a token; the target's chunk kernel once per layer per step,
            the draft's chunk kernel once and its Tq=1 kernel 3 times per
            draft layer per rollout; acceptance rate, tokens a verify
            step and tokens/s beside the twin's
  ladder_dh256, ladder_dh256_int8  the ladder on the slab layout for an
            LM at D 512 over 2 heads (dh 256; 2 layers), float32 and int8
            KV: the wide flash instance (flash_attention_quant) once per
            layer per prefill batch, the Tq=1 slab kernel at dh 256 once
            per layer per step; streams held against lm_generate
  train     the headline benchmark, bench.py's bench_lstm ported
            (scripts/bench.bench_lstm): the LSTM text classifier at vocab
            30000, embedding 128, 2 x LSTM h=512, batch 64, length 100,
            Momentum, on one fixed batch.  Its first step is held
            against the same step on the CPU (plain versions: loss and
            every gradient leaf), then warm-up and timed steps: each
            step launches the LSTM forward and backward kernels once per
            layer, the loss is finite and falls
  train_lstm1280, train_lstm2048  bench.py's lstm1280 / lstm2048 rows:
            the same model and batch at h=1280 and 2048, whose LSTMs take
            the gate-blocked route: the first step against the CPU (at
            batch 8 for h=2048, the same route at an eighth of the
            host's cost), then warm-up and timed steps at batch 64, each
            launching the blocked forward once per layer and no resident
            kernel; the loss is finite and falls
  train_transformer  bench.py's bench_transformer ported
            (scripts/bench.bench_transformer): the Transformer-base MT
            model at vocab 32000, d_model 512, 8 heads, dff 2048, 6+6
            layers, length 256, Adam lr 1e-4, label smoothing 0.1,
            full_seq.  One step at batch 2 is held against the same step
            on the CPU: its FFN pre-activations, the ReLU sign flips
            between the two counted; loss, every gradient leaf and m/v
            slot against a CPU step that keeps the card's ReLU
            decisions, and by relative L2 against the plain CPU step; a
            TF32 control step must fail these checks.  Adam's update on
            the card is held against its own slots; then
            warm-up and timed steps at batch 32, each launching the flash
            forward, dK/dV and dQ kernels 18 times (6 encoder, 6 decoder
            self-, 6 cross-attentions); the loss is finite and falls
  train_seq2seq  bench.py's bench_seq2seq ported
            (scripts/bench.bench_seq2seq): the attention NMT model at
            vocab 30000 both sides, emb = hidden = attention 512, batch
            64, lengths 30 / 30, Momentum.  Its first step is held against
            the same step on the CPU (plain versions: loss, every
            gradient leaf and momentum slot), then warm-up and timed
            steps, each launching the GRU forward and backward kernels
            twice (the encoder's two directions); the loss is finite and
            falls.  Then greedy_generate at batch 64, max_len 30 on the
            trained params: the lean GRU forward twice, no backward; its
            tokens held against the same call on the CPU up to each
            row's first step whose top-1/top-2 margin is below MARGIN_TOL,
            and the whole sample on values: the encoder's outputs and
            every step's log-probs teacher-forced on the CPU's tokens,
            card vs CPU within S2S_REL_TOL
  train_rnn  a layer-DSL config through trainer.SGD (models/text_rnn: the
            RNN text classifier, vocab 30000, embedding 128, 2 x
            [fc_layer(512) -> recurrent_layer(tanh)], max-pool, fc 2
            softmax, classification_cost, batch 64, length 100,
            Momentum): the first step against a CPU witness from the
            same weights that max-pools at the card's argmax (loss, every
            gradient, param and momentum leaf; the argmax flips counted,
            each a near-tie), its update lowering its batch's cost; then
            SGD.train over 20 batches, each step launching the simple-RNN
            forward and backward kernels twice, the losses finite;
            SGD.test on a held-out reader; the step's split into feed,
            forward, backward and update; then `python -m
            paddle_tpu_torch train` as a subprocess on a config file,
            whose pass dir SGD.load restores bit for bit
Then the kernel summary line, the nvidia-smi line, and last:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Without a CUDA device, or run from a directory that holds this script
and nothing else of the repository, it exits non-zero and prints no
result.
"""

import argparse
import contextlib
from concurrent.futures import ThreadPoolExecutor
import json
import math
import sys
import threading
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s,
# float32 FLOP/s outside the tensor cores (the SIMT kernels), and the
# tensor cores' dense TF32 rate (495 TFLOP/s) over 3: the flash forward,
# its int8 instance, the dK/dV and dQ kernels, the gate-blocked LSTM
# forward, the resident LSTM and the vanilla-RNN kernels run each float32
# product as three TF32 ones (3xTF32), so their least time is the float32
# FLOPs over PEAK_3XTF32_FLOPS.  Their phase rows also keep the float32
# SIMT bound beside it (bound_f32_simt_ms), comparable with the earlier
# rows; the `kernels` line carries bound_ms alone.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3

# Kernel vs plain version on the same inputs: float32 with TF32 off on
# both sides, summed in different orders (tiled online softmax vs a
# materialized softmax); observed differences are ~1e-6, so 1e-4 bounds
# them with room and still catches any indexing or masking fault (those
# give O(1) errors on N(0, 1) inputs).
KERNEL_TOL = 1e-4
# Engine stream vs lm_generate, and card vs CPU: the two paths round
# differently (chunked slab step vs prefill + decode step; kernel vs
# plain attention), moving logits by ~1e-5.  A token is compared only
# while the reference's top-1/top-2 logit margin exceeds this; past the
# first smaller margin the two may legitimately diverge.  Random weights
# give small margins, so the number of tokens compared is reported.
MARGIN_TOL = 2e-3

LAYERS, HEADS, VOCAB, D_MODEL, DFF = 6, 8, 32000, 512, 2048
SLOTS, SERVE_MAX_LEN, CHUNK = 8, 256, 8
GEN_BATCH, GEN_PROMPT, GEN_MAX_LEN = 32, 32, 160
# the paged layout: block size 16 (the JAX default); the kernels phase
# uses the slab-equivalent pool (8 rows x 16 blocks + scratch), the
# serve_paged phase a quarter of it, so that the pool runs dry
PAGE_BS = 16
PAGE_BLOCKS = SLOTS * SERVE_MAX_LEN // PAGE_BS + 1
PAGED_POOL = (PAGE_BLOCKS - 1) // 4 + 1
# The split-KV chunk kernels' long-span case: rows of chunk_qpos(2048),
# its longest crossing 2048 / 128 = 16 splits at dh 64 (at least
# SPLIT_MIN_SPLITS is checked), over a pool of 8 x 128 blocks + scratch
SPLIT_LONG_T = 2048
SPLIT_MIN_SPLITS = 16
# the split-KV kernels' rows also carry their device time alone (CUDA-graph
# replay) and scaled_dot_product_attention's, beside the wrapper-timed ms
DEVICE_KEYS = ("device_ms", "library_device_ms")
PREAMBLE = 64
LADDER_PROMPTS, LADDER_TOKENS = (5, 17, 32, 40, 64, 9, 50, 23), 24
# serve_w8: the card's quantize_lm against the CPU's on the same weights,
# bit for bit (amax / 127 and w / s are correctly rounded divisions on
# both devices), and its prefill logits against the CPU's plain prefill
# of the same int8 tree.  Both devices compute in float32 with TF32 off
# (the card's flash prefill in 3xTF32), so the logits agree to ~1e-6 (the
# float32 tree's difference is reported beside); 1e-3 bounds that with
# room, while five codes off by one (scales an ulp off: a division by a
# Python scalar on the card) moved a logit by 2.7e-3 there, and a wrong
# scale or dequantization moves them by far more
W8_CPU_TOL = 1e-3
# speculative serving: bench.py's bench_serving_speculative defaults
# (bench.py:2601-2604); the step's lane width max(CHUNK, SPEC_K + 1)
# stays CHUNK, the K the split kernels are checked at
SPEC_K, SPEC_DRAFT_LAYERS = 4, 2

# The LSTM kernels at the train path's shape (bench_lstm: T=100, B=64,
# h=512) against their plain versions on the same inputs, at the JAX
# tests' scale (x*0.3, W_r*0.1, checks*0.1).  Both sides are float32 but
# sum the recurrent products in different orders, and the differences
# ride the recurrence for 100 steps: 1e-4 absolute bounds hs, c_fin, cs,
# acts and dxs (O(0.1-1) values) with room and still catches an indexing
# or masking fault, which moves values by O(0.1).  dW_r and dchecks sum
# T*B = 6400 terms each, so they are held relative to max |ref|.
LSTM_T, LSTM_B, LSTM_D = 100, 64, 512
LSTM_TOL = 1e-4
LSTM_REL_TOL = 1e-4
# Every resident LSTM check is also held within LSTM_TC_TOL, the gate
# that tells 3xTF32 from one TF32 pass (hs, c_fin, cs, acts and dxs
# absolute, dW_r and dchecks relative to their largest entry): at the
# train shape one pass lands at 1.4e-3 (forward) and 3.6e-3 (dxs) from
# the plain versions, 3xTF32 under 7e-6 (scripts/probe_lstm.py, `tf32_1x`
# and `kernel`).  The tf32_1x variant, built from the source, must fail
# it at the train shape.
LSTM_TC_TOL = 1e-5
# The resident kernels across the (B, D) lstm.supported admits, each on a
# ragged mask with an empty row: D 128 and 256 at B 24 and odd T, D 384
# at B 64, D 640 at B 32 (the largest B there), and the largest B at
# D 128 (1448) and at D 512 (168), where a CTA walks several b-blocks.
LSTM_OTHER = ((37, 24, 128), (37, 24, 256), (20, 64, 384), (20, 32, 640),
              (5, 1448, 128), (9, 168, 512))
# The gate-blocked LSTM forward at the lstm1280 / lstm2048 train shape
# (T=100, B=64; timed at both D on full rows) and across the range
# lstm_blocked.supported admits: D 640 and odd T at B 64, B 256 with
# D 512, the largest D at B 8 (3456), and B 72 with D 2432, where the
# kernel halves its pass to fit shared memory, each on a ragged mask
# with an empty row, against its plain version within KERNEL_TOL.  W_r is drawn
# at the model's own init scale, std 1/sqrt(D) (text_lstm.init): at the
# JAX tests' 0.1 the recurrent gain 0.1 sqrt(D) is 3.6 at D=1280, and
# 100 steps of it amplify float32 rounding to O(0.1) between any two
# summation orders, two plain versions included (BLK_GAIN_PROBE shows it
# at D=1280: kernel vs plain beside plain on the card vs plain on the CPU).
BLK_T, BLK_B = 100, 64
# Every blocked check is also held within BLK_TC_TOL, the gate that tells
# 3xTF32 from one TF32 pass: at the train shapes one pass (a_big b_big)
# lands at 6e-5 to 8e-5 from the plain version, under KERNEL_TOL, and
# 3xTF32 at ~4e-7 (scripts/probe_lstm_blocked.py, `tf32_1x` and `kernel`).
BLK_TC_TOL = 1e-5
BLK_TIMED = (1280, 2048)
BLK_OTHER = ((100, 64, 640), (37, 64, 1280), (9, 256, 512), (15, 8, 3456),
             (5, 72, 2432))
BLK_GAIN_PROBE = 0.1
# Card (kernels) vs CPU (plain versions) on the first train step: the
# loss, every gradient leaf, and every param leaf and ``mom`` slot after
# the in-place Momentum update, each relative to the leaf's max |CPU
# value|.  The two run the same float32 arithmetic in different
# summation orders through 2 x 100 recurrent steps forward and back;
# 1e-3 leaves room for that drift while a wrong gradient or slot is off
# by O(1).  A param moves by about 1e-4 of itself in one step, too little
# for a param comparison to see a wrong update, so the card's params are
# also held to its own step, p0 + mom (mom starts at 0), relative to max
# |mom|: that catches a wrong sign, step size or a slot not applied.
TRAIN_REL_TOL = 1e-3
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
# The flash kernels at the MT train path's shape (bench_transformer: B 32,
# H 8, T 256, dh 64).  The backward's dq, dk and dv sum up to T terms of
# products of O(1) values; each is held relative to its largest magnitude
# (as the LSTM backward's sums are), 1e-4, which an indexing or masking
# fault exceeds by orders of magnitude.  The train phase's first step at
# batch 2 (card vs CPU) is held at TRAIN_REL_TOL, and Adam's update on
# the card to its own m/v slots.  Then MT_WARMUP + MT_STEPS steps at
# batch 32, each launching the flash forward, dK/dV and dQ kernels once
# per attention: 6 encoder self-, 6 decoder self- and 6 cross-attentions.
MT_BATCH, MT_SEQ, MT_HEADS, MT_DH = 32, 256, 8, 64
MT_REL_TOL = 1e-4
# The MT model's FFNs are ReLUs.  Card and CPU round their products
# differently, so at batch 2 a few of the 6.3 M FFN pre-activations lie
# close enough to 0 to fall on the other side of the kink: each such
# flip moves one token's whole contribution to its layer's w1/b1
# gradient and, through the residual stream, gradients upstream of it
# (the embedding rows of that token).  The first step therefore shows
# and takes out that cause before it holds the gradients:
#   - every FFN pre-activation on the card within MT_PRE_TOL of the
#     CPU's, relative to its layer's largest (1.6e-6 on an H100), so
#     each flip lies within that distance of 0; the flips are counted;
#   - every gradient leaf and m/v slot within TRAIN_REL_TOL of its
#     largest magnitude of a CPU witness step that keeps the card's
#     ReLU decisions (the same step with each FFN's mask given);
#   - against the plain CPU step, each gradient leaf and slot by its
#     relative L2 error at MT_GRAD_TOL, which the flips' share (1.3e-3
#     on an H100) stays well under.
# A TF32 control step on the card (matrix products at 10-bit mantissa)
# must fail these checks, or they could not tell it from float32.
MT_PRE_TOL = 2e-5
MT_GRAD_TOL = 4e-3
MT_WARMUP, MT_STEPS = 2, 10
MT_ATTENTIONS = 18
# The flash route at a head dim between the compiled ones (JAX's kernel
# takes any up to 128; the port's wrappers pad it to the next compiled
# width), held like the train shape's checks.
FLASH_PADDED_DH = 96
# check_head_dims' widths: the decode kernels at each (6, 8, 24 and 96
# padded inside the kernel, 6 loading one value at a time, 8 and 24 their
# int8 codes one at a time; 256, 384 and 512 compiled widths), the flash
# kernels up to 128
HEAD_DIMS_CHECKED = (6, 8, 16, 24, 32, 96, 128, 256, 384, 512)
# The flash kernels' wide instances (dh 256, 384, 512: the head dim split
# across a CTA's warps, 3xTF32 products) at a timed shape, B 4, H 2, T 512
# causal and full, each output within WIDE_TC_TOL of the plain version
# (the forward's o and lse absolute, dq / dk / dv relative to their
# largest entry), which a one-TF32-pass build (probe_flash.py's tf32_1x)
# must fail on the same inputs.  The 2-head ladder runs the LM at D 512
# with dh 256 through them and the Tq=1 kernels at that width.
WIDE_TC_TOL = 1e-5
WIDE_B, WIDE_H, WIDE_T = 4, 2, 512
WIDE_HEADS, WIDE_LAYERS = 2, 2
# The GRU kernels at the seq2seq train path's shape (bench_seq2seq's
# encoder: T=30, B=64, h=512) against their plain versions, held as the
# LSTM pair is (hs, acts and dxs within LSTM_TOL absolute, dW_gate and
# dW_state within LSTM_REL_TOL of their largest entry), and at the ends
# of the range gru.supported admits: D 128 and 640 at B 64, D 768 at B 8,
# and the largest B at D 128, 512 and 768 (2536, 392, 16: B % 16 = 8 at
# the first, half an m16 tile), where a CTA walks several b-blocks.
# The train phase's first step (card vs CPU) is held at TRAIN_REL_TOL:
# the model has no ReLU, so card and CPU differ only by summation order.
GRU_T, GRU_B, GRU_D = 30, 64, 512
GRU_OTHER = ((64, 128), (64, 640), (8, 768), (2536, 128), (392, 512),
             (16, 768))
# Every GRU check is also held within GRU_TC_TOL, the gate that tells
# 3xTF32 from one TF32 pass: hs and acts absolute (|h| < 1), dxs, dW_gate
# and dW_state relative to their largest entry (dxs grows along the
# reversed recurrence, as the simple RNN's does).  The tf32_1x variant of
# csrc/gru.cu (scripts/probe_gru.py), built from the source, must fail it
# at the train shape.  Two launches on the same inputs must give
# bit-identical hs, acts, dxs, dW_gate and dW_state: every sum runs in a
# fixed order.
GRU_TC_TOL = 1e-5
S2S_BATCH, S2S_LEN, S2S_VOCAB, S2S_HIDDEN = 64, 30, 30000, 512
S2S_WARMUP, S2S_STEPS = 3, 10
# greedy_generate card vs CPU on the trained params, beyond the tokens
# the margins let through: the encoder's outputs (enc, proj, boot) and
# the log-probs of every step teacher-forced on the CPU's tokens, each
# relative to its largest magnitude.  Same float32 arithmetic in other
# summation orders, through 30 encoder and 30 decoder steps without
# updates; a wrong kernel or step moves them by O(1e-2) and more.
S2S_REL_TOL = 1e-4
S2S_DIRECTIONS = 2
# The vanilla-RNN kernels at the DSL slice's train shape
# (models/text_rnn: T=100, B=64, h=512) against their plain versions on
# the same inputs, W at the layer's own init std 1/sqrt(D)
# (layers/recurrent.py, the recurrence's gain about 1) and x*0.3: hs and
# dxs within KERNEL_TOL absolute, dW within KERNEL_TOL of its largest
# entry (T*B = 6400 terms a sum).  Then at the ends of the range
# simple_rnn.supported admits (D 1152 at B 64, D 1280 at B 8, B 4736 at
# D 128) and at an odd T, each on a ragged mask with an empty row.
RNN_T, RNN_B, RNN_D = 100, 64, 512
RNN_OTHER = ((30, 64, 1152), (30, 8, 1280), (30, 4736, 128), (37, 64, 512))
# Every simple-RNN check is also held within RNN_TC_TOL, the gate that
# tells 3xTF32 from one TF32 pass: hs absolute (|h| < 1), dxs and dW
# relative to their largest entry.  dxs is held relative because it
# grows along the reversed recurrence (|dxs| reaches ~10 at the train
# shape's full rows and ~40 on a ragged mask, where 3xTF32's absolute
# error reaches ~1e-5 while its relative error stays under 1e-6).  At
# the train shape one pass lands at 1.2e-3 on hs and 4.5e-4 / 5.1e-4 on
# dxs / dW, 3xTF32 under 8e-7 (scripts/probe_simple_rnn.py, `tf32_1x`
# and `kernel`); the tf32_1x variant, built from the source, must fail
# it.  Two launches on the same inputs must give bit-identical hs, dxs
# and dW: every sum runs in a fixed order.
RNN_TC_TOL = 1e-5
# The train_rnn phase: the first step on the card against the CPU at
# TRAIN_REL_TOL, and its update must lower the cost of the batch it was
# taken on (SGD.test before and after).  With the reference's Momentum
# (lr 0.01, m 0.9) on random labels, a pass's losses wander and may
# climb after a few steps, on the CPU as on the card, so the pass over
# RNN_BATCHES batches is held to finite losses (reported) and 2 + 2
# launches of the simple-RNN kernels a step.  The CLI runs
# RNN_CLI_BATCHES batches.
RNN_BATCHES, RNN_CLI_BATCHES = 20, 3
# The model max-pools each hidden unit over 100 steps.  Card and CPU
# round the recurrence differently (kernel vs plain hs agree to ~1e-6),
# so a unit whose two largest steps lie closer than that may take the
# other argmax: one such flip among the 32,768 pooled units sends that
# unit's gradient down another step, which moves the weight gradients
# by percents of a leaf's largest entry (the phase reports it against
# the plain CPU step).  So, as the MT step does with its ReLU kinks, the
# first step records each max-pool's argmax on the card (pool_probe)
# and holds:
#   - the pooled values, card vs CPU, within RNN_TIE_TOL of the largest;
#   - every flipped unit's top-1/top-2 gap on the CPU within RNN_TIE_TOL
#     of the largest pooled value (a tie within rounding, not a fault:
#     a wrong kernel moves values by O(1e-2));
#   - loss, every gradient, param and momentum leaf within TRAIN_REL_TOL
#     of the largest entry of a CPU witness step that pools at the
#     card's argmax; the plain CPU step's errors are reported.
RNN_TIE_TOL = 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def time_ms(torch, fn, samples=50, reps=10):
    """Median over ``samples`` of the mean device time of ``reps``
    back-to-back calls between two CUDA events, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def bound(nbytes, flops, peak=PEAK_F32_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_bound(row, nbytes, flops):
    """A 3xTF32 kernel's row: bound_ms / bound_by at the tensor-core
    peak, bound_f32_simt_ms at the float32 SIMT one, and library_ratio =
    ms / library_ms where both were timed."""
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                             PEAK_3XTF32_FLOPS)
    row["bound_f32_simt_ms"] = bound(nbytes, flops)[0]
    if row.get("library_ms"):
        row["library_ratio"] = row["ms"] / row["library_ms"]


# ------------------------------------------------------------- kernels

def chunk_qpos(t):
    """Per-lane positions [8, 8] mixing the row kinds the serving step
    sees: decode rows (one live lane), full 8-lane prompt chunks, a
    ragged chunk tail (clamped lanes repeat the last live position), a
    row ending at T-1 and a free row at 0."""
    rows = [[100] * 8,                                   # decode row
            list(range(0, 8)),                           # first chunk
            list(range(40, 48)),                         # full chunk
            [120, 121, 122, 123, 124, 124, 124, 124],    # ragged tail
            [t - 1] * 8,                                 # decode at T-1
            [0] * 8,                                     # free row at 0
            list(range(t - 8, t)),                       # chunk to T-1
            [17] * 8]                                    # decode row
    return np.asarray(rows, np.int32)


def check_decode_kernel(torch, dev, rng, hkv):
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    s, kk, t, d, h = 8, CHUNK, SERVE_MAX_LEN, D_MODEL, HEADS
    dkv = d // h * hkv
    q = torch.tensor(normal(rng, (s, kk, d)), device=dev)
    k = torch.tensor(normal(rng, (s, t, dkv)),
                     device=dev)
    v = torch.tensor(normal(rng, (s, t, dkv)),
                     device=dev)
    qpos_np = chunk_qpos(t)
    qpos = torch.tensor(qpos_np, device=dev)
    out = dk.decode_attention_slab_chunk(q, k, v, qpos, h)
    ref = dk.decode_attention_slab_chunk_plain(q, k, v, qpos, h)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    decode_rows = qpos_np[:, -1] == qpos_np[:, 0]
    zeros_ok = bool((out[torch.tensor(decode_rows, device=dev), 1:] == 0)
                    .all())
    if not err <= KERNEL_TOL or not zeros_ok:
        fail(f"decode_attention_slab_chunk (Hkv={hkv}) disagrees with its "
             f"plain version: max abs err {err} (bound {KERNEL_TOL}), "
             f"decode-row dead lanes exact zero: {zeros_ok}")
    row = {"name": dk.NAME, "hkv": hkv, "max_abs_err": err}
    if hkv != h:
        return row
    # this run's work: each row streams K and V up to its furthest lane;
    # a decode row reads q and computes for lane 0 only (its other lanes
    # are written as zeros), every other row all K lanes
    dh = d // h
    span = qpos_np[:, -1].astype(np.int64) + 1
    live = np.where(decode_rows[:, None], np.arange(kk)[None] == 0, True)
    nbytes = (4 * (s * kk * d + int(live.sum()) * d + s * kk)
              + 4 * 2 * int(span.sum()) * dkv)
    flops = 4 * dh * h * int(((qpos_np + 1) * live).sum())
    mask = (torch.arange(t, device=dev)[None, None, :]
            <= qpos.long()[:, :, None])[:, None]
    qh = q.reshape(s, kk, h, dh).transpose(1, 2).contiguous()
    kh = k.reshape(s, t, h, dh).transpose(1, 2).contiguous()
    vh = v.reshape(s, t, h, dh).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row.update(
        shape={"S": s, "K": kk, "T": t, "D": d, "H": h, "Hkv": hkv},
        ms=time_ms(torch, lambda: dk.decode_attention_slab_chunk(
            q, k, v, qpos, h)),
        plain_ms=time_ms(torch, lambda: dk.decode_attention_slab_chunk_plain(
            q, k, v, qpos, h)),
        library_ms=time_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask)),
        bytes=nbytes, flops=flops)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return row


def paged_tables(rng, last, nb_row, num_blocks):
    """Block tables [S, nb_row] int32 for rows whose furthest positions
    are ``last`` [S]: each row's blocks drawn from a shuffled pool (ids
    1..num_blocks-1), row 3 sharing row 0's leading blocks, the free row
    (row 5, at position 0) all on scratch block 0, and the entries past a
    row's last block pointing at blocks the row must never read."""
    ids = list(rng.permutation(np.arange(1, num_blocks)))
    tables = rng.randint(1, num_blocks, (len(last), nb_row)).astype(np.int32)
    need = last // PAGE_BS + 1
    for r in range(len(last)):
        tables[r, :need[r]] = [ids.pop() for _ in range(need[r])]
    share = min(need[0], need[3])
    tables[3, :share] = tables[0, :share]
    tables[5] = 0
    return tables


def check_paged_kernels(torch, dev, rng, hkv):
    """The paged chunk kernel at the paged serving step's shapes (8 rows
    of K = 8 lanes, chunk_qpos, over a 129-block pool of 16 positions,
    16 blocks per row; paged_tables), and the Tq=1 pair at each row's
    furthest position: decode_attention_slab over [8, 256] slab rows,
    decode_attention_paged over the same pool.  Each against its plain
    version; timed when Hkv = H.  The library yardstick is one masked
    scaled_dot_product_attention, over the gathered chain on the pool
    (the gather included)."""
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    s, kk, t, d, h = 8, CHUNK, SERVE_MAX_LEN, D_MODEL, HEADS
    dh, nb_row = d // h, t // PAGE_BS
    dkv = dh * hkv
    qpos_np = chunk_qpos(t)
    last = qpos_np[:, -1].astype(np.int64)
    tables_np = paged_tables(rng, last, nb_row, PAGE_BLOCKS)
    q = torch.tensor(normal(rng, (s, kk, d)), device=dev)
    q1 = torch.tensor(normal(rng, (s, d)), device=dev)
    pool_k, pool_v = (torch.tensor(normal(rng, (PAGE_BLOCKS, PAGE_BS, dkv)),
                                   device=dev) for _ in range(2))
    slab_k, slab_v = (torch.tensor(normal(rng, (s, t, dkv)), device=dev)
                      for _ in range(2))
    qpos = torch.tensor(qpos_np, device=dev)
    pos = torch.tensor(qpos_np[:, -1].copy(), device=dev)
    tables = torch.tensor(tables_np, device=dev)
    calls = {
        dk.NAME_PAGED_CHUNK: (
            lambda: dk.decode_attention_paged_chunk(q, pool_k, pool_v, qpos,
                                                    tables, h),
            lambda: dk.decode_attention_paged_chunk_plain(
                q, pool_k, pool_v, qpos, tables, h)),
        dk.NAME_SLAB: (
            lambda: dk.decode_attention_slab(q1, slab_k, slab_v, pos, h),
            lambda: dk.decode_attention_slab_plain(q1, slab_k, slab_v, pos,
                                                   h)),
        dk.NAME_PAGED: (
            lambda: dk.decode_attention_paged(q1, pool_k, pool_v, pos,
                                              tables, h),
            lambda: dk.decode_attention_paged_plain(q1, pool_k, pool_v, pos,
                                                    tables, h))}
    rows = {}
    decode_rows = qpos_np[:, -1] == qpos_np[:, 0]
    for name, (fn, plain) in calls.items():
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        zeros_ok = name != dk.NAME_PAGED_CHUNK or bool(
            (out[torch.tensor(decode_rows, device=dev), 1:] == 0).all())
        if not err <= KERNEL_TOL or not zeros_ok:
            fail(f"{name} (Hkv={hkv}) disagrees with its plain version: max "
                 f"abs err {err} (bound {KERNEL_TOL}), decode-row dead "
                 f"lanes exact zero: {zeros_ok}")
        rows[name] = {"name": name, "hkv": hkv, "max_abs_err": err}
    if hkv != h:
        return rows
    # this run's work.  Bytes: q for the lanes computed, out, positions
    # and table words, and each pool block some row's furthest lane
    # reaches, once (shared blocks are one input); the slab kernel reads
    # each row up to its position.  Operations: QK and PV per live lane
    # per column <= its position.
    live = np.where(decode_rows[:, None], np.arange(kk)[None] == 0, True)
    need = last // PAGE_BS + 1
    reached = {int(tables_np[r, j]) for r in range(s) for j in range(need[r])}
    pool_bytes = 4 * 2 * len(reached) * PAGE_BS * dkv
    tq1_flops = 4 * dh * h * int((last + 1).sum())
    costs = {
        dk.NAME_PAGED_CHUNK: (
            4 * (int(live.sum()) * d + s * kk * d + s * kk + int(need.sum()))
            + pool_bytes, 4 * dh * h * int(((qpos_np + 1) * live).sum())),
        dk.NAME_SLAB: (4 * (2 * s * d + s) + 4 * 2 * int((last + 1).sum())
                       * dkv, tq1_flops),
        dk.NAME_PAGED: (4 * (2 * s * d + s + int(need.sum())) + pool_bytes,
                        tq1_flops)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cols = torch.arange(t, device=dev)
    chunk_mask = (cols[None, None, :] <= qpos.long()[:, :, None])[:, None]
    tq1_mask = (cols[None, :] <= pos.long()[:, None])[:, None, None]
    qh = q.reshape(s, kk, h, dh).transpose(1, 2)
    q1h = q1.reshape(s, 1, h, dh).transpose(1, 2)

    def heads(rows_):           # [S, T, D] -> [S, H, T, dh]
        return rows_.reshape(s, t, h, dh).transpose(1, 2)

    def chain(pool):            # the gather the library call needs
        return heads(pool[tables.long()])

    library = {
        dk.NAME_PAGED_CHUNK: lambda: sdpa(qh, chain(pool_k), chain(pool_v),
                                          attn_mask=chunk_mask),
        dk.NAME_SLAB: lambda: sdpa(q1h, heads(slab_k), heads(slab_v),
                                   attn_mask=tq1_mask),
        dk.NAME_PAGED: lambda: sdpa(q1h, chain(pool_k), chain(pool_v),
                                    attn_mask=tq1_mask)}
    for name, (fn, plain) in calls.items():
        nbytes, flops = costs[name]
        row = rows[name]
        row.update(
            shape={"S": s, "K": 1 if name == dk.NAME_SLAB
                   or name == dk.NAME_PAGED else kk, "T": t, "D": d, "H": h,
                   "Hkv": hkv, "block_size": PAGE_BS,
                   "pool_blocks": PAGE_BLOCKS, "blocks_reached":
                   len(reached)},
            ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, library[name]), bytes=nbytes,
            flops=flops)
        if name != dk.NAME_SLAB:
            row["library_note"] = ("one masked scaled_dot_product_attention "
                                   "over each row's chain gathered from the "
                                   "pool, the gather included")
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return rows


def graph_ms(torch, fn, calls=20, replays=30):
    """Median device ms a call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed, so that the host's launch path is out of
    the reading (as ab_kernels.py's ``graph:`` rows)."""
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


def check_split_kernels(torch, dev, rng, tq1=False, h=HEADS, hkv=HEADS):
    """The split-KV decode kernels (slab and paged, float32 and int8 K/V)
    at the main path's shape (S 8, T 256, D 512, H heads over Hkv KV
    heads; the paged over the 129-block pool): the chunked pair (K 8
    lanes a row at chunk_qpos) or, ``tq1``, the Tq=1 pair (one query a
    row at chunk_qpos' last positions).  Checks: within KERNEL_TOL of the
    plain version; a second launch equal to the first bit for bit; each
    row computed alone (S 1) and inside a T 2048 span (the slab's first
    256 columns, the table's first 16 entries) equal to the same row of
    the S 8 batch bit for bit; a long span (chunk_qpos(SPLIT_LONG_T)
    rows over T 2048, the paged over 8 x 128 blocks; its longest row
    crossing at least SPLIT_MIN_SPLITS splits) within KERNEL_TOL of the
    plain version; each int8 instance bit for bit its float32 kernel on
    the dequantized cache, at both spans.  At Hkv = H also each kernel's
    device time alone (graph_ms) beside one
    scaled_dot_product_attention over the same rows (the paged: over
    each row's chain gathered from the pool, the gather included; none
    for int8).  Returns {kernel: row}."""
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    s, d = 8, D_MODEL
    kk = 1 if tq1 else CHUNK
    dh, t, tl = d // h, SERVE_MAX_LEN, SPLIT_LONG_T
    dkv = dh * hkv
    qpos_np, long_np = chunk_qpos(t), chunk_qpos(tl)
    if tq1:
        qpos_np, long_np = qpos_np[:, -1:], long_np[:, -1:]
    q = torch.tensor(normal(rng, (s, kk, d)), device=dev)
    # the Tq=1 kernels take q [S, D] and positions [S]
    qpos, qlong = (torch.tensor(x[:, 0] if tq1 else x, device=dev)
                   for x in (qpos_np, long_np))
    if tq1:
        q = q[:, 0]
    # the slab rows at T 2048; the main path's T 256 are their first
    # columns (codes and scales alike)
    kl, vl = (torch.tensor(normal(rng, (s, tl, dkv)), device=dev)
              for _ in range(2))
    (kl8, ksl8), (vl8, vsl8) = (quantized(torch, dev, rng, (s, tl, dkv), hkv)
                                for _ in range(2))

    def head(x):
        return x[:, :t].contiguous()

    slab = {False: ((kl, vl, None, None), tuple(
                head(x) for x in (kl, vl)) + (None, None)),
            True: ((kl8, vl8, ksl8, vsl8), tuple(
                head(x) for x in (kl8, vl8, ksl8, vsl8)))}
    pool_shape = (PAGE_BLOCKS, PAGE_BS, dkv)
    pk, pv = (torch.tensor(normal(rng, pool_shape), device=dev)
              for _ in range(2))
    (p8, ps8), (w8, ws8) = (quantized(torch, dev, rng, pool_shape, hkv)
                            for _ in range(2))
    pool = {False: (pk, pv, None, None), True: (p8, w8, ps8, ws8)}
    tables_np = paged_tables(rng, qpos_np[:, -1].astype(np.int64),
                             t // PAGE_BS, PAGE_BLOCKS)
    tables = torch.tensor(tables_np, device=dev)
    # the same rows' tables at span 2048: entries past each row's
    # furthest block point at pool blocks the row must never read
    wide = torch.tensor(np.concatenate(
        [tables_np, rng.randint(1, PAGE_BLOCKS, (s, (tl - t) // PAGE_BS))],
        1).astype(np.int32), device=dev)
    long_blocks = s * (tl // PAGE_BS) + 1
    lpool_shape = (long_blocks, PAGE_BS, dkv)
    lk, lv = (torch.tensor(normal(rng, lpool_shape), device=dev)
              for _ in range(2))
    (lk8, lks8), (lv8, lvs8) = (quantized(torch, dev, rng, lpool_shape, hkv)
                                for _ in range(2))
    lpool = {False: (lk, lv, None, None), True: (lk8, lv8, lks8, lvs8)}
    ltables = torch.tensor(paged_tables(
        rng, long_np[:, -1].astype(np.int64), tl // PAGE_BS, long_blocks),
        device=dev)
    fns = {(False, False): (dk.decode_attention_slab_chunk,
                            dk.decode_attention_slab_chunk_plain),
           (True, False): (dk.decode_attention_paged_chunk,
                           dk.decode_attention_paged_chunk_plain),
           (False, True): (dk.decode_attention_slab,
                           dk.decode_attention_slab_plain),
           (True, True): (dk.decode_attention_paged,
                          dk.decode_attention_paged_plain)}

    def call(paged, kv, qp, tbl, rows=slice(None), widen=False, plain=False):
        """One kernel call (or its plain version) on ``rows``."""
        k, v, ks, vs = kv
        if ks is not None and widen:
            k, v, ks, vs = (dequantize_heads(k, ks), dequantize_heads(v, vs),
                            None, None)
        extra = {} if ks is None else dict(kscale=ks, vscale=vs)
        qp = qp[rows].clone()       # a fresh, 16-byte aligned buffer
        fn = fns[paged, tq1][plain]
        if paged:
            return fn(q[rows], k, v, qp, tbl[rows], h, **extra)
        return fn(q[rows], k[rows], v[rows], qp, h,
                  **{a: x[rows] for a, x in extra.items()})

    # splits of the longest long-span row: the scratch holds a record a
    # (row, query vector, KV head, split)
    nq = kk * (h // hkv)
    n_split = dk._count("decode_attention_chunk_scratch", s, kk, tl, h, hkv,
                        dh) // (s * nq * hkv * (dh + 4))
    if n_split < SPLIT_MIN_SPLITS:
        fail(f"the long-span case crosses {n_split} splits (want at least "
             f"{SPLIT_MIN_SPLITS})")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(t, device=dev)[None, None, :]
            <= qpos.long().reshape(s, kk)[:, :, None])[:, None]
    qh = q.reshape(s, kk, h, dh).transpose(1, 2)

    def heads(x):               # [S, T, Dkv] -> [S, H, T, dh]
        x = x.reshape(s, t, hkv, dh).transpose(1, 2)
        return x if hkv == h else torch.repeat_interleave(x, h // hkv, 1)

    library = {
        (False, False): lambda: sdpa(qh, heads(slab[False][1][0]),
                                     heads(slab[False][1][1]),
                                     attn_mask=mask),
        (True, False): lambda: sdpa(qh, heads(pk[tables.long()]),
                                    heads(pv[tables.long()]),
                                    attn_mask=mask)}
    names = {(False, False): (dk.NAME, dk.NAME_SLAB),
             (False, True): (dk.NAME_I8, dk.NAME_SLAB_I8),
             (True, False): (dk.NAME_PAGED_CHUNK, dk.NAME_PAGED),
             (True, True): (dk.NAME_PAGED_CHUNK_I8, dk.NAME_PAGED_I8)}
    rows = {}
    for paged, int8 in ((False, False), (False, True), (True, False),
                        (True, True)):
        name = names[paged, int8][tq1]
        main = pool[int8] if paged else slab[int8][1]
        big = pool[int8] if paged else slab[int8][0]
        tbl, tbl_wide = (tables, wide) if paged else (None, None)
        first, second = call(paged, main, qpos, tbl), call(paged, main, qpos,
                                                           tbl)
        ref = call(paged, main, qpos, tbl, plain=True)
        alone = [call(paged, main, qpos, tbl, slice(r, r + 1))
                 for r in range(s)]
        in_wide = call(paged, big, qpos, tbl_wide)
        lkv = lpool[int8] if paged else slab[int8][0]
        ltbl = ltables if paged else None
        long_out = call(paged, lkv, qlong, ltbl)
        long_ref = call(paged, lkv, qlong, ltbl, plain=True)
        f32 = (call(paged, main, qpos, tbl, widen=True),
               call(paged, lkv, qlong, ltbl, widen=True)) if int8 else None
        torch.cuda.synchronize()
        err = float((first - ref).abs().max())
        repeat = bool(torch.equal(first, second))
        row_alone = all(bool(torch.equal(a, first[r:r + 1]))
                        for r, a in enumerate(alone))
        row_wide = bool(torch.equal(in_wide, first))
        long_err = float((long_out - long_ref).abs().max())
        exact = (max(float((first - f32[0]).abs().max()),
                     float((long_out - f32[1]).abs().max()))
                 if int8 else None)
        if not (repeat and row_alone and row_wide) or not err <= KERNEL_TOL \
                or not long_err <= KERNEL_TOL or exact not in (None, 0.0):
            fail(f"{name} (H={h}, Hkv={hkv}, dh={dh}): max abs err {err}, "
                 f"long span {long_err} (bound {KERNEL_TOL}); second launch "
                 f"bit for bit {repeat}, rows alone (S 1) {row_alone}, rows "
                 f"inside a T {tl} span {row_wide}; against the float32 "
                 f"kernel on the dequantized cache {exact} (want 0)")
        row = {"name": name, "h": h, "hkv": hkv, "dh": dh,
               "max_abs_err": err, "repeat_bit_for_bit": repeat,
               "rows_alone_bit_for_bit": row_alone,
               f"rows_in_T{tl}_bit_for_bit": row_wide,
               "long_span": {"T": tl, "splits_longest_row": n_split,
                             "max_abs_err": long_err},
               "err_vs_f32_kernel_on_dequantized": exact}
        if hkv == h:
            row["device_ms"] = graph_ms(torch, lambda: call(paged, main, qpos,
                                                            tbl))
            lib = library.get((paged, int8))
            row["library_device_ms"] = graph_ms(torch, lib) if lib else None
        rows[name] = row
    return rows


def check_flash_kernel(torch, dev, rng, b, t, timed):
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    h, dh = HEADS, D_MODEL // HEADS
    q, k, v = (torch.tensor(normal(rng, (b, h, t, dh)),
                            device=dev) for _ in range(3))
    o, lse = fk.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max(float((o - o_ref).abs().max()),
              float((lse - lse_ref).abs().max()))
    if not err <= KERNEL_TOL:
        fail(f"flash_attention (B={b}, T={t}) disagrees with its plain "
             f"version: max abs err {err} (bound {KERNEL_TOL})")
    row = {"name": fk.NAME, "T": t, "max_abs_err": err}
    if not timed:
        return row
    nbytes = 4 * (4 * b * h * t * dh + b * h * t)
    flops = 4 * dh * b * h * (t * (t + 1) // 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row.update(
        shape={"B": b, "H": h, "T": t, "dh": dh, "causal": True},
        ms=time_ms(torch, lambda: fk.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(torch, lambda: fk.flash_attention_plain(
            q, k, v, causal=True)),
        library_ms=time_ms(torch, lambda: sdpa(q, k, v, is_causal=True)),
        bytes=nbytes, flops=flops)
    tc_bound(row, nbytes, flops)
    return row


def flash_bwd_cost(bh, tq, tk, dh, causal):
    """(bytes, flops) of the forward, the dK/dV and the dQ kernel: each
    input read once and each output written once (lse and delta [BH, Tq]
    besides the [BH, T, dh] operands; the dQ kernel reads q, do, o, k, v
    and lse and writes dq and delta, which dK/dV reads beside q, do, k,
    v and lse), and the products over the (q, k) pairs the mask leaves
    (a causal row t needs t + 1 columns): the forward 2 (s, p v), dK/dV
    4 (s, dp, dv, dk), dQ 3 (s, dp, dq), each 2 * dh FLOPs per pair."""
    pairs = bh * (tq * (tq + 1) // 2 if causal else tq * tk)
    q_side, k_side, row = bh * tq * dh, bh * tk * dh, bh * tq
    return {"fwd": (4 * (2 * q_side + 2 * k_side + row), 4 * dh * pairs),
            "dkv": (4 * (2 * q_side + 4 * k_side + 2 * row), 8 * dh * pairs),
            "dq": (4 * (4 * q_side + 2 * k_side + 2 * row), 6 * dh * pairs)}


def flash_bwd_pair(torch, dev, rng, b, h, tq, tk, dh, causal):
    """The backward pair against flash_attention_bwd_plain on one set of
    inputs (both given the plain forward's o and lse, so the check
    stands alone): each of dq, dk, dv relative to its largest magnitude;
    then a second run, which must equal the first bit for bit."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    q = torch.tensor(normal(rng, (b, h, tq, dh)), device=dev)
    k, v = (torch.tensor(normal(rng, (b, h, tk, dh)), device=dev)
            for _ in range(2))
    do = torch.tensor(normal(rng, (b, h, tq, dh)), device=dev)
    o, lse = fk.flash_attention_plain(q, k, v, causal=causal)
    got = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ref = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    rel = {n: float((g - r).abs().max() / r.abs().max())
           for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    where = (f"B={b}, H={h}, Tq={tq}, Tk={tk}, dh={dh}, "
             f"causal={causal}")
    if not max(rel.values()) <= MT_REL_TOL:
        fail(f"flash backward ({where}) disagrees with its plain version: "
             f"relative errors {rel} (bound {MT_REL_TOL})")
    if not same:
        fail(f"flash backward ({where}): two runs differ")
    return {"shape": where, "rel_err": rel, "bitwise_repeatable": same,
            "max_abs_err": max(float((g - r).abs().max())
                               for g, r in zip(got, ref))}, \
        (q, k, v, o, lse, do)


def check_flash_train(torch, dev, rng):
    """The flash kernels at the MT train path's shape: the forward
    non-causal and causal (max abs err, bound KERNEL_TOL), the backward
    pair causal and not, ragged (non-causal Tq 200 / Tk 136, causal T
    200) and at dh 16, 32 and 128 (each output relative to its largest
    magnitude, bound MT_REL_TOL, and bit for bit equal over two runs);
    timed at the train shape beside the plain versions, the bound and
    the library's scaled_dot_product_attention (its backward timed
    alone: autograd.grad over a retained graph)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    b, h, t, dh = MT_BATCH, MT_HEADS, MT_SEQ, MT_DH
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_rows, checks, rows = {}, [], {}
    for causal in (False, True):
        q, k, v = (torch.tensor(normal(rng, (b, h, t, dh)), device=dev)
                   for _ in range(3))
        o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max(float((o - o_ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
        if not err <= KERNEL_TOL:
            fail(f"flash_attention (B={b}, T={t}, causal={causal}) disagrees "
                 f"with its plain version: max abs err {err} (bound "
                 f"{KERNEL_TOL})")
        cost = flash_bwd_cost(b * h, t, t, dh, causal)
        fwd = {"causal": causal, "max_abs_err": err,
               "ms": time_ms(torch, lambda: fk.flash_attention_fwd(
                   q, k, v, causal=causal), samples=20, reps=5),
               "plain_ms": time_ms(torch, lambda: fk.flash_attention_plain(
                   q, k, v, causal=causal), samples=10, reps=2),
               "library_ms": time_ms(torch, lambda: sdpa(
                   q, k, v, is_causal=causal), samples=20, reps=5),
               "bytes": cost["fwd"][0], "flops": cost["fwd"][1]}
        tc_bound(fwd, *cost["fwd"])
        fwd_rows[causal] = fwd

        row, (q, k, v, o, lse, do) = flash_bwd_pair(torch, dev, rng, b, h,
                                                    t, t, dh, causal)
        checks.append(row)
        scale = 1.0 / math.sqrt(dh)
        _, delta = fk.bwd_dq_kernel(q, k, v, o, lse, do, scale, causal)
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        lib_out = sdpa(qg, kg, vg, is_causal=causal)
        library = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), do, retain_graph=True), samples=20,
            reps=5)
        plain = time_ms(torch, lambda: fk.flash_attention_bwd_plain(
            q, k, v, o, lse, do, scale, causal), samples=10, reps=2)
        for name, fn in (
                (fk.NAME_BWD_DKV, lambda: fk.bwd_dkv_kernel(
                    q, k, v, do, lse, delta, scale, causal)),
                (fk.NAME_BWD_DQ, lambda: fk.bwd_dq_kernel(
                    q, k, v, o, lse, do, scale, causal))):
            key = "dkv" if name == fk.NAME_BWD_DKV else "dq"
            r = {"causal": causal, "ms": time_ms(torch, fn, samples=20,
                                                  reps=5),
                 "plain_ms": plain, "library_ms": library,
                 "bytes": cost[key][0], "flops": cost[key][1],
                 "rel_err": row["rel_err"],
                 "max_abs_err": row["max_abs_err"]}
            tc_bound(r, *cost[key])
            rows.setdefault(name, {})[causal] = r
    for bb, hh, tq, tk, d, causal in ((2, 2, 200, 136, MT_DH, False),
                                      (2, 2, 200, 200, MT_DH, True),
                                      *((1, 2, 77, 77, d, True)
                                        for d in (16, 32, 128)),
                                      *((1, 2, 45, 77, d, False)
                                        for d in (16, 32, 128))):
        checks.append(flash_bwd_pair(torch, dev, rng, bb, hh, tq, tk, d,
                                     causal)[0])
    return fwd_rows, rows, checks


def sdpa_backend(torch, q, k, v, causal):
    """The backend scaled_dot_product_attention picks for these inputs
    (its own dispatch rule, torch._fused_sdp_choice)."""
    names = {0: "MATH", 1: "FLASH_ATTENTION", 2: "EFFICIENT_ATTENTION",
             3: "CUDNN_ATTENTION", 4: "OVERRIDEABLE"}
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "not reported by this torch"
    pick = int(choose(q, k, v, None, 0.0, causal))
    return names.get(pick, str(pick))


def check_flash_wide(torch, dev, rng, control):
    """The flash forward, dK/dV and dQ kernels at the wide head dims
    (_check.WIDE_HEAD_DIMS) at B WIDE_B, H WIDE_H, T WIDE_T, causal and
    full: within WIDE_TC_TOL of the plain versions (the backward given
    the plain forward's o and lse), bit for bit on a second run, and the
    one-TF32-pass build ``control`` (probe_flash.py's tf32_1x library)
    outside it on the same inputs; each timed beside the plain versions,
    its bounds and one scaled_dot_product_attention call (forward, and
    its backward alone: autograd.grad over a retained graph), naming the
    backend SDPA picked.  Returns a list of rows."""
    from paddle_tpu_torch.ops.kernels import _build, _check
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.scripts import probe_flash
    one_fwd, one_dkv, one_dq, _ = probe_flash.entries(control)
    b, h, t = WIDE_B, WIDE_H, WIDE_T
    sdpa = torch.nn.functional.scaled_dot_product_attention
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dh in _check.WIDE_HEAD_DIMS:
        for causal in (False, True):
            q, k, v, do = (torch.tensor(normal(rng, (b, h, t, dh)),
                                        device=dev) for _ in range(4))
            scale = 1.0 / math.sqrt(dh)
            o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
            got = fk.flash_attention_bwd(q, k, v, o_ref, lse_ref, do,
                                         causal=causal)
            again = fk.flash_attention_bwd(q, k, v, o_ref, lse_ref, do,
                                           causal=causal)
            ref = fk.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                               scale, causal)
            # the one-pass control on the same inputs
            o1, lse1 = torch.empty_like(q), torch.empty_like(lse_ref)
            dq1, dk1, dv1 = (torch.empty_like(x) for x in (q, k, v))
            delta1 = torch.empty_like(lse_ref)
            _build.check("tf32_1x", one_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o1.data_ptr(),
                lse1.data_ptr(), b * h, t, t, dh, scale, int(causal),
                stream))
            _build.check("tf32_1x", one_dq(
                *(x.data_ptr() for x in (q, k, v, do, o_ref, lse_ref, delta1,
                                         dq1)),
                b * h, t, t, dh, scale, int(causal), stream))
            _build.check("tf32_1x", one_dkv(
                *(x.data_ptr() for x in (q, k, v, do, lse_ref, delta1, dk1,
                                         dv1)),
                b * h, t, t, dh, scale, int(causal), stream))
            torch.cuda.synchronize()

            def rel(x, r):
                return float((x - r).abs().max() / r.abs().max())

            err = {"fwd": max(float((o - o_ref).abs().max()),
                              float((lse - lse_ref).abs().max())),
                   "dq": rel(got[0], ref[0]),
                   "dkv": max(rel(got[1], ref[1]), rel(got[2], ref[2]))}
            one = {"fwd": max(float((o1 - o_ref).abs().max()),
                              float((lse1 - lse_ref).abs().max())),
                   "dq": rel(dq1, ref[0]),
                   "dkv": max(rel(dk1, ref[1]), rel(dv1, ref[2]))}
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            where = f"B={b}, H={h}, T={t}, dh={dh}, causal={causal}"
            if not max(err.values()) <= WIDE_TC_TOL or not same:
                fail(f"flash kernels ({where}) disagree with their plain "
                     f"versions: {err} (bound {WIDE_TC_TOL}); the backward "
                     f"bit for bit on a second run: {same}")
            if not min(one.values()) > WIDE_TC_TOL:
                fail(f"flash kernels ({where}): the one-TF32-pass control "
                     f"{one} passes the {WIDE_TC_TOL} gate")
            _, delta = fk.bwd_dq_kernel(q, k, v, o_ref, lse_ref, do, scale,
                                        causal)
            qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
            lib_out = sdpa(qg, kg, vg, is_causal=causal)
            cost = flash_bwd_cost(b * h, t, t, dh, causal)
            plain_bwd = time_ms(torch, lambda: fk.flash_attention_bwd_plain(
                q, k, v, o_ref, lse_ref, do, scale, causal), samples=10,
                reps=2)
            lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), do, retain_graph=True), samples=20,
                reps=5)
            row = {"dh": dh, "causal": causal,
                   "shape": {"B": b, "H": h, "T": t},
                   "sdpa_backend": sdpa_backend(torch, q, k, v, causal),
                   "bitwise_repeatable": same, "one_tf32_pass_err": one}
            for key, fn, plain, lib in (
                    ("fwd", lambda: fk.flash_attention_fwd(
                        q, k, v, causal=causal),
                     time_ms(torch, lambda: fk.flash_attention_plain(
                         q, k, v, causal=causal), samples=10, reps=2),
                     time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal),
                             samples=20, reps=5)),
                    ("dkv", lambda: fk.bwd_dkv_kernel(
                        q, k, v, do, lse_ref, delta, scale, causal),
                     plain_bwd, lib_bwd),
                    ("dq", lambda: fk.bwd_dq_kernel(
                        q, k, v, o_ref, lse_ref, do, scale, causal),
                     plain_bwd, lib_bwd)):
                r = {"max_err": err[key],
                     "ms": time_ms(torch, fn, samples=20, reps=5),
                     "plain_ms": plain, "library_ms": lib,
                     "bytes": cost[key][0], "flops": cost[key][1]}
                tc_bound(r, *cost[key])
                row[key] = r
            rows.append(row)
    return rows


def check_flash_padded(torch, dev, rng, kernels):
    """The flash route at a head dim between the compiled ones (dh
    FLASH_PADDED_DH, which the wrappers zero-pad to 128): the forward
    (max abs err of o and lse, bound KERNEL_TOL) and the backward pair
    (each output relative to its largest magnitude, bound MT_REL_TOL,
    and bit for bit over two runs) against the plain versions computed
    at the true dh, causal at the MT train shape's T 256 (B 2) and
    non-causal Tq 200 / Tk 136; then dot_product_attention's flash route
    forward and backward at B 2, H 8, T 256, causal, which must launch
    the forward, dQ and dK/dV kernels once each, its gradients held
    against autograd of the plain forward at MT_REL_TOL."""
    from paddle_tpu_torch.ops import attention as attn_ops
    fk = kernels.flash_attention
    dh, b, h, t = FLASH_PADDED_DH, 2, MT_HEADS, MT_SEQ
    fwd = {}
    for causal, tq, tk in ((True, t, t), (False, 200, 136)):
        q = torch.tensor(normal(rng, (b, h, tq, dh)), device=dev)
        k, v = (torch.tensor(normal(rng, (b, h, tk, dh)), device=dev)
                for _ in range(2))
        o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        fwd[f"causal{int(causal)}"] = max(
            float((o - o_ref).abs().max()),
            float((lse - lse_ref).abs().max()))
    bad = {key: e for key, e in fwd.items() if not e <= KERNEL_TOL}
    if bad:
        fail(f"flash_attention at dh {dh} disagrees with its plain version:"
             f" {bad} (bound {KERNEL_TOL})")
    pairs = [flash_bwd_pair(torch, dev, rng, b, h, tq, tk, dh, causal)[0]
             for causal, tq, tk in ((True, t, t), (False, 200, 136))]
    q, k, v, do = (torch.tensor(normal(rng, (b, h, t, dh)), device=dev)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kernels.reset_launches()
    out = attn_ops.dot_product_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    launched = {fk.NAME: fk.launches, fk.NAME_BWD_DQ: fk.launches_bwd_dq,
                fk.NAME_BWD_DKV: fk.launches_bwd_dkv}
    if launched != dict.fromkeys(launched, 1):
        fail(f"dot_product_attention at dh {dh}: launches {launched}, "
             "want one of each flash kernel")
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = fk.flash_attention_plain(*ref_leaves, causal=True)[0]
    ref_grads = torch.autograd.grad(ref, ref_leaves, do)
    rel = {n: float((x.grad - r).abs().max() / r.abs().max())
           for n, x, r in zip(("dq", "dk", "dv"), leaves, ref_grads)}
    rel["o"] = float((out - ref).detach().abs().max()
                     / ref.detach().abs().max())
    if not max(rel.values()) <= MT_REL_TOL:
        fail(f"dot_product_attention at dh {dh} disagrees with autograd of "
             f"the plain forward: {rel} (bound {MT_REL_TOL})")
    return {"phase": "flash_dh96", "dh": dh, "padded_to":
            fk.padded_head_dim(dh), "forward_max_abs_err": fwd,
            "backward_checks": pairs, "route": {
                "shape": {"B": b, "H": h, "T": t, "causal": True},
                "launches": launched, "rel_err_vs_autograd_of_plain": rel}}


def quantized(torch, dev, rng, shape, hkv):
    """(codes int8, scales f32) of a seeded N(0, 1) K/V on the card, as
    the int8 cache holds them."""
    from paddle_tpu_torch.quant import kv as kvq
    return kvq.quantize_heads(torch.tensor(normal(rng, shape), device=dev),
                              hkv)


I8_LIBRARY_NOTE = ("no single PyTorch call attends over int8 codes with "
                   "per-(position, head) scales")


def check_int8_decode_kernels(torch, dev, rng, hkv):
    """The four int8 instances at the main path's shapes (the slab chunk
    kernel at row 1's, the paged pair and the Tq=1 slab kernel at rows
    3-5's: chunk_qpos over [8, 256] slab rows and over the 129-block pool
    of 16-position blocks with shuffled ids, shared leading blocks and a
    free row on block 0).  Each is held bit for bit against its float32
    kernel run on dequantize_heads(cache), and within KERNEL_TOL against
    its plain version; timed beside the float32 kernel when Hkv = H."""
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    s, kk, t, d, h = 8, CHUNK, SERVE_MAX_LEN, D_MODEL, HEADS
    dh, nb_row = d // h, t // PAGE_BS
    dkv = dh * hkv
    qpos_np = chunk_qpos(t)
    last = qpos_np[:, -1].astype(np.int64)
    tables_np = paged_tables(rng, last, nb_row, PAGE_BLOCKS)
    q = torch.tensor(normal(rng, (s, kk, d)), device=dev)
    q1 = torch.tensor(normal(rng, (s, d)), device=dev)
    (sk, sks), (sv, svs) = (quantized(torch, dev, rng, (s, t, dkv), hkv)
                            for _ in range(2))
    (pk, pks), (pv, pvs) = (quantized(torch, dev, rng,
                                      (PAGE_BLOCKS, PAGE_BS, dkv), hkv)
                            for _ in range(2))
    slab = dict(kscale=sks, vscale=svs)
    pool = dict(kscale=pks, vscale=pvs)
    sk_w, sv_w = dequantize_heads(sk, sks), dequantize_heads(sv, svs)
    pk_w, pv_w = dequantize_heads(pk, pks), dequantize_heads(pv, pvs)
    qpos = torch.tensor(qpos_np, device=dev)
    pos = torch.tensor(qpos_np[:, -1].copy(), device=dev)
    tables = torch.tensor(tables_np, device=dev)
    # name -> (int8 kernel, float32 kernel on the dequantized cache, plain)
    calls = {
        dk.NAME_I8: (
            lambda: dk.decode_attention_slab_chunk(q, sk, sv, qpos, h, **slab),
            lambda: dk.decode_attention_slab_chunk(q, sk_w, sv_w, qpos, h),
            lambda: dk.decode_attention_slab_chunk_plain(q, sk, sv, qpos, h,
                                                         **slab)),
        dk.NAME_SLAB_I8: (
            lambda: dk.decode_attention_slab(q1, sk, sv, pos, h, **slab),
            lambda: dk.decode_attention_slab(q1, sk_w, sv_w, pos, h),
            lambda: dk.decode_attention_slab_plain(q1, sk, sv, pos, h,
                                                   **slab)),
        dk.NAME_PAGED_I8: (
            lambda: dk.decode_attention_paged(q1, pk, pv, pos, tables, h,
                                              **pool),
            lambda: dk.decode_attention_paged(q1, pk_w, pv_w, pos, tables,
                                              h),
            lambda: dk.decode_attention_paged_plain(q1, pk, pv, pos, tables,
                                                    h, **pool)),
        dk.NAME_PAGED_CHUNK_I8: (
            lambda: dk.decode_attention_paged_chunk(q, pk, pv, qpos, tables,
                                                    h, **pool),
            lambda: dk.decode_attention_paged_chunk(q, pk_w, pv_w, qpos,
                                                    tables, h),
            lambda: dk.decode_attention_paged_chunk_plain(
                q, pk, pv, qpos, tables, h, **pool))}
    rows = {}
    for name, (fn, f32, plain) in calls.items():
        out, twin, ref = fn(), f32(), plain()
        torch.cuda.synchronize()
        exact = float((out - twin).abs().max())
        err = float((out - ref).abs().max())
        if exact != 0.0 or not err <= KERNEL_TOL:
            fail(f"{name} (Hkv={hkv}): max abs err {exact} against the "
                 f"float32 kernel on the dequantized cache (want 0), {err} "
                 f"against its plain version (bound {KERNEL_TOL})")
        rows[name] = {"name": name, "hkv": hkv, "max_abs_err": err,
                      "err_vs_f32_kernel_on_dequantized": exact}
    if hkv != h:
        return rows
    # this run's work, as the float32 rows count it, with each K/V value
    # one byte and each (position, KV head) two f32 scales beside it
    decode_rows = qpos_np[:, -1] == qpos_np[:, 0]
    live = np.where(decode_rows[:, None], np.arange(kk)[None] == 0, True)
    need = last // PAGE_BS + 1
    reached = {int(tables_np[r, j]) for r in range(s) for j in range(need[r])}
    per_pos = 2 * dkv + 2 * 4 * hkv
    pool_bytes = per_pos * len(reached) * PAGE_BS
    tq1_flops = 4 * dh * h * int((last + 1).sum())
    chunk_flops = 4 * dh * h * int(((qpos_np + 1) * live).sum())
    span = int((last + 1).sum())
    costs = {
        dk.NAME_I8: (4 * (s * kk * d + int(live.sum()) * d + s * kk)
                     + per_pos * span, chunk_flops),
        dk.NAME_SLAB_I8: (4 * (2 * s * d + s) + per_pos * span, tq1_flops),
        dk.NAME_PAGED_I8: (4 * (2 * s * d + s + int(need.sum()))
                           + pool_bytes, tq1_flops),
        dk.NAME_PAGED_CHUNK_I8: (
            4 * (int(live.sum()) * d + s * kk * d + s * kk + int(need.sum()))
            + pool_bytes, chunk_flops)}
    for name, (fn, f32, plain) in calls.items():
        nbytes, flops = costs[name]
        rows[name].update(
            shape={"S": s, "K": kk if name in (dk.NAME_I8,
                                               dk.NAME_PAGED_CHUNK_I8) else 1,
                   "T": t, "D": d, "H": h, "Hkv": hkv,
                   "block_size": PAGE_BS, "pool_blocks": PAGE_BLOCKS,
                   "blocks_reached": len(reached)},
            ms=time_ms(torch, fn), f32_kernel_ms=time_ms(torch, f32),
            plain_ms=time_ms(torch, plain), library_ms=None,
            library_note=I8_LIBRARY_NOTE, bytes=nbytes, flops=flops)
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(nbytes, flops)
    return rows


def check_flash_quant_kernel(torch, dev, rng, b, t, hkv, timed, h=HEADS,
                             dh=D_MODEL // HEADS):
    """flash_attention_quant on q [B, T, H * dh] and an int8 cache
    [B, T, Hkv * dh]: bit for bit against the float32 flash kernel on the
    dequantized, head-repeated K/V, within KERNEL_TOL of its plain
    version."""
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    q = torch.tensor(normal(rng, (b, t, h * dh)), device=dev)
    (k, ks), (v, vs) = (quantized(torch, dev, rng, (b, t, hkv * dh), hkv)
                        for _ in range(2))

    def heads(x, n):
        return x.reshape(b, t, n, dh).transpose(1, 2)

    qh = heads(q, h).contiguous()
    kw = attn_ops.repeat_kv_heads(heads(dequantize_heads(k, ks), hkv),
                                  h).contiguous()
    vw = attn_ops.repeat_kv_heads(heads(dequantize_heads(v, vs), hkv),
                                  h).contiguous()

    def run():
        return fk.flash_attention_quant(q, k, v, ks, vs, h, causal=True)

    def f32():
        return fk.flash_attention(qh, kw, vw, causal=True)

    def plain():
        return fk.flash_attention_quant_plain(q, k, v, ks, vs, h, causal=True)

    out, twin, ref = run(), f32(), plain()
    torch.cuda.synchronize()
    exact = float((out - twin).abs().max())
    err = float((out - ref).abs().max())
    if exact != 0.0 or not err <= KERNEL_TOL:
        fail(f"flash_attention_quant (B={b}, T={t}, Hkv={hkv}): max abs err "
             f"{exact} against the float32 kernel on the dequantized K/V "
             f"(want 0), {err} against its plain version (bound "
             f"{KERNEL_TOL})")
    row = {"name": fk.NAME_QUANT, "T": t, "hkv": hkv, "dh": dh,
           "max_abs_err": err, "err_vs_f32_kernel_on_dequantized": exact}
    if not timed:
        return row
    nbytes = (4 * b * t * h * dh + b * t * (2 * hkv * dh + 2 * 4 * hkv)
              + 4 * b * h * t * dh)
    flops = 4 * dh * b * h * (t * (t + 1) // 2)
    row.update(
        shape={"B": b, "H": h, "Hkv": hkv, "T": t, "dh": dh, "causal": True},
        ms=time_ms(torch, run), f32_kernel_ms=time_ms(torch, f32),
        plain_ms=time_ms(torch, plain), library_ms=None,
        library_note=I8_LIBRARY_NOTE, bytes=nbytes, flops=flops)
    tc_bound(row, nbytes, flops)
    return row


def check_head_dims(torch, dev, rng):
    """Every kernel of the attention family at other head dims it takes,
    on small ragged shapes: the decode kernels at HEAD_DIMS_CHECKED (6, 8,
    24 and 96 padded to a compiled width inside the kernel; 6 loads its
    values, 8 and 24 their int8 codes, one at a time) -- GQA, K = 5 lanes over T = 77 for the
    slab chunk kernel, the same rows over a shuffled pool of 8-position
    blocks for the paged chunk kernel, lane 0 of each row for the Tq=1
    pair (at GQA and at H = Hkv), and the int8 instance of each of the
    four on the same rows;
    causal T = 45 and non-causal Tq = 19, Tk = 45 for the flash forward
    and its backward pair (each output relative to its largest entry,
    bound MT_REL_TOL, and bit for bit on a second run), and
    flash_attention_quant at causal T = 45, Hkv = 2 (widths between the
    compiled ones zero-padded by the wrappers; 256, 384 and 512 the wide
    instances)."""
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    errs, exacts, bwd_rel = {}, {}, {}

    def err(name, dh, got, want):
        errs[f"{name}/dh{dh}"] = float((got - want).abs().max())

    def exact(name, dh, got, want):
        exacts[f"{name}/dh{dh}"] = float((got - want).abs().max())

    for dh in HEAD_DIMS_CHECKED:
        h, hkv, kk, t, bs = 4, 2, 5, 77, 8
        q = torch.tensor(normal(rng, (3, kk, h * dh)), device=dev)
        k = torch.tensor(normal(rng, (3, t, hkv * dh)), device=dev)
        v = torch.tensor(normal(rng, (3, t, hkv * dh)), device=dev)
        live = np.asarray([1, 5, 3])
        start = np.asarray([40, 0, t - 3])
        qpos = torch.tensor(start[:, None] + np.minimum(
            np.arange(kk)[None], live[:, None] - 1), dtype=torch.int32,
            device=dev)
        err(dk.NAME, dh, dk.decode_attention_slab_chunk(q, k, v, qpos, h),
            dk.decode_attention_slab_chunk_plain(q, k, v, qpos, h))
        nb_row = -(-t // bs)
        tables = torch.tensor(rng.permutation(np.arange(1, 3 * nb_row + 1))
                              .reshape(3, nb_row), dtype=torch.int32,
                              device=dev)
        tables[2, :4] = tables[1, :4]               # shared leading blocks
        pk, pv = (torch.tensor(normal(rng, (3 * nb_row + 1, bs, hkv * dh)),
                               device=dev) for _ in range(2))
        err(dk.NAME_PAGED_CHUNK, dh,
            dk.decode_attention_paged_chunk(q, pk, pv, qpos, tables, h),
            dk.decode_attention_paged_chunk_plain(q, pk, pv, qpos, tables, h))
        q1, pos = q[:, 0].contiguous(), qpos[:, 0].contiguous()
        err(dk.NAME_PAGED, dh,
            dk.decode_attention_paged(q1, pk, pv, pos, tables, h),
            dk.decode_attention_paged_plain(q1, pk, pv, pos, tables, h))
        err(dk.NAME_SLAB, dh, dk.decode_attention_slab(q1, k, v, pos, h),
            dk.decode_attention_slab_plain(q1, k, v, pos, h))
        # the int8 instances: bit for bit against the float32 kernels on
        # the dequantized cache
        (k8, k8s), (v8, v8s) = (quantized(torch, dev, rng, k.shape, hkv)
                                for _ in range(2))
        (p8, p8s), (w8, w8s) = (quantized(torch, dev, rng, pk.shape, hkv)
                                for _ in range(2))
        slab, pool = dict(kscale=k8s, vscale=v8s), dict(kscale=p8s,
                                                       vscale=w8s)
        kw, vw = dequantize_heads(k8, k8s), dequantize_heads(v8, v8s)
        pw, ww = dequantize_heads(p8, p8s), dequantize_heads(w8, w8s)
        exact(dk.NAME_I8, dh,
              dk.decode_attention_slab_chunk(q, k8, v8, qpos, h, **slab),
              dk.decode_attention_slab_chunk(q, kw, vw, qpos, h))
        exact(dk.NAME_PAGED_CHUNK_I8, dh,
              dk.decode_attention_paged_chunk(q, p8, w8, qpos, tables, h,
                                              **pool),
              dk.decode_attention_paged_chunk(q, pw, ww, qpos, tables, h))
        exact(dk.NAME_PAGED_I8, dh,
              dk.decode_attention_paged(q1, p8, w8, pos, tables, h, **pool),
              dk.decode_attention_paged(q1, pw, ww, pos, tables, h))
        exact(dk.NAME_SLAB_I8, dh,
              dk.decode_attention_slab(q1, k8, v8, pos, h, **slab),
              dk.decode_attention_slab(q1, kw, vw, pos, h))
        # the Tq=1 pair at H = Hkv = 2 (one query vector a CTA, the
        # instance the grouped heads above do not launch), float32
        # against the plain versions, int8 against the float32 kernels
        qm = torch.tensor(normal(rng, (3, 2 * dh)), device=dev)
        for paged in (False, True):
            shape = (3 * nb_row + 1, bs, 2 * dh) if paged else (3, t, 2 * dh)
            km, vm = (torch.tensor(normal(rng, shape), device=dev)
                      for _ in range(2))
            (k8, k8s), (v8, v8s) = (quantized(torch, dev, rng, shape, 2)
                                    for _ in range(2))
            kw, vw = dequantize_heads(k8, k8s), dequantize_heads(v8, v8s)
            tbl = (tables,) if paged else ()
            fn, plain, name, name8 = (
                (dk.decode_attention_paged, dk.decode_attention_paged_plain,
                 dk.NAME_PAGED, dk.NAME_PAGED_I8) if paged else
                (dk.decode_attention_slab, dk.decode_attention_slab_plain,
                 dk.NAME_SLAB, dk.NAME_SLAB_I8))
            err(f"{name}/mha", dh, fn(qm, km, vm, pos, *tbl, 2),
                plain(qm, km, vm, pos, *tbl, 2))
            exact(f"{name8}/mha", dh,
                  fn(qm, k8, v8, pos, *tbl, 2, kscale=k8s, vscale=v8s),
                  fn(qm, kw, vw, pos, *tbl, 2))
        for causal, tq in ((True, 45), (False, 19)):
            q = torch.tensor(normal(rng, (1, 2, tq, dh)), device=dev)
            k = torch.tensor(normal(rng, (1, 2, 45, dh)), device=dev)
            v = torch.tensor(normal(rng, (1, 2, 45, dh)), device=dev)
            o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
            errs[f"flash_attention/dh{dh}/causal{int(causal)}"] = max(
                float((o - o_ref).abs().max()),
                float((lse - lse_ref).abs().max()))
            bwd_rel[f"dh{dh}/causal{int(causal)}"] = flash_bwd_pair(
                torch, dev, rng, 1, 2, tq, 45, dh, causal)[0]["rel_err"]
        # flash_attention_quant, ragged T = 45 with GQA: bit for bit
        # against the float32 kernel on the dequantized, repeated heads
        qf = torch.tensor(normal(rng, (2, 45, h * dh)), device=dev)
        (kq, kqs), (vq, vqs) = (quantized(torch, dev, rng,
                                          (2, 45, hkv * dh), hkv)
                                for _ in range(2))

        def heads(x, n):
            return x.reshape(2, 45, n, dh).transpose(1, 2)

        exact(fk.NAME_QUANT, dh,
              fk.flash_attention_quant(qf, kq, vq, kqs, vqs, h),
              fk.flash_attention(
                  heads(qf, h).contiguous(),
                  attn_ops.repeat_kv_heads(
                      heads(dequantize_heads(kq, kqs), hkv), h).contiguous(),
                  attn_ops.repeat_kv_heads(
                      heads(dequantize_heads(vq, vqs), hkv), h).contiguous(),
                  causal=True))
        err(fk.NAME_QUANT, dh,
            fk.flash_attention_quant(qf, kq, vq, kqs, vqs, h),
            fk.flash_attention_quant_plain(qf, kq, vq, kqs, vqs, h))
    torch.cuda.synchronize()
    bad = {k: e for k, e in errs.items() if not e <= KERNEL_TOL}
    bad.update({k: e for k, e in exacts.items() if e != 0.0})
    if bad:
        fail(f"kernels disagree with their plain versions (bound "
             f"{KERNEL_TOL}) or, int8, with their float32 kernels on the "
             f"dequantized cache (want 0): {bad}")
    return {"vs_plain": errs, "int8_vs_f32_kernel": exacts,
            "flash_backward_rel_err": bwd_rel}


def lstm_inputs(torch, dev, rng, t, b, d, ragged, w_scale=0.1):
    """(lengths, xs [T, B, 4D], mask [T, B], w_r, checks) at the JAX
    tests' scale (W_r at ``w_scale``).  Ragged: random lengths with one
    empty row and one full row; else every row full, as the train path's
    batch is."""
    lengths = np.full(b, t)
    if ragged:
        lengths = rng.randint(1, t + 1, b)
        lengths[0] = 0
        lengths[-1] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (lengths,
            torch.tensor(normal(rng, (t, b, 4 * d)) * 0.3, device=dev),
            torch.tensor(mask, device=dev),
            torch.tensor(normal(rng, (d, 4 * d)) * w_scale, device=dev),
            torch.tensor(normal(rng, (3, d)) * 0.1, device=dev))


def lstm_cost(lengths, t, d):
    """(bytes, flops) of the forward with residuals and of the backward
    with dW_r on these inputs.  Bytes: each input read once, each output
    written once.  Operations: the recurrent products these lengths
    need.  The forward needs h_{t-1} @ W_r at every step t >= 1 of a row
    that ever started (acts are outputs even where the mask is 0; an
    empty row's h stays 0); the backward needs dgates_t @ W_r^T and
    h_{t-1}^T dgates_t only where the mask is 1 and t >= 1 (elsewhere
    dgates_t is 0).  The cell's ~30 elementwise operations per unit and
    step are under 1 % of it."""
    b, g = len(lengths), 4 * d
    fwd_bytes = 4 * (2 * t * b * g + d * g + 3 * d + t * b + 2 * t * b * d
                     + b * d)
    bwd_bytes = 4 * (2 * t * b * g + 3 * t * b * d + 2 * d * g + 3 * d
                     + t * b + b * d + 3 * b * d)
    fwd_rows = (t - 1) * int((lengths > 0).sum())
    bwd_rows = int(np.maximum(lengths - 1, 0).sum())
    return ((fwd_bytes, 2 * fwd_rows * d * g),
            (bwd_bytes, 2 * 2 * bwd_rows * d * g))


def lstm_pair(torch, dev, rng, t, b, d, ragged):
    """Forward (both variants) and backward kernels against their plain
    versions on one set of inputs; the backward gets the plain forward's
    residuals on both sides so that its check stands alone.  Returns the
    two result rows, the four calls (kernel, plain) x (fwd, bwd) and the
    call of the dW_r product alone."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import lstm as lk
    lengths, xs, mask, w_r, checks = lstm_inputs(torch, dev, rng, t, b, d,
                                                 ragged)
    ref = lk.lstm_fwd_plain(xs, mask, w_r, checks, True)
    got = lk.lstm_fwd(xs, mask, w_r, checks, True)
    lean = lk.lstm_fwd(xs, mask, w_r, checks, False)
    dh_out = torch.tensor(normal(rng, (t, b, d)), device=dev)
    dcfin = torch.tensor(normal(rng, (b, d)), device=dev)
    _, _, cs, acts = ref
    bwd_args = (acts, cs, ref[0], w_r, checks, mask, dh_out, dcfin)
    gb = lk.lstm_bwd(*bwd_args)
    rb = lk.lstm_bwd_plain(*bwd_args)
    torch.cuda.synchronize()

    def err(x, y):
        return float((x - y).abs().max())

    fwd_err = max([err(x, y) for x, y in zip(got, ref)]
                  + [err(lean[0], ref[0]), err(lean[1], ref[1])])
    dxs_err = err(gb[0], rb[0])
    rel = {"dW_r": err(gb[1], rb[1]) / float(rb[1].abs().max()),
           "dchecks": err(gb[2], rb[2]) / float(rb[2].abs().max())}
    if not fwd_err <= LSTM_TOL or not dxs_err <= LSTM_TOL \
            or not max(rel.values()) <= LSTM_REL_TOL:
        fail(f"LSTM kernels (T={t}, B={b}, D={d}, ragged={ragged}) disagree "
             f"with their plain versions: forward max abs err {fwd_err}, "
             f"dxs {dxs_err} (bound {LSTM_TOL}); relative {rel} (bound "
             f"{LSTM_REL_TOL})")
    tc_err = max([fwd_err, dxs_err] + list(rel.values()))
    if not tc_err <= LSTM_TC_TOL:
        fail(f"LSTM kernels (T={t}, B={b}, D={d}, ragged={ragged}): error "
             f"{tc_err} exceeds the 3xTF32 gate {LSTM_TC_TOL} (one TF32 "
             f"pass lands above it)")
    if ragged and got[0][:, 0].any():
        fail("lstm_fwd: the empty row's hs is not exactly 0")
    rows = [{"name": lk.NAME_FWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": fwd_err},
            {"name": lk.NAME_BWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": max(dxs_err, err(gb[1], rb[1]),
                                err(gb[2], rb[2])),
             "dxs_max_abs_err": dxs_err, "rel_err": rel}]
    dwr = torch.empty_like(w_r)
    dwr_entry = _build.entry("lstm", "lstm_dwr_f32", 3, 3)
    stream = torch.cuda.current_stream().cuda_stream

    def dwr_only():     # dW_r alone: the backward's second launch
        _build.check(lk.NAME_BWD, dwr_entry(
            ref[0].data_ptr(), gb[0].data_ptr(), dwr.data_ptr(), t, b, d,
            stream))

    calls = ((lambda: lk.lstm_fwd(xs, mask, w_r, checks, True),
              lambda: lk.lstm_fwd_plain(xs, mask, w_r, checks, True)),
             (lambda: lk.lstm_bwd(*bwd_args),
              lambda: lk.lstm_bwd_plain(*bwd_args)),
             dwr_only)
    return rows, calls, lstm_cost(lengths, t, d)


def check_lstm_kernels(torch, dev, rng, t, b, d, timed):
    """The LSTM pair on a ragged mask (with an empty row); when timed,
    also on the train path's own data (every row full length), which is
    what the times and the bound are taken on."""
    rows, _, _ = lstm_pair(torch, dev, rng, t, b, d, ragged=True)
    if not timed:
        return rows
    full, calls, costs = lstm_pair(torch, dev, rng, t, b, d, ragged=False)
    library = ("no single PyTorch call computes this function: cuDNN's "
               "LSTM has no peepholes and no masked carry freeze")
    for row, row_full, (fn, plain), (nbytes, flops) in zip(rows, full,
                                                           calls[:2], costs):
        row.update(max_abs_err=max(row["max_abs_err"],
                                   row_full["max_abs_err"]),
                   full_rows_check=row_full,
                   shape={"T": t, "B": b, "D": d, "timed_on": "full rows"},
                   ms=time_ms(torch, fn, samples=20, reps=5),
                   plain_ms=time_ms(torch, plain, samples=5, reps=2),
                   library_ms=None, library_note=library,
                   bytes=nbytes, flops=flops)
        tc_bound(row, nbytes, flops)
    # the backward's split: dW_r alone (its second launch), BPTT the rest;
    # dW_r's bound: hs and dxs read once, dW_r written once, its product
    dwr_ms = time_ms(torch, calls[2], samples=20, reps=5)
    dwr_flops = costs[1][1] // 2
    dwr_bytes = 4 * ((t - 1) * b * (d + 4 * d) + 4 * d * d)
    rows[1]["split"] = {"dW_r_ms": dwr_ms, "bptt_ms": rows[1]["ms"] - dwr_ms,
                        "dW_r_bound_ms": bound(dwr_bytes, dwr_flops,
                                               PEAK_3XTF32_FLOPS)[0]}
    return rows


def check_lstm_tf32_control(torch, dev):
    """The tf32_1x variant of csrc/lstm.cu (one TF32 product a k-step,
    scripts/probe_lstm.py) and the kernels as built, on one set of train
    shape inputs: the kernels pass LSTM_TC_TOL and the variant must not,
    or the gate could not tell one pass from 3xTF32."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.scripts import probe_lstm
    (control, _), = probe_lstm.build(["tf32_1x"]).values()
    case = probe_lstm.Case(dev, np.random.RandomState(1), LSTM_T, LSTM_B,
                           LSTM_D)
    kernel = (_build.entry("lstm", "lstm_fwd_f32", 8, 4),
              _build.entry("lstm", "lstm_bwd_f32", 14, 3),
              _build.entry("lstm", "lstm_dwr_f32", 3, 3))
    errs = {"kernel": case.errors(kernel), "tf32_1x": case.errors(control)}
    worst = {name: max(e.values()) for name, e in errs.items()}
    if not worst["kernel"] <= LSTM_TC_TOL or worst["tf32_1x"] <= LSTM_TC_TOL:
        fail(f"3xTF32 gate {LSTM_TC_TOL}: the LSTM kernels read {errs['kernel']}"
             f", the one-pass control {errs['tf32_1x']} (the control must "
             "fail the gate, the kernels pass it)")
    return {"shape": {"T": LSTM_T, "B": LSTM_B, "D": LSTM_D},
            "gate": LSTM_TC_TOL, "errors": errs}


def lstm_card_vs_cpu(torch, dev, rng, kernels, b, lengths, reverse, **kw):
    """rnn.lstm (T 30, D 128) on the card against the same call on the
    CPU: loss and every gradient, relative to each one's largest entry;
    with the LSTM launches the card's call made."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import rnn
    t, d = 30, 128
    x = normal(rng, (b, t, 4 * d)) * 0.3
    w_r = normal(rng, (d, 4 * d)) * 0.1
    rest = [normal(rng, (d,)) * 0.1 for _ in range(3)] \
        + [normal(rng, (4 * d,)) * 0.1]

    def run(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, w_r, *rest)]
        out, final = rnn.lstm(
            SequenceBatch(args[0], torch.tensor(lengths, device=device)),
            args[1], bias=args[5], check_i=args[2], check_f=args[3],
            check_o=args[4], reverse=reverse, **kw)
        loss = (out.data ** 2).sum() + (final.c ** 2).sum() + final.h.sum()
        loss.backward()
        return float(loss.detach()), [a.grad.cpu() for a in args]

    kernels.reset_launches()
    loss_c, grads_c = run(dev)
    launches = {kernels.lstm.NAME_FWD: kernels.lstm.launches_fwd,
                kernels.lstm.NAME_BWD: kernels.lstm.launches_bwd,
                kernels.lstm_blocked.NAME_FWD:
                    kernels.lstm_blocked.launches_fwd}
    loss_r, grads_r = run("cpu")
    worst = max(float((g - r).abs().max() / r.abs().max())
                for g, r in zip(grads_c, grads_r))
    return abs(loss_c - loss_r) / abs(loss_r), worst, launches


def check_lstm_reverse(torch, dev, rng, kernels):
    """rnn.lstm(reverse=True) on the card (kernels, through LstmFused:
    B 8, D 128 is the resident route's) against the same call on the CPU
    (plain versions), on a ragged batch with an empty row."""
    lengths = np.asarray([0, 30, 7, 19, 1, 12, 30, 3], np.int32)
    loss_err, worst, launches = lstm_card_vs_cpu(
        torch, dev, rng, kernels, len(lengths), lengths, True)
    want = {kernels.lstm.NAME_FWD: 1, kernels.lstm.NAME_BWD: 1,
            kernels.lstm_blocked.NAME_FWD: 0}
    if launches != want or not worst <= LSTM_REL_TOL \
            or not loss_err <= LSTM_REL_TOL:
        fail(f"reverse rnn.lstm: launches {launches} (want {want}); card vs "
             f"CPU relative error loss {loss_err}, grads {worst} (bound "
             f"{LSTM_REL_TOL})")
    return {"reverse_lstm": {"B": len(lengths), "D": 128},
            "loss_rel_err": loss_err, "grad_rel_err": worst}


def check_lstm_scan(torch, dev, rng, kernels):
    """Where JAX's rules send rnn.lstm to the masked scan (B % 8 != 0, a
    non-default activation), the card runs the scan too: it matches the
    CPU's and launches no kernel."""
    rows = []
    for b, kw in ((5, {}), (8, {"act": "relu"})):
        lengths = rng.randint(1, 31, b).astype(np.int32)
        lengths[0] = 0
        loss_err, worst, launches = lstm_card_vs_cpu(
            torch, dev, rng, kernels, b, lengths, False, **kw)
        if any(launches.values()) or not worst <= LSTM_REL_TOL \
                or not loss_err <= LSTM_REL_TOL:
            fail(f"rnn.lstm scan (B {b}, {kw}): launches {launches} (want "
                 f"none); card vs CPU relative error loss {loss_err}, grads "
                 f"{worst} (bound {LSTM_REL_TOL})")
        rows.append({"B": b, "D": 128, **kw, "loss_rel_err": loss_err,
                     "grad_rel_err": worst, "launches": launches})
    return rows


def blocked_check(torch, dev, rng, t, b, d, ragged):
    """The blocked forward, both variants, against its plain version on
    one set of inputs (W_r std 1/sqrt(D)).  Returns the result row, the
    (kernel, plain) calls and the forward's (bytes, flops)."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    from paddle_tpu_torch.ops.kernels import lstm_blocked as bk
    lengths, xs, mask, w_r, checks = lstm_inputs(
        torch, dev, rng, t, b, d, ragged, w_scale=1.0 / math.sqrt(d))
    ref = lk.lstm_fwd_plain(xs, mask, w_r, checks, True)
    got = bk.lstm_blocked_fwd(xs, mask, w_r, checks, True)
    lean = bk.lstm_blocked_fwd(xs, mask, w_r, checks, False)
    torch.cuda.synchronize()
    err = max([float((x - y).abs().max()) for x, y in zip(got, ref)]
              + [float((lean[i] - ref[i]).abs().max()) for i in (0, 1)])
    if not err <= KERNEL_TOL:
        fail(f"lstm_blocked_fwd (T={t}, B={b}, D={d}, ragged={ragged}) "
             f"disagrees with its plain version: max abs err {err} (bound "
             f"{KERNEL_TOL})")
    if not err <= BLK_TC_TOL:
        fail(f"lstm_blocked_fwd (T={t}, B={b}, D={d}, ragged={ragged}): "
             f"max abs err {err} exceeds the 3xTF32 gate {BLK_TC_TOL} (one "
             f"TF32 pass lands above it)")
    if ragged and got[0][:, 0].any():
        fail("lstm_blocked_fwd: the empty row's hs is not exactly 0")
    calls = (lambda: bk.lstm_blocked_fwd(xs, mask, w_r, checks, True),
             lambda: lk.lstm_fwd_plain(xs, mask, w_r, checks, True))
    return ({"name": bk.NAME_FWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": err}, calls, lstm_cost(lengths, t, d)[0])


def check_blocked_kernel(torch, dev, rng):
    """The blocked forward at the train shape for each of BLK_TIMED on a
    ragged mask (with an empty row) and on full rows, timed on the
    latter (the train batch's rows) beside its plain version and its
    bound; then ragged at BLK_OTHER; then the gain probe."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    from paddle_tpu_torch.ops.kernels import lstm_blocked as bk
    timed = {}
    for d in BLK_TIMED:
        row, _, _ = blocked_check(torch, dev, rng, BLK_T, BLK_B, d, True)
        full, (fn, plain), (nbytes, flops) = blocked_check(
            torch, dev, rng, BLK_T, BLK_B, d, False)
        row.update(
            max_abs_err=max(row["max_abs_err"], full["max_abs_err"]),
            full_rows_max_abs_err=full["max_abs_err"],
            timed_on="full rows", ms=time_ms(torch, fn, samples=10, reps=3),
            plain_ms=time_ms(torch, plain, samples=3, reps=2),
            library_ms=None,
            library_note="no single PyTorch call computes this function: "
                         "cuDNN's LSTM has no peepholes and no masked "
                         "carry freeze", bytes=nbytes, flops=flops)
        tc_bound(row, nbytes, flops)
        # W_r read again at each of the T - 1 steps with a product, from
        # HBM: what a W_r streamed every step costs where it outgrows L2
        row["bound_w_r_streamed_ms"] = (BLK_T - 1) * 4 * d * 4 * d \
            / PEAK_BYTES_S * 1e3
        timed[d] = row
    other = [blocked_check(torch, dev, rng, t, b, d, True)[0]
             for t, b, d in BLK_OTHER]
    # W_r at the JAX tests' 0.1: the kernel's distance from its plain
    # version beside that of the plain version on the card from the same
    # plain version on the CPU (reported, not bounded: a measure of the
    # recurrence's gain, not of the kernel)
    _, xs, mask, w_r, checks = lstm_inputs(torch, dev, rng, BLK_T, BLK_B,
                                           BLK_TIMED[0], False,
                                           w_scale=BLK_GAIN_PROBE)
    ref = lk.lstm_fwd_plain(xs, mask, w_r, checks, False)[0]
    got = bk.lstm_blocked_fwd(xs, mask, w_r, checks, False)[0]
    cpu = lk.lstm_fwd_plain(*(a.cpu() for a in (xs, mask, w_r, checks)),
                            False)[0]
    probe = {"D": BLK_TIMED[0], "w_scale": BLK_GAIN_PROBE,
             "kernel_vs_plain_hs": float((got - ref).abs().max()),
             "plain_card_vs_plain_cpu_hs": float(
                 (ref.cpu() - cpu).abs().max()),
             "hs_max": float(cpu.abs().max())}
    return timed, other, probe


def gru_inputs(torch, dev, rng, t, b, d, ragged):
    """(lengths, xs [T, B, 3D], mask [T, B], w_gate, w_state) at the JAX
    tests' scale.  Ragged: random lengths with one empty row and one
    full row; else every row full, as the train path's batch is."""
    lengths = np.full(b, t)
    if ragged:
        lengths = rng.randint(1, t + 1, b)
        lengths[0] = 0
        lengths[-1] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (lengths,
            torch.tensor(normal(rng, (t, b, 3 * d)) * 0.3, device=dev),
            torch.tensor(mask, device=dev),
            torch.tensor(normal(rng, (d, 2 * d)) * 0.1, device=dev),
            torch.tensor(normal(rng, (d, d)) * 0.1, device=dev))


def gru_cost(lengths, t, d):
    """(bytes, flops) of the forward with residuals and of the backward
    with dW_gate and dW_state on these inputs.  Bytes: each input read
    once, each output written once.  Operations: the recurrent products
    these lengths need, 6 D^2 a row and step each way.  The forward
    needs h_{t-1} W_gate and (r h_{t-1}) W_state at every step t >= 1 of
    a row that ever started (acts are outputs even where the mask is 0;
    an empty row's h stays 0); the backward needs dccg W_state^T,
    dgates W_gate^T and the two dW terms only where the mask is 1 and
    t >= 1 (elsewhere dgates and dccg m are 0, and h_{-1} = 0)."""
    b = len(lengths)
    fwd_bytes = 4 * (7 * t * b * d + t * b + 3 * d * d)
    bwd_bytes = 4 * (8 * t * b * d + t * b + 6 * d * d)
    fwd_rows = (t - 1) * int((lengths > 0).sum())
    bwd_rows = int(np.maximum(lengths - 1, 0).sum())
    return ((fwd_bytes, 6 * d * d * fwd_rows),
            (bwd_bytes, 12 * d * d * bwd_rows))


def gru_pair(torch, dev, rng, t, b, d, ragged):
    """Forward (both variants) and backward kernels against their plain
    versions on one set of inputs; the backward gets the plain forward's
    residuals on both sides so that its check stands alone.  Each check
    also within GRU_TC_TOL, and a second launch of each kernel bit for
    bit the first.  Returns the two result rows, the calls (kernel,
    plain) x (fwd, bwd) and the costs."""
    from paddle_tpu_torch.ops.kernels import gru as gk
    lengths, xs, mask, w_gate, w_state = gru_inputs(torch, dev, rng, t, b,
                                                    d, ragged)
    ref = gk.gru_fwd_plain(xs, mask, w_gate, w_state, True)
    got = gk.gru_fwd(xs, mask, w_gate, w_state, True)
    lean, _ = gk.gru_fwd(xs, mask, w_gate, w_state, False)
    dh_out = torch.tensor(normal(rng, (t, b, d)), device=dev)
    bwd_args = (ref[1], ref[0], w_gate, w_state, mask, dh_out)
    gb = gk.gru_bwd(*bwd_args)
    rb = gk.gru_bwd_plain(*bwd_args)
    torch.cuda.synchronize()

    def err(x, y):
        return float((x - y).abs().max())

    fwd_err = max(err(got[0], ref[0]), err(got[1], ref[1]),
                  err(lean, ref[0]))
    dxs_err = err(gb[0], rb[0])
    rel = {"dxs": dxs_err / float(rb[0].abs().max()),
           "dW_gate": err(gb[1], rb[1]) / float(rb[1].abs().max()),
           "dW_state": err(gb[2], rb[2]) / float(rb[2].abs().max())}
    if not fwd_err <= LSTM_TOL or not dxs_err <= LSTM_TOL \
            or not max(rel["dW_gate"], rel["dW_state"]) <= LSTM_REL_TOL:
        fail(f"GRU kernels (T={t}, B={b}, D={d}, ragged={ragged}) disagree "
             f"with their plain versions: forward max abs err {fwd_err}, "
             f"dxs {dxs_err} (bound {LSTM_TOL}); relative {rel} (bound "
             f"{LSTM_REL_TOL})")
    if not max([fwd_err] + list(rel.values())) <= GRU_TC_TOL:
        fail(f"GRU kernels (T={t}, B={b}, D={d}, ragged={ragged}): hs / "
             f"acts {fwd_err}, relative {rel} exceed the 3xTF32 gate "
             f"{GRU_TC_TOL} (one TF32 pass lands above it)")
    if ragged and (got[0][:, 0].any() or gb[0][:, 0].any()):
        fail("GRU kernels: the empty row's hs or dxs is not exactly 0")
    again = gk.gru_fwd(xs, mask, w_gate, w_state, True)
    again_lean, _ = gk.gru_fwd(xs, mask, w_gate, w_state, False)
    again_b = gk.gru_bwd(*bwd_args)
    if not all(torch.equal(x, y) for x, y in zip(
            (*again, again_lean, *again_b), (*got, lean, *gb))):
        fail(f"GRU kernels (T={t}, B={b}, D={d}, ragged={ragged}): a second "
             "launch on the same inputs differs from the first")
    rows = [{"name": gk.NAME_FWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": fwd_err, "repeat": "bit for bit"},
            {"name": gk.NAME_BWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": max(dxs_err, err(gb[1], rb[1]),
                                err(gb[2], rb[2])),
             "dxs_max_abs_err": dxs_err, "rel_err": rel,
             "repeat": "bit for bit"}]
    calls = ((lambda: gk.gru_fwd(xs, mask, w_gate, w_state, True),
              lambda: gk.gru_fwd_plain(xs, mask, w_gate, w_state, True)),
             (lambda: gk.gru_bwd(*bwd_args),
              lambda: gk.gru_bwd_plain(*bwd_args)))
    return rows, calls, gru_cost(lengths, t, d)


def check_gru_kernels(torch, dev, rng, libs):
    """The GRU pair at the train shape on a ragged mask (with an empty
    row) and on the train path's own data (every row full length), which
    the times and the bound are taken on, with the backward's split (dW
    alone through ``libs["kernel"]``, scripts/probe_gru.build's entries
    on the same source, and BPTT the rest); then ragged at GRU_OTHER."""
    rows, _, _ = gru_pair(torch, dev, rng, GRU_T, GRU_B, GRU_D, ragged=True)
    full, calls, costs = gru_pair(torch, dev, rng, GRU_T, GRU_B, GRU_D,
                                  ragged=False)
    library = ("no single PyTorch call computes this function: cuDNN's GRU "
               "applies the reset gate after the recurrent product, "
               "r (h W_hn + b_hn), where Paddle's applies it before, "
               "(r h) W_state, and has no masked carry freeze")
    for row, row_full, (fn, plain), (nbytes, flops) in zip(rows, full, calls,
                                                           costs):
        row.update(max_abs_err=max(row["max_abs_err"],
                                   row_full["max_abs_err"]),
                   full_rows_check=row_full,
                   shape={"T": GRU_T, "B": GRU_B, "D": GRU_D,
                          "timed_on": "full rows"},
                   ms=time_ms(torch, fn, samples=20, reps=5),
                   plain_ms=time_ms(torch, plain, samples=5, reps=2),
                   library_ms=None, library_note=library,
                   bytes=nbytes, flops=flops)
        if "rel_err" in row:
            row["rel_err"] = {key: max(v, row_full["rel_err"][key])
                              for key, v in row["rel_err"].items()}
        tc_bound(row, nbytes, flops)
    # dW alone (the backward's second launch); its bound: hs, s_all and
    # dxs[1:] read once, dW_gate and dW_state written once, their product
    from paddle_tpu_torch.scripts import probe_gru
    case = probe_gru.Case(dev, np.random.RandomState(2), GRU_T, GRU_B, GRU_D)
    entries = libs["kernel"][0]
    case.bwd(entries)
    dw_ms = time_ms(torch, lambda: case.dw(entries), samples=20, reps=5)
    k = (GRU_T - 1) * GRU_B
    rows[1]["split"] = {
        "dW_ms": dw_ms, "bptt_ms": rows[1]["ms"] - dw_ms,
        "dW_bound_ms": bound(4 * (k * 5 * GRU_D + 3 * GRU_D * GRU_D),
                             costs[1][1] // 2, PEAK_3XTF32_FLOPS)[0]}
    other = [r for b, d in GRU_OTHER
             for r in gru_pair(torch, dev, rng, GRU_T, b, d, True)[0]]
    return rows, other


def check_gru_tf32_control(torch, dev, libs):
    """The tf32_1x variant of csrc/gru.cu (one TF32 product a k-step,
    scripts/probe_gru.py) and the kernels as built, on one set of train
    shape inputs: the kernels pass GRU_TC_TOL and the variant must not,
    or the gate could not tell one pass from 3xTF32."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.scripts import probe_gru
    case = probe_gru.Case(dev, np.random.RandomState(1), GRU_T, GRU_B,
                          GRU_D)
    kernel = (_build.entry("gru", "gru_fwd_f32", 7, 4),
              _build.entry("gru", "gru_bwd_f32", 12, 3))
    errs = {"kernel": case.errors(kernel),
            "tf32_1x": case.errors(libs["tf32_1x"][0])}
    worst = {name: max(e.values()) for name, e in errs.items()}
    if not worst["kernel"] <= GRU_TC_TOL or worst["tf32_1x"] <= GRU_TC_TOL:
        fail(f"3xTF32 gate {GRU_TC_TOL}: the GRU kernels read "
             f"{errs['kernel']}, the one-pass control {errs['tf32_1x']} (the "
             "control must fail the gate, the kernels pass it)")
    return {"shape": {"T": GRU_T, "B": GRU_B, "D": GRU_D},
            "gate": GRU_TC_TOL, "errors": errs}


def check_gru_reverse(torch, dev, rng, kernels):
    """rnn.gru(reverse=True) at the train shape on the card (kernels,
    through GruFused) against the same call on the CPU (plain versions):
    loss and every gradient, on a ragged batch with an empty row."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import rnn
    t, b, d = GRU_T, GRU_B, GRU_D
    x = normal(rng, (b, t, 3 * d)) * 0.3
    lengths = rng.randint(1, t + 1, b).astype(np.int32)
    lengths[0] = 0
    w_gate, w_state = normal(rng, (d, 2 * d)) * 0.1, normal(rng, (d, d)) * 0.1
    bias = normal(rng, (3 * d,)) * 0.1

    def run(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, w_gate, w_state, bias)]
        out, final = rnn.gru(
            SequenceBatch(args[0], torch.tensor(lengths, device=device)),
            args[1], args[2], bias=args[3], reverse=True)
        loss = (out.data ** 2).sum() + (final ** 2).sum()
        loss.backward()
        return float(loss.detach()), [a.grad.cpu() for a in args]

    kernels.reset_launches()
    loss_c, grads_c = run(dev)
    launches = (kernels.gru.launches_fwd, kernels.gru.launches_bwd)
    loss_r, grads_r = run("cpu")
    worst = max(float((g - r).abs().max() / r.abs().max())
                for g, r in zip(grads_c, grads_r))
    loss_err = abs(loss_c - loss_r) / abs(loss_r)
    if launches != (1, 1) or not worst <= LSTM_REL_TOL \
            or not loss_err <= LSTM_REL_TOL:
        fail(f"reverse rnn.gru: launches {launches} (want 1, 1); card vs "
             f"CPU relative error loss {loss_err}, grads {worst} (bound "
             f"{LSTM_REL_TOL})")
    return {"reverse_gru": {"T": t, "B": b, "D": d}, "loss_rel_err": loss_err,
            "grad_rel_err": worst}


def check_gru_barrier(torch):
    """The device time of one grid-wide barrier at the grid the GRU
    forward launches at the train shape (D / 16 unit blocks times its
    b-groups, 128 CTAs of one an SM on an H100): a cooperative launch of
    2 (GRU_T - 1) barriers alone, the count one train-shape launch
    makes, less an empty one."""
    from paddle_tpu_torch.ops.kernels import _build
    probe = _build.entry("gru", "gru_barrier_probe", 0, 3)
    stream = torch.cuda.current_stream().cuda_stream
    syncs = 2 * (GRU_T - 1)

    def run(n):
        _build.check("gru_barrier_probe", probe(n, GRU_B, GRU_D, stream))

    with_syncs = time_ms(torch, lambda: run(syncs), samples=20, reps=5)
    empty = time_ms(torch, lambda: run(0), samples=20, reps=5)
    return {"barriers": syncs, "launch_ms": with_syncs, "empty_launch_ms":
            empty, "us_per_barrier": (with_syncs - empty) / syncs * 1e3}


def rnn_inputs(torch, dev, rng, t, b, d, ragged):
    """(lengths, xs [T, B, D], mask [T, B], W [D, D]).  Ragged: random
    lengths with one empty row and one full row; else every row full, as
    the train path's batch is."""
    lengths = np.full(b, t)
    if ragged:
        lengths = rng.randint(1, t + 1, b)
        lengths[0] = 0
        lengths[-1] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (lengths,
            torch.tensor(normal(rng, (t, b, d)) * 0.3, device=dev),
            torch.tensor(mask, device=dev),
            torch.tensor(normal(rng, (d, d)) / np.float32(math.sqrt(d)),
                         device=dev))


def rnn_cost(lengths, t, d):
    """(bytes, flops) of the forward and of the backward with dW on these
    inputs.  Bytes: each input read once, each output written once.
    Operations: the products these lengths need, h_{t-1} W forward and
    dg W^T and h_{t-1}^T dg backward, only where the mask is 1 and
    t >= 1 (a masked step copies the carry, and h_{-1} = 0)."""
    b = len(lengths)
    rows = int(np.maximum(lengths - 1, 0).sum())
    return ((4 * (2 * t * b * d + t * b + d * d), 2 * d * d * rows),
            (4 * (3 * t * b * d + t * b + 2 * d * d), 4 * d * d * rows))


def rnn_library(torch, dev, xs, w, dh_out):
    """torch.nn.RNN (cuDNN RNN_TANH, no bias) computing the same
    recurrence on full rows, W_ih = I and W_hh = W^T: (forward, backward
    of input and W_hh by autograd.grad over a retained graph, its max
    abs error against the plain forward).  A yardstick the port never
    calls; its time includes the input product by I."""
    d = w.shape[0]
    lib = torch.nn.RNN(d, d, nonlinearity="tanh", bias=False).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(d, device=dev))
        lib.weight_hh_l0.copy_(w.T)
    x = xs.clone().requires_grad_(True)
    out = lib(x)[0]

    def forward():
        with torch.no_grad():
            return lib(xs)
    return (forward,
            (lambda: torch.autograd.grad(out, (x, lib.weight_hh_l0), dh_out,
                                         retain_graph=True)),
            out.detach())


def rnn_pair(torch, dev, rng, t, b, d, ragged):
    """Forward, BPTT and dW kernels against their plain versions on one
    set of inputs; the backward gets the plain forward's hs on both sides
    so that its check stands alone.  Returns the two result rows, the
    (kernel, plain) calls of each and the costs."""
    from paddle_tpu_torch.ops.kernels import simple_rnn as rk
    lengths, xs, mask, w = rnn_inputs(torch, dev, rng, t, b, d, ragged)
    ref = rk.simple_rnn_fwd_plain(xs, mask, w)
    got = rk.simple_rnn_fwd(xs, mask, w)
    dh_out = torch.tensor(normal(rng, (t, b, d)), device=dev)
    gb = rk.simple_rnn_bwd(ref, w, mask, dh_out)
    rb = rk.simple_rnn_bwd_plain(ref, w, mask, dh_out)
    torch.cuda.synchronize()

    def err(x, y):
        return float((x - y).abs().max())

    fwd_err, dxs_err = err(got, ref), err(gb[0], rb[0])
    dxs_rel = dxs_err / float(rb[0].abs().max())
    dw_rel = err(gb[1], rb[1]) / float(rb[1].abs().max())
    if not fwd_err <= KERNEL_TOL or not dxs_err <= KERNEL_TOL \
            or not dw_rel <= KERNEL_TOL:
        fail(f"simple-RNN kernels (T={t}, B={b}, D={d}, ragged={ragged}) "
             f"disagree with their plain versions: hs max abs err "
             f"{fwd_err}, dxs {dxs_err}, dW relative {dw_rel} (bound "
             f"{KERNEL_TOL})")
    if not max(fwd_err, dxs_rel, dw_rel) <= RNN_TC_TOL:
        fail(f"simple-RNN kernels (T={t}, B={b}, D={d}, ragged={ragged}): "
             f"hs {fwd_err}, dxs relative {dxs_rel}, dW relative {dw_rel} "
             f"exceed the 3xTF32 gate {RNN_TC_TOL} (one TF32 pass lands "
             "above it)")
    if ragged and (got[:, 0].any() or gb[0][:, 0].any()):
        fail("simple-RNN kernels: the empty row's hs or dxs is not "
             "exactly 0")
    again, again_b = (rk.simple_rnn_fwd(xs, mask, w),
                      rk.simple_rnn_bwd(ref, w, mask, dh_out))
    if not (torch.equal(again, got) and torch.equal(again_b[0], gb[0])
            and torch.equal(again_b[1], gb[1])):
        fail(f"simple-RNN kernels (T={t}, B={b}, D={d}, ragged={ragged}): "
             "a second launch on the same inputs differs from the first")
    rows = [{"name": rk.NAME_FWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": fwd_err, "repeat": "bit for bit"},
            {"name": rk.NAME_BWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": dxs_err, "dxs_rel_err": dxs_rel,
             "dW_max_abs_err": err(gb[1], rb[1]), "dW_rel_err": dw_rel,
             "repeat": "bit for bit"}]
    calls = ((lambda: rk.simple_rnn_fwd(xs, mask, w),
              lambda: rk.simple_rnn_fwd_plain(xs, mask, w)),
             (lambda: rk.simple_rnn_bwd(ref, w, mask, dh_out),
              lambda: rk.simple_rnn_bwd_plain(ref, w, mask, dh_out)))
    return rows, calls, rnn_cost(lengths, t, d), (xs, w, dh_out, ref)


def check_rnn_kernels(torch, dev, rng, libs=None):
    """The simple-RNN kernels at the train shape on a ragged mask (with
    an empty row) and on the train path's own data (every row full),
    which the times, the bound and the cuDNN yardstick are taken on;
    then ragged at RNN_OTHER.  With ``libs`` (scripts/probe_simple_rnn.
    build's, holding "kernel"), also the backward's split: dW alone and
    BPTT the rest."""
    rows, _, _, _ = rnn_pair(torch, dev, rng, RNN_T, RNN_B, RNN_D, True)
    full, calls, costs, (xs, w, dh_out, ref) = rnn_pair(
        torch, dev, rng, RNN_T, RNN_B, RNN_D, False)
    lib_fwd, lib_bwd, lib_out = rnn_library(torch, dev, xs, w, dh_out)
    lib_err = float((lib_out - ref).abs().max())
    note = ("torch.nn.RNN (cuDNN RNN_TANH, no bias) with W_ih = I and "
            "W_hh = W^T on the same full rows: its time includes one "
            "extra [T B, D] x [D, D] input product; the backward is "
            "autograd.grad of the input and W_hh over a retained graph")
    for row, row_full, (fn, plain), (nbytes, flops), lib in zip(
            rows, full, calls, costs, (lib_fwd, lib_bwd)):
        row.update(max_abs_err=max(row["max_abs_err"],
                                   row_full["max_abs_err"]),
                   full_rows_check=row_full,
                   shape={"T": RNN_T, "B": RNN_B, "D": RNN_D,
                          "timed_on": "full rows"},
                   ms=time_ms(torch, fn, samples=20, reps=5),
                   plain_ms=time_ms(torch, plain, samples=5, reps=2),
                   library_ms=time_ms(torch, lib, samples=20, reps=5),
                   library_note=note, library_fwd_max_abs_err=lib_err,
                   bytes=nbytes, flops=flops)
        for key in ("dxs_rel_err", "dW_rel_err"):
            if key in row:
                row[key] = max(row[key], row_full[key])
        tc_bound(row, nbytes, flops)
    if libs is not None:
        # dW alone (the backward's second launch, the probe's entry on the
        # same source); its bound: hs and dxs read once, dW written once
        from paddle_tpu_torch.scripts import probe_simple_rnn
        case = probe_simple_rnn.Case(dev, np.random.RandomState(2), RNN_T,
                                     RNN_B, RNN_D)
        entries = libs["kernel"][0]
        case.bwd(entries)
        dw_ms = time_ms(torch, lambda: case.dw(entries), samples=20, reps=5)
        rows[1]["split"] = {
            "dW_ms": dw_ms, "bptt_ms": rows[1]["ms"] - dw_ms,
            "dW_bound_ms": bound(4 * (2 * (RNN_T - 1) * RNN_B * RNN_D
                                      + RNN_D * RNN_D),
                                 costs[1][1] // 2, PEAK_3XTF32_FLOPS)[0]}
    other = [r for t, b, d in RNN_OTHER
             for r in rnn_pair(torch, dev, rng, t, b, d, True)[0]]
    return rows, other


def check_rnn_tf32_control(torch, dev, libs):
    """The tf32_1x variant of csrc/simple_rnn.cu (one TF32 product a
    k-step, scripts/probe_simple_rnn.py) and the kernels as built, on one
    set of train shape inputs: the kernels pass RNN_TC_TOL and the
    variant must not, or the gate could not tell one pass from 3xTF32."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.scripts import probe_simple_rnn
    case = probe_simple_rnn.Case(dev, np.random.RandomState(1), RNN_T,
                                 RNN_B, RNN_D)
    kernel = (_build.entry("simple_rnn", "simple_rnn_fwd_f32", 4, 3),
              _build.entry("simple_rnn", "simple_rnn_bwd_f32", 7, 3))
    errs = {"kernel": case.errors(kernel),
            "tf32_1x": case.errors(libs["tf32_1x"][0])}
    worst = {name: max(e.values()) for name, e in errs.items()}
    if not worst["kernel"] <= RNN_TC_TOL or worst["tf32_1x"] <= RNN_TC_TOL:
        fail(f"3xTF32 gate {RNN_TC_TOL}: the simple-RNN kernels read "
             f"{errs['kernel']}, the one-pass control {errs['tf32_1x']} (the "
             "control must fail the gate, the kernels pass it)")
    return {"shape": {"T": RNN_T, "B": RNN_B, "D": RNN_D},
            "gate": RNN_TC_TOL, "errors": errs}


def rnn_card_vs_cpu(torch, dev, rng, kernels, t, b, d, lengths, reverse,
                    **kw):
    """rnn.simple_rnn on the card against the same call on the CPU: loss
    and every gradient (x, W, bias) relative to each one's largest
    entry, with the simple-RNN launches the card's call made."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import rnn
    x = normal(rng, (b, t, d)) * 0.3
    w = normal(rng, (d, d)) / np.float32(math.sqrt(d))
    bias = normal(rng, (d,)) * 0.1

    def run(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, w, bias)]
        out, final = rnn.simple_rnn(
            SequenceBatch(args[0], torch.tensor(lengths, device=device)),
            args[1], bias=args[2], reverse=reverse, **kw)
        loss = (out.data ** 2).sum() + (final ** 2).sum()
        loss.backward()
        return float(loss.detach()), [a.grad.cpu() for a in args]

    kernels.reset_launches()
    loss_c, grads_c = run(dev)
    launches = (kernels.simple_rnn.launches_fwd,
                kernels.simple_rnn.launches_bwd)
    loss_r, grads_r = run("cpu")
    worst = max(float((g - r).abs().max() / r.abs().max())
                for g, r in zip(grads_c, grads_r))
    return abs(loss_c - loss_r) / abs(loss_r), worst, launches


def check_rnn_routes(torch, dev, rng, kernels):
    """rnn.simple_rnn(reverse=True) at the train shape through the kernels
    (SimpleRnnFused), on a ragged batch with an empty row; then where
    JAX's rule sends it to the masked scan (B 12; act="relu"), the card
    runs the scan too: each matches the CPU's and the scan launches no
    kernel."""
    out = []
    for t, b, d, reverse, kw, want in (
            (RNN_T, RNN_B, RNN_D, True, {}, (1, 1)),
            (30, 12, 128, False, {}, (0, 0)),
            (30, 8, 128, False, {"act": "relu"}, (0, 0))):
        lengths = rng.randint(1, t + 1, b).astype(np.int32)
        lengths[0] = 0
        loss_err, worst, launches = rnn_card_vs_cpu(
            torch, dev, rng, kernels, t, b, d, lengths, reverse, **kw)
        if launches != want or not worst <= LSTM_REL_TOL \
                or not loss_err <= LSTM_REL_TOL:
            fail(f"rnn.simple_rnn (T {t}, B {b}, D {d}, reverse {reverse}, "
                 f"{kw}): launches {launches} (want {want}); card vs CPU "
                 f"relative error loss {loss_err}, grads {worst} (bound "
                 f"{LSTM_REL_TOL})")
        out.append({"T": t, "B": b, "D": d, "reverse": reverse, **kw,
                    "route": "kernels" if any(want) else "scan",
                    "launches": list(launches), "loss_rel_err": loss_err,
                    "grad_rel_err": worst})
    return out


# ------------------------------------------------------------- paths

def margins(torch, transformer, params, ids, kv_dtype=None, heads=HEADS):
    """Top-1 minus top-2 logit at every position of ``ids`` [B, T]
    (teacher-forced: one prefill over the whole sequence, over an int8
    cache when ``kv_dtype="int8"``)."""
    hidden, _ = transformer.lm_prefill(params, ids, ids.shape[1],
                                       num_heads=heads, kv_dtype=kv_dtype)
    top2 = torch.topk(transformer._lm_project(params, hidden), 2, dim=-1)
    return (top2.values[..., 0] - top2.values[..., 1]).cpu().numpy()


def compare(got, ref, margin):
    """Tokens compared (up to the first position whose reference margin
    is below MARGIN_TOL) and whether they all match."""
    n = 0
    for g, r, m in zip(got, ref, margin):
        if m < MARGIN_TOL:
            break
        if g != r:
            return n, False
        n += 1
    return n, True


def run_generate(torch, dev, transformer, kernels, params, rng):
    prompt = rng.randint(3, VOCAB, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    transformer.lm_generate(params, prompt[:2], GEN_PROMPT + 4, HEADS)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ids = transformer.lm_generate(params, prompt, GEN_MAX_LEN, HEADS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_attention": kernels.flash_attention.launches,
                "decode_attention_slab_chunk":
                    kernels.decode_attention.launches}
    if launches["flash_attention"] != LAYERS:
        fail(f"lm_generate launched flash_attention "
             f"{launches['flash_attention']} times, want {LAYERS} (one "
             "prefill)")
    ids_np = ids.cpu().numpy()
    if ids_np.shape != (GEN_BATCH, GEN_MAX_LEN) \
            or not (ids_np[:, :GEN_PROMPT] == prompt).all() \
            or ids_np.min() < 0 or ids_np.max() >= VOCAB:
        fail("lm_generate output is malformed")
    # two rows against the same call on the CPU, where every kernel
    # takes its plain version
    cpu_params = transformer.tree_map(lambda x: x.cpu(), params)
    ref = transformer.lm_generate(cpu_params, prompt[:2], GEN_MAX_LEN,
                                  HEADS)
    marg = margins(torch, transformer, cpu_params, ref)
    ref_np = ref.numpy()
    checked = 0
    for r in range(2):
        n, ok = compare(ids_np[r, GEN_PROMPT:], ref_np[r, GEN_PROMPT:],
                        marg[r, GEN_PROMPT - 1:])
        if not ok:
            fail(f"lm_generate row {r}: card and CPU disagree within the "
                 f"first {n + 1} tokens above margin {MARGIN_TOL}")
        checked += n
    out = {"phase": "generate", "batch": GEN_BATCH, "prompt": GEN_PROMPT,
           "max_len": GEN_MAX_LEN, "seconds": dt,
           "emitted_tokens_per_s": GEN_BATCH * (GEN_MAX_LEN - GEN_PROMPT)
           / dt,
           "launches": launches, "cpu_tokens_checked": checked,
           "cpu_tokens_total": 2 * (GEN_MAX_LEN - GEN_PROMPT)}
    emit(out)
    return launches


def launch_counts(kernels):
    dk, fk = kernels.decode_attention, kernels.flash_attention
    return {"flash_attention": fk.launches,
            fk.NAME_QUANT: fk.launches_quant,
            dk.NAME: dk.launches, dk.NAME_SLAB: dk.launches_slab,
            dk.NAME_PAGED: dk.launches_paged,
            dk.NAME_PAGED_CHUNK: dk.launches_paged_chunk,
            dk.NAME_I8: dk.launches_i8, dk.NAME_SLAB_I8: dk.launches_slab_i8,
            dk.NAME_PAGED_I8: dk.launches_paged_i8,
            dk.NAME_PAGED_CHUNK_I8: dk.launches_paged_chunk_i8}


def check_streams(torch, transformer, params, prompts, outs, what,
                  kv_dtype=None, heads=HEADS):
    """Each stream against lm_generate (over the same KV dtype) on the
    card, up to its first reference margin below MARGIN_TOL; returns the
    tokens compared."""
    checked = 0
    for i, (prompt, toks) in enumerate(zip(prompts, outs)):
        p = np.asarray([prompt], np.int32)
        ref = transformer.lm_generate(params, p, p.shape[1] + len(toks),
                                      heads, kv_dtype=kv_dtype)
        marg = margins(torch, transformer, params, ref, kv_dtype, heads)[0]
        n, ok = compare(toks, ref[0, p.shape[1]:].tolist(),
                        marg[p.shape[1] - 1:])
        if not ok:
            fail(f"{what}: request {i} (prompt {p.shape[1]}) disagrees with "
                 f"lm_generate within its first {n + 1} tokens above margin "
                 f"{MARGIN_TOL}")
        checked += n
    return checked


def serve_http(torch, kernels, engine, prompts, n_tok, starts):
    """Put ``engine`` behind the HTTP server and POST each prompt to
    /v1/generate from its own thread ``starts[i]`` seconds in, every
    third streamed.  Returns the run's record: results [(status,
    tokens)], inter-token gaps of the streamed ones (s), errors, seconds,
    steps, launches (counts set to 0 just before), the metrics snapshot,
    the /metrics text, and the batcher (still open)."""
    from paddle_tpu_torch.serving import GenerationBatcher, make_server
    gen = GenerationBatcher(engine, default_max_tokens=n_tok)
    httpd = make_server(gen, port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.port}/v1/generate"
    results, gaps, errors = [None] * len(prompts), [], []

    def client(i):
        time.sleep(starts[i])
        body = {"prompt": prompts[i], "max_tokens": n_tok,
                "stream": i % 3 == 0}
        req = urllib.request.Request(base, data=json.dumps(body).encode(),
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                if not body["stream"]:
                    results[i] = (r.status, json.loads(r.read())["tokens"])
                    return
                toks, stamps = [], []
                for line in r:
                    rec = json.loads(line)
                    if "token" in rec:
                        toks.append(rec["token"])
                        stamps.append(time.perf_counter())
                    elif rec.get("done"):
                        results[i] = (r.status, toks)
                gaps.extend(np.diff(stamps).tolist())
        except Exception as e:    # noqa: BLE001 — reported by the caller
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    kernels.reset_launches()
    steps0 = engine.metrics.decode_steps_total
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    torch.cuda.synchronize()
    run = {"seconds": time.perf_counter() - t0,
           "launches": launch_counts(kernels),
           "steps": engine.metrics.decode_steps_total - steps0,
           "snapshot": engine.metrics.snapshot(), "results": results,
           "gaps": gaps, "errors": errors, "gen": gen}
    with urllib.request.urlopen(base.replace("/v1/generate", "/metrics"),
                                timeout=60) as r:
        run["metrics_text"] = r.read().decode()
    httpd.shutdown()
    httpd.server_close()
    server.join(30)
    return run


def serve_record(run, n_tok):
    """The timing half of a serve phase's line."""
    n_req = len(run["results"])
    snap = run["snapshot"]
    return {"requests": n_req, "max_tokens": n_tok,
            "seconds": run["seconds"], "steps": run["steps"],
            "launches": run["launches"],
            "tokens_per_s": n_req * n_tok / run["seconds"],
            "stream_inter_token_ms": {
                "p50": float(np.percentile(run["gaps"], 50)) * 1e3,
                "p99": float(np.percentile(run["gaps"], 99)) * 1e3},
            "step_ms": snap["tpot_ms"], "ttft_ms": snap["ttft_ms"]}


def check_served(run, n_tok, what):
    if run["errors"] or any(r is None or r[0] != 200 or len(r[1]) != n_tok
                            for r in run["results"]):
        fail(f"{what}: not every request completed with 200 and {n_tok} "
             f"tokens: {run['errors'] or run['results']}")


def run_serve(torch, dev, transformer, kernels, params, rng,
              kv_dtype="float32"):
    """The HTTP server on the chunked slab step (phase "serve", or
    "serve_int8" over an int8 KV cache): 12 staggered requests, the chunk
    kernel of the cache's dtype once per layer per step, each stream held
    against lm_generate over the same cache dtype."""
    from paddle_tpu_torch.serving import DecodeEngine
    dk = kernels.decode_attention
    int8 = kv_dtype == "int8"
    phase, kernel = ("serve_int8", dk.NAME_I8) if int8 else ("serve",
                                                             dk.NAME)
    engine = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                          max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                          kv_dtype=kv_dtype, name="base_lm", device=dev)
    n_req, n_tok = 12, 32
    lengths = np.linspace(3, 120, n_req).astype(int)
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in lengths]
    # staggered: admissions land mid-decode
    run = serve_http(torch, kernels, engine, prompts, n_tok,
                     [0.03 * i for i in range(n_req)])
    run["gen"].close()
    check_served(run, n_tok, phase)
    launches, steps = run["launches"], run["steps"]
    other = dk.NAME if int8 else dk.NAME_I8
    if launches[kernel] != LAYERS * steps or launches[other]:
        fail(f"{phase}: chunk kernels launched {kernel} "
             f"{launches[kernel]}, {other} {launches[other]} times over "
             f"{steps} steps, want {LAYERS * steps} and 0")
    int8_line = f"{engine.metrics.name}_kv_cache_int8 {int(int8)}"
    if int8_line not in run["metrics_text"].splitlines():
        fail(f"{phase}: /metrics lacks the line {int8_line!r}")
    checked = check_streams(torch, transformer, params, prompts,
                            [r[1] for r in run["results"]], phase,
                            kv_dtype)
    emit({"phase": phase, "kv_dtype": kv_dtype,
          "prompt_lengths": lengths.tolist(),
          **serve_record(run, n_tok),
          "tokens_checked_vs_lm_generate": checked,
          "tokens_total": n_req * n_tok, "metrics_line": int8_line,
          "note": "tokens compared up to each stream's first reference "
                  f"top-1/top-2 margin below {MARGIN_TOL} (random weights "
                  "give small margins)"})
    return launches


def paged_prompts(rng):
    """12 prompts: six share a 64-token preamble (request 3 is the
    preamble alone); requests 2 and 7 repeat requests 0 and 1 exactly."""
    pre = rng.randint(3, VOCAB, PREAMBLE).tolist()
    prompts = []
    for i, (shared, n) in enumerate(((1, 13), (0, 30), (1, 0), (1, 0),
                                     (0, 55), (1, 25), (0, 90), (0, 0),
                                     (1, 41), (0, 120), (1, 3), (0, 17))):
        if i == 2 or i == 7:
            prompts.append(list(prompts[i - 2 if i == 2 else 1]))
        else:
            prompts.append((pre if shared else [])
                           + rng.randint(3, VOCAB, n).tolist())
    return prompts


def run_serve_paged(torch, dev, transformer, kernels, params, rng):
    """The server on the paged layout with a pool a quarter of the slab's
    size.  Requests 0 and 1 come first, request 2 (0's duplicate: a
    prefix hit whose first write forks the shared tail block) and 3 after
    them, the other eight in one burst whose growth outruns the pool."""
    from paddle_tpu_torch.serving import DecodeEngine
    engine = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                          max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                          kv_layout="paged", kv_block_size=PAGE_BS,
                          kv_num_blocks=PAGED_POOL, name="base_lm_paged",
                          device=dev)
    n_tok = 32
    prompts = paged_prompts(rng)
    starts = [0.0, 0.0, 0.15, 0.15] + [0.3] * 8
    run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
    outs = [r[1] if r else None for r in run["results"]]
    check_served(run, n_tok, "serve_paged")
    gen, burst = run["gen"], []
    if not run["snapshot"]["evictions"]["pool_exhausted"]:
        # arrival timing did not run the pool dry: eight long requests at
        # once through the same engine do (8 x 10 blocks > 32)
        burst = [rng.randint(3, VOCAB, 120).tolist() for _ in range(SLOTS)]
        steps0 = engine.metrics.decode_steps_total
        futs = [gen.submit(p, max_tokens=n_tok) for p in burst]
        outs += [f.result(timeout=300)["tokens"] for f in futs]
        torch.cuda.synchronize()
        run["steps"] += engine.metrics.decode_steps_total - steps0
        run["launches"] = launch_counts(kernels)
    gen.close()
    snap = engine.metrics.snapshot()
    engine._paged.check()
    launches, steps = run["launches"], run["steps"]
    if launches["decode_attention_paged_chunk"] != LAYERS * steps:
        fail(f"serve_paged: paged chunk kernel launched "
             f"{launches['decode_attention_paged_chunk']} times over "
             f"{steps} steps, want {LAYERS * steps}")
    counts = {"prefix_cache_hits": snap["prefix_cache_hits_total"],
              "prefix_cache_misses": snap["prefix_cache_misses_total"],
              "cow_forks": snap["cow_forks_total"],
              "preemptions": snap["evictions"]["pool_exhausted"],
              "reseats": snap["slot_reprefills_total"]}
    if not (counts["prefix_cache_hits"] > 0 and counts["cow_forks"] > 0
            and counts["preemptions"] > 0):
        fail(f"serve_paged: want prefix hits, copy-on-write forks and a "
             f"pool-exhausted preemption, got {counts}")
    checked = check_streams(torch, transformer, params, prompts + burst,
                            outs, "serve_paged")
    emit({"phase": "serve_paged", "block_size": PAGE_BS,
          "pool_blocks": PAGED_POOL, "slab_equivalent_blocks": PAGE_BLOCKS,
          "prompt_lengths": [len(p) for p in prompts],
          **serve_record(run, n_tok), "burst_requests": len(burst),
          **counts, "kv_blocks_free_after": snap["kv_blocks_free"],
          "tokens_checked_vs_lm_generate": checked,
          "tokens_total": len(outs) * n_tok})
    return launches


def run_ladder(torch, dev, transformer, kernels, params, rng,
               kv_dtype="float32", heads=HEADS, layers=LAYERS,
               layouts=("slab", "paged")):
    """The legacy prefill ladder (phase "ladder", or "ladder_int8" over
    an int8 KV cache; at another head count "ladder_dh<width>..."): 8
    staggered requests straight to the batcher on each of ``layouts``;
    the prefill's flash kernel once per layer per prefill batch, the
    Tq=1 kernel once per layer per step, both of the cache's dtype.
    Returns each layout's launches."""
    from paddle_tpu_torch.serving import DecodeEngine, GenerationBatcher
    dk, fk = kernels.decode_attention, kernels.flash_attention
    int8 = kv_dtype == "int8"
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in LADDER_PROMPTS]
    phase = "ladder" if heads == HEADS else f"ladder_dh{D_MODEL // heads}"
    record = {"phase": phase + ("_int8" if int8 else ""),
              "kv_dtype": kv_dtype, "heads": heads,
              "head_dim": D_MODEL // heads, "layers": layers,
              "prompt_lengths": list(LADDER_PROMPTS)}
    launches = {}
    flash = fk.NAME_QUANT if int8 else "flash_attention"
    for layout, step_kernel in (
            (lay, {"slab": dk.NAME_SLAB_I8 if int8 else dk.NAME_SLAB,
                   "paged": dk.NAME_PAGED_I8 if int8 else dk.NAME_PAGED}[lay])
            for lay in layouts):
        engine = DecodeEngine(params, num_heads=heads, num_slots=SLOTS,
                              max_len=SERVE_MAX_LEN, prefill_chunk=0,
                              kv_layout=layout, kv_block_size=PAGE_BS,
                              kv_dtype=kv_dtype, name=f"ladder_{layout}",
                              device=dev)
        gen = GenerationBatcher(engine)
        kernels.reset_launches()
        steps0 = engine.metrics.decode_steps_total
        batches0 = engine.prefill_batches_total
        t0 = time.perf_counter()
        futs = []
        for p in prompts:
            futs.append(gen.submit(p, max_tokens=LADDER_TOKENS))
            time.sleep(0.01)
        outs = [f.result(timeout=300)["tokens"] for f in futs]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = launch_counts(kernels)
        steps = engine.metrics.decode_steps_total - steps0
        batches = engine.prefill_batches_total - batches0
        snap = engine.metrics.snapshot()
        gen.close()
        want = {flash: layers * batches, step_kernel: layers * steps}
        if any(got[k] != want.get(k, 0) for k in got) \
                or any(len(o) != LADDER_TOKENS for o in outs):
            fail(f"{record['phase']} ({layout}): launches {got} over "
                 f"{batches} prefill batches and {steps} steps, want {want} "
                 f"and no other; tokens {[len(o) for o in outs]}")
        record[layout] = {
            "seconds": dt, "steps": steps, "prefill_batches": batches,
            "launches": {k: n for k, n in got.items() if n},
            "tokens_per_s": len(prompts) * LADDER_TOKENS / dt,
            "step_ms": snap["tpot_ms"], "ttft_ms": snap["ttft_ms"],
            "tokens_checked_vs_lm_generate": check_streams(
                torch, transformer, params, prompts, outs,
                f"{record['phase']} ({layout})", kv_dtype, heads),
            "tokens_total": len(prompts) * LADDER_TOKENS}
        launches[layout] = got
    emit(record)
    return launches


def run_generate_int8(torch, dev, transformer, kernels, params, rng):
    """lm_generate over an int8 KV cache at the generate phase's shape:
    flash_attention_quant once per layer (the float32 flash kernel not
    at all); the int8 prefill's logits within LOGIT_ERR_BUDGET of its
    float32 twin's; the greedy prefix each stream shares with the float32
    stream reported; two rows held against the same call on the CPU."""
    from paddle_tpu_torch.quant import kv as kvq
    fk = kernels.flash_attention
    prompt = rng.randint(3, VOCAB, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    transformer.lm_generate(params, prompt[:2], GEN_PROMPT + 4, HEADS,
                            kv_dtype="int8")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ids = transformer.lm_generate(params, prompt, GEN_MAX_LEN, HEADS,
                                  kv_dtype="int8")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts(kernels)
    if launches[fk.NAME_QUANT] != LAYERS or launches["flash_attention"]:
        fail(f"lm_generate(kv_dtype='int8') launched flash_attention_quant "
             f"{launches[fk.NAME_QUANT]} and flash_attention "
             f"{launches['flash_attention']} times, want {LAYERS} and 0")
    ids_np = ids.cpu().numpy()
    if ids_np.shape != (GEN_BATCH, GEN_MAX_LEN) \
            or not (ids_np[:, :GEN_PROMPT] == prompt).all() \
            or ids_np.min() < 0 or ids_np.max() >= VOCAB:
        fail("lm_generate(kv_dtype='int8') output is malformed")
    # the int8 prefill against its float32 twin on the same prompts
    h8, _ = transformer.lm_prefill(params, prompt, GEN_PROMPT, HEADS,
                                   kv_dtype="int8")
    h32, _ = transformer.lm_prefill(params, prompt, GEN_PROMPT, HEADS)
    err = kvq.logit_err(transformer._lm_project(params, h32),
                        transformer._lm_project(params, h8))
    if not float(err.max()) <= kvq.LOGIT_ERR_BUDGET:
        fail(f"int8 lm_prefill logit error {float(err.max())} exceeds the "
             f"budget {kvq.LOGIT_ERR_BUDGET}")
    f32_ids = transformer.lm_generate(params, prompt, GEN_MAX_LEN,
                                      HEADS).cpu().numpy()
    prefix = [kvq.greedy_prefix_len(a[GEN_PROMPT:], b[GEN_PROMPT:])
              for a, b in zip(ids_np, f32_ids)]
    cpu_params = transformer.tree_map(lambda x: x.cpu(), params)
    ref = transformer.lm_generate(cpu_params, prompt[:2], GEN_MAX_LEN,
                                  HEADS, kv_dtype="int8")
    marg = margins(torch, transformer, cpu_params, ref, "int8")
    ref_np = ref.numpy()
    checked = 0
    for r in range(2):
        n, ok = compare(ids_np[r, GEN_PROMPT:], ref_np[r, GEN_PROMPT:],
                        marg[r, GEN_PROMPT - 1:])
        if not ok:
            fail(f"lm_generate(kv_dtype='int8') row {r}: card and CPU "
                 f"disagree within the first {n + 1} tokens above margin "
                 f"{MARGIN_TOL}")
        checked += n
    emit({"phase": "generate_int8", "batch": GEN_BATCH, "prompt": GEN_PROMPT,
          "max_len": GEN_MAX_LEN, "seconds": dt,
          "emitted_tokens_per_s": GEN_BATCH * (GEN_MAX_LEN - GEN_PROMPT)
          / dt, "launches": {k: n for k, n in launches.items() if n},
          "prefill_logit_err_vs_f32": {"max": float(err.max()),
                                       "mean": float(err.mean()),
                                       "budget": kvq.LOGIT_ERR_BUDGET},
          "greedy_prefix_vs_f32": {"min": min(prefix),
                                   "median": float(np.median(prefix)),
                                   "max": max(prefix),
                                   "of": GEN_MAX_LEN - GEN_PROMPT},
          "cpu_tokens_checked": checked,
          "cpu_tokens_total": 2 * (GEN_MAX_LEN - GEN_PROMPT)})
    return launches


def run_serve_paged_int8(torch, dev, transformer, kernels, params, rng):
    """The server on the paged layout over an int8 KV cache with the auto
    pool (twice the float32 slab's block count in fewer bytes): the 12
    paged_prompts requests with their shared 64-token preamble and two
    exact duplicates.  The int8 paged chunk kernel launches once per layer
    per step; the prefix cache hits and an int8 block is forked
    (copy-on-write, its scales with it); every stream is held against the
    int8 lm_generate; the pool's KV bytes are reported beside the float32
    slab's."""
    from paddle_tpu_torch.serving import DecodeEngine
    dk = kernels.decode_attention
    engine = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                          max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                          kv_layout="paged", kv_block_size=PAGE_BS,
                          kv_dtype="int8", name="base_lm_paged_int8",
                          device=dev)
    blocks = engine._paged.pool.num_blocks
    if blocks != 2 * (PAGE_BLOCKS - 1) + 1:
        fail(f"serve_paged_int8: auto pool of {blocks} blocks, want "
             f"{2 * (PAGE_BLOCKS - 1) + 1}")
    pool_bytes = sum(t.numel() * t.element_size() for c in engine._cache
                     for t in c.values())
    slab_bytes = LAYERS * 2 * SLOTS * SERVE_MAX_LEN * D_MODEL * 4
    n_tok = 32
    prompts = paged_prompts(rng)
    starts = [0.0, 0.0, 0.15, 0.15] + [0.3] * 8
    run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
    run["gen"].close()
    check_served(run, n_tok, "serve_paged_int8")
    snap = engine.metrics.snapshot()
    engine._paged.check()
    launches, steps = run["launches"], run["steps"]
    if launches[dk.NAME_PAGED_CHUNK_I8] != LAYERS * steps \
            or launches[dk.NAME_PAGED_CHUNK]:
        fail(f"serve_paged_int8: int8 paged chunk kernel launched "
             f"{launches[dk.NAME_PAGED_CHUNK_I8]} times over {steps} steps "
             f"(want {LAYERS * steps}), float32 "
             f"{launches[dk.NAME_PAGED_CHUNK]} (want 0)")
    counts = {"prefix_cache_hits": snap["prefix_cache_hits_total"],
              "prefix_cache_misses": snap["prefix_cache_misses_total"],
              "cow_forks": snap["cow_forks_total"],
              "preemptions": snap["evictions"]["pool_exhausted"]}
    if not (counts["prefix_cache_hits"] > 0 and counts["cow_forks"] > 0):
        fail(f"serve_paged_int8: want prefix hits and copy-on-write forks "
             f"of int8 blocks, got {counts}")
    if f"{engine.metrics.name}_kv_cache_int8 1" \
            not in run["metrics_text"].splitlines():
        fail("serve_paged_int8: /metrics does not show kv_cache_int8 1")
    checked = check_streams(torch, transformer, params, prompts,
                            [r[1] for r in run["results"]],
                            "serve_paged_int8", "int8")
    emit({"phase": "serve_paged_int8", "kv_dtype": "int8",
          "block_size": PAGE_BS, "pool_blocks": blocks,
          "f32_slab_equivalent_blocks": PAGE_BLOCKS,
          "pool_kv_bytes": pool_bytes, "f32_slab_kv_bytes": slab_bytes,
          "prompt_lengths": [len(p) for p in prompts],
          **serve_record(run, n_tok), **counts,
          "kv_blocks_free_after": snap["kv_blocks_free"],
          "tokens_checked_vs_lm_generate": checked,
          "tokens_total": len(prompts) * n_tok})
    return launches


def serve_prompts(rng):
    """The serve phase's 12 prompts (3 to 120 tokens) and starts."""
    lengths = np.linspace(3, 120, 12).astype(int)
    return ([rng.randint(3, VOCAB, n).tolist() for n in lengths],
            [0.03 * i for i in range(12)])


def compare_twin(torch, transformer, params, prompts, outs, ref_outs, what,
                 kv_dtype=None):
    """Each stream against another engine's stream of the same request,
    up to the first margin below MARGIN_TOL over the reference stream;
    returns the tokens compared."""
    checked = 0
    for i, (prompt, toks, ref) in enumerate(zip(prompts, outs, ref_outs)):
        ids = np.asarray([list(prompt) + list(ref)], np.int32)
        marg = margins(torch, transformer, params, ids, kv_dtype)[0]
        n, ok = compare(toks, ref, marg[len(prompt) - 1:])
        if not ok:
            fail(f"{what}: request {i} disagrees with the non-speculating "
                 f"engine within its first {n + 1} tokens above margin "
                 f"{MARGIN_TOL}")
        checked += n
    return checked


def step_line(run, n_tok):
    """A serve run's timing line with the launches a step beside it."""
    steps = max(run["steps"], 1)
    rec = serve_record(run, n_tok)
    rec["launches"] = {k: n for k, n in rec["launches"].items() if n}
    rec["launches_per_step"] = {k: n / steps
                                for k, n in rec["launches"].items()}
    return rec


def w8_prompt(seed):
    """serve_w8's prefill prompts: 8 of GEN_PROMPT tokens from their own
    seed, so that a CPU run can read the same prefill on the same weights
    (``init_lm(torch.Generator().manual_seed(seed), ...)``: the weights
    are drawn on the CPU and moved)."""
    return np.random.RandomState(seed).randint(
        3, VOCAB, (8, GEN_PROMPT)).astype(np.int32)


def run_serve_w8(torch, dev, transformer, kernels, params, seed, rng):
    """The LM's int8 trunk (quant/weights.quantize_lm) behind the server
    in two engines: slab chunked over float32 KV, and paged chunked over
    int8 KV with the auto pool (the full-quant engine).  12 staggered
    requests each; the chunk kernel of the cache once per layer per
    step; every stream against lm_generate over the same int8 tree.

    Before serving, the card's int8 tree and its prefill are held against
    the CPU's on the same weights: quantize_lm's codes and scales bit
    for bit, and the int8 tree's prefill logits
    (w8_prompt) within W8_CPU_TOL of the port's plain CPU prefill, which
    tests/test_torch_quant_weights.py holds against the JAX package's on
    these inputs.  The logit error against the float32 tree is reported
    per stream on both devices beside quant/kv's LOGIT_ERR_BUDGET (0.06),
    the budget the JAX package's tests/test_quant.py holds its int8 trees
    to on small trunks; at this width the JAX package's own quantize_lm
    exceeds it on some streams (ROADMAP C6)."""
    from paddle_tpu_torch.quant import kv as kvq
    from paddle_tpu_torch.quant.weights import param_bytes, quantize_lm
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    dk = kernels.decode_attention
    qparams = quantize_lm(params)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    qcpu = quantize_lm(cpu_params)
    code_diff, scale_rel, n_codes = 0, 0.0, 0
    for got, want in zip(tree_leaves(qparams), tree_leaves(qcpu),
                         strict=True):
        got = got.cpu()
        if want.dtype == torch.int8:
            code_diff = max(code_diff, int(
                (got.int() - want.int()).abs().max()))
            n_codes += int((got != want).sum())
        else:
            scale_rel = max(scale_rel, float(
                ((got - want).abs() / want.abs().clamp_min(1e-30)).max()))
    prompt = w8_prompt(seed)

    def prefill_logits(p):
        h, _ = transformer.lm_prefill(p, prompt, GEN_PROMPT, HEADS)
        return transformer._lm_project(p, h).cpu()

    l8, l32 = prefill_logits(qparams), prefill_logits(params)
    l8_cpu, l32_cpu = prefill_logits(qcpu), prefill_logits(cpu_params)
    del cpu_params, qcpu
    d8 = float((l8 - l8_cpu).abs().max())
    d32 = float((l32 - l32_cpu).abs().max())
    if n_codes or scale_rel or not d8 <= W8_CPU_TOL:
        fail(f"serve_w8: the card's int8 tree against the CPU's: codes "
             f"differ by up to {code_diff} ({n_codes} codes), scales by "
             f"{scale_rel} relative, the prefill logits by {d8} (the "
             f"float32 tree's by {d32}); want codes and scales bit for "
             f"bit, logits within {W8_CPU_TOL}")
    err = kvq.logit_err(l32, l8)
    err_cpu = kvq.logit_err(l32_cpu, l8_cpu)
    record = {"phase": "serve_w8", "param_bytes": {
                  "float32": param_bytes(params), "int8": param_bytes(qparams)},
              "vs_cpu": {"code_diff_max": code_diff,
                         "codes_differing": n_codes,
                         "scale_rel_diff_max": scale_rel,
                         "w8_prefill_logits_max_abs_diff": d8,
                         "f32_prefill_logits_max_abs_diff": d32,
                         "tolerance": W8_CPU_TOL},
              "prefill_logit_err_vs_f32": {
                  "card": err.tolist(), "cpu": err_cpu.tolist(),
                  "max": float(err.max()), "streams": len(err),
                  "within_budget": int(
                      (err <= kvq.LOGIT_ERR_BUDGET).sum()),
                  "budget": kvq.LOGIT_ERR_BUDGET}}
    n_tok = 32
    launches = {}
    for name, kw, kernel in (
            ("slab_f32kv", dict(kv_dtype="float32"), dk.NAME),
            ("paged_i8kv", dict(kv_layout="paged", kv_block_size=PAGE_BS,
                                kv_dtype="int8"), dk.NAME_PAGED_CHUNK_I8)):
        engine = DecodeEngine(qparams, num_heads=HEADS, num_slots=SLOTS,
                              max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                              name=f"w8_{name}", device=dev, **kw)
        prompts, starts = serve_prompts(rng)
        run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
        run["gen"].close()
        check_served(run, n_tok, f"serve_w8 ({name})")
        got, steps = run["launches"], run["steps"]
        if got[kernel] != LAYERS * steps \
                or any(n for k, n in got.items() if k != kernel):
            fail(f"serve_w8 ({name}): launches {got} over {steps} steps, "
                 f"want {kernel} {LAYERS * steps} and no other")
        if engine._paged is not None:
            engine._paged.check()
        # the oracle: lm_generate's prefill (the flash kernel, or its
        # int8 instance) and the margins' prefill, LAYERS launches each
        kernels.reset_launches()
        checked = check_streams(torch, transformer, qparams, prompts,
                                [r[1] for r in run["results"]],
                                f"serve_w8 ({name})", kw["kv_dtype"])
        torch.cuda.synchronize()
        flash = launch_counts(kernels)[
            "flash_attention" if kw["kv_dtype"] == "float32"
            else kernels.flash_attention.NAME_QUANT]
        if flash != 2 * LAYERS * len(prompts):
            fail(f"serve_w8 ({name}): the oracle launched the prefill's "
                 f"flash kernel {flash} times, want "
                 f"{2 * LAYERS * len(prompts)}")
        record[name] = {**step_line(run, n_tok),
                        "tokens_checked_vs_lm_generate": checked,
                        "tokens_total": len(prompts) * n_tok,
                        "oracle_flash_launches": flash}
        launches[name] = dict(got, oracle_flash=flash)
    emit(record)
    return launches


def run_serve_spec(torch, dev, transformer, kernels, params, seed, rng):
    """Speculative serving (speculate_k SPEC_K, a draft of the target's
    first SPEC_DRAFT_LAYERS blocks) behind the server: slab over float32
    KV and paged over int8 KV, each beside its non-speculating twin on
    the same 12 staggered requests, then the slab twice more with other
    drafts: another seed's trunk of the same shape, and an adversarial
    one.  A random trunk at this width mostly repeats a token its tied
    embedding favours, so another seed's draft agrees with the target
    about as often as the target's own; the adversarial draft is that
    trunk with its embedding scaled by 0.01, whose blocks, not its
    embedding, then pick the token: it (almost) never agrees.  Last, the
    server's --quant-weights 1 --speculate-k engine: the slab over the
    int8 trunk (quant/weights.quantize_lm), its draft the quantized
    target's first blocks, beside a non-speculating twin over the same
    int8 trunk, streams against lm_generate over that trunk.  Every
    stream equals its twin's and lm_generate's up to its margin; every
    verify step nets at least one token; the launches are exact: the
    target's chunk kernel LAYERS a step, the draft's chunk kernel
    SPEC_DRAFT_LAYERS a rollout and its Tq=1 kernel SPEC_DRAFT_LAYERS x
    (SPEC_K - 1) a rollout."""
    from paddle_tpu_torch.quant.weights import quantize_lm
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.serving.speculative import make_draft
    dk = kernels.decode_attention
    n_tok = 32
    other = transformer.init_lm(
        torch.Generator().manual_seed(seed + 7), VOCAB, D_MODEL, HEADS,
        DFF, LAYERS, SERVE_MAX_LEN, device=dev)
    adversarial = dict(other, src_emb=other["src_emb"] * 0.01)
    qparams = quantize_lm(params)
    record = {"phase": "serve_spec", "speculate_k": SPEC_K,
              "draft_layers": SPEC_DRAFT_LAYERS}
    launches, slab_ref = {}, None
    for name, kw, target_kernel, target, draft_params in (
            ("slab_f32kv", dict(kv_dtype="float32"), dk.NAME, params,
             params),
            ("paged_i8kv", dict(kv_layout="paged", kv_block_size=PAGE_BS,
                                kv_dtype="int8"), dk.NAME_PAGED_CHUNK_I8,
             params, params),
            ("slab_f32kv_other_seed", dict(kv_dtype="float32"), dk.NAME,
             params, other),
            ("slab_f32kv_adversarial", dict(kv_dtype="float32"), dk.NAME,
             params, adversarial),
            ("w8_slab_f32kv", dict(kv_dtype="float32"), dk.NAME, qparams,
             qparams)):
        if name.startswith("slab_f32kv_"):
            # the slab run's requests, so its twin stands
            prompts, starts, twin_outs = slab_ref
            record[name] = {}
        else:
            prompts, starts = serve_prompts(rng)
            twin = DecodeEngine(target, num_heads=HEADS, num_slots=SLOTS,
                                max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                                name=f"twin_{name}", device=dev, **kw)
            twin_run = serve_http(torch, kernels, twin, prompts, n_tok,
                                  starts)
            twin_run["gen"].close()
            check_served(twin_run, n_tok, f"serve_spec twin ({name})")
            record[name] = {"twin": step_line(twin_run, n_tok)}
            twin_outs = [r[1] for r in twin_run["results"]]
            slab_ref = slab_ref or (prompts, starts, twin_outs)
        engine = DecodeEngine(
            target, num_heads=HEADS, num_slots=SLOTS,
            max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK, speculate_k=SPEC_K,
            draft=make_draft(draft_params, SPEC_DRAFT_LAYERS),
            name=f"spec_{name}", device=dev, **kw)
        if engine._kk != CHUNK:
            fail(f"serve_spec: the step's lane width {engine._kk} is not "
                 f"the checked chunk K {CHUNK}: check the split kernels at "
                 "that K")
        r0 = engine.draft.rollouts
        run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
        run["gen"].close()
        rollouts = engine.draft.rollouts - r0
        check_served(run, n_tok, f"serve_spec ({name})")
        got, steps = run["launches"], run["steps"]
        want = {target_kernel: LAYERS * steps}
        want[dk.NAME] = want.get(dk.NAME, 0) + SPEC_DRAFT_LAYERS * rollouts
        want[dk.NAME_SLAB] = SPEC_DRAFT_LAYERS * (SPEC_K - 1) * rollouts
        if any(got[k] != want.get(k, 0) for k in got):
            fail(f"serve_spec ({name}): launches {got} over {steps} steps "
                 f"and {rollouts} rollouts, want {want} and no other")
        if engine._paged is not None:
            engine._paged.check()
        outs = [r[1] for r in run["results"]]
        snap = run["snapshot"]
        # tokens each verify run delivered -> runs: one run for each
        # speculating slot-step, each netting at least one token
        runs = run["gen"].verify_runs
        if not (snap["drafted_tokens_total"] > 0 and runs
                and min(runs) >= 1
                and sum(runs.values()) == snap["spec_slot_steps_total"]):
            fail(f"serve_spec ({name}): no draft lanes scored, or verify "
                 f"runs {dict(runs)} do not each net a token over "
                 f"{snap['spec_slot_steps_total']} speculating slot-steps")
        if name.endswith("_adversarial") \
                and not snap["spec_acceptance_rate"] < 0.5:
            fail(f"serve_spec ({name}): the adversarial draft accepted "
                 f"{snap['spec_acceptance_rate']} of its lanes")
        what = f"serve_spec ({name})"
        line = {**step_line(run, n_tok), "rollouts": rollouts,
                "launches_per_rollout": {
                    dk.NAME_SLAB: got[dk.NAME_SLAB] / max(rollouts, 1)},
                "spec_acceptance_rate": snap["spec_acceptance_rate"],
                "spec_tokens_per_step": snap["spec_tokens_per_step"],
                "spec_steps": snap["spec_steps_total"],
                "verify_runs_by_tokens": dict(sorted(runs.items())),
                "tokens_checked_vs_twin": compare_twin(
                    torch, transformer, target, prompts, outs, twin_outs,
                    what, kw["kv_dtype"]),
                "tokens_checked_vs_lm_generate": check_streams(
                    torch, transformer, target, prompts, outs, what,
                    kw["kv_dtype"]),
                "tokens_total": len(prompts) * n_tok}
        if "twin" in record[name]:
            line["tokens_per_s_vs_twin"] = (
                line["tokens_per_s"] / record[name]["twin"]["tokens_per_s"])
        record[name].update(spec=line)
        launches[name] = got
    emit(record)
    return launches


def run_train(torch, dev, kernels, hidden=LSTM_D, check_batch=None):
    """bench_lstm at ``hidden`` on the card: the first step against the
    CPU (at ``check_batch`` rows, the bench's 64 unless given: the route
    is the same), then warm-up and TRAIN_STEPS timed steps at batch 64
    with the launch counts read.  h=512 is the phase "train" (the
    resident kernels); larger h are "train_lstm<h>" (the blocked
    forward, the backward in plain torch)."""
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves
    phase = "train" if hidden == LSTM_D else f"train_lstm{hidden}"

    def rel(got, want):
        return [float((g.detach().cpu() - w.detach()).abs().max()
                      / w.detach().abs().max()) for g, w in zip(got, want)]

    kw = {} if check_batch is None else {"batch": check_batch}
    card_run = bench.bench_lstm(hidden=hidden, device=dev, **kw)
    cpu_run = bench.bench_lstm(hidden=hidden, device="cpu", **kw)
    before = [p.detach().clone() for p in tree_leaves(cpu_run.params)]
    first = float(card_run.train_step())
    first_cpu = float(cpu_run.train_step())
    card_leaves = tree_leaves(card_run.params)
    cpu_leaves = tree_leaves(cpu_run.params)
    card_mom = [m.cpu() for m in
                tree_leaves(card_run.opt_state["slots"]["mom"])]
    leaf_err = rel([p.grad for p in card_leaves],
                   [q.grad for q in cpu_leaves])
    param_err = rel(card_leaves, cpu_leaves)
    mom_err = rel(card_mom, tree_leaves(cpu_run.opt_state["slots"]["mom"]))
    # both sides start from the same params (made on the host from one
    # seed); the card's step must have added its slot to them.  Held as
    # p1 - (p0 + mom), both sides rounded alike, not as (p1 - p0) vs mom,
    # where p1's own rounding is already 1 % of the step.
    step_err = [float((p.detach().cpu() - (w + m)).abs().max()
                      / m.abs().max())
                for p, w, m in zip(card_leaves, before, card_mom)]
    loss_err = abs(first - first_cpu) / abs(first_cpu)
    worst = max(leaf_err + param_err + mom_err + step_err + [loss_err])
    if not worst <= TRAIN_REL_TOL:
        fail(f"{phase}: first step on the card vs the CPU: loss rel err "
             f"{loss_err}, per-leaf rel err of grads {leaf_err}, of params "
             f"{param_err}, of mom {mom_err}, of the card's step vs its "
             f"mom {step_err} (bound {TRAIN_REL_TOL})")
    del cpu_run
    if check_batch is not None:
        card_run = bench.bench_lstm(hidden=hidden, device=dev)
        first = float(card_run.train_step())
    for _ in range(TRAIN_WARMUP):
        card_run.train_step()
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = card_run.train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    lk, bk = kernels.lstm, kernels.lstm_blocked
    launches = {lk.NAME_FWD: lk.launches_fwd, lk.NAME_BWD: lk.launches_bwd,
                bk.NAME_FWD: bk.launches_fwd}
    want = bench.NUM_LAYERS * TRAIN_STEPS
    expect = ({lk.NAME_FWD: want, lk.NAME_BWD: want, bk.NAME_FWD: 0}
              if hidden == LSTM_D else
              {lk.NAME_FWD: 0, lk.NAME_BWD: 0, bk.NAME_FWD: want})
    if launches != expect:
        fail(f"{phase}: LSTM kernels launched {launches} over {TRAIN_STEPS} "
             f"steps, want {expect} (one per layer per step)")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < first:
        fail(f"{phase}: loss not finite or not falling: first {first}, "
             f"timed steps {losses}")
    ms = float(np.median(times))
    emit({"phase": phase, "config": {
        "vocab": 30000, "emb": bench.EMB_DIM, "hidden": card_run.hidden,
        "layers": bench.NUM_LAYERS, "batch": 64, "seq_len": 100},
        "warmup": 1 + TRAIN_WARMUP, "steps": TRAIN_STEPS,
        "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "tflop_per_s": card_run.flops_per_step / (ms / 1e3) / 1e12,
        "launches": launches, "loss_first": first, "loss_last": losses[-1],
        "first_step_vs_cpu": {"batch": check_batch or 64,
                              "loss_rel_err": loss_err,
                              "grad_rel_err_max": max(leaf_err),
                              "param_rel_err_max": max(param_err),
                              "mom_rel_err_max": max(mom_err),
                              "step_vs_mom_rel_err_max": max(step_err),
                              "bound": TRAIN_REL_TOL}})
    return launches


def leaf_names(tree, prefix=""):
    """Each leaf's path, in ``tree_leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}.{k}" if prefix
                                    else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


@contextlib.contextmanager
def ffn_probe(torch, transformer, record, signs=None):
    """Within it, the model's FFNs append each ReLU pre-activation (on
    the CPU, in call order) to ``record``; with ``signs`` (masks in the
    same order) each FFN keeps the positions its mask gives instead of
    its own positive ones: relu's value and gradient wherever the two
    agree, the other side's decision where they do not."""
    plain = transformer._ffn
    given = None if signs is None else iter(signs)

    def ffn(blk, x):
        pre = transformer.linear.matmul(x, blk["w1"]) + blk["b1"]
        record.append(pre.detach().cpu())
        h = (torch.relu(pre) if given is None
             else pre * next(given).to(pre.device))
        return transformer.linear.matmul(h, blk["w2"]) + blk["b2"]

    transformer._ffn = ffn
    try:
        yield
    finally:
        transformer._ffn = plain


def first_step(torch, transformer, run, record, signs=None):
    """One train step of ``run`` under ``ffn_probe``: (loss, grads on
    the CPU, m slots, v slots)."""
    from paddle_tpu_torch.utils.tree import tree_leaves
    with ffn_probe(torch, transformer, record, signs):
        loss = float(run.train_step())
    slots = run.opt_state["slots"]
    return (loss, [p.grad.cpu() for p in tree_leaves(run.params)],
            [m.cpu() for m in tree_leaves(slots["m"])],
            [v.cpu() for v in tree_leaves(slots["v"])])


def run_train_transformer(torch, dev, kernels):
    """bench_transformer on the card: one step at batch 2 against the
    same step on the CPU, the CPU step that keeps the card's ReLU
    decisions, and a TF32 control; then MT_WARMUP + MT_STEPS steps at
    batch 32 with each step's flash launches read."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves
    fk = kernels.flash_attention
    card_run = bench.bench_transformer(batch=2, device=dev)
    cpu_run = bench.bench_transformer(batch=2, device="cpu")
    names = leaf_names(cpu_run.params)
    n_enc = len(cpu_run.params["enc"])
    before = [p.detach().clone() for p in tree_leaves(cpu_run.params)]
    card_pre, cpu_pre, witness_pre = [], [], []
    first, card_g, card_m, card_v = first_step(torch, transformer, card_run,
                                               card_pre)
    first_cpu, cpu_g, cpu_m, cpu_v = first_step(torch, transformer,
                                                cpu_run, cpu_pre)
    del cpu_run
    witness = first_step(torch, transformer,
                         bench.bench_transformer(batch=2, device="cpu"),
                         witness_pre, [p > 0 for p in card_pre])

    def l2(got, want):
        return [float((g - w).norm() / w.norm()) for g, w in zip(got, want)]

    def largest(got, want):
        return [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got, want)]

    def pre_err(pres):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(pres, cpu_pre)]

    grad_err = l2(card_g, cpu_g)
    slot_err = l2(card_m + card_v, cpu_m + cpu_v)
    grad_max_err = largest(card_g, cpu_g)
    witness_err = largest(card_g + card_m + card_v,
                          witness[1] + witness[2] + witness[3])
    slot_names = [f"{kind} {n}" for kind in ("grad", "m", "v")
                  for n in names]
    card_pre_err = pre_err(card_pre)
    layers = [f"enc[{i}]" if i < n_enc else f"dec[{i - n_enc}]"
              for i in range(len(cpu_pre))]
    flips, flip_dist = {}, {}
    for name, a, b in zip(layers, card_pre, cpu_pre):
        flip = (a > 0) != (b > 0)
        if flip.any():
            flips[name] = int(flip.sum())
            flip_dist[name] = float(b[flip].abs().max() / b.abs().max())
    # Adam's first step from the card's own slots, in float64: p1 - p0 =
    # -lr * m_hat / (sqrt(v_hat) + eps) with m_hat = m / (1 - 0.9) and
    # v_hat = v / (1 - 0.999).  p1 is float32: its own rounding (up to
    # one spacing of p1, 1.2e-7 for a layer-norm gain near 1 against a
    # step of ~1e-4) is taken off before the difference is held
    # relative to the leaf's largest step.
    step_err = []
    for p, p0, m, v in zip(tree_leaves(card_run.params), before, card_m,
                           card_v):
        p1 = p.detach().cpu()
        want = (-1e-4 * (m.double() / (1 - 0.9))
                / ((v.double() / (1 - 0.999)).sqrt() + 1e-8))
        spacing = (torch.nextafter(p1, torch.tensor(math.inf))
                   - p1).double()
        miss = ((p1.double() - p0.double() - want).abs()
                - spacing).clamp(min=0)
        step_err.append(float(miss.max() / want.abs().max()))
    loss_err = abs(first - first_cpu) / abs(first_cpu)
    witness_loss_err = abs(first - witness[0]) / abs(witness[0])
    if len(cpu_pre) != len(card_pre) or len(witness_pre) != len(cpu_pre) \
            or not max(card_pre_err) <= MT_PRE_TOL \
            or not max(step_err + [loss_err, witness_loss_err]
                       + witness_err) <= TRAIN_REL_TOL \
            or not max(grad_err + slot_err) <= MT_GRAD_TOL:
        fail(f"train_transformer: first step at batch 2 on the card vs the "
             f"CPU: FFN pre-activations per layer {card_pre_err} (bound "
             f"{MT_PRE_TOL}, {len(card_pre)}/{len(cpu_pre)}/"
             f"{len(witness_pre)} FFN calls), sign flips {flips}; loss rel "
             f"err {loss_err}, {witness_loss_err} vs the witness; card's "
             f"step vs its slots {step_err}; largest-entry err of grads "
             f"and m/v vs the witness "
             f"{dict(zip(slot_names, witness_err))} (bound "
             f"{TRAIN_REL_TOL}); relative L2 err vs the plain CPU step of "
             f"grads {dict(zip(names, grad_err))}, of m/v {slot_err} "
             f"(bound {MT_GRAD_TOL})")
    del card_run, witness, before
    # the control: the same step with TF32 matrix products on the card
    # (switched on after bench_transformer, whose device.resolve sets
    # them off)
    control, control_pre = bench.bench_transformer(batch=2, device=dev), []
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, tf32_g, _, _ = first_step(torch, transformer, control,
                                     control_pre)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del control
    tf32 = {"ffn_pre_rel_err_max": max(pre_err(control_pre)),
            "grad_rel_l2_err_max": max(l2(tf32_g, cpu_g)),
            "grad_largest_entry_rel_err_max": max(largest(tf32_g, cpu_g))}
    if not (tf32["ffn_pre_rel_err_max"] > MT_PRE_TOL
            or tf32["grad_rel_l2_err_max"] > MT_GRAD_TOL):
        fail(f"train_transformer: the TF32 control step passes the first "
             f"step's checks: {tf32}")
    del tf32_g, control_pre, card_pre, cpu_pre, witness_pre
    over = {n: e for n, e in zip(names, grad_max_err) if e > TRAIN_REL_TOL}
    run = bench.bench_transformer(device=dev)
    losses, times, per_step = [], [], []
    for i in range(MT_WARMUP + MT_STEPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = run.train_step()
        torch.cuda.synchronize()
        losses.append(float(loss))
        if i >= MT_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append((fk.launches, fk.launches_bwd_dkv,
                             fk.launches_bwd_dq))
    want = (MT_ATTENTIONS,) * 3
    if any(n != want for n in per_step):
        fail(f"train_transformer: per-step (forward, dK/dV, dQ) launches "
             f"{per_step}, want {want} each step")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"train_transformer: loss not finite or not falling: {losses}")
    ms = float(np.median(times))
    launches = dict(zip((fk.NAME, fk.NAME_BWD_DKV, fk.NAME_BWD_DQ),
                        map(sum, zip(*per_step))))
    emit({"phase": "train_transformer", "config": {
        "vocab": 32000, "d_model": 512, "heads": MT_HEADS, "dff": 2048,
        "layers": "6+6", "batch": MT_BATCH, "seq_len": MT_SEQ,
        "optimizer": "Adam lr 1e-4", "label_smoothing": 0.1,
        "full_seq": True},
        "warmup": MT_WARMUP, "steps": MT_STEPS, "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "tokens_per_s": run.tokens_per_step / (ms / 1e3),
        "launches": launches,
        "launches_per_step": dict(zip(launches, want)),
        "loss_first": losses[0], "loss_last": losses[-1],
        "first_step_vs_cpu": {
            "batch": 2, "loss_rel_err": loss_err,
            "ffn_pre_rel_err_max": max(card_pre_err),
            "ffn_pre_bound": MT_PRE_TOL,
            "relu_sign_flips": flips,
            "flip_distance_from_0_rel_max": flip_dist,
            "vs_witness_largest_entry_rel_err_max": max(witness_err),
            "witness_loss_rel_err": witness_loss_err,
            "step_vs_slots_rel_err_max": max(step_err),
            "bound": TRAIN_REL_TOL,
            "grad_rel_l2_err_max": max(grad_err),
            "m_v_rel_l2_err_max": max(slot_err),
            "l2_bound": MT_GRAD_TOL,
            "grad_largest_entry_rel_err_max": max(grad_max_err),
            "leaves_over_bound_by_largest_entry": over,
            "tf32_control": tf32}})
    return launches


def run_train_seq2seq(torch, dev, kernels):
    """bench_seq2seq on the card: the first step against the CPU, then
    S2S_WARMUP + S2S_STEPS steps with each step's GRU launches read; then
    greedy_generate on the trained params against the CPU."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.models import seq2seq
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    gk = kernels.gru

    def rel(got, want):
        return [float((g.detach().cpu() - w.detach()).abs().max()
                      / w.detach().abs().max()) for g, w in zip(got, want)]

    card_run = bench.bench_seq2seq(device=dev)
    cpu_run = bench.bench_seq2seq(device="cpu")
    names = leaf_names(cpu_run.params)
    losses, times, per_step = [], [], []
    for i in range(1 + S2S_WARMUP + S2S_STEPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = card_run.train_step()
        torch.cuda.synchronize()
        if i > S2S_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append((gk.launches_fwd, gk.launches_bwd))
        if i == 0:    # the first step against the CPU's
            loss_cpu = float(cpu_run.train_step())
            grad_err = rel([p.grad for p in tree_leaves(card_run.params)],
                           [p.grad for p in tree_leaves(cpu_run.params)])
            mom_err = rel(tree_leaves(card_run.opt_state["slots"]["mom"]),
                          tree_leaves(cpu_run.opt_state["slots"]["mom"]))
            loss_err = abs(losses[0] - loss_cpu) / abs(loss_cpu)
            if not max(grad_err + mom_err + [loss_err]) <= TRAIN_REL_TOL:
                fail(f"train_seq2seq: first step on the card vs the CPU: "
                     f"loss rel err {loss_err}, per-leaf rel err of grads "
                     f"{dict(zip(names, grad_err))}, of mom "
                     f"{dict(zip(names, mom_err))} (bound {TRAIN_REL_TOL})")
            del cpu_run
    want = (S2S_DIRECTIONS, S2S_DIRECTIONS)
    if any(n != want for n in per_step):
        fail(f"train_seq2seq: per-step (forward, backward) GRU launches "
             f"{per_step}, want {want} each step")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"train_seq2seq: loss not finite or not falling: {losses}")

    src = card_run.src
    kernels.reset_launches()
    t0 = time.perf_counter()
    tokens, lengths = seq2seq.greedy_generate(card_run.params, src,
                                              max_len=S2S_LEN)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    gen_launches = (gk.launches_fwd, gk.launches_bwd)
    if gen_launches != (S2S_DIRECTIONS, 0):
        fail(f"train_seq2seq: greedy_generate launched the GRU kernels "
             f"{gen_launches} (forward, backward), want ({S2S_DIRECTIONS}, "
             f"0): the lean forward once per direction")
    params_cpu = tree_map(lambda p: p.detach().cpu(), card_run.params)
    src_cpu = SequenceBatch(src.data.cpu(), src.lengths.cpu())
    ref_tokens, ref_lengths = seq2seq.greedy_generate(params_cpu, src_cpu,
                                                      max_len=S2S_LEN)
    with torch.no_grad():   # the CPU's logits at each of its steps
        prev = torch.cat([torch.zeros_like(ref_tokens[:, :1]),
                          ref_tokens[:, :-1]], dim=1)
        logits = seq2seq.forward(params_cpu, src_cpu, SequenceBatch(
            prev, torch.full_like(src_cpu.lengths, S2S_LEN)))
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    checked = [compare(g, r, m) for g, r, m in zip(
        tokens.cpu().tolist(), ref_tokens.tolist(), margin)]
    if not all(ok for _, ok in checked):
        fail(f"train_seq2seq: greedy tokens differ from the CPU's within "
             f"the margin {MARGIN_TOL}: compared/ok {checked}")
    # the margins leave most tokens unchecked, so the whole sample is also
    # held on the card's values: the encoder (lean kernels, under no_grad)
    # and every step's log-probs, teacher-forced on the CPU's tokens
    with torch.no_grad():
        enc_c = seq2seq.encode(card_run.params, src)
        enc_r = seq2seq.encode(params_cpu, src_cpu)
        logp_c = torch.log_softmax(seq2seq.forward(
            card_run.params, src, SequenceBatch(
                prev.to(dev), torch.full_like(src.lengths, S2S_LEN))), -1)
    enc_err = dict(zip(("enc", "proj", "boot"), rel(
        [enc_c[0].data, enc_c[1].data, enc_c[2]],
        [enc_r[0].data, enc_r[1].data, enc_r[2]])))
    logp_err = rel([logp_c], [torch.log_softmax(logits, -1)])[0]
    if not max(enc_err.values()) <= S2S_REL_TOL \
            or not logp_err <= S2S_REL_TOL:
        fail(f"train_seq2seq: card vs CPU on the trained params: encode "
             f"rel err {enc_err}, log-probs on the CPU's tokens {logp_err} "
             f"(bound {S2S_REL_TOL})")
    launches = {gk.NAME_FWD: sum(f for f, _ in per_step),
                gk.NAME_BWD: sum(b for _, b in per_step)}
    ms = float(np.median(times))
    emit({"phase": "train_seq2seq", "config": {
        "vocab": S2S_VOCAB, "emb": S2S_HIDDEN, "hidden": S2S_HIDDEN,
        "att": S2S_HIDDEN, "batch": S2S_BATCH, "src_len": S2S_LEN,
        "trg_len": S2S_LEN, "optimizer": "Momentum lr 0.01 m 0.9"},
        "warmup": 1 + S2S_WARMUP, "steps": S2S_STEPS, "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "tokens_per_s": card_run.tokens_per_step / (ms / 1e3),
        "launches": launches, "launches_per_step": [
            dict(zip(launches, n)) for n in sorted(set(per_step))],
        "loss_first": losses[0], "loss_last": losses[-1],
        "first_step_vs_cpu": {"loss_rel_err": loss_err,
                              "grad_rel_err_max": max(grad_err),
                              "mom_rel_err_max": max(mom_err),
                              "bound": TRAIN_REL_TOL},
        "greedy_generate": {
            "batch": S2S_BATCH, "max_len": S2S_LEN, "ms": gen_ms,
            "launches": dict(zip(launches, gen_launches)),
            "tokens_compared": sum(n for n, _ in checked),
            "tokens": S2S_BATCH * S2S_LEN,
            "lengths_equal": bool((lengths.cpu() == ref_lengths).all()),
            "encode_rel_err": enc_err, "log_prob_rel_err": logp_err,
            "rel_bound": S2S_REL_TOL}})
    return {"train": launches, "generate": dict(zip(launches, gen_launches))}


@contextlib.contextmanager
def pool_probe(torch, record, argmax=None):
    """Swaps ``ops/sequence.seq_max_pool``: each call appends its argmax
    over time [B, D], the top-1 minus top-2 gap and the pooled values to
    ``record``.  With ``argmax`` (one [B, D] tensor per call, in call
    order) it pools at those steps instead, gradient and all: a step
    that keeps another run's decisions."""
    from paddle_tpu_torch.ops import sequence as seq_ops
    plain, given = seq_ops.seq_max_pool, iter(argmax or ())

    def probe(seq):
        valid = seq.mask(seq.data.dtype)[..., None] > 0
        top = torch.where(valid, seq.data, -1e30).detach().topk(2, dim=1)
        if argmax is None:
            out = plain(seq)
        else:
            idx = next(given).to(seq.data.device)
            out = torch.where((seq.lengths > 0)[:, None],
                              seq.data.gather(1, idx[:, None, :])[:, 0], 0.0)
        record.append({"argmax": top.indices[:, 0].cpu(),
                       "gap": (top.values[:, 0] - top.values[:, 1]).cpu(),
                       "pooled": out.detach().cpu()})
        return out

    seq_ops.seq_max_pool = probe
    try:
        yield
    finally:
        seq_ops.seq_max_pool = plain


def rnn_first_step(torch, dev, kernels, batch):
    """One SGD step of the slice's config on the card, on the CPU, and on
    a CPU witness that max-pools at the card's argmax, all from the same
    weights (SGD's seed) on ``batch``; held as RNN_TIE_TOL says.  Returns
    the card's trainer and the result record."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves
    rk = kernels.simple_rnn

    feeding = text_rnn.feeding()

    def step(device, record, argmax=None):
        tr = SGD(cost=text_rnn.build(), update_equation=text_rnn.optimizer(),
                 device=device)
        before = [p.detach().clone() for p in tr._leaves]
        with pool_probe(torch, record, argmax):
            total, _ = tr._forward(DataFeeder(feeding,
                                              device=tr.device)(batch))
        tr._backward(total)
        grads = [p.grad.detach().cpu() for p in tr._leaves]
        tr._update()
        return tr, float(total.detach()), before, grads

    def rel(got, want):
        return [float((g.detach().cpu() - w.detach()).abs().max()
                      / w.detach().abs().max()) for g, w in zip(got, want)]

    kernels.reset_launches()
    rec_c, rec_r, rec_w = [], [], []
    card, loss_c, before_c, grads_c = step(dev, rec_c)
    launches = (rk.launches_fwd, rk.launches_bwd)
    # the update descends: the batch's cost after it, in test mode
    after = card.test(lambda: iter([batch]), feeding=feeding)
    _, loss_r, _, grads_r = step("cpu", rec_r)
    witness, loss_w, _, grads_w = step("cpu", rec_w,
                                       [r["argmax"] for r in rec_c])
    names = leaf_names(witness.parameters)
    (pc,), (pr,), (pw,) = rec_c, rec_r, rec_w
    scale = float(pr["pooled"].abs().max())
    pooled_err = float((pc["pooled"] - pr["pooled"]).abs().max()) / scale
    flips = pc["argmax"] != pr["argmax"]
    flip_gap = float(pr["gap"][flips].max()) / scale if flips.any() else 0.0
    card_mom = [m.cpu() for m in tree_leaves(card.opt_state["slots"]["mom"])]
    loss_err = abs(loss_c - loss_w) / abs(loss_w)
    grad_err = rel(grads_c, grads_w)
    param_err = rel(card._leaves, witness._leaves)
    mom_err = rel(card_mom, tree_leaves(witness.opt_state["slots"]["mom"]))
    # the card's update is its own momentum added to the same start
    step_err = [float((p.detach().cpu() - (w.cpu() + m)).abs().max()
                      / m.abs().max())
                for p, w, m in zip(card._leaves, before_c, card_mom)]
    worst = max(grad_err + param_err + mom_err + step_err + [loss_err])
    if launches != (2, 2) or not pooled_err <= RNN_TIE_TOL \
            or not flip_gap <= RNN_TIE_TOL or not worst <= TRAIN_REL_TOL \
            or not after < loss_c:
        fail(f"train_rnn: first step on the card: launches {launches} (want "
             f"2, 2); the batch's cost {loss_c} before the update, {after} "
             f"after (must fall); pooled values vs the CPU rel err "
             f"{pooled_err}, "
             f"{int(flips.sum())} argmax flips with CPU gaps up to "
             f"{flip_gap} of the largest (bound {RNN_TIE_TOL}); vs the CPU "
             f"witness: loss rel err {loss_err}, per-leaf rel err of grads "
             f"{dict(zip(names, grad_err))}, of params "
             f"{dict(zip(names, param_err))}, of mom "
             f"{dict(zip(names, mom_err))}, of the card's step vs its mom "
             f"{dict(zip(names, step_err))} (bound {TRAIN_REL_TOL})")
    plain = {"loss_rel_err": abs(loss_c - loss_r) / abs(loss_r),
             "grad_largest_entry_rel_err_max": max(rel(grads_c, grads_r)),
             "grad_rel_l2_err_max": max(
                 float((g - r).norm() / r.norm())
                 for g, r in zip(grads_c, grads_r))}
    return card, launches, {
        "batch": text_rnn.BATCH, "cost_before_after_update": [loss_c, after],
        "pooled_rel_err": pooled_err,
        "argmax_flips": int(flips.sum()), "pooled_units": flips.numel(),
        "flip_gap_rel_max": flip_gap, "tie_bound": RNN_TIE_TOL,
        "vs_witness": {"loss_rel_err": loss_err,
                       "grad_rel_err_max": max(grad_err),
                       "param_rel_err_max": max(param_err),
                       "mom_rel_err_max": max(mom_err),
                       "step_vs_mom_rel_err_max": max(step_err),
                       "bound": TRAIN_REL_TOL},
        "vs_plain_cpu_step": plain}


RNN_CLI_CONFIG = """\
from paddle_tpu_torch.models import text_rnn


def get_config():
    return text_rnn.config(seed=int(CONFIG_ARGS["seed"]),
                           n_batches=int(CONFIG_ARGS["batches"]))
"""


def rnn_cli(torch, dev, seed, trainer):
    """``python -m paddle_tpu_torch train`` as a subprocess on a config
    file written to a temp dir (the slice's config, RNN_CLI_BATCHES
    batches, one pass): its pass dir must exist and ``SGD.load`` must
    restore its parameters bit for bit; then ``trainer``'s own save and
    load round trip, bit for bit too."""
    import os
    import subprocess
    import tempfile
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import SGD, load_checkpoint
    root = os.path.dirname(os.path.abspath(__file__))

    def fresh():
        return SGD(cost=text_rnn.build(), update_equation=text_rnn.optimizer(),
                   device=dev)

    def equal(params, tree):
        return all(np.array_equal(params[k][n].detach().cpu().numpy(),
                                  np.asarray(tree[k][n]))
                   for k in tree for n in tree[k])

    with tempfile.TemporaryDirectory() as tmp:
        cfg, save = os.path.join(tmp, "rnn_config.py"), os.path.join(tmp,
                                                                    "out")
        with open(cfg, "w") as f:
            f.write(RNN_CLI_CONFIG)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "train", "--config",
             cfg, "--config_args", f"seed={seed},batches={RNN_CLI_BATCHES}",
             "--num_passes", "1", "--save_dir", save, "--log_period", "1",
             "--device", dev.type],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        pass_dir = os.path.join(save, "pass-00000")
        if run.returncode != 0 or not os.path.isdir(pass_dir):
            fail(f"train_rnn: the CLI exited {run.returncode} and left "
                 f"{os.listdir(save) if os.path.isdir(save) else None}: "
                 f"{run.stderr[-3000:]}")
        loaded = fresh()
        meta = loaded.load(save)
        params, opt_state, _, _ = load_checkpoint(save)
        if not equal(loaded.parameters, params) \
                or loaded.opt_state["step"] != RNN_CLI_BATCHES:
            fail(f"train_rnn: SGD.load of the CLI's {pass_dir} does not "
                 f"restore its parameters bit for bit (optimizer step "
                 f"{loaded.opt_state['step']}, want {RNN_CLI_BATCHES})")
        mine = os.path.join(tmp, "mine")
        trainer.save(mine, 0)
        again = fresh()
        again.load(mine)
        host = {k: {n: p.detach().cpu().numpy() for n, p in v.items()}
                for k, v in trainer.parameters.items()}
        if not equal(again.parameters, host):
            fail("train_rnn: SGD.save then SGD.load does not restore the "
                 "trained parameters bit for bit")
        cost_lines = [line for line in run.stderr.splitlines()
                      if " Cost " in line]
    return {"seconds": cli_s, "pass_dir": os.path.basename(pass_dir),
            "meta_pass_id": meta["pass_id"], "batches": RNN_CLI_BATCHES,
            "log": cost_lines[-1].split("] ", 1)[-1] if cost_lines else None,
            "load_bit_for_bit": True, "save_load_round_trip": True}


def run_train_rnn(torch, dev, kernels, seed):
    """The layer-DSL slice (models/text_rnn: 2 x recurrent_layer h=512)
    through trainer.SGD on the card: the first step against the CPU from
    the same weights, then ``SGD.train`` over RNN_BATCHES batches with
    each step's simple-RNN launches and wall time read from the events,
    ``SGD.test`` on a held-out reader, the step's split, and the CLI."""
    from paddle_tpu_torch.data import DataFeeder, reader as reader_mod
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.trainer import events
    rk = kernels.simple_rnn
    feeding = text_rnn.feeding()
    data = text_rnn.samples(seed, RNN_BATCHES * text_rnn.BATCH)

    card, first_launches, first = rnn_first_step(
        torch, dev, kernels, data[:text_rnn.BATCH])

    record = {"ms": [], "loss": [], "launches": []}

    def handler(e):
        if isinstance(e, events.BeginIteration):
            torch.cuda.synchronize()
            kernels.reset_launches()
            record["t0"] = time.perf_counter()
        elif isinstance(e, events.EndIteration):
            record["loss"].append(float(e.cost))     # a synchronize
            record["ms"].append((time.perf_counter() - record["t0"]) * 1e3)
            record["launches"].append((rk.launches_fwd, rk.launches_bwd))

    t0 = time.perf_counter()
    card.train(reader_mod.batch(lambda: iter(data), text_rnn.BATCH),
               num_passes=1, event_handler=handler, feeding=feeding,
               log_period=0)
    pass_s = time.perf_counter() - t0
    losses, per_step = record["loss"], record["launches"]
    if len(losses) != RNN_BATCHES or any(n != (2, 2) for n in per_step):
        fail(f"train_rnn: {len(losses)} steps with per-step (forward, "
             f"backward) launches {per_step}, want {RNN_BATCHES} steps of "
             f"(2, 2): one of each per recurrent layer")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_rnn: loss not finite: {losses}")
    test_cost = card.test(text_rnn.batches(seed + 1, text_rnn.TEST_BATCHES),
                          feeding=feeding)
    if not math.isfinite(test_cost):
        fail(f"train_rnn: SGD.test cost {test_cost}")
    feeder = DataFeeder(feeding, device=dev)
    split = bench.step_split(card, feeder, list(reader_mod.batch(
        lambda: iter(data), text_rnn.BATCH)()), 10)
    cli = rnn_cli(torch, dev, seed, card)
    timed = record["ms"][3:]
    ms = float(np.median(timed))
    launches = {rk.NAME_FWD: first_launches[0] + sum(f for f, _ in per_step),
                rk.NAME_BWD: first_launches[1] + sum(b for _, b in per_step)}
    emit({"phase": "train_rnn", "config": {
        "model": "models/text_rnn (layer DSL)", "vocab": text_rnn.VOCAB,
        "emb": text_rnn.EMB, "hidden": text_rnn.HIDDEN,
        "layers": text_rnn.LAYERS, "batch": text_rnn.BATCH,
        "seq_len": text_rnn.SEQ_LEN, "optimizer": "Momentum lr 0.01 m 0.9",
        "entry": "trainer.SGD.train", "batches": RNN_BATCHES},
        "steps_timed": len(timed), "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(timed), max(timed)],
        "tokens_per_s": text_rnn.BATCH * text_rnn.SEQ_LEN / (ms / 1e3),
        "tflop_per_s": bench.rnn_flops(text_rnn.BATCH, text_rnn.SEQ_LEN,
                                       text_rnn.HIDDEN) / (ms / 1e3) / 1e12,
        "pass_seconds": pass_s, "split_ms": split,
        "launches": launches, "launches_per_step": [
            dict(zip(launches, n)) for n in sorted(set(per_step))],
        "losses": losses, "test_cost": test_cost,
        "first_step_vs_cpu": first, "cli": cli})
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from paddle_tpu_torch import device as _device
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels
    dev = _device.resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _device.card()
    emit({"phase": "device", "kind": kind, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # every library and the probes' 3xTF32 controls, all nvcc at once
    from paddle_tpu_torch.scripts import (probe_flash, probe_gru,
                                          probe_simple_rnn)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = (pool.submit(kernels.build),
                pool.submit(probe_simple_rnn.build, ["kernel", "tf32_1x"]),
                pool.submit(probe_gru.build, ["kernel", "tf32_1x"]),
                pool.submit(probe_flash.build, ["tf32_1x"]))
        libs, rnn_libs, gru_libs, flash_libs = (job.result() for job in jobs)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs),
          "probe_variants": {"simple_rnn": sorted(rnn_libs),
                             "gru": sorted(gru_libs),
                             "flash": sorted(flash_libs)},
          "flash_wide_ptxas": {
              name: rep for name, rep in flash_libs["tf32_1x"][1].items()
              if int(name.split("/dh")[1].split("/")[0]) > 128}})

    rng = np.random.RandomState(args.seed)
    chunk = check_decode_kernel(torch, dev, rng, hkv=HEADS)
    chunk_gqa = check_decode_kernel(torch, dev, rng, hkv=2)
    flash = check_flash_kernel(torch, dev, rng, GEN_BATCH, GEN_PROMPT,
                               timed=True)
    flash_ragged = check_flash_kernel(torch, dev, rng, 4, 200, timed=False)
    lstm_fwd, lstm_bwd = check_lstm_kernels(torch, dev, rng, LSTM_T, LSTM_B,
                                            LSTM_D, timed=True)
    lstm_other = [row for t, b, d in LSTM_OTHER
                  for row in check_lstm_kernels(torch, dev, rng, t, b, d,
                                                timed=False)]
    lstm_control = check_lstm_tf32_control(torch, dev)
    paged = check_paged_kernels(torch, dev, rng, hkv=HEADS)
    paged_gqa = check_paged_kernels(torch, dev, rng, hkv=2)
    int8 = check_int8_decode_kernels(torch, dev, rng, hkv=HEADS)
    int8_gqa = check_int8_decode_kernels(torch, dev, rng, hkv=2)
    split = check_split_kernels(torch, dev, rng)
    tq1 = check_split_kernels(torch, dev, rng, tq1=True)
    tq1_gqa = check_split_kernels(torch, dev, rng, tq1=True, hkv=2)
    # the Tq=1 instances the 2-head ladder's steps launch (dh 256)
    tq1_wide = check_split_kernels(torch, dev, rng, tq1=True, h=WIDE_HEADS,
                                   hkv=WIDE_HEADS)
    # the device time alone beside the wrapper-timed ms of each row
    dk = kernels.decode_attention
    for row, alone in (
            (chunk, split), (paged[dk.NAME_PAGED_CHUNK], split),
            (int8[dk.NAME_I8], split), (int8[dk.NAME_PAGED_CHUNK_I8], split),
            (paged[dk.NAME_SLAB], tq1), (paged[dk.NAME_PAGED], tq1),
            (int8[dk.NAME_SLAB_I8], tq1), (int8[dk.NAME_PAGED_I8], tq1)):
        row.update({key: alone[row["name"]][key]
                    for key in ("device_ms", "library_device_ms")})
    flash_q = check_flash_quant_kernel(torch, dev, rng, GEN_BATCH,
                                       GEN_PROMPT, HEADS, timed=True)
    flash_q_ragged = check_flash_quant_kernel(torch, dev, rng, 4, 200, 2,
                                              timed=False)
    flash_train, flash_bwd, flash_bwd_checks = check_flash_train(torch, dev,
                                                                 rng)
    flash_wide = check_flash_wide(torch, dev, rng, flash_libs["tf32_1x"][0])
    flash_q_wide = check_flash_quant_kernel(
        torch, dev, rng, WIDE_B, WIDE_T, WIDE_H, timed=True, h=WIDE_H,
        dh=D_MODEL // WIDE_HEADS)
    (gru_fwd, gru_bwd), gru_other = check_gru_kernels(torch, dev, rng,
                                                      gru_libs)
    blk_timed, blk_other, blk_probe = check_blocked_kernel(torch, dev, rng)
    (rnn_fwd, rnn_bwd), rnn_other = check_rnn_kernels(torch, dev, rng,
                                                      rnn_libs)
    emit({"phase": "kernels", "tolerance": KERNEL_TOL,
          "lstm_blocked_3xtf32_tolerance": BLK_TC_TOL,
          "int8_vs_f32_kernel_on_dequantized": "bit for bit (max abs err 0)",
          "lstm_tolerance": {"abs": LSTM_TOL, "rel": LSTM_REL_TOL,
                             "3xtf32": LSTM_TC_TOL},
          "checks": [chunk, chunk_gqa, flash, flash_ragged, lstm_fwd,
                     lstm_bwd, *lstm_other, *paged.values(),
                     *paged_gqa.values(), *int8.values(),
                     *int8_gqa.values(), flash_q, flash_q_ragged],
          "flash_train_shape": {"forward": list(flash_train.values()),
                                "backward": [r for rows in flash_bwd.values()
                                             for r in rows.values()],
                                "backward_checks": flash_bwd_checks,
                                "backward_rel_tolerance": MT_REL_TOL},
          "split_kv_chunk_kernels": list(split.values()),
          "split_kv_tq1_kernels": [*tq1.values(), *tq1_gqa.values(),
                                   *tq1_wide.values()],
          "flash_wide": {"tolerance_3xtf32": WIDE_TC_TOL,
                         "rows": flash_wide,
                         "flash_attention_quant": flash_q_wide},
          "other_head_dims": check_head_dims(torch, dev, rng),
          "lstm_3xtf32_control": lstm_control,
          "lstm_reverse": check_lstm_reverse(torch, dev, rng, kernels),
          "lstm_scan": check_lstm_scan(torch, dev, rng, kernels),
          "lstm_blocked_train_shape": list(blk_timed.values()),
          "lstm_blocked_other": blk_other,
          "lstm_blocked_gain_probe": blk_probe,
          "gru_3xtf32_tolerance": GRU_TC_TOL,
          "gru_train_shape": [gru_fwd, gru_bwd], "gru_other": gru_other,
          "gru_3xtf32_control": check_gru_tf32_control(torch, dev,
                                                       gru_libs),
          "gru_reverse": check_gru_reverse(torch, dev, rng, kernels),
          "gru_barrier": check_gru_barrier(torch),
          "simple_rnn_3xtf32_tolerance": RNN_TC_TOL,
          "simple_rnn_train_shape": [rnn_fwd, rnn_bwd],
          "simple_rnn_other": rnn_other,
          "simple_rnn_3xtf32_control": check_rnn_tf32_control(
              torch, dev, rnn_libs),
          "simple_rnn_routes": check_rnn_routes(torch, dev, rng, kernels)})

    emit(check_flash_padded(torch, dev, rng, kernels))

    params = transformer.init_lm(
        torch.Generator().manual_seed(args.seed), VOCAB, D_MODEL, HEADS,
        DFF, LAYERS, SERVE_MAX_LEN, device=dev)
    gen_launches = run_generate(torch, dev, transformer, kernels, params,
                                rng)
    serve_launches = run_serve(torch, dev, transformer, kernels, params,
                               rng)
    paged_launches = run_serve_paged(torch, dev, transformer, kernels,
                                     params, rng)
    ladder_launches = run_ladder(torch, dev, transformer, kernels, params,
                                 rng)
    gen8_launches = run_generate_int8(torch, dev, transformer, kernels,
                                      params, rng)
    serve8_launches = run_serve(torch, dev, transformer, kernels, params,
                                rng, kv_dtype="int8")
    paged8_launches = run_serve_paged_int8(torch, dev, transformer, kernels,
                                           params, rng)
    ladder8_launches = run_ladder(torch, dev, transformer, kernels, params,
                                  rng, kv_dtype="int8")
    w8_launches = run_serve_w8(torch, dev, transformer, kernels, params,
                               args.seed, rng)
    spec_launches = run_serve_spec(torch, dev, transformer, kernels, params,
                                   args.seed, rng)
    del params
    # the same ladder at D 512 over 2 heads (dh 256: the wide flash
    # instances in the prefill, the Tq=1 kernels at that width), depth cut
    params = transformer.init_lm(
        torch.Generator().manual_seed(args.seed), VOCAB, D_MODEL,
        WIDE_HEADS, DFF, WIDE_LAYERS, SERVE_MAX_LEN, device=dev)
    wide_launches = {
        kv: run_ladder(torch, dev, transformer, kernels, params, rng,
                       kv_dtype=kv, heads=WIDE_HEADS, layers=WIDE_LAYERS,
                       layouts=("slab",))["slab"]
        for kv in ("float32", "int8")}
    del params
    train_launches = run_train(torch, dev, kernels)
    blk_launches = {h: run_train(torch, dev, kernels, hidden=h,
                                 check_batch=b)
                    for h, b in ((1280, None), (2048, 8))}
    mt_launches = run_train_transformer(torch, dev, kernels)
    s2s_launches = run_train_seq2seq(torch, dev, kernels)
    rnn_launches = run_train_rnn(torch, dev, kernels, args.seed)

    summary = []
    for row, mod, launches in (
            (chunk, kernels.decode_attention,
             serve_launches["decode_attention_slab_chunk"]),
            (flash, kernels.flash_attention,
             gen_launches["flash_attention"])):
        summary.append({
            "name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{key: row[key] for key in DEVICE_KEYS if key in row}})
    summary[-1]["launches_dh256"] = wide_launches["float32"]["flash_attention"]
    # the forward on the train path: its launches in train_transformer
    # and its non-causal time at the train shape beside the prefill row
    train_fwd = flash_train[False]
    summary[-1]["train"] = {
        "launches": mt_launches[kernels.flash_attention.NAME],
        "shape": {"B": MT_BATCH, "H": MT_HEADS, "T": MT_SEQ, "dh": MT_DH,
                  "causal": False},
        **{key: train_fwd[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "causal": {key: flash_train[True][key] for key in (
            "ms", "bound_ms", "bound_by", "library_ms")}}
    fk = kernels.flash_attention
    for name, replaces in ((fk.NAME_BWD_DKV, fk.REPLACES_BWD_DKV),
                           (fk.NAME_BWD_DQ, fk.REPLACES_BWD_DQ)):
        row, causal_row = flash_bwd[name][False], flash_bwd[name][True]
        summary.append({
            "name": name, "route": "cuda", "source": fk.SOURCE,
            "replaces": replaces, "launches": mt_launches[name],
            "max_abs_err": max(row["max_abs_err"],
                               causal_row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {"B": MT_BATCH, "H": MT_HEADS, "T": MT_SEQ,
                      "dh": MT_DH, "causal": False},
            "causal": {key: causal_row[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "library_note": "scaled_dot_product_attention's backward alone "
                            "(autograd.grad over a retained graph): it "
                            "computes dq, dk and dv together, so the same "
                            "time stands on both rows; plain_ms likewise "
                            "is the whole plain backward"})
    # the wide instances at WIDE_B, WIDE_H, WIDE_T: on the forward row
    # and the two backward rows
    for row, key in ((summary[1], "fwd"), (summary[2], "dkv"),
                     (summary[3], "dq")):
        row["wide"] = [{"dh": w["dh"], "causal": w["causal"],
                        "sdpa_backend": w["sdpa_backend"],
                        **{k: w[key][k] for k in (
                            "max_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}}
                       for w in flash_wide]
    for row, replaces in ((lstm_fwd, kernels.lstm.REPLACES_FWD),
                          (lstm_bwd, kernels.lstm.REPLACES_BWD)):
        name = row["name"]
        summary.append({
            "name": name, "route": "cuda",
            "source": kernels.lstm.SOURCE, "replaces": replaces,
            "launches": train_launches[name],
            "max_abs_err": max([row["max_abs_err"]]
                               + [r["max_abs_err"] for r in lstm_other
                                  if r["name"] == name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "library_note": row["library_note"],
            "shape": row["shape"],
            **({"dW_r_ms": row["split"]["dW_r_ms"]}
               if "split" in row else {})})
    bk = kernels.lstm_blocked
    row = blk_timed[BLK_TIMED[0]]
    summary.append({
        "name": bk.NAME_FWD, "route": "cuda", "source": bk.SOURCE,
        "replaces": bk.REPLACES_FWD,
        "launches": sum(n[bk.NAME_FWD] for n in blk_launches.values()),
        "launches_by_path": {f"train_lstm{h}": n[bk.NAME_FWD]
                             for h, n in blk_launches.items()},
        "max_abs_err": max([r["max_abs_err"] for r in blk_timed.values()]
                           + [r["max_abs_err"] for r in blk_other]),
        **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "library_note")},
        "shape": {"T": BLK_T, "B": BLK_B, "D": BLK_TIMED[0]},
        **{f"D{d}": {key: r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
           for d, r in blk_timed.items() if d != BLK_TIMED[0]}})
    for row, replaces in ((gru_fwd, kernels.gru.REPLACES_FWD),
                          (gru_bwd, kernels.gru.REPLACES_BWD)):
        name = row["name"]
        summary.append({
            "name": name, "route": "cuda", "source": kernels.gru.SOURCE,
            "replaces": replaces,
            "launches": s2s_launches["train"][name]
            + s2s_launches["generate"][name],
            "launches_by_path": {path: n[name]
                                 for path, n in s2s_launches.items()},
            "max_abs_err": max([row["max_abs_err"]]
                               + [r["max_abs_err"] for r in gru_other
                                  if r["name"] == name]),
            **({"rel_err": {key: max([row["rel_err"][key]]
                                     + [r["rel_err"][key] for r in gru_other
                                        if r["name"] == name])
                            for key in row["rel_err"]}}
               if name == kernels.gru.NAME_BWD else {}),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "library_note")},
            **({"dW_ms": row["split"]["dW_ms"]}
               if name == kernels.gru.NAME_BWD else {}),
            "shape": row["shape"]})
    for row, replaces in ((rnn_fwd, kernels.simple_rnn.REPLACES_FWD),
                          (rnn_bwd, kernels.simple_rnn.REPLACES_BWD)):
        name = row["name"]
        summary.append({
            "name": name, "route": "cuda",
            "source": kernels.simple_rnn.SOURCE, "replaces": replaces,
            "launches": rnn_launches[name],
            "max_abs_err": max([row["max_abs_err"]]
                               + [r["max_abs_err"] for r in rnn_other
                                  if r["name"] == name]),
            **({key: max([row[key]] + [r[key] for r in rnn_other
                                       if r["name"] == name])
                for key in ("dxs_rel_err", "dW_rel_err")}
               if name == kernels.simple_rnn.NAME_BWD else {}),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "library_note")},
            **({"dW_ms": row["split"]["dW_ms"]} if "split" in row else {}),
            "shape": row["shape"]})
    for name, replaces, launches in (
            (dk.NAME_SLAB, dk.REPLACES_SLAB,
             ladder_launches["slab"][dk.NAME_SLAB]),
            (dk.NAME_PAGED, dk.REPLACES_PAGED,
             ladder_launches["paged"][dk.NAME_PAGED]),
            (dk.NAME_PAGED_CHUNK, dk.REPLACES_PAGED_CHUNK,
             paged_launches[dk.NAME_PAGED_CHUNK])):
        row = paged[name]
        summary.append({
            "name": name, "route": "cuda", "source": dk.SOURCE,
            "replaces": replaces, "launches": launches,
            **({"launches_dh256": wide_launches["float32"][name],
                "dh256": {key: tq1_wide[name][key] for key in (
                    "max_abs_err", "device_ms")}}
               if name == dk.NAME_SLAB else {}),
            "max_abs_err": max(row["max_abs_err"],
                               paged_gqa[name]["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **{key: row[key] for key in DEVICE_KEYS if key in row},
            **({"library_note": row["library_note"]}
               if "library_note" in row else {})})
    for name, replaces, launches, row, gqa in (
            (dk.NAME_I8, dk.REPLACES, serve8_launches[dk.NAME_I8],
             int8[dk.NAME_I8], int8_gqa[dk.NAME_I8]),
            (dk.NAME_SLAB_I8, dk.REPLACES_SLAB,
             ladder8_launches["slab"][dk.NAME_SLAB_I8],
             int8[dk.NAME_SLAB_I8], int8_gqa[dk.NAME_SLAB_I8]),
            (dk.NAME_PAGED_I8, dk.REPLACES_PAGED,
             ladder8_launches["paged"][dk.NAME_PAGED_I8],
             int8[dk.NAME_PAGED_I8], int8_gqa[dk.NAME_PAGED_I8]),
            (dk.NAME_PAGED_CHUNK_I8, dk.REPLACES_PAGED_CHUNK,
             paged8_launches[dk.NAME_PAGED_CHUNK_I8],
             int8[dk.NAME_PAGED_CHUNK_I8], int8_gqa[dk.NAME_PAGED_CHUNK_I8]),
            (fk.NAME_QUANT, fk.REPLACES_QUANT, gen8_launches[fk.NAME_QUANT],
             flash_q, flash_q_ragged)):
        summary.append({
            "name": name, "route": "cuda",
            "source": fk.SOURCE if name == fk.NAME_QUANT else dk.SOURCE,
            "replaces": replaces, "launches": launches,
            **({"launches_dh256": wide_launches["int8"][name]}
               if name in (dk.NAME_SLAB_I8, fk.NAME_QUANT) else {}),
            **({"dh256": {key: tq1_wide[name][key] for key in (
                "max_abs_err", "err_vs_f32_kernel_on_dequantized",
                "device_ms")}} if name == dk.NAME_SLAB_I8 else {}),
            "max_abs_err": max(row["max_abs_err"], gqa["max_abs_err"]),
            "err_vs_f32_kernel_on_dequantized": max(
                row["err_vs_f32_kernel_on_dequantized"],
                gqa["err_vs_f32_kernel_on_dequantized"]),
            "ms": row["ms"], "f32_kernel_ms": row["f32_kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            **{key: row[key] for key in DEVICE_KEYS if key in row},
            "library_note": row["library_note"]})
    summary[-1]["dh256"] = {key: flash_q_wide[key] for key in (
        "shape", "max_abs_err", "ms", "f32_kernel_ms", "plain_ms",
        "bound_ms", "bound_by")}
    # the int8-weight and speculative serving phases' launches, by row
    for row in summary:
        extra = {}
        for phase, runs in (("serve_w8", w8_launches),
                            ("serve_spec", spec_launches)):
            n = sum(got.get(row["name"], 0) for got in runs.values())
            if phase == "serve_w8" and row["name"] in (
                    fk.NAME, fk.NAME_QUANT):
                # the oracle's prefill: float32 KV (slab), int8 (paged)
                n = w8_launches["slab_f32kv" if row["name"] == fk.NAME
                                else "paged_i8kv"]["oracle_flash"]
            if n:
                extra[phase] = n
        if extra:
            row["launches_serving_variants"] = extra
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
