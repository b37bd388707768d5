#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no final "ok" line:

  device    the card's name, and its name and power limit as nvidia-smi
            reports them (also printed alone on a line)
  build     nvcc builds every kernel library from paddle_tpu_torch/csrc
            (decode attention, flash attention, LSTM), one nvcc per
            source, in parallel; seconds taken
  kernels   each kernel at the main path's shapes against its plain
            PyTorch version (max abs error within the stated bound; the
            LSTM pair on a ragged mask with an empty row, timed on the
            train batch's full rows, also at D=128 and 256 and through
            a reverse LSTM; the paged pair over a 129-block pool with
            shuffled ids, shared leading blocks and a free row on block
            0, and the Tq=1 slab kernel; the int8 instances of the four
            decode kernels at the same shapes and flash_attention_quant
            at B=32, T=32 and a ragged T=200 with Hkv=2, each also held
            bit for bit against its float32 kernel on the dequantized
            cache), timed with CUDA events beside the plain version, one
            PyTorch library call computing the same function (a
            yardstick the port never calls; none exists for the int8
            kernels) and the least time the card could take
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
  train     the headline benchmark, bench.py's bench_lstm ported
            (scripts/bench.bench_lstm): the LSTM text classifier at vocab
            30000, embedding 128, 2 x LSTM h=512, batch 64, length 100,
            Momentum, on one fixed batch.  Its first step is held
            against the same step on the CPU (plain versions: loss and
            every gradient leaf), then warm-up and timed steps: each
            step launches the LSTM forward and backward kernels once per
            layer, the loss is finite and falls
Then the kernel summary line, the nvidia-smi line, and last:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Without a CUDA device, or run from a directory that holds this script
and nothing else of the repository, it exits non-zero and prints no
result.
"""

import argparse
import json
import math
import sys
import threading
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 FLOP/s outside the tensor cores (both kernels compute in f32)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

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
PREAMBLE = 64
LADDER_PROMPTS, LADDER_TOKENS = (5, 17, 32, 40, 64, 9, 50, 23), 24

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


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return row


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


def check_flash_quant_kernel(torch, dev, rng, b, t, hkv, timed):
    """flash_attention_quant on q [B, T, D] and an int8 cache [B, T, Dkv]:
    bit for bit against the float32 flash kernel on the dequantized,
    head-repeated K/V, within KERNEL_TOL of its plain version."""
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    h, dh = HEADS, D_MODEL // HEADS
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
    row = {"name": fk.NAME_QUANT, "T": t, "hkv": hkv, "max_abs_err": err,
           "err_vs_f32_kernel_on_dequantized": exact}
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
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return row


def check_head_dims(torch, dev, rng):
    """Every kernel of the attention family at every other head dim it
    takes (16, 32, 128), on small ragged shapes: GQA, K = 5 lanes over T
    = 77 for the slab chunk kernel, the same rows over a shuffled pool of
    8-position blocks for the paged chunk kernel, lane 0 of each row for
    the Tq=1 pair; causal T = 45 and non-causal Tq = 19, Tk = 45 for the
    flash kernel; the int8 instance of each of the four on the same rows
    and flash_attention_quant at causal T = 45, Hkv = 2."""
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    errs, exacts = {}, {}

    def err(name, dh, got, want):
        errs[f"{name}/dh{dh}"] = float((got - want).abs().max())

    def exact(name, dh, got, want):
        exacts[f"{name}/dh{dh}"] = float((got - want).abs().max())

    for dh in (16, 32, 128):
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
        for causal, tq in ((True, 45), (False, 19)):
            q = torch.tensor(normal(rng, (1, 2, tq, dh)), device=dev)
            k = torch.tensor(normal(rng, (1, 2, 45, dh)), device=dev)
            v = torch.tensor(normal(rng, (1, 2, 45, dh)), device=dev)
            o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
            errs[f"flash_attention/dh{dh}/causal{int(causal)}"] = max(
                float((o - o_ref).abs().max()),
                float((lse - lse_ref).abs().max()))
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
    return {"vs_plain": errs, "int8_vs_f32_kernel": exacts}


def lstm_inputs(torch, dev, rng, t, b, d, ragged):
    """(lengths, xs [T, B, 4D], mask [T, B], w_r, checks) at the JAX
    tests' scale.  Ragged: random lengths with one empty row and one
    full row; else every row full, as the train path's batch is."""
    lengths = np.full(b, t)
    if ragged:
        lengths = rng.randint(1, t + 1, b)
        lengths[0] = 0
        lengths[-1] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (lengths,
            torch.tensor(normal(rng, (t, b, 4 * d)) * 0.3, device=dev),
            torch.tensor(mask, device=dev),
            torch.tensor(normal(rng, (d, 4 * d)) * 0.1, device=dev),
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
    two result rows and the four calls (kernel, plain) x (fwd, bwd)."""
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
    rows = [{"name": lk.NAME_FWD, "D": d, "ragged": ragged,
             "max_abs_err": fwd_err},
            {"name": lk.NAME_BWD, "D": d, "ragged": ragged,
             "max_abs_err": max(dxs_err, err(gb[1], rb[1]),
                                err(gb[2], rb[2])),
             "dxs_max_abs_err": dxs_err, "rel_err": rel}]
    calls = ((lambda: lk.lstm_fwd(xs, mask, w_r, checks, True),
              lambda: lk.lstm_fwd_plain(xs, mask, w_r, checks, True)),
             (lambda: lk.lstm_bwd(*bwd_args),
              lambda: lk.lstm_bwd_plain(*bwd_args)))
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
    for row, row_full, (fn, plain), (nbytes, flops) in zip(rows, full, calls,
                                                           costs):
        row.update(max_abs_err=max(row["max_abs_err"],
                                   row_full["max_abs_err"]),
                   full_rows_check=row_full,
                   shape={"T": t, "B": b, "D": d, "timed_on": "full rows"},
                   ms=time_ms(torch, fn, samples=20, reps=5),
                   plain_ms=time_ms(torch, plain, samples=5, reps=2),
                   library_ms=None, library_note=library,
                   bytes=nbytes, flops=flops)
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return rows


def check_lstm_reverse(torch, dev, rng):
    """rnn.lstm(reverse=True) on the card (kernels, through LstmFused)
    against the same call on the CPU (plain versions): loss and every
    gradient, on a ragged batch with an empty row and an odd B."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import rnn
    t, b, d = 30, 5, 128
    x = normal(rng, (b, t, 4 * d)) * 0.3
    lengths = np.asarray([0, 30, 7, 19, 1], np.int32)
    w_r = normal(rng, (d, 4 * d)) * 0.1
    rest = [normal(rng, (d,)) * 0.1 for _ in range(3)] \
        + [normal(rng, (4 * d,)) * 0.1]

    def run(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, w_r, *rest)]
        out, final = rnn.lstm(
            SequenceBatch(args[0], torch.tensor(lengths, device=device)),
            args[1], bias=args[5], check_i=args[2], check_f=args[3],
            check_o=args[4], reverse=True)
        loss = (out.data ** 2).sum() + (final.c ** 2).sum() + final.h.sum()
        loss.backward()
        return float(loss.detach()), [a.grad.cpu() for a in args]

    loss_c, grads_c = run(dev)
    loss_r, grads_r = run("cpu")
    worst = max(float((g - r).abs().max() / r.abs().max())
                for g, r in zip(grads_c, grads_r))
    loss_err = abs(loss_c - loss_r) / abs(loss_r)
    if not worst <= LSTM_REL_TOL or not loss_err <= LSTM_REL_TOL:
        fail(f"reverse rnn.lstm: card vs CPU relative error loss {loss_err}, "
             f"grads {worst} (bound {LSTM_REL_TOL})")
    return {"reverse_lstm_D": d, "loss_rel_err": loss_err,
            "grad_rel_err": worst}


# ------------------------------------------------------------- paths

def margins(torch, transformer, params, ids, kv_dtype=None):
    """Top-1 minus top-2 logit at every position of ``ids`` [B, T]
    (teacher-forced: one prefill over the whole sequence, over an int8
    cache when ``kv_dtype="int8"``)."""
    hidden, _ = transformer.lm_prefill(params, ids, ids.shape[1],
                                       num_heads=HEADS, kv_dtype=kv_dtype)
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
                  kv_dtype=None):
    """Each stream against lm_generate (over the same KV dtype) on the
    card, up to its first reference margin below MARGIN_TOL; returns the
    tokens compared."""
    checked = 0
    for i, (prompt, toks) in enumerate(zip(prompts, outs)):
        p = np.asarray([prompt], np.int32)
        ref = transformer.lm_generate(params, p, p.shape[1] + len(toks),
                                      HEADS, kv_dtype=kv_dtype)
        marg = margins(torch, transformer, params, ref, kv_dtype)[0]
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
               kv_dtype="float32"):
    """The legacy prefill ladder on both layouts (phase "ladder", or
    "ladder_int8" over an int8 KV cache): 8 staggered requests straight
    to the batcher; the prefill's flash kernel once per layer per prefill
    batch, the Tq=1 kernel once per layer per step, both of the cache's
    dtype.  Returns each layout's launches."""
    from paddle_tpu_torch.serving import DecodeEngine, GenerationBatcher
    dk, fk = kernels.decode_attention, kernels.flash_attention
    int8 = kv_dtype == "int8"
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in LADDER_PROMPTS]
    record = {"phase": "ladder_int8" if int8 else "ladder",
              "kv_dtype": kv_dtype, "prompt_lengths": list(LADDER_PROMPTS)}
    launches = {}
    flash = fk.NAME_QUANT if int8 else "flash_attention"
    for layout, step_kernel in (
            ("slab", dk.NAME_SLAB_I8 if int8 else dk.NAME_SLAB),
            ("paged", dk.NAME_PAGED_I8 if int8 else dk.NAME_PAGED)):
        engine = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
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
        want = {flash: LAYERS * batches, step_kernel: LAYERS * steps}
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
                f"{record['phase']} ({layout})", kv_dtype),
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


def run_train(torch, dev, kernels):
    """bench_lstm on the card: the first step against the CPU, then
    warm-up and TRAIN_STEPS timed steps with the launch counts read."""
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves
    def rel(got, want):
        return [float((g.detach().cpu() - w.detach()).abs().max()
                      / w.detach().abs().max()) for g, w in zip(got, want)]

    card_run = bench.bench_lstm(device=dev)
    cpu_run = bench.bench_lstm(device="cpu")
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
        fail(f"train: first step on the card vs the CPU: loss rel err "
             f"{loss_err}, per-leaf rel err of grads {leaf_err}, of params "
             f"{param_err}, of mom {mom_err}, of the card's step vs its "
             f"mom {step_err} (bound {TRAIN_REL_TOL})")
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
    launches = {"lstm_fwd": kernels.lstm.launches_fwd,
                "lstm_bwd": kernels.lstm.launches_bwd}
    want = bench.NUM_LAYERS * TRAIN_STEPS
    if launches != {"lstm_fwd": want, "lstm_bwd": want}:
        fail(f"train: LSTM kernels launched {launches} over {TRAIN_STEPS} "
             f"steps, want {want} each (one per layer per step)")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < first:
        fail(f"train: loss not finite or not falling: first {first}, "
             f"timed steps {losses}")
    emit({"phase": "train", "config": {
        "vocab": 30000, "emb": bench.EMB_DIM, "hidden": card_run.hidden,
        "layers": bench.NUM_LAYERS, "batch": 64, "seq_len": 100},
        "warmup": 1 + TRAIN_WARMUP, "steps": TRAIN_STEPS,
        "ms_per_batch": float(np.median(times)),
        "ms_per_batch_min_max": [min(times), max(times)],
        "launches": launches, "loss_first": first, "loss_last": losses[-1],
        "first_step_vs_cpu": {"loss_rel_err": loss_err,
                              "grad_rel_err_max": max(leaf_err),
                              "param_rel_err_max": max(param_err),
                              "mom_rel_err_max": max(mom_err),
                              "step_vs_mom_rel_err_max": max(step_err),
                              "bound": TRAIN_REL_TOL}})
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

    t0 = time.perf_counter()
    libs = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs)})

    rng = np.random.RandomState(args.seed)
    chunk = check_decode_kernel(torch, dev, rng, hkv=HEADS)
    chunk_gqa = check_decode_kernel(torch, dev, rng, hkv=2)
    flash = check_flash_kernel(torch, dev, rng, GEN_BATCH, GEN_PROMPT,
                               timed=True)
    flash_ragged = check_flash_kernel(torch, dev, rng, 4, 200, timed=False)
    lstm_fwd, lstm_bwd = check_lstm_kernels(torch, dev, rng, LSTM_T, LSTM_B,
                                            LSTM_D, timed=True)
    lstm_small = [row for d in (128, 256) for row in check_lstm_kernels(
        torch, dev, rng, 37, 13, d, timed=False)]
    paged = check_paged_kernels(torch, dev, rng, hkv=HEADS)
    paged_gqa = check_paged_kernels(torch, dev, rng, hkv=2)
    int8 = check_int8_decode_kernels(torch, dev, rng, hkv=HEADS)
    int8_gqa = check_int8_decode_kernels(torch, dev, rng, hkv=2)
    flash_q = check_flash_quant_kernel(torch, dev, rng, GEN_BATCH,
                                       GEN_PROMPT, HEADS, timed=True)
    flash_q_ragged = check_flash_quant_kernel(torch, dev, rng, 4, 200, 2,
                                              timed=False)
    emit({"phase": "kernels", "tolerance": KERNEL_TOL,
          "int8_vs_f32_kernel_on_dequantized": "bit for bit (max abs err 0)",
          "lstm_tolerance": {"abs": LSTM_TOL, "rel": LSTM_REL_TOL},
          "checks": [chunk, chunk_gqa, flash, flash_ragged, lstm_fwd,
                     lstm_bwd, *lstm_small, *paged.values(),
                     *paged_gqa.values(), *int8.values(),
                     *int8_gqa.values(), flash_q, flash_q_ragged],
          "other_head_dims": check_head_dims(torch, dev, rng),
          "lstm_reverse": check_lstm_reverse(torch, dev, rng)})

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
    del params
    train_launches = run_train(torch, dev, kernels)

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
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    for row, replaces in ((lstm_fwd, kernels.lstm.REPLACES_FWD),
                          (lstm_bwd, kernels.lstm.REPLACES_BWD)):
        summary.append({
            "name": row["name"], "route": "cuda",
            "source": kernels.lstm.SOURCE, "replaces": replaces,
            "launches": train_launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "library_note": row["library_note"]})
    dk = kernels.decode_attention
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
            "max_abs_err": max(row["max_abs_err"],
                               paged_gqa[name]["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **({"library_note": row["library_note"]}
               if "library_note" in row else {})})
    fk = kernels.flash_attention
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
            "max_abs_err": max(row["max_abs_err"], gqa["max_abs_err"]),
            "err_vs_f32_kernel_on_dequantized": max(
                row["err_vs_f32_kernel_on_dequantized"],
                gqa["err_vs_f32_kernel_on_dequantized"]),
            "ms": row["ms"], "f32_kernel_ms": row["f32_kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "library_note": row["library_note"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
