"""The training benchmarks of ``bench.py``, ported: ``bench_lstm`` (the
headline), ``bench_transformer`` and ``bench_seq2seq``; ``bench_rnn``,
the layer-DSL slice through ``trainer.SGD``; and the measurement legs
of two serving benchmarks, ``bench_serving_quant`` and
``bench_serving_speculative``.

    python -m paddle_tpu_torch.scripts.bench
        [--model lstm|transformer|seq2seq|rnn|serving_quant|
                 serving_speculative] [--hidden 512|1280|2048]

``lstm`` (the default) trains the LSTM text classifier at the
reference's benchmark config (vocab 30000, embedding 128, 2 stacked LSTMs
h=512, batch 64, length 100, Momentum lr 0.01 m 0.9); ``--hidden`` sets
its hidden size (``bench.py``'s ``lstm1280`` / ``lstm2048`` rows, whose
LSTMs take the gate-blocked kernel), and its line adds the bench's own
FLOP count (``bench.py:341-345``) and the FLOP/s achieved; ``transformer``
trains the Transformer-base MT model (vocab 32000, d_model 512, 8 heads,
dff 2048, 6+6 layers, batch 32, length 256, Adam lr 1e-4, label
smoothing 0.1, ``full_seq=True``: every attention through the flash
kernels); ``seq2seq`` trains the attention NMT model (vocab 30000 both
sides, emb = hidden = attention 512, bi-GRU encoder through the GRU
kernels, batch 64, lengths 30 / 30, Momentum lr 0.01 m 0.9); ``rnn``
trains ``models/text_rnn``'s DSL config (the same text classifier with
two vanilla-RNN layers h=512 through the simple-RNN kernels, Momentum)
through ``SGD.train_one_batch`` on a new batch each step, the feed
included, and adds bench.py's FLOP convention (3 x the forward's
products) and the step's split into feed, forward, backward and update.
The others run on one fixed random batch.  Each prints one JSON line:
ms/batch as the
median of STEPS timed steps after WARMUP (and, for the transformer and
seq2seq, tokens/s = batch * target length / s, the bench's headline), the
card's name and power limit as nvidia-smi gives them, and the kernel
launches.  Runs on the card and raises without one.

``serving_quant`` and ``serving_speculative`` serve the full-width
Transformer-base LM (``serving/server.BASE_LM``: vocab 32000, d_model
512, 8 heads, dff 2048, 6 layers; random weights from seed 0) to
closed-loop client threads on ``GenerationBatcher``s, with the traffic
shapes of ``bench.py``'s ``bench_serving_quant`` (``bench.py:2044``)
and ``bench_serving_speculative`` (``bench.py:2601``); each prints one
JSON line.  Their HLO and analytic legs (the compiled step's int8
operands, the predicted step bytes, the all-lanes projection in the
compiled HLO) inspect XLA programs and have no torch counterpart.
"""

import argparse
import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.models import seq2seq, text_lstm, text_rnn, transformer
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optim import Adam, Momentum
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

NUM_LAYERS, EMB_DIM = 2, 128
WARMUP, STEPS = 5, 30
# the reference's own baseline for this config, on its K40m
# (docs/perf.md:3-6, BASELINE.md) -- not a number of this port
REFERENCE_K40M_MS = 184.0


class LstmBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    opt_state: dict
    ids: SequenceBatch
    labels: torch.Tensor
    hidden: int
    flops_per_step: float


def lstm_flops(batch, seq_len, hidden):
    """``bench.py:341-345``'s count for one train step: the two layers'
    input and recurrent products forward, 2 B T 4H (emb + H + H + H), and
    the backward at twice the forward."""
    return 3.0 * 2.0 * batch * seq_len * 4 * hidden * (EMB_DIM + 3 * hidden)


def bench_lstm(batch=64, seq_len=100, hidden=512, vocab=30000, device=None):
    """The config, data and optimizer of ``bench.py:324-333`` (data from
    ``np.random.RandomState(0)``, params from a generator seeded 0).
    ``train_step()`` zeroes the grads, runs ``text_lstm.loss``, calls
    ``backward()``, applies Momentum in place and returns the loss."""
    dev = _device.resolve(device)
    params = text_lstm.init(torch.Generator().manual_seed(0), vocab=vocab,
                            emb_dim=EMB_DIM, hidden=hidden,
                            num_layers=NUM_LAYERS, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Momentum(learning_rate=0.01, momentum=0.9)
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)
    ids = SequenceBatch(
        data=torch.tensor(rng.randint(0, vocab, (batch, seq_len)),
                          dtype=torch.int32, device=dev),
        lengths=torch.full((batch,), seq_len, dtype=torch.int32, device=dev))
    labels = torch.tensor(rng.randint(0, 2, (batch,)), dtype=torch.int32,
                          device=dev)

    def train_step():
        for p in leaves:
            p.grad = None
        loss = text_lstm.loss(params, ids, labels, NUM_LAYERS, hidden)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return LstmBench(train_step, params, opt_state, ids, labels, hidden,
                     lstm_flops(batch, seq_len, hidden))


class TransformerBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    opt_state: dict
    src: SequenceBatch
    trg: SequenceBatch
    tokens_per_step: int


def bench_transformer(batch=32, seq_len=256, vocab=32000, d_model=512,
                      dff=2048, layers=6, heads=8, device=None):
    """The config, data and optimizer of ``bench.py:485-542``: source and
    target ids from ``np.random.RandomState(0)`` in [3, vocab), every row
    full length, params from a generator seeded 0, Adam lr 1e-4.
    ``train_step()`` zeroes the grads, runs ``transformer.loss(...,
    full_seq=True)`` with ``trg`` as both the decoder input and the
    labels (as ``bench.py:522`` passes it), calls ``backward()``, applies
    Adam in place and returns the loss."""
    dev = _device.resolve(device)
    params = transformer.init(torch.Generator().manual_seed(0),
                              src_vocab=vocab, trg_vocab=vocab,
                              d_model=d_model, num_heads=heads, dff=dff,
                              enc_layers=layers, dec_layers=layers,
                              max_len=seq_len, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Adam(learning_rate=1e-4)
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)

    def batch_of_ids():
        return SequenceBatch(
            data=torch.tensor(rng.randint(3, vocab, (batch, seq_len)),
                              dtype=torch.int32, device=dev),
            lengths=torch.full((batch,), seq_len, dtype=torch.int32,
                               device=dev))

    src, trg = batch_of_ids(), batch_of_ids()

    def train_step():
        for p in leaves:
            p.grad = None
        loss = transformer.loss(params, src, trg, trg, heads, full_seq=True)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return TransformerBench(train_step, params, opt_state, src, trg,
                            batch * seq_len)


class Seq2SeqBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    opt_state: dict
    src: SequenceBatch
    trg: SequenceBatch
    tokens_per_step: int


def bench_seq2seq(batch=64, src_len=30, trg_len=30, vocab=30000, hidden=512,
                  device=None):
    """The config, data and optimizer of ``bench.py:435-482``: emb = h =
    att = ``hidden``, source then target ids from
    ``np.random.RandomState(0)`` in [3, vocab), every row full length,
    params from a generator seeded 0, Momentum lr 0.01 m 0.9.
    ``train_step()`` zeroes the grads, runs ``seq2seq.loss`` with ``trg``
    as both the decoder input and the labels (as ``bench.py:462``
    passes it), calls ``backward()``, applies Momentum in place and
    returns the loss.  No reference baseline exists; tokens/s (batch x
    trg_len per step) is the headline."""
    dev = _device.resolve(device)
    params = seq2seq.init(torch.Generator().manual_seed(0), src_vocab=vocab,
                          trg_vocab=vocab, emb_dim=hidden, hidden=hidden,
                          device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Momentum(learning_rate=0.01, momentum=0.9)
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)

    def batch_of_ids(length):
        return SequenceBatch(
            data=torch.tensor(rng.randint(3, vocab, (batch, length)),
                              dtype=torch.int32, device=dev),
            lengths=torch.full((batch,), length, dtype=torch.int32,
                               device=dev))

    src = batch_of_ids(src_len)
    trg = batch_of_ids(trg_len)

    def train_step():
        for p in leaves:
            p.grad = None
        loss = seq2seq.loss(params, src, trg, trg)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return Seq2SeqBench(train_step, params, opt_state, src, trg,
                        batch * trg_len)


class RnnBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    trainer: object
    feeder: DataFeeder
    batches: list
    tokens_per_step: int
    flops_per_step: float


def rnn_flops(batch, seq_len, hidden):
    """bench.py's convention for one train step: each layer's input and
    recurrent products forward, 2 B T H (emb + H + H + H) for the two
    layers, and the backward at twice the forward."""
    return 3.0 * 2.0 * batch * seq_len * hidden * (text_rnn.EMB
                                                   + 3 * hidden)


def bench_rnn(batch=text_rnn.BATCH, seq_len=text_rnn.SEQ_LEN,
              hidden=text_rnn.HIDDEN, vocab=text_rnn.VOCAB, n_batches=8,
              seed=0, device=None):
    """``trainer.SGD`` over ``models/text_rnn``'s config (params from a
    generator seeded 1, SGD's default seed; ``n_batches`` batches of ids
    drawn from ``seed``).  ``train_step()`` feeds the next batch through
    ``SGD.train_one_batch`` (DataFeeder, forward, ``backward()``,
    Momentum in place) and returns the loss."""
    from paddle_tpu_torch.trainer import SGD
    dev = _device.resolve(device)
    trainer = SGD(cost=text_rnn.build(vocab=vocab, hidden=hidden),
                  update_equation=text_rnn.optimizer(), device=dev)
    feeder = DataFeeder(text_rnn.feeding(vocab), device=dev)
    batches = list(text_rnn.batches(seed, n_batches, batch=batch,
                                    seq_len=seq_len, vocab=vocab)())
    count = [0]

    def train_step():
        i = count[0] % len(batches)
        count[0] += 1
        return trainer.train_one_batch(batches[i], feeder)

    return RnnBench(train_step, trainer, feeder, batches, batch * seq_len,
                    rnn_flops(batch, seq_len, hidden))


def step_split(trainer, feeder, batches, steps):
    """Median ms of each part of ``trainer``'s step over ``steps`` steps
    on ``batches`` in turn, each part ending in a synchronize: the feed
    (DataFeeder, host to device), the forward (graph walk and kernels),
    ``backward()`` and the optimizer update."""
    parts = {"feed": [], "forward": [], "backward": [], "update": []}
    for i in range(steps):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        feed = feeder(batches[i % len(batches)])
        mark()
        total, _ = trainer._forward(feed)
        mark()
        trainer._backward(total)
        mark()
        trainer._update()
        mark()
        for name, a, b in zip(parts, marks, marks[1:]):
            parts[name].append((b - a) * 1e3)
    return {name: float(np.median(v)) for name, v in parts.items()}


def _closed_loop(engine, reqs, n_clients):
    """``n_clients`` threads each submitting the next of ``reqs``
    ((prompt, max_tokens) pairs) until none is left: tokens/s over the
    wall, TTFT p99, TPOT p50 / p99, mean active slots a step, the
    metrics snapshot and every stream (by request index)."""
    import threading
    from paddle_tpu_torch.serving import GenerationBatcher, ServingMetrics
    engine.metrics = ServingMetrics()
    bat = GenerationBatcher(engine, queue_size=4096)
    lock, nxt, outs = threading.Lock(), [0], {}

    def client():
        while True:
            with lock:
                i = nxt[0]
                if i >= len(reqs):
                    return
                nxt[0] += 1
            prompt, mt = reqs[i]
            out = bat.submit(prompt, max_tokens=mt).result(600)
            with lock:
                outs[i] = out["tokens"]

    ts = [threading.Thread(target=client) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    dt = time.perf_counter() - t0
    bat.close()
    snap = engine.metrics.snapshot()
    return {"clients": n_clients, "seconds": dt,
            "tokens_per_s": sum(len(o) for o in outs.values()) / dt,
            "ttft_p99_ms": snap["ttft_ms"]["p99"],
            "tpot_p50_ms": snap["tpot_ms"]["p50"],
            "tpot_p99_ms": snap["tpot_ms"]["p99"],
            "effective_streams": snap["mean_slot_occupancy"],
            "snapshot": snap, "outs": [outs[i] for i in range(len(reqs))]}


def _card(dev):
    return _device.card() if dev.type == "cuda" else None


def _serving_params(seed, max_len, dev):
    from paddle_tpu_torch.serving.server import BASE_LM
    return transformer.init_lm(
        torch.Generator().manual_seed(seed), BASE_LM["vocab"],
        BASE_LM["d_model"], BASE_LM["num_heads"], BASE_LM["dff"],
        BASE_LM["layers"], max_len, device=dev), BASE_LM


def bench_serving_quant(slots=8, n_requests=48, block_size=16, chunk=8,
                        seed=0, device=None):
    """float32 KV vs int8 KV vs int8 KV + int8 weights at one KV byte
    budget (``bench.py:2044``'s measurement leg): the float32 paged
    engine gets ``slots * ceil(max_len / block_size)`` blocks, the int8
    engines twice the blocks and twice the slots in about the same
    bytes (an int8 block plus its per-head scales costs 1/4 + 1/dh of a
    float32 one).  Closed-loop mixed traffic at 48 clients (prompts of
    3-8 tokens; the first ``slots // 2`` requests emit 48 tokens, the
    rest 6).  Per variant: tokens/s, TTFT p99, TPOT, effective streams,
    the pool's blocks and bytes; for the int8 variants each stream's
    greedy prefix shared with the float32 engine's stream (the quality
    evidence; ``quant/kv.greedy_prefix_len``)."""
    from paddle_tpu_torch.quant import kv as kvq
    from paddle_tpu_torch.quant.weights import param_bytes, quantize_lm
    from paddle_tpu_torch.serving.decode_engine import DecodeEngine
    dev = _device.resolve(device)
    gen_short, gen_long = 6, 48
    max_len = 16 + gen_long
    budget = slots * -(-max_len // block_size)
    params, cfg = _serving_params(seed, max_len, dev)
    qparams = quantize_lm(params)
    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(1, cfg["vocab"], rng.randint(3, 9))
             .astype(np.int32), gen_long if i < slots // 2 else gen_short)
            for i in range(n_requests)]
    out = {"bench": "serving_quant", "card": _card(dev),
           "config": dict(cfg, max_len=max_len, block_size=block_size,
                          chunk=chunk, requests=n_requests, clients=48),
           "param_bytes": {"float32": param_bytes(params),
                           "int8": param_bytes(qparams)}}
    streams = {}
    for name, p, kv_dtype, n_slots, n_blocks in (
            ("f32", params, "float32", slots, budget),
            ("i8kv", params, "int8", 2 * slots, 2 * budget),
            ("i8kv_w", qparams, "int8", 2 * slots, 2 * budget)):
        engine = DecodeEngine(p, num_heads=cfg["num_heads"],
                              num_slots=n_slots, max_len=max_len,
                              prefill_chunk=chunk, kv_layout="paged",
                              kv_block_size=block_size,
                              kv_num_blocks=n_blocks + 1, kv_dtype=kv_dtype,
                              name=f"bench_q_{name}", device=dev)
        r = _closed_loop(engine, reqs, 48)
        streams[name] = r.pop("outs")
        snap = r.pop("snapshot")
        r["kv_blocks_total"] = snap["kv_blocks_total"]
        r["pool_kv_bytes"] = sum(t.numel() * t.element_size()
                                 for c in engine._cache for t in c.values())
        if name != "f32":
            prefix = [kvq.greedy_prefix_len(a, b) for a, b in
                      zip(streams[name], streams["f32"])]
            r["greedy_prefix_vs_f32"] = {
                "min": min(prefix), "median": float(np.median(prefix)),
                "exact_streams": sum(a == b for a, b in zip(
                    streams[name], streams["f32"]))}
        out[name] = r
    print(json.dumps(out), flush=True)
    return out


def bench_serving_speculative(slots=8, n_requests=32, chunk=8,
                              speculate_k=4, draft_layers=2, seed=0,
                              clients=(8, 32), device=None):
    """Speculative decoding against the same chunked engine without a
    draft, at 8 and 32 clients (``bench.py:2601``'s measurement leg):
    prompts of 4-11 tokens, 12-20 tokens each, max_len 96.  Per mode
    and client count: tokens/s, TTFT p99, TPOT p50 / p99, and with a
    draft the acceptance rate and emitted tokens per speculating
    slot-step.  Two more drafts: another seed's trunk of the same shape
    (``bench.py``'s adversarial draft; a random trunk at this width
    mostly repeats a token its tied embedding favours, so it agrees with
    the target about as often as the target's own draft), and an
    adversarial one, that trunk with its embedding scaled by 0.01 (its
    blocks then pick the token): it sets the floor, every verify step
    still netting one token.  Each speculating drive reports how many of
    its streams equal the plain engine's at the same client count
    (``chip_smoke.py``'s serve_spec holds them up to margin)."""
    from paddle_tpu_torch.serving.decode_engine import DecodeEngine
    from paddle_tpu_torch.serving.speculative import make_draft
    dev = _device.resolve(device)
    max_len = 96
    params, cfg = _serving_params(seed, max_len, dev)
    other, _ = _serving_params(seed + 7, max_len, dev)
    adversarial = dict(other, src_emb=other["src_emb"] * 0.01)
    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(1, cfg["vocab"], rng.randint(4, 12))
             .astype(np.int32), int(rng.randint(12, 21)))
            for _ in range(n_requests)]
    out = {"bench": "serving_speculative", "card": _card(dev),
           "config": dict(cfg, max_len=max_len, chunk=chunk,
                          speculate_k=speculate_k, draft_layers=draft_layers,
                          requests=n_requests), "drives": []}
    for n_clients in clients:
        plain = None
        for mode, draft_from in (("plain", None), ("spec", params),
                                 ("other_seed", other),
                                 ("adversarial", adversarial)):
            engine = DecodeEngine(
                params, num_heads=cfg["num_heads"], num_slots=slots,
                max_len=max_len, prefill_chunk=chunk,
                speculate_k=speculate_k if draft_from else 0,
                draft=(make_draft(draft_from, draft_layers)
                       if draft_from else None),
                name=f"bench_spec_{mode}", device=dev)
            r = _closed_loop(engine, reqs, n_clients)
            snap, outs = r.pop("snapshot"), r.pop("outs")
            r["mode"] = mode
            if mode == "plain":
                plain = outs
            else:
                r["spec_acceptance_rate"] = snap["spec_acceptance_rate"]
                r["spec_tokens_per_step"] = snap["spec_tokens_per_step"]
                r["streams_equal_to_plain"] = sum(
                    a == b for a, b in zip(outs, plain))
            out["drives"].append(r)
    print(json.dumps(out), flush=True)
    return out


def _timed(train_step):
    """WARMUP steps, then STEPS timed ones (each ending in a synchronize)
    with the launch counters reset before them: (times ms, losses)."""
    for _ in range(WARMUP):
        train_step()
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return times, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("lstm", "transformer", "seq2seq",
                                        "rnn", "serving_quant",
                                        "serving_speculative"),
                    default="lstm")
    ap.add_argument("--hidden", type=int, default=512,
                    help="the LSTM's hidden size (--model lstm)")
    args = ap.parse_args(argv)
    dev = _device.resolve("cuda")
    if args.model == "serving_quant":
        bench_serving_quant(device=dev)
        return 0
    if args.model == "serving_speculative":
        bench_serving_speculative(device=dev)
        return 0
    if args.model == "rnn":
        bench = bench_rnn(device=dev)
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        rk = kernels.simple_rnn
        print(json.dumps({
            "bench": "rnn_textclass_dsl", "card": _device.card(),
            "config": {"vocab": text_rnn.VOCAB, "emb": text_rnn.EMB,
                       "hidden": text_rnn.HIDDEN, "layers": text_rnn.LAYERS,
                       "batch": text_rnn.BATCH, "seq_len": text_rnn.SEQ_LEN,
                       "optimizer": "Momentum lr 0.01 m 0.9",
                       "entry": "trainer.SGD.train_one_batch"},
            "steps": STEPS, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "tokens_per_s": bench.tokens_per_step / (ms / 1e3),
            "flops_per_step": bench.flops_per_step,
            "tflop_per_s": bench.flops_per_step / (ms / 1e3) / 1e12,
            "loss_first_last": [losses[0], losses[-1]],
            "launches": {rk.NAME_FWD: rk.launches_fwd,
                         rk.NAME_BWD: rk.launches_bwd},
            "split_ms": step_split(bench.trainer, bench.feeder,
                                   bench.batches, STEPS),
        }), flush=True)
        return 0
    if args.model == "seq2seq":
        bench = bench_seq2seq(device=dev)
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        gk = kernels.gru
        print(json.dumps({
            "bench": "seq2seq_attention_nmt", "card": _device.card(),
            "config": {"vocab": 30000, "emb": 512, "hidden": 512,
                       "att": 512, "batch": 64, "src_len": 30,
                       "trg_len": 30, "optimizer": "Momentum lr 0.01 m 0.9"},
            "steps": STEPS, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "tokens_per_s": bench.tokens_per_step / (ms / 1e3),
            "loss_first_last": [losses[0], losses[-1]],
            "launches": {gk.NAME_FWD: gk.launches_fwd,
                         gk.NAME_BWD: gk.launches_bwd},
        }), flush=True)
        return 0
    if args.model == "lstm":
        bench = bench_lstm(hidden=args.hidden, device=dev)
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        lk, bk = kernels.lstm, kernels.lstm_blocked
        print(json.dumps({
            "bench": "lstm_textclass", "card": _device.card(),
            "config": {"vocab": 30000, "emb": EMB_DIM,
                       "hidden": bench.hidden, "layers": NUM_LAYERS,
                       "batch": 64, "seq_len": 100,
                       "optimizer": "Momentum lr 0.01 m 0.9"},
            "steps": STEPS, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "flops_per_step": bench.flops_per_step,
            "tflop_per_s": bench.flops_per_step / (ms / 1e3) / 1e12,
            "loss_first_last": [losses[0], losses[-1]],
            "launches": {lk.NAME_FWD: lk.launches_fwd,
                         lk.NAME_BWD: lk.launches_bwd,
                         bk.NAME_FWD: bk.launches_fwd},
            # the reference's K40m time is for its own config, h=512
            **({"reference_k40m_ms_per_batch": REFERENCE_K40M_MS}
               if bench.hidden == 512 else {}),
        }), flush=True)
        return 0
    bench = bench_transformer(device=dev)
    times, losses = _timed(bench.train_step)
    ms = float(np.median(times))
    fk = kernels.flash_attention
    print(json.dumps({
        "bench": "transformer_mt", "card": _device.card(),
        "config": {"vocab": 32000, "d_model": 512, "heads": 8, "dff": 2048,
                   "layers": "6+6", "batch": 32, "seq_len": 256,
                   "optimizer": "Adam lr 1e-4", "label_smoothing": 0.1,
                   "full_seq": True},
        "steps": STEPS, "ms_per_batch": ms,
        "ms_per_batch_p90": float(np.percentile(times, 90)),
        "tokens_per_s": bench.tokens_per_step / (ms / 1e3),
        "loss_first_last": [losses[0], losses[-1]],
        "launches": {fk.NAME: fk.launches,
                     fk.NAME_BWD_DKV: fk.launches_bwd_dkv,
                     fk.NAME_BWD_DQ: fk.launches_bwd_dq},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
