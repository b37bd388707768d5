"""The training benchmarks of ``bench.py``, ported: ``bench_lstm`` (the
headline), ``bench_transformer`` and ``bench_seq2seq``; and ``bench_rnn``,
the layer-DSL slice through ``trainer.SGD``.

    python -m paddle_tpu_torch.scripts.bench
        [--model lstm|transformer|seq2seq|rnn] [--hidden 512|1280|2048]

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
                                        "rnn"), default="lstm")
    ap.add_argument("--hidden", type=int, default=512,
                    help="the LSTM's hidden size (--model lstm)")
    args = ap.parse_args(argv)
    dev = _device.resolve("cuda")
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
