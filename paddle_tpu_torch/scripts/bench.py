"""The training benchmarks of ``bench.py``, ported: ``bench_lstm`` (the
headline), ``bench_transformer`` (with ``remat``),
``bench_transformer_packed``, ``bench_transformer_moe`` and
``bench_seq2seq``; ``bench_rnn``, the layer-DSL slice through
``trainer.SGD``, and ``bench_trainer_int8``, its int8 weight-streaming
mode; ``bench_transformer_decode``, the MT model's KV-cached beam
search; the image benchmarks ``bench_resnet50`` and ``bench_image``
(smallnet, alexnet, googlenet); the demos' steps ``bench_recommendation``
(demo/recommendation), ``bench_dsl`` (the image_classification demo's
vgg, the sentiment demo, quick_start's cnn, the SRL and
sequence_tagging demos and demo/word2vec in both variants, through
``trainer.SGD``) and ``bench_seqtoseq_demo`` (demo/seqToseq); and the
measurement legs of two serving benchmarks, ``bench_serving_quant`` and
``bench_serving_speculative``.

    python -m paddle_tpu_torch.scripts.bench
        [--model lstm|transformer|transformer_packed|transformer_moe|
                 seq2seq|rnn|trainer_int8|transformer_decode|
                 serving_quant|serving_speculative|resnet50|smallnet|
                 alexnet|googlenet|recommendation|vgg_cifar|sentiment|
                 quick_start_cnn|srl|tagging|word2vec|word2vec_softmax|
                 seqtoseq_demo|rnn_sparse|trainer_prefetch]
        [--hidden 512|1280|2048] [--remat]

``recommendation`` trains the MovieLens towers at the demo's config
(emb 256, hidden 256, batch 128 of the movielens loader, Adam lr 1e-3),
each step feeding its batch as the demo does, and prints ms/batch and
samples/s; ``vgg_cifar``, ``sentiment``, ``quick_start_cnn``, ``srl``
and ``tagging`` train those configs through ``SGD.train_one_batch``
(vgg: batch 128 of the cifar loader, Momentum; sentiment: hid 128,
batch 64 of the imdb loader's ragged reviews, Adam with l2 and
clip_norm, its three LSTMs through the fused LSTM kernels; quick_start's
cnn at batch 64 of imdb; srl: the db-LSTM at hid 128, depth 8, batch 16
of the conll05 loader, its eight LSTMs through the fused LSTM kernels,
and the CRF; tagging: the linear CRF at batch 32 of conll05), printing
ms/batch, samples/s, the LSTM launches and the step's split, and for
the CRF configs the CRF's share of the step (``crf_split``: the step
against the same step with the CRF cost summed away).  ``word2vec`` and
``word2vec_softmax`` train demo/word2vec (vocab 2073, four embeddings
of 32 sharing one table, fc 128 sigmoid, hsigmoid or a softmax fc of
the vocab, AdaGrad lr 0.1, batch 64 of the imikolov loader) the same
way.  ``seqtoseq_demo`` trains demo/seqToseq's script
(``models/seqtoseq_demo``: hidden = emb 256, batch 32 of the wmt14
loader's ragged sources, Adam lr 5e-4 clip_norm 5, the encoder's GRUs
through the GRU kernels), each step feeding its batch as the demo does,
one timed step a batch of the demo's whole pass (64), and prints
ms/batch, samples/s, target tokens/s and the GRU launches a step.
``rnn_sparse`` trains ``models/text_rnn``'s LSTM config (vocab 30000,
emb 128, two LSTMs of 512, batch 64 x 100 ids, Momentum) with its
embedding trained by its touched rows, beside the same config dense:
ms/batch, samples/s, the LSTM launches and the sparse step's host sync
alone (``sparse_sync_ms``) with its share of the step.
``trainer_prefetch`` is ``bench.py``'s ``bench_trainer_prefetch`` (an
MLP at batch 64, dim 256, hidden 512, 24 batches of 4 ms host cost):
steps/s through ``SGD.train`` at prefetch 0 and 2, the speedup and the
prefetch-2 pass's mean ``h2d_wait``.  The word2vec configs and ``seqtoseq_demo`` launch no host sync
inside the step beyond reading the loss; ``print_layer`` is on none of
the timed graphs.

``resnet50`` trains ResNet-50 at ``bench.py:358-395``'s config (batch
32 of 224x224x3 images from ``np.random.RandomState(0)``, 1000 classes,
Momentum lr 0.1 m 0.9, remat by ``--remat`` or the bench's rule: on
from batch 512), the moving stats threaded through the steps;
``smallnet`` / ``alexnet`` / ``googlenet`` train the reference's image
benchmark configs at ``bench.py:3645-3647``'s batch sizes and shapes
(64 at 32x32, 10 classes; 64 at 227x227 and 64 at 224x224, 1000
classes; Momentum lr 0.01 m 0.9).  Each prints ms/batch, images/s and
the FLOP count (3 x the forward's FLOPs per image, two to a
multiply-add), beside the reference's K40m time for the same config where BASELINE.md has one.

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
``transformer_packed`` trains the decoder-only trunk of the same widths
(6 layers) on packed rows (B 16 x 512 slots of ragged sequences, Adam
lr 1e-4) and reports REAL tokens/s and the pack efficiency;
``transformer_moe`` the same trunk with 8-expert top-2 FFNs at B 16, T
512; ``--remat`` recomputes their blocks (and the MT model's) in the
backward.  ``trainer_int8`` trains ``SGD(quant_weights=True)`` (an fc
classifier, B 64, dim 64, hidden 128) beside its float32 twin over 24
batches, holds the loss gap within ``quant/weights.TRAIN_LOSS_BUDGET``
and checks that only int8 codes of the quantized weights persist
between steps (``weights_quantized``, in place of the JAX bench's HLO
gate).  The others run on one fixed random batch.  Each prints one JSON
line:
ms/batch as the
median of STEPS timed steps after WARMUP (and, for the transformer and
seq2seq, tokens/s = batch * target length / s, the bench's headline), the
card's name and power limit as nvidia-smi gives them, the compute
dtype, and the kernel launches.  Runs on the card and raises without
one.  ``BENCH_DTYPE=bfloat16`` sets the compute policy for the run
(``core/dtypes.set_policy``), as ``bench.py`` reads it: the products of
``ops/linear.matmul`` in bf16 with a float32 accumulator.

``transformer_decode`` beam-decodes a batch with the MT model's KV
cache (``generate_cached``: batch 32, sources of 128 tokens, 128 decode
steps, beam 4, vocab 32000, d_model 512, 8 heads, dff 2048, 6+6 layers,
random weights from seed 0; ``BENCH_QUANT=int8`` its int8 weight tree)
and prints ms per decoded batch (DECODE_WARMUP, then DECODE_RUNS timed
runs), emitted tokens/s (batch x steps per run), a step's ms and the
FLOP/s of the bench's count.

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
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.sequence import SequenceBatch, pack_sequences
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.datasets import movielens
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.models import (alexnet, googlenet, image_dsl,
                                     seqtoseq_demo, word2vec_dsl,
                                     recommendation, resnet, seq2seq,
                                     smallnet, tagging_dsl, text_dsl,
                                     text_lstm, text_rnn, transformer)
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optim import Adam, Momentum
from paddle_tpu_torch.quant.weights import TRAIN_LOSS_BUDGET
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

NUM_LAYERS, EMB_DIM = 2, 128
WARMUP, STEPS = 5, 30
# a beam decode runs 128 steps: fewer runs
DECODE_WARMUP, DECODE_RUNS = 1, 5
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


class ImageBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    # the step's parts, in order: forward() -> loss (the new moving stats
    # kept), backward(loss), update()
    parts: tuple
    params: dict
    state: dict                 # {"state": the moving stats}, per step
    opt_state: dict
    images: torch.Tensor
    labels: torch.Tensor
    flops_per_step: float
    remat: bool


# the image configs of bench.py:3644-3647: (batch, image side, classes,
# forward FLOPs per image, two to a multiply-add; bench.py:391's 4.1e9
# for ResNet-50 is its count of multiply-adds, the others' are FLOPs)
IMAGE_CONFIGS = {"resnet50": (32, 224, 1000, 8.2e9),
                 "smallnet": (64, 32, 10, 2.5e7),
                 "alexnet": (64, 227, 1000, 1.4e9),
                 "googlenet": (64, 224, 1000, 3.0e9)}
# the reference's K40m ms/batch at those batches (BASELINE.md, the
# reference's own GPU numbers; bench.py:3658-3662) -- not the port's
IMAGE_K40M_MS = {"smallnet": 10.463, "alexnet": 195.0, "googlenet": 613.0}
_IMAGE_MODELS = {"resnet50": resnet, "smallnet": smallnet,
                 "alexnet": alexnet, "googlenet": googlenet}


def bench_image(model_name, batch=None, remat=None, device=None, seed=0):
    """``bench.py``'s ``bench_resnet50`` (model ``resnet50``) or
    ``bench_image``: params from a generator seeded ``seed``, images and
    labels from ``np.random.RandomState(seed)`` (NHWC), Momentum (lr 0.1
    for ResNet-50, 0.01 for the others, m 0.9).  ``train_step()`` zeroes
    the grads, runs the model's ``loss`` (ResNet-50 with ``remat``; None
    takes the bench's rule, ``batch >= 512``), calls ``backward()``, applies
    Momentum in place, keeps the new moving stats and returns the
    loss."""
    dev = _device.resolve(device)
    default_batch, hw, classes, fwd_flops = IMAGE_CONFIGS[model_name]
    batch = batch or default_batch
    mod = _IMAGE_MODELS[model_name]
    gen = torch.Generator().manual_seed(seed)
    if model_name == "resnet50":
        params, state = resnet.init(gen, depth=50, num_classes=classes,
                                    device=dev)
        remat = _remat(remat, batch >= 512)
        lr = 0.1
    else:
        params, state = mod.init(gen, num_classes=classes, device=dev)
        remat, lr = False, 0.01
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Momentum(learning_rate=lr, momentum=0.9)
    opt_state = opt.init(params)
    rng = np.random.RandomState(seed)
    images = torch.tensor(rng.randn(batch, hw, hw, 3), dtype=torch.float32,
                          device=dev)
    labels = torch.tensor(rng.randint(0, classes, (batch,)),
                          dtype=torch.int32, device=dev)
    live = {"state": state}

    def forward():
        for p in leaves:
            p.grad = None
        if model_name == "resnet50":
            loss, new_state = resnet.loss(params, live["state"], images,
                                          labels, depth=50, remat=remat)
        else:
            loss, new_state = mod.loss(params, live["state"], images, labels)
        live["state"] = new_state
        return loss

    def update():
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)

    def train_step():
        loss = forward()
        loss.backward()
        update()
        return loss.detach()

    return ImageBench(train_step, (forward, torch.Tensor.backward, update),
                      params, live, opt_state, images, labels,
                      3.0 * fwd_flops * batch, remat)


def bench_resnet50(batch=32, remat=None, device=None, seed=0):
    """``bench.py:358``'s ResNet-50 train step (``bench_image``)."""
    return bench_image("resnet50", batch, remat, device, seed)


class TransformerBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    opt_state: dict
    src: SequenceBatch
    trg: SequenceBatch
    tokens_per_step: int


def _remat(remat, default):
    """``remat`` as given, else the model's own rule (what ``bench.py``'s
    ``_env_remat`` falls back to without ``BENCH_REMAT``)."""
    return default if remat is None else bool(remat)


def bench_transformer(batch=32, seq_len=256, vocab=32000, d_model=512,
                      dff=2048, layers=6, heads=8, remat=None, device=None):
    """The config, data and optimizer of ``bench.py:485-542``: source and
    target ids from ``np.random.RandomState(0)`` in [3, vocab), every row
    full length, params from a generator seeded 0, Adam lr 1e-4.
    ``train_step()`` zeroes the grads, runs ``transformer.loss(...,
    full_seq=True)`` with ``trg`` as both the decoder input and the
    labels (as ``bench.py:522`` passes it), calls ``backward()``, applies
    Adam in place and returns the loss.  ``remat`` recomputes each block
    in the backward; None takes ``bench.py``'s rule (batch * seq_len >=
    32768 or seq_len >= 4096: off at the defaults)."""
    dev = _device.resolve(device)
    remat = _remat(remat, batch * seq_len >= 32768 or seq_len >= 4096)
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
        loss = transformer.loss(params, src, trg, trg, heads, remat=remat,
                                full_seq=True)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return TransformerBench(train_step, params, opt_state, src, trg,
                            batch * seq_len)


class LmBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    opt_state: dict
    tokens: SequenceBatch
    tokens_per_step: int
    pack_efficiency: float
    remat: bool


def _lm_train_step(params, loss_fn):
    """(params with grads on, Adam lr 1e-4 state, train_step): the step
    zeroes the grads, runs ``loss_fn(params)``, calls ``backward()``,
    applies Adam in place and returns the loss."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Adam(learning_rate=1e-4)
    opt_state = opt.init(params)

    def train_step():
        for p in leaves:
            p.grad = None
        loss = loss_fn(params)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return opt_state, train_step


def bench_transformer_packed(batch=16, max_len=512, vocab=32000,
                             d_model=512, dff=2048, layers=6, heads=8,
                             remat=None, device=None):
    """Packed causal-LM training (``bench.py:545-619``): ragged sequences
    (lengths geometric with mean max_len / 3, clipped to [8, max_len],
    ids in [3, vocab), all from ``np.random.RandomState(0)``) packed
    first-fit into ``batch`` rows of ``max_len`` slots
    (``core.sequence.pack_sequences``); ``lm_loss`` with the rows'
    ``segment_ids`` / ``positions`` (block-diagonal attention: the
    segmented dense path, no flash kernel, as JAX routes it), Adam lr
    1e-4, on the decoder-only trunk (``init_lm``, a generator seeded 0:
    the parameters the loss trains, which JAX's bench gets from ``init``
    with no decoder and a one-row target vocabulary).  The headline is
    REAL tokens/s (``tokens_per_step`` counts segment tokens);
    ``pack_efficiency`` is real over slot tokens.  ``remat`` None takes
    ``bench.py``'s rule (batch * max_len >= 32768: off at the
    defaults)."""
    dev = _device.resolve(device)
    params = transformer.init_lm(torch.Generator().manual_seed(0), vocab,
                                 d_model, heads, dff, layers, max_len,
                                 device=dev)
    rng = np.random.RandomState(0)
    n_seqs = batch * 3 * 2
    while True:
        lens = np.clip(rng.geometric(1.0 / (max_len // 3), size=n_seqs),
                       8, max_len)
        seqs = [rng.randint(3, vocab, int(n)) for n in lens]
        rows = pack_sequences(seqs, max_len)
        if rows[0].shape[0] >= batch:
            break
        n_seqs *= 2
    data, seg, pos = (torch.tensor(a[:batch], dtype=torch.int32, device=dev)
                      for a in rows)
    tokens = SequenceBatch(data=data, lengths=torch.full(
        (batch,), max_len, dtype=torch.int32, device=dev))
    real = int((seg > 0).sum())
    remat = _remat(remat, batch * max_len >= 32768)
    opt_state, train_step = _lm_train_step(params, lambda p: transformer.
                                           lm_loss(p, tokens, heads,
                                                   segment_ids=seg,
                                                   positions=pos,
                                                   remat=remat))
    return LmBench(train_step, params, opt_state, tokens, real,
                   real / (batch * max_len), remat)


def bench_transformer_moe(batch=16, seq_len=512, vocab=32000, d_model=512,
                          dff=2048, layers=6, heads=8, experts=8,
                          moe_top_k=2, remat=None, device=None):
    """Sparse-expert causal-LM training (``bench.py:622-678``): the
    decoder-only trunk with every block's FFN an ``experts``-expert
    top-``moe_top_k`` mixture (``init_lm(moe_experts=)``, a generator
    seeded 0), ids from ``np.random.RandomState(0)`` in [3, vocab),
    every row full length, ``lm_loss`` (the key-masked dense attention
    path, no flash kernel, as JAX routes it; the load-balance aux at
    weight 0.01), Adam lr 1e-4.  Every expert runs on every token (the
    dense dispatch).  ``remat`` as ``bench_transformer_packed``."""
    dev = _device.resolve(device)
    params = transformer.init_lm(torch.Generator().manual_seed(0), vocab,
                                 d_model, heads, dff, layers, seq_len,
                                 moe_experts=experts, device=dev)
    rng = np.random.RandomState(0)
    tokens = SequenceBatch(
        data=torch.tensor(rng.randint(3, vocab, (batch, seq_len)),
                          dtype=torch.int32, device=dev),
        lengths=torch.full((batch,), seq_len, dtype=torch.int32,
                           device=dev))
    remat = _remat(remat, batch * seq_len >= 32768)
    opt_state, train_step = _lm_train_step(params, lambda p: transformer.
                                           lm_loss(p, tokens, heads,
                                                   moe_top_k=moe_top_k,
                                                   remat=remat))
    return LmBench(train_step, params, opt_state, tokens, batch * seq_len,
                   1.0, remat)


class TrainerInt8Bench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    trainer: object
    twin: object
    feeder: DataFeeder
    batches: list
    flops_per_step: float


def bench_trainer_int8(batch=64, dim=64, hidden=128, n_batches=24, seed=0,
                       device=None):
    """Int8 weight-streaming training (``bench.py:2481-2597``): an
    fc(tanh) -> fc(softmax) classifier on ``dim``-wide dense inputs
    (labels: the sign of the row sum), ``n_batches`` batches from
    ``np.random.RandomState(seed)``, ``trainer.SGD(quant_weights=True,
    quant_min_size=1024)`` (the hidden layer's weight streams int8) and
    its float32 twin from the same weights (SGD's seed), Momentum lr
    0.01 m 0.9.  ``int8_loss_gap`` trains both side by side;
    ``weights_quantized`` checks what the int8 trainer keeps between
    steps; ``train_step()`` is one int8 step on the next batch."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.data import dense_vector, integer_value
    from paddle_tpu_torch.trainer import SGD
    dev = _device.resolve(device)
    rng = np.random.RandomState(seed)
    xs = rng.randn(n_batches, batch, dim).astype(np.float32)
    ys = (xs.sum(-1) > 0).astype(np.int64)
    feeder = DataFeeder({"x": dense_vector(dim), "lab": integer_value(2)},
                        device=dev)

    def build(quant):
        L.reset_names()
        x = L.data_layer("x", size=dim)
        lab = L.data_layer("lab", size=1)
        h = L.fc_layer(x, size=hidden, act="tanh")
        y = L.fc_layer(h, size=2, act="softmax")
        return SGD(cost=L.classification_cost(y, lab),
                   update_equation=Momentum(learning_rate=0.01,
                                            momentum=0.9),
                   quant_weights=quant, quant_min_size=1024, device=dev)

    trainer, twin = build(True), build(False)
    if not trainer._qtree:
        raise AssertionError("the int8 trainer must quantize the fc weights")
    batches = [[(xs[i, j], int(ys[i, j])) for j in range(batch)]
               for i in range(n_batches)]
    count = [0]

    def train_step():
        i = count[0] % n_batches
        count[0] += 1
        return trainer.train_one_batch(batches[i], feeder)

    return TrainerInt8Bench(train_step, trainer, twin, feeder, batches,
                            3.0 * 2.0 * (dim * hidden + hidden * 2) * batch)


def int8_loss_gap(bench):
    """Trains the int8 trainer and its float32 twin over every batch, one
    step each on the same batch: (max per-step |loss_int8 - loss_f32| /
    max(|loss_f32|, 1), the int8 losses, the float32 losses), against
    ``quant/weights.TRAIN_LOSS_BUDGET``."""
    q_losses, f_losses = [], []
    for b in bench.batches:
        q_losses.append(float(bench.trainer.train_one_batch(b,
                                                            bench.feeder)))
        f_losses.append(float(bench.twin.train_one_batch(b, bench.feeder)))
    gap = max(abs(q - f) / max(abs(f), 1.0)
              for q, f in zip(q_losses, f_losses))
    return gap, q_losses, f_losses


def weights_quantized(trainer, others=()):
    """The direct check that takes the place of ``bench.py``'s HLO gate:
    every weight the int8 trainer keeps quantized is int8 codes [din,
    dout] with float32 scales [1, dout] on its device, equal to its
    float32 master's requantization, and no widened float32 copy of it
    stays live: every float32 tensor of a quantized weight's shape that
    the garbage collector can reach is the master or one of its
    optimizer slots (or a param, slot or gradient of ``others``, e.g.
    the float32 twin trainer).  Raises AssertionError; returns the
    quantized shapes."""
    import gc
    from paddle_tpu_torch.quant import weights as qw
    if trainer._view is not None:
        raise AssertionError("the step's dequantized view outlived the step")
    # the masters' own device ("cuda:0", where the trainer says "cuda")
    dev = tree_leaves(trainer.parameters)[0].device
    allowed = {t.data_ptr() for t in tree_leaves(trainer.parameters)
               + tree_leaves(trainer.opt_state["slots"])}
    for other in others:
        held = tree_leaves(other.parameters)
        allowed |= {t.data_ptr() for t in held
                    + tree_leaves(other.opt_state["slots"])
                    + [p.grad for p in held if p.grad is not None]}
    shapes = set()
    for key, leaf in trainer._qtree.items():
        q, s = leaf["q"], leaf["s"]
        if q.dtype != torch.int8 or s.dtype != torch.float32 \
                or q.dim() != 2 or tuple(s.shape) != (1, q.shape[1]) \
                or q.device != dev or s.device != dev:
            raise AssertionError(f"{key}: codes {q.dtype} {tuple(q.shape)}, "
                                 f"scales {s.dtype} {tuple(s.shape)}")
        layer, name = key[2:-2].split("']['")
        again = qw.quantize_leaf(trainer.parameters[layer][name].detach())
        if not (torch.equal(again["q"], q) and torch.equal(again["s"], s)):
            raise AssertionError(f"{key}: the twin is not its master's "
                                 "requantization")
        shapes.add(tuple(q.shape))
    gc.collect()
    widened = [tuple(t.shape) for t in gc.get_objects()
               if issubclass(type(t), torch.Tensor)
               and t.dtype == torch.float32
               and t.device == dev and tuple(t.shape) in shapes
               and t.data_ptr() not in allowed]
    if widened:
        raise AssertionError(f"float32 copies of quantized weights stay "
                             f"live between steps: {widened}")
    return sorted(shapes)


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


class Seq2SeqDemoBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    batches: list
    batch: int
    target_tokens_per_step: float


def bench_seqtoseq_demo(device=None):
    """demo/seqToseq's step (``models/seqtoseq_demo.setup``: hidden = emb
    256, Adam lr 5e-4 clip_norm 5) over one pass of the demo's reader (64
    batches of 32 wmt14 triples), in turn and then again.
    ``train_step()`` feeds the next batch (``feed_batch``: padding and the
    copy to the card, as the demo's loop does), steps and returns the
    loss; ``target_tokens_per_step`` is the pass's mean count of target
    tokens (eos included) a batch."""
    dev = _device.resolve(device)
    params, _, step = seqtoseq_demo.setup(device=dev)
    batches = list(seqtoseq_demo.make_batches()())
    count = [0]

    def train_step():
        batch = batches[count[0] % len(batches)]
        count[0] += 1
        return step(*seqtoseq_demo.feed_batch(batch, dev))

    return Seq2SeqDemoBench(train_step, params, batches, len(batches[0]),
                            float(np.mean([sum(len(s[2]) for s in b)
                                           for b in batches])))


class DecodeBench(NamedTuple):
    run: Callable[[], object]
    params: dict
    src: SequenceBatch
    kw: dict                 # generate_cached's beam_size, max_len, num_heads
    tokens_per_run: int
    flops_per_run: float
    quant: object


def decode_flops(batch, src_len, max_len, vocab, d_model, dff, layers,
                 beam):
    """Analytic FLOPs of one KV-cached beam decode of a batch
    (``bench.py:741-753``, the bench's own count): per decoded position
    and beam lane the self-attention q/k/v/o, the cross-attention q/o,
    the FFN and the vocabulary projection; the encoder and the cross K/V
    once a sequence.  Attention over the cache is left out, as there."""
    dec_per_tok = layers * (6 * d_model ** 2 + 2 * d_model * dff) \
        + d_model * vocab
    per_seq = layers * (4 * d_model ** 2 + 2 * d_model * dff) * src_len \
        + layers * 2 * d_model ** 2 * src_len * beam
    return 2.0 * batch * (dec_per_tok * beam * max_len + per_seq)


def bench_transformer_decode(batch=32, src_len=128, max_len=128,
                             vocab=32000, d_model=512, dff=2048, layers=6,
                             heads=8, beam=4, device=None):
    """The serving decode of ``bench.py:769-812``: KV-cached beam search
    (``transformer.generate_cached``, length penalty 0.6) on the
    Transformer-base MT model, params from a generator seeded 0 (the
    positional table ``src_len + max_len`` rows), a batch of full-length
    sources from ``np.random.RandomState(0)`` in [3, vocab).  ``run()``
    decodes the batch once.  ``BENCH_QUANT=int8`` serves the
    ``quant/weights.quantize_lm`` tree (every 2-D float32 weight of at
    least 1024 elements int8 with per-output scales; the call
    dequantizes it once).  Emitted tokens/s (batch x max_len a run) is
    the headline; there is no reference baseline."""
    dev = _device.resolve(device)
    params = transformer.init(torch.Generator().manual_seed(0),
                              src_vocab=vocab, trg_vocab=vocab,
                              d_model=d_model, num_heads=heads, dff=dff,
                              enc_layers=layers, dec_layers=layers,
                              max_len=src_len + max_len, device=dev)
    quant = os.environ.get("BENCH_QUANT") or None
    if quant not in (None, "int8"):
        raise ValueError(f"BENCH_QUANT={quant!r} (takes int8)")
    if quant:
        from paddle_tpu_torch.quant.weights import quantize_lm
        params = quantize_lm(params)
    rng = np.random.RandomState(0)
    src = SequenceBatch(
        data=torch.tensor(rng.randint(3, vocab, (batch, src_len)),
                          dtype=torch.int32, device=dev),
        lengths=torch.full((batch,), src_len, dtype=torch.int32,
                           device=dev))

    kw = {"beam_size": beam, "max_len": max_len, "num_heads": heads}

    def run():
        return transformer.generate_cached(params, src, **kw)

    return DecodeBench(run, params, src, kw, batch * max_len,
                       decode_flops(batch, src_len, max_len, vocab, d_model,
                                    dff, layers, beam), quant)


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
              seed=0, compute_dtype=None, cell="rnn", sparse_update=False,
              device=None):
    """``trainer.SGD`` over ``models/text_rnn``'s config (params from a
    generator seeded 1, SGD's default seed; ``n_batches`` batches of ids
    drawn from ``seed``; ``compute_dtype`` as ``SGD`` takes it; ``cell``
    "rnn" or "lstm"; ``sparse_update`` trains the embedding by its
    touched rows).  ``train_step()`` feeds the next batch through
    ``SGD.train_one_batch`` (DataFeeder, forward, ``backward()``,
    Momentum in place) and returns the loss."""
    from paddle_tpu_torch.trainer import SGD
    dev = _device.resolve(device)
    flops = {"rnn": rnn_flops, "lstm": lstm_flops}[cell]
    trainer = SGD(cost=text_rnn.build(vocab=vocab, hidden=hidden, cell=cell,
                                      sparse_update=sparse_update),
                  update_equation=text_rnn.optimizer(),
                  compute_dtype=compute_dtype, device=dev)
    feeder = DataFeeder(text_rnn.feeding(vocab), device=dev)
    batches = list(text_rnn.batches(seed, n_batches, batch=batch,
                                    seq_len=seq_len, vocab=vocab)())
    count = [0]

    def train_step():
        i = count[0] % len(batches)
        count[0] += 1
        return trainer.train_one_batch(batches[i], feeder)

    return RnnBench(train_step, trainer, feeder, batches, batch * seq_len,
                    flops(batch, seq_len, hidden))


def sparse_sync_ms(bench, steps):
    """Median ms of the sparse step's host sync alone: ``ops/sparse.
    unique_touched`` on a batch's ids (the unique kernel, the read of its
    size and the padding), the card idle before and after."""
    from paddle_tpu_torch.ops import sparse as sparse_ops
    (key, spec), = bench.trainer._sparse_specs.items()
    times = []
    for i in range(steps):
        ids = bench.feeder(bench.batches[i % len(bench.batches)])[
            spec["feeds"][0]].data
        budget = spec["budget"] or sparse_ops.default_row_budget(ids.numel())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sparse_ops.unique_touched(ids, budget, spec["vocab"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


class PrefetchBench(NamedTuple):
    one_pass: Callable[[int], None]     # one pass at a prefetch depth
    trainer: Callable[[], object]       # a fresh trainer, the same init
    n_batches: int


def bench_trainer_prefetch(batch=64, dim=256, hidden=512, n_batches=24,
                           host_ms=4.0, device=None):
    """``bench.py:3449-3535``: the trainer's input overlap on an
    input-bound MLP (fc ``hidden`` tanh -> fc 2 softmax over dense
    inputs of ``dim``, Momentum lr 0.01 m 0.9, ``batch`` rows), each host
    batch costing ``host_ms`` of synthetic input latency.
    ``one_pass(prefetch, trainer=None)`` trains one pass of
    ``n_batches`` batches (``buffered_batches=0``) at that prefetch depth
    and returns the trainer; ``prefetch_rates`` times both depths."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.data.provider import dense_vector, integer_value
    from paddle_tpu_torch.trainer import SGD
    dev = _device.resolve(device)
    rng = np.random.RandomState(0)
    xs = rng.randn(n_batches, batch, dim).astype(np.float32)
    ys = (xs.sum(-1) > 0).astype(np.int64)

    def reader():
        for i in range(n_batches):
            time.sleep(host_ms * 1e-3)      # synthetic host input cost
            yield [(xs[i, j], int(ys[i, j])) for j in range(batch)]

    feeding = {"x": dense_vector(dim), "lab": integer_value(2)}

    def trainer():
        L.reset_names()
        x, lab = L.data_layer("x", size=dim), L.data_layer("lab", size=1)
        y = L.fc_layer(L.fc_layer(x, size=hidden, act="tanh"), size=2,
                       act="softmax")
        return SGD(cost=L.classification_cost(y, lab),
                   update_equation=Momentum(learning_rate=0.01,
                                            momentum=0.9), device=dev)

    shared = trainer()

    def one_pass(prefetch, tr=None):
        tr = tr or shared
        tr.train(reader, num_passes=1, feeding=feeding, log_period=0,
                 buffered_batches=0, prefetch=prefetch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return tr

    return PrefetchBench(one_pass, trainer, n_batches)


def prefetch_rates(bench):
    """Steps/s of a pass at prefetch 0 and at 2 (each depth warmed by a
    pass first), the speedup, and the mean ``h2d_wait`` of the prefetch-2
    pass in ms."""
    from paddle_tpu_torch.utils.stats import global_stats

    def steps_per_s(prefetch):
        t0 = time.perf_counter()
        bench.one_pass(prefetch)
        return bench.n_batches / (time.perf_counter() - t0)
    steps_per_s(0)
    steps_per_s(2)
    sps0 = steps_per_s(0)
    wait = global_stats.get("h2d_wait")
    wait.reset()
    sps2 = steps_per_s(2)
    return {"steps_per_s_prefetch0": sps0, "steps_per_s_prefetch2": sps2,
            "prefetch_speedup": sps2 / sps0, "h2d_wait_ms": wait.avg * 1e3}


class RecBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    params: dict
    opt_state: dict
    batches: list               # host batches of movielens samples
    batch: int


def bench_recommendation(batch=128, emb=256, hidden=256, seed=0,
                         device=None):
    """``demo/recommendation/train.py``'s step: the MovieLens towers at
    ``emb`` / ``hidden`` (``models/recommendation``, params from a
    generator seeded ``seed``), Adam lr 1e-3, the movielens train split
    (its synthetic fallback: 4096 samples) shuffled in a buffer of 1024
    with seed 0 and batched by ``batch``, as the demo reads it.
    ``train_step()`` feeds the next batch (``feed_batch``: the 8 slots
    to tensors on the device), zeroes the grads, runs the loss, calls
    ``backward()``, applies Adam in place and returns the loss."""
    dev = _device.resolve(device)
    params = recommendation.init(torch.Generator().manual_seed(seed),
                                 emb=emb, hidden=hidden, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Adam(learning_rate=1e-3)
    opt_state = opt.init(params)
    batches = list(reader_mod.batch(reader_mod.shuffle(
        movielens.train(), 1024, seed=0), batch, drop_last=True)())
    count = [0]

    def train_step():
        feed = recommendation.feed_batch(batches[count[0] % len(batches)],
                                         device=dev)
        count[0] += 1
        for p in leaves:
            p.grad = None
        loss = recommendation.loss(params, *feed)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return RecBench(train_step, params, opt_state, batches, batch)


class DslBench(NamedTuple):
    train_step: Callable[[], torch.Tensor]
    trainer: object
    feeder: DataFeeder
    batches: list
    samples_per_step: int


# bench_dsl's configs: model -> (the config's description, its dict)
DSL_CONFIGS = {
    "vgg_cifar": ({"model": "demo/image_classification vgg_bn_drop "
                            "(models/image_dsl)", "image": [32, 32, 3],
                   "optimizer": "Momentum lr 0.01 m 0.9 l2 1e-4"},
                  lambda n: image_dsl.cifar_config(model="vgg", n_batches=n)),
    "sentiment": ({"model": "demo/sentiment stacked_lstm_net "
                            "(models/text_dsl)", "emb": 128, "hid": 128,
                   "lstm_layers": 3,
                   "data": "data.datasets.imdb train, 8-119 tokens",
                   "optimizer": "Adam lr 0.002 l2 1e-4 clip_norm 5"},
                  lambda n: text_dsl.config("sentiment", n_batches=n)),
    "quick_start_cnn": ({"model": "demo/quick_start cnn_net "
                                  "(models/text_dsl: networks."
                                  "sequence_conv_pool, window 3, fc 256)",
                         "emb": 128,
                         "data": "data.datasets.imdb train, 8-119 tokens",
                         "optimizer": "Adam lr 0.002"},
                        lambda n: text_dsl.config("cnn", n_batches=n)),
    "srl": ({"model": "demo/semantic_role_labeling db_lstm "
                      "(models/tagging_dsl.db_lstm_net: mixed layers, "
                      "lstmemory x 8 alternating, crf_layer)",
             "emb": 32, "hid": 128, "depth": 8,
             "data": "data.datasets.conll05 train, 5-39 tokens",
             "optimizer": "Adam lr 1e-3 clip_threshold 5"},
            lambda n: tagging_dsl.config("srl", n_batches=n)),
    "tagging": ({"model": "demo/sequence_tagging linear_crf "
                          "(models/tagging_dsl.linear_crf_net: context "
                          "window 3, fc 128, crf_layer)",
                 "word_emb": 64, "pred_emb": 32, "hidden": 128,
                 "data": "data.datasets.conll05 train, shuffled, "
                         "5-39 tokens",
                 "optimizer": "Momentum lr 0.01 m 0.9 l2 1e-4"},
                lambda n: tagging_dsl.config("tagging", n_batches=n)),
    "word2vec": ({"model": "demo/word2vec hsigmoid (models/word2vec_dsl)",
                  "vocab": 2073, "emb": 32, "hidden": 128, "ngram": 5,
                  "data": "data.datasets.imikolov train",
                  "optimizer": "AdaGrad lr 0.1"},
                 lambda n: word2vec_dsl.config(True, n_batches=n)),
    "word2vec_softmax": ({"model": "demo/word2vec softmax "
                                   "(models/word2vec_dsl)",
                          "vocab": 2073, "emb": 32, "hidden": 128,
                          "ngram": 5,
                          "data": "data.datasets.imikolov train",
                          "optimizer": "AdaGrad lr 0.1"},
                         lambda n: word2vec_dsl.config(False, n_batches=n)),
}


def bench_dsl(model, n_batches=8, device=None):
    """``trainer.SGD`` over a demo's layer-DSL config (``DSL_CONFIGS``):
    ``vgg_cifar`` (the image_classification demo's vgg, batch 128 of the
    cifar loader), ``sentiment`` (the sentiment demo's stacked LSTM, hid
    128, batch 64 of the imdb loader's ragged reviews),
    ``quick_start_cnn`` (quick_start's cnn, batch 64 of imdb), ``srl``
    (the SRL demo's db-LSTM + CRF at hid 128, depth 8, batch 16 of the
    conll05 loader) or ``tagging`` (sequence_tagging's linear CRF, batch
    32 of conll05), over the loader's first ``n_batches`` batches
    (params from SGD's seed).  ``train_step()`` feeds the next batch
    through ``SGD.train_one_batch`` (DataFeeder, forward,
    ``backward()``, the update) and returns the loss."""
    from paddle_tpu_torch.trainer import SGD
    dev = _device.resolve(device)
    if model not in DSL_CONFIGS:
        raise ValueError(f"bench_dsl: model {model!r}")
    cfg = DSL_CONFIGS[model][1](n_batches)
    trainer = SGD(cost=cfg["cost"], update_equation=cfg["optimizer"],
                  device=dev)
    feeder = DataFeeder(cfg["feeding"], device=dev)
    batches = list(cfg["train_reader"]())
    count = [0]

    def train_step():
        i = count[0] % len(batches)
        count[0] += 1
        return trainer.train_one_batch(batches[i], feeder)

    return DslBench(train_step, trainer, feeder, batches, len(batches[0]))


def crf_split(bench, steps):
    """The CRF cost's share of a CRF config's step (``bench_dsl``), by
    ablation: ``steps`` pairs of steps on the same batch, one as it is
    and one with ``ops/crf.crf_log_likelihood`` replaced by zero times
    the sum of its emissions and weight (every other node, the backward
    through the emissions and the update unchanged), after a warm-up
    pair, each step ending in a synchronize.  Returns the two median ms,
    their difference (the CRF's ms) and its share of the step; raises
    unless each ablated step called the stand-in once (a step that
    reached the CRF some other way would read a share of 0)."""
    from paddle_tpu_torch.ops import crf as crf_ops
    plain = crf_ops.crf_log_likelihood
    calls = [0]

    def stand_in(emissions, tags, lengths, w):
        calls[0] += 1
        # zero, so the parameters keep to the demo's path
        return 0.0 * (emissions.sum(dim=(1, 2)) + w.sum())

    times = ([], [])
    try:
        # a warm-up pair first
        for i in range(2 * steps + 2):
            crf_ops.crf_log_likelihood = stand_in if i % 2 else plain
            batch = bench.batches[(i // 2) % len(bench.batches)]
            before = calls[0]
            t0 = time.perf_counter()
            bench.trainer.train_one_batch(batch, bench.feeder)
            torch.cuda.synchronize()
            if i >= 2:
                times[i % 2].append((time.perf_counter() - t0) * 1e3)
            if calls[0] - before != i % 2:
                raise RuntimeError(
                    f"crf_split: step {i} called the stand-in "
                    f"{calls[0] - before} times, not {i % 2}")
    finally:
        crf_ops.crf_log_likelihood = plain
    with_crf, without = (float(np.median(t)) for t in times)
    return {"step_ms": with_crf, "step_ms_crf_summed_away": without,
            "crf_ms": with_crf - without,
            "crf_share": (with_crf - without) / with_crf}


def image_step_split(bench, steps):
    """Median ms of an image bench's forward, ``backward()`` and
    optimizer update over ``steps`` steps, each part ending in a
    synchronize."""
    forward, backward, update = bench.parts
    parts = {"forward": [], "backward": [], "update": []}
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, a, b in zip(parts, (t0, t1, t2), (t1, t2, t3)):
            parts[name].append((b - a) * 1e3)
    return {name: float(np.median(v)) for name, v in parts.items()}


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


def _compute_dtype():
    """The dtype policy's compute dtype, as its name ("bfloat16")."""
    return str(dtypes.compute_dtype()).replace("torch.", "")


def apply_bench_dtype():
    """``BENCH_DTYPE`` (float32 | bfloat16 | ...), as ``bench.py:3764-3767``
    reads it: the process's compute policy for the run
    (``core/dtypes.set_policy``); unset keeps auto (float32)."""
    if os.environ.get("BENCH_DTYPE"):
        dtypes.set_policy(compute_dtype=os.environ["BENCH_DTYPE"])


def _timed(train_step, steps=STEPS):
    """WARMUP steps, then ``steps`` timed ones (each ending in a
    synchronize) with the launch counters reset before them: (times ms,
    losses)."""
    for _ in range(WARMUP):
        train_step()
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return times, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("lstm", "transformer",
                                        "transformer_packed",
                                        "transformer_moe", "seq2seq", "rnn",
                                        "trainer_int8", "transformer_decode",
                                        "serving_quant",
                                        "serving_speculative",
                                        "recommendation", "seqtoseq_demo",
                                        "rnn_sparse", "trainer_prefetch",
                                        *DSL_CONFIGS,
                                        *IMAGE_CONFIGS),
                    default="lstm")
    ap.add_argument("--hidden", type=int, default=512,
                    help="the LSTM's hidden size (--model lstm)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward (the "
                         "transformer models)")
    args = ap.parse_args(argv)
    apply_bench_dtype()
    dev = _device.resolve("cuda")
    remat = True if args.remat else None
    if args.model in ("transformer_packed", "transformer_moe"):
        moe = args.model == "transformer_moe"
        bench = (bench_transformer_moe if moe
                 else bench_transformer_packed)(remat=remat, device=dev)
        torch.cuda.reset_peak_memory_stats()
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        fk = kernels.flash_attention
        print(json.dumps({
            "bench": args.model, "card": _device.card(),
            "compute_dtype": _compute_dtype(),
            "config": {"vocab": 32000, "d_model": 512, "heads": 8,
                       "dff": 2048, "layers": 6, "batch": 16,
                       "slots" if not moe else "seq_len": 512,
                       **({"experts": 8, "moe_top_k": 2} if moe else {}),
                       "optimizer": "Adam lr 1e-4", "remat": bench.remat},
            "steps": STEPS, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "real_tokens_per_s" if not moe else "tokens_per_s":
                bench.tokens_per_step / (ms / 1e3),
            **({} if moe else {"pack_efficiency": bench.pack_efficiency}),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "loss_first_last": [losses[0], losses[-1]],
            "launches": {fk.NAME: fk.launches,
                         fk.NAME_BWD_DKV: fk.launches_bwd_dkv,
                         fk.NAME_BWD_DQ: fk.launches_bwd_dq},
        }), flush=True)
        return 0
    if args.model == "trainer_int8":
        bench = bench_trainer_int8(device=dev)
        gap, q_losses, f_losses = int8_loss_gap(bench)
        if gap > TRAIN_LOSS_BUDGET:
            raise AssertionError(f"int8 trainer loss gap {gap} exceeds the "
                                 f"budget {TRAIN_LOSS_BUDGET}")
        shapes = weights_quantized(bench.trainer, others=(bench.twin,))
        times, _ = _timed(bench.train_step)
        ms = float(np.median(times))
        print(json.dumps({
            "bench": "trainer_int8", "card": _device.card(),
            "compute_dtype": _compute_dtype(),
            "config": {"batch": 64, "dim": 64, "hidden": 128,
                       "batches": len(bench.batches), "quant_min_size": 1024,
                       "optimizer": "Momentum lr 0.01 m 0.9"},
            "loss_gap_max": gap, "loss_gap_budget": TRAIN_LOSS_BUDGET,
            "final_loss_int8": q_losses[-1], "final_loss_f32": f_losses[-1],
            "quantized_weight_shapes": [list(x) for x in shapes],
            "steps": STEPS, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
        }), flush=True)
        return 0
    if args.model == "transformer_decode":
        bench = bench_transformer_decode(device=dev)
        for _ in range(DECODE_WARMUP):
            bench.run()
        torch.cuda.synchronize()
        kernels.reset_launches()
        times = []
        for _ in range(DECODE_RUNS):
            t0 = time.perf_counter()
            res = bench.run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        fk = kernels.flash_attention
        print(json.dumps({
            "bench": "transformer_decode", "card": _device.card(),
            "compute_dtype": _compute_dtype(), "quant": bench.quant,
            "config": {"vocab": 32000, "d_model": 512, "heads": 8,
                       "dff": 2048, "layers": "6+6", "batch": 32,
                       "src_len": 128, "max_len": 128, "beam": 4,
                       "length_penalty": 0.6},
            "runs": DECODE_RUNS, "ms_per_batch": ms,
            "ms_per_batch_all": times,
            "ms_per_step": ms / 128,
            "tokens_per_s": bench.tokens_per_run / (ms / 1e3),
            "flops_per_run": bench.flops_per_run,
            "tflop_per_s": bench.flops_per_run / (ms / 1e3) / 1e12,
            "mean_best_score": float(res.scores[:, 0].mean()),
            "launches": {fk.NAME: fk.launches},
        }), flush=True)
        return 0
    if args.model in IMAGE_CONFIGS:
        bench = bench_image(args.model, remat=True if args.remat else None,
                            device=dev)
        torch.cuda.reset_peak_memory_stats()
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        batch, hw, classes, _ = IMAGE_CONFIGS[args.model]
        print(json.dumps({
            "bench": f"{args.model}_train", "card": _device.card(),
            "compute_dtype": _compute_dtype(),
            "config": {"batch": batch, "image": [hw, hw, 3],
                       "classes": classes, "remat": bench.remat,
                       "optimizer": "Momentum lr "
                       f"{0.1 if args.model == 'resnet50' else 0.01} m 0.9"},
            "steps": STEPS, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "images_per_s": batch / (ms / 1e3),
            "flops_per_step": bench.flops_per_step,
            "tflop_per_s": bench.flops_per_step / (ms / 1e3) / 1e12,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "loss_first_last": [losses[0], losses[-1]],
            **({"reference_k40m_ms_per_batch": IMAGE_K40M_MS[args.model]}
               if args.model in IMAGE_K40M_MS else {}),
        }), flush=True)
        return 0
    if args.model == "recommendation":
        bench = bench_recommendation(device=dev)
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        print(json.dumps({
            "bench": "recommendation_movielens", "card": _device.card(),
            "compute_dtype": _compute_dtype(),
            "config": {"emb": 256, "hidden": 256, "batch": bench.batch,
                       "data": "data.datasets.movielens train, shuffled "
                               "(buffer 1024, seed 0)",
                       "optimizer": "Adam lr 1e-3",
                       "entry": "demo/recommendation's step, feed_batch "
                                "included"},
            "steps": STEPS, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "samples_per_s": bench.batch / (ms / 1e3),
            "loss_first_last": [losses[0], losses[-1]],
        }), flush=True)
        return 0
    if args.model in DSL_CONFIGS:
        bench = bench_dsl(args.model, device=dev)
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        lk = kernels.lstm
        split = step_split(bench.trainer, bench.feeder, bench.batches, STEPS)
        print(json.dumps({
            "bench": f"{args.model}_dsl", "card": _device.card(),
            "compute_dtype": _compute_dtype(),
            "config": {**DSL_CONFIGS[args.model][0],
                       "batch": bench.samples_per_step},
            "entry": "trainer.SGD.train_one_batch",
            "steps": STEPS, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "samples_per_s": bench.samples_per_step / (ms / 1e3),
            "loss_first_last": [losses[0], losses[-1]],
            "launches": {lk.NAME_FWD: lk.launches_fwd,
                         lk.NAME_BWD: lk.launches_bwd},
            "split_ms": split,
            **({"crf": crf_split(bench, STEPS)}
               if args.model in ("srl", "tagging") else {}),
        }), flush=True)
        return 0
    if args.model == "serving_quant":
        bench_serving_quant(device=dev)
        return 0
    if args.model == "trainer_prefetch":
        print(json.dumps({
            "bench": "trainer_prefetch", "card": _device.card(),
            "config": {"batch": 64, "dim": 256, "hidden": 512,
                       "batches": 24, "host_ms": 4.0,
                       "optimizer": "Momentum lr 0.01 m 0.9",
                       "entry": "trainer.SGD.train(prefetch=0 | 2)"},
            **prefetch_rates(bench_trainer_prefetch(device=dev))}),
              flush=True)
        return 0
    if args.model == "rnn_sparse":
        # text_rnn's LSTM config with the embedding trained by its touched
        # rows, beside the same config dense
        out = {}
        for sparse in (True, False):
            bench = bench_rnn(cell="lstm", sparse_update=sparse, device=dev)
            times, losses = _timed(bench.train_step)
            ms = float(np.median(times))
            lk = kernels.lstm
            sync = sparse_sync_ms(bench, STEPS) if sparse else None
            out["sparse" if sparse else "dense"] = {
                "ms_per_batch": ms,
                "ms_per_batch_p90": float(np.percentile(times, 90)),
                "samples_per_s": text_rnn.BATCH / (ms / 1e3),
                "loss_first_last": [losses[0], losses[-1]],
                "launches": {lk.NAME_FWD: lk.launches_fwd,
                             lk.NAME_BWD: lk.launches_bwd},
                **({"host_sync_ms": sync, "host_sync_share": sync / ms}
                   if sparse else {})}
        print(json.dumps({
            "bench": "rnn_sparse", "card": _device.card(),
            "config": {"vocab": text_rnn.VOCAB, "emb": text_rnn.EMB,
                       "hidden": text_rnn.HIDDEN, "cell": "lstm",
                       "layers": text_rnn.LAYERS, "batch": text_rnn.BATCH,
                       "seq_len": text_rnn.SEQ_LEN,
                       "optimizer": "Momentum lr 0.01 m 0.9",
                       "entry": "trainer.SGD.train_one_batch"},
            "steps": STEPS, **out}), flush=True)
        return 0
    if args.model == "serving_speculative":
        bench_serving_speculative(device=dev)
        return 0
    if args.model == "rnn":
        # the DSL trainer casts at the step boundary under bf16, as the
        # trainer CLI's --dtype bfloat16 does
        bench = bench_rnn(compute_dtype=(
            torch.bfloat16 if dtypes.compute_dtype() == torch.bfloat16
            else None), device=dev)
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        rk = kernels.simple_rnn
        print(json.dumps({
            "bench": "rnn_textclass_dsl", "card": _device.card(),
            "compute_dtype": _compute_dtype(),
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
    if args.model == "seqtoseq_demo":
        # one timed step a batch of the pass: the batches' lengths vary
        bench = bench_seqtoseq_demo(device=dev)
        steps = len(bench.batches)
        times, losses = _timed(bench.train_step, steps)
        ms = float(np.median(times))
        gk = kernels.gru
        print(json.dumps({
            "bench": "seqtoseq_demo", "card": _device.card(),
            "compute_dtype": _compute_dtype(),
            "config": {"vocab": 3000, "emb": 256, "hidden": 256,
                       "batch": bench.batch, "batches": len(bench.batches),
                       "data": "data.datasets.wmt14 train, shuffled "
                               "(buffer 1024, seed 0), sources of 3-29 "
                               "tokens",
                       "optimizer": "Adam lr 5e-4 clip_norm 5",
                       "entry": "demo/seqToseq's step, feed_batch included"},
            "steps": steps, "ms_per_batch": ms,
            "ms_per_batch_p90": float(np.percentile(times, 90)),
            "samples_per_s": bench.batch / (ms / 1e3),
            "target_tokens_per_s": bench.target_tokens_per_step / (ms / 1e3),
            "loss_first_last": [losses[0], losses[-1]],
            "launches_per_step": {gk.NAME_FWD: gk.launches_fwd / steps,
                                  gk.NAME_BWD: gk.launches_bwd / steps},
        }), flush=True)
        return 0
    if args.model == "seq2seq":
        bench = bench_seq2seq(device=dev)
        times, losses = _timed(bench.train_step)
        ms = float(np.median(times))
        gk = kernels.gru
        print(json.dumps({
            "bench": "seq2seq_attention_nmt", "card": _device.card(),
            "compute_dtype": _compute_dtype(),
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
            "compute_dtype": _compute_dtype(),
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
    bench = bench_transformer(remat=remat, device=dev)
    torch.cuda.reset_peak_memory_stats()
    times, losses = _timed(bench.train_step)
    ms = float(np.median(times))
    fk = kernels.flash_attention
    print(json.dumps({
        "bench": "transformer_mt", "card": _device.card(),
        "compute_dtype": _compute_dtype(),
        "config": {"vocab": 32000, "d_model": 512, "heads": 8, "dff": 2048,
                   "layers": "6+6", "batch": 32, "seq_len": 256,
                   "optimizer": "Adam lr 1e-4", "label_smoothing": 0.1,
                   "full_seq": True, "remat": bool(args.remat)},
        "steps": STEPS, "ms_per_batch": ms,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
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
