"""The reference's RNN text classifier as a layer-DSL config: the slice
that ``trainer.SGD`` and ``python -m paddle_tpu_torch train`` run.

The setup of ``bench.py``'s ``bench_lstm`` (``bench.py:316-355``; the
reference's benchmark/paddle/rnn/rnn.py, IMDB) with each recurrent layer
the reference's RecurrentLayer instead of an LSTM:

    data_layer("word", vocab, is_seq=True) -> embedding_layer(128)
    2 x [fc_layer(hidden, act=None, bias_attr=False)
         -> recurrent_layer(act="tanh")]
    -> pooling_layer(Max) -> fc_layer(2, act="softmax")
    -> classification_cost against data_layer("label", 1)

trained with Momentum (lr 0.01, momentum 0.9) on batches of 64 rows of
100 token ids.  Both recurrent layers take the vanilla-RNN kernels on
the card (``ops/kernels/simple_rnn.supported(64, 512, "tanh", None)``).
``cell="lstm"`` puts ``lstmemory`` on ``fc_layer(4 hidden, act=None,
bias_attr=False)`` in each recurrent layer's place (the LSTM kernels, or
the gate-blocked forward at hidden 1280), ``cell="gru"`` ``grumemory``
on ``fc_layer(3 hidden, act=None)`` (the GRU kernels).
``sparse_update=True`` trains the embedding table by its touched rows
(``trainer.SGD``'s sparse step, the reference's large-vocab path).
The data are random ids and labels drawn from a seed; the JAX package
runs the same config unchanged (``tests/test_torch_trainer.py``).
"""

import numpy as np

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.provider import integer_value, \
    integer_value_sequence
from paddle_tpu_torch.optim import Momentum

VOCAB, EMB, HIDDEN, LAYERS, CLASSES = 30000, 128, 512, 2, 2
BATCH, SEQ_LEN = 64, 100
TEST_BATCHES = 2


CELLS = ("rnn", "lstm", "gru")


def _recurrent(cell, x, hidden):
    """One recurrent layer of ``cell`` over ``x``, fed by its projection."""
    if cell == "rnn":
        return L.recurrent_layer(L.fc_layer(x, size=hidden, act=None,
                                            bias_attr=False), act="tanh")
    if cell == "lstm":
        return L.lstmemory(L.fc_layer(x, size=4 * hidden, act=None,
                                      bias_attr=False))
    if cell == "gru":
        return L.grumemory(L.fc_layer(x, size=3 * hidden, act=None))
    raise ValueError(f"cell must be one of {CELLS}, got {cell!r}")


def build(vocab=VOCAB, hidden=HIDDEN, cell="rnn", sparse_update=False):
    """The cost LayerOutput, with a fresh layer-name registry (so every
    build mints the same parameter keys)."""
    L.reset_names()
    word = L.data_layer("word", vocab, is_seq=True)
    label = L.data_layer("label", 1)
    x = L.embedding_layer(word, size=EMB, sparse_update=sparse_update)
    for _ in range(LAYERS):
        x = _recurrent(cell, x, hidden)
    pooled = L.pooling_layer(x, pooling_type=L.pooling.Max)
    out = L.fc_layer(pooled, size=CLASSES, act="softmax")
    return L.classification_cost(out, label)


def feeding(vocab=VOCAB):
    return {"word": integer_value_sequence(vocab),
            "label": integer_value(CLASSES)}


def samples(seed, n, seq_len=SEQ_LEN, vocab=VOCAB):
    """``n`` samples (ids of ``seq_len`` tokens, label) drawn in bulk from
    ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (n, seq_len)).astype(np.int32)
    labels = rng.randint(0, CLASSES, n)
    return [(ids[i], int(labels[i])) for i in range(n)]


def batches(seed, n_batches, batch=BATCH, **kw):
    """A batched reader of ``n_batches`` batches from ``samples``."""
    data = samples(seed, n_batches * batch, **kw)
    return reader_mod.batch(lambda: iter(data), batch)


def optimizer():
    return Momentum(learning_rate=0.01, momentum=0.9)


def config(seed=0, n_batches=20, batch=BATCH, seq_len=SEQ_LEN, vocab=VOCAB,
           hidden=HIDDEN, cell="rnn"):
    """The dict a ``get_config()`` returns for the trainer CLI: this
    model, its optimizer and feeding, and readers drawn from ``seed``
    (the test reader from ``seed + 1``)."""
    kw = dict(batch=batch, seq_len=seq_len, vocab=vocab)
    return {"cost": build(vocab=vocab, hidden=hidden, cell=cell),
            "optimizer": optimizer(), "feeding": feeding(vocab),
            "train_reader": batches(seed, n_batches, **kw),
            "test_reader": batches(seed + 1, TEST_BATCHES, **kw)}
