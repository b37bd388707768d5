"""The tagging demos and the introduction as layer-DSL configs: the
networks that ``trainer.SGD`` and ``python -m paddle_tpu_torch train``
run on the conll05 loader's word / predicate / IOB-label sequences, and
the one-weight regression.

``db_lstm_net`` is ``demo/semantic_role_labeling/train.py:19-50`` (the
reference's demo/semantic_role_labeling db_lstm): word and predicate
embeddings of ``emb`` -> a mixed layer of 4 ``hid`` over their two full
matrix projections -> ``depth`` ``lstmemory`` layers of ``hid``,
alternating in direction, each fed by a mixed layer of 4 ``hid`` over
the previous mixed layer and LSTM -> the emission mixed layer of
NUM_LABELS over the last two -> ``crf_layer`` (the cost) and
``crf_decoding_layer`` sharing its weight.  The defaults are the
reference's depth 8 at hid 128 and emb 32, batch 16, Adam lr 1e-3 with
clip_threshold 5.0: at hid 128 and batch 16 every LSTM passes JAX's
resident rule, so on the card each runs the fused LSTM kernels
(``ops/rnn.lstm``), the reversed ones over the ragged sentences (the
demo's own widths, hid 64 at depth 4, take the plain scan in both
packages).

``linear_crf_net`` is ``demo/sequence_tagging/train.py:14-42`` at its
widths: word embedding 64 in a context window of 3 (start -1) -> a
192-wide mixed layer, concatenated with the predicate embedding of 32
(the demo sums the two in one 224-wide mixed layer, which fails in
both the reference's width check and JAX's apply: ROADMAP C15) -> fc
128 tanh -> fc NUM_LABELS -> the CRF and its decoding, Momentum lr 0.01
m 0.9 l2 1e-4 at batch 32.

``fit_a_line`` is ``demo/introduction/train.py:14-40``: fc(1) over
x -> ``regression_cost`` against y = 2x + 0.3 + noise, Momentum lr 0.1
m 0.9 at batch 64.

``get_config()`` selects by ``CONFIG_ARGS`` ``model`` (srl, the
default; tagging or fit_a_line): ``python -m paddle_tpu_torch train
--config paddle_tpu_torch/models/tagging_dsl.py --config_args
model=srl`` (``batches=N`` stops a pass after N batches).
"""

import numpy as np

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.datasets import conll05
from paddle_tpu_torch.data.provider import (dense_vector,
                                            integer_value_sequence)
from paddle_tpu_torch.optim import Adam, Momentum

MODELS = ("srl", "tagging", "fit_a_line")
BATCH = {"srl": 16, "tagging": 32, "fit_a_line": 64}


def db_lstm_net(words, preds, label, emb=32, hid=128, depth=8):
    """The SRL demo's db-LSTM + CRF: (cost, decoded output)."""
    n = conll05.NUM_LABELS
    word_emb = L.embedding_layer(words, size=emb)
    pred_emb = L.embedding_layer(preds, size=emb)
    feats = L.mixed_layer(size=4 * hid, input=[
        L.full_matrix_projection(word_emb),
        L.full_matrix_projection(pred_emb)], act=None)
    inputs = [feats, L.lstmemory(feats, size=hid, reverse=False)]
    for i in range(1, depth):
        mix = L.mixed_layer(size=4 * hid, input=[
            L.full_matrix_projection(inputs[-1]),
            L.full_matrix_projection(inputs[-2])], act=None)
        inputs += [mix, L.lstmemory(mix, size=hid, reverse=(i % 2 == 1))]
    emission = L.mixed_layer(size=n, input=[
        L.full_matrix_projection(inputs[-2]),
        L.full_matrix_projection(inputs[-1])], act=None)
    return _crf(emission, label)


def linear_crf_net(words, preds, label):
    """The sequence_tagging demo's linear CRF: (cost, decoded output)."""
    word = L.embedding_layer(words, size=64)
    pred = L.embedding_layer(preds, size=32)
    window = L.mixed_layer(size=3 * 64, input=[
        L.context_projection(word, context_len=3, context_start=-1)],
        act=None)
    feats = L.concat_layer([window, pred])
    hid = L.fc_layer(feats, size=128, act="tanh")
    emission = L.fc_layer(hid, size=conll05.NUM_LABELS, act=None)
    return _crf(emission, label)


def _crf(emission, label):
    n = conll05.NUM_LABELS
    cost = L.crf_layer(emission, label, size=n, name="crf")
    decoded = L.crf_decoding_layer(emission, size=n,
                                   param_name=cost.cfg["param_name"])
    return cost, decoded


def fit_a_line(x, y):
    """The introduction's regression: (cost, prediction)."""
    pred = L.fc_layer(x, size=1, act=None, name="fc")
    return L.regression_cost(pred, y), pred


def build(model="srl", **sizes):
    """(cost, output) of ``model`` with a fresh layer-name registry;
    ``sizes`` narrow srl (emb, hid, depth)."""
    if model not in MODELS:
        raise ValueError(f"model={model!r}: one of {MODELS}")
    L.reset_names()
    if model == "fit_a_line":
        return fit_a_line(L.data_layer("x", size=1),
                          L.data_layer("y", size=1))
    words = L.data_layer("words", size=conll05.WORD_DICT, is_seq=True)
    preds = L.data_layer("preds", size=conll05.PRED_DICT, is_seq=True)
    label = L.data_layer("label", size=1, is_seq=True)
    if model == "srl":
        return db_lstm_net(words, preds, label, **sizes)
    return linear_crf_net(words, preds, label)


def optimizer(model="srl"):
    """The demo's optimizer."""
    if model == "srl":
        return Adam(learning_rate=1e-3, clip_threshold=5.0)
    if model == "tagging":
        return Momentum(learning_rate=0.01, momentum=0.9, l2=1e-4)
    return Momentum(learning_rate=0.1, momentum=0.9)


def feeding(model="srl"):
    if model == "fit_a_line":
        return {"x": dense_vector(1), "y": dense_vector(1)}
    return {"words": integer_value_sequence(conll05.WORD_DICT),
            "preds": integer_value_sequence(conll05.PRED_DICT),
            "label": integer_value_sequence(conll05.NUM_LABELS)}


def line_samples(n=1024, seed=0):
    """The introduction's reader (``demo/introduction/train.py:14-24``):
    n samples of x ~ U(-1, 1), y = 2x + 0.3 + 0.05 N(0, 1), from
    ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    y = (2.0 * x + 0.3 + 0.05 * rng.randn(n, 1)).astype(np.float32)

    def reader():
        for i in range(n):
            yield x[i], y[i]
    return reader


def readers(model="srl"):
    """(train, test) readers of samples, as the demos read them: srl the
    conll05 train split in order; tagging the train split shuffled in a
    buffer of 256 with seed 0, and the test split; fit_a_line its
    synthetic line (no test split)."""
    if model == "srl":
        return conll05.train(), conll05.test()
    if model == "tagging":
        return reader_mod.shuffle(conll05.train(), 256, seed=0), \
            conll05.test()
    return line_samples(), None


def config(model="srl", n_batches=None):
    """The dict a ``get_config()`` returns: ``model`` at the demo's
    widths, with its readers in batches of ``BATCH[model]``, each pass
    capped at ``n_batches`` batches (None: all)."""
    cost, out = build(model)
    batch = BATCH[model]
    train, test = readers(model)
    cfg = {"cost": cost, "output": out, "optimizer": optimizer(model),
           "train_reader": reader_mod.firstn(reader_mod.batch(train, batch),
                                             n_batches),
           "feeding": feeding(model)}
    if test is not None:
        cfg["test_reader"] = reader_mod.firstn(reader_mod.batch(test, batch),
                                               n_batches)
    return cfg


def get_config():
    """The CLI's entry: ``CONFIG_ARGS`` ``model`` and ``batches``."""
    args = globals().get("CONFIG_ARGS", {})
    n = int(args["batches"]) if "batches" in args else None
    return config(args.get("model", "srl"), n_batches=n)
