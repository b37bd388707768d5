"""demo/word2vec as a layer-DSL config (``demo/word2vec/train.py:17-41``;
the reference's demo/word2vec over the imikolov n-grams): the network
that ``trainer.SGD`` and ``python -m paddle_tpu_torch train`` run.

A 5-gram: the four context words (vocab ``imikolov.WORD_DIM``, 2073)
each through an ``embedding_layer`` of 32 that shares one table
(``param_attr={"name": "emb"}``: its gradient is the sum over the four)
-> ``concat_layer`` -> ``fc_layer(128, sigmoid)`` -> the fifth word's
cost, ``hsigmoid`` over the vocab (the default) or a softmax ``fc`` of
the vocab with ``classification_cost``; AdaGrad lr 0.1 at batch 64.
No kernel of the port's own is on this path: the lookups, products,
the hierarchical sigmoid and AdaGrad are PyTorch calls, as they are
XLA's in JAX.

``get_config()`` selects by ``CONFIG_ARGS`` ``use_hsigmoid`` (1, the
default, or 0), as the demo's ``get_config(use_hsigmoid)`` does:
``python -m paddle_tpu_torch train --config
paddle_tpu_torch/models/word2vec_dsl.py --config_args use_hsigmoid=0``
(``batches=N`` stops a pass after N batches).
"""

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.datasets import imikolov
from paddle_tpu_torch.data.provider import integer_value
from paddle_tpu_torch.optim import AdaGrad

EMB = 32
HIDDEN = 128
N = 5          # the n-gram's order
BATCH = 64


def build(use_hsigmoid=True):
    """(cost, output) of the demo's network over the imikolov vocab, with
    a fresh layer-name registry."""
    vocab = imikolov.WORD_DIM
    L.reset_names()
    words = [L.data_layer(f"w{i}", size=vocab) for i in range(N - 1)]
    target = L.data_layer("target", size=1)
    embs = [L.embedding_layer(w, size=EMB, param_attr={"name": "emb"})
            for w in words]
    hidden = L.fc_layer(L.concat_layer(embs), size=HIDDEN, act="sigmoid")
    if use_hsigmoid:
        return L.hsigmoid(hidden, target, num_classes=vocab), hidden
    pred = L.fc_layer(hidden, size=vocab, act="softmax")
    return L.classification_cost(pred, target), pred


def optimizer():
    return AdaGrad(learning_rate=0.1)


def feeding():
    out = {f"w{i}": integer_value(imikolov.WORD_DIM) for i in range(N - 1)}
    out["target"] = integer_value(imikolov.WORD_DIM)
    return out


def config(use_hsigmoid=True, n_batches=None):
    """The dict a ``get_config()`` returns: the demo's network and
    optimizer over the imikolov train n-grams in batches of ``BATCH``,
    each pass capped at ``n_batches`` batches (None: all 64)."""
    cost, out = build(use_hsigmoid)
    return {"cost": cost, "output": out, "optimizer": optimizer(),
            "train_reader": reader_mod.firstn(
                reader_mod.batch(imikolov.train(n=N), BATCH), n_batches),
            "test_reader": reader_mod.firstn(
                reader_mod.batch(imikolov.test(n=N), BATCH), n_batches),
            "feeding": feeding()}


def get_config():
    """The CLI's entry: ``CONFIG_ARGS`` ``use_hsigmoid`` and ``batches``."""
    args = globals().get("CONFIG_ARGS", {})
    n = int(args["batches"]) if "batches" in args else None
    use_hsigmoid = args.get("use_hsigmoid", "1").lower() not in (
        "0", "false", "no")
    return config(use_hsigmoid, n_batches=n)
