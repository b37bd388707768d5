"""The text demos' networks as layer-DSL configs, on the imdb loader:
the trunks that ``trainer.SGD`` and ``python -m paddle_tpu_torch train``
run on word-id sequences.

``stacked_lstm_net`` is ``demo/sentiment/train.py:16-33`` (the
reference's demo/sentiment sentiment_net.py): embedding 128 -> fc hid
-> three stacked ``lstmemory`` layers of hid 128, each fed by an fc of
4 hid over the concat of the previous fc and LSTM, the middle one
reversed -> max pools of the last fc and LSTM -> fc 2 softmax, trained
with Adam (lr 0.002, l2 1e-4, clip_norm 5.0) at batch 64.  At hid 128
and batch 64 the LSTMs pass JAX's resident rule, so on the card each
runs the fused LSTM kernels (``ops/rnn.lstm``), the reversed one over
ragged reviews of 8-119 tokens.

``lr_net``, ``cnn_net`` and ``lstm_net`` are quick_start's
(``demo/quick_start/train.py:17-36``): embedding 64 -> sum pool -> fc 2
softmax; embedding 128 -> ``networks.sequence_conv_pool`` (a context
window of 3 in a 384-wide mixed layer, fc 256 relu, max pool: the
reference's network, ROADMAP C14) -> fc 2 softmax; embedding 128 ->
``networks.simple_lstm`` of 128 -> max pool -> fc 2 softmax; each
trained with Adam (lr 0.002) at batch 64.

``nested_lstm_net`` reads each review as sub-sequences (sentences) of
at most ``SUB_LEN`` tokens, the first ``MAX_SUBS`` of them: embedding
128 -> an average pool within each sub-sequence (``agg_level="seq"``,
a sequence of sentence vectors) -> fc of 4 hid -> ``lstmemory`` of hid
128 over the sentences -> max pool -> fc 2 softmax, with Adam (lr
0.002).  At hid 128 and batch 64 its LSTM runs the fused kernels over
1-8 sentences.

``nested_group_net`` reads the same sentences hierarchically, as a
nested ``recurrent_group`` over a ``SubsequenceInput`` of the
embedding: each outer step runs an fc of 4 hid and an ``lstmemory`` of
hid over one sentence, takes its ``last_seq``, and an fc of hid (tanh)
over it and the outer memory, the review's state so far; then
``last_seq`` over the sentences and fc 2 softmax, with Adam (lr 0.002).
The sentence LSTM passes JAX's resident rule at hid 128 and batch 64,
so the card runs the fused LSTM kernels once an outer step.

``get_config()`` selects by ``CONFIG_ARGS`` ``model`` (sentiment, the
default; lr, cnn, lstm, nested or nested_group) as the demos' ``get_config`` does:
``python -m paddle_tpu_torch train --config
paddle_tpu_torch/models/text_dsl.py --config_args model=lstm``
(``batches=N`` stops a pass after N batches).
"""

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.datasets import imdb
from paddle_tpu_torch.data.provider import (integer_value,
                                            integer_value_sequence,
                                            integer_value_sub_sequence)
from paddle_tpu_torch.optim import Adam

DICT_DIM = imdb.WORD_DIM
BATCH = 64
MODELS = ("sentiment", "lr", "cnn", "lstm", "nested", "nested_group")
SUB_LEN, MAX_SUBS = 16, 8


def stacked_lstm_net(words, label, hid=128, stacked_num=3, emb=128):
    """demo/sentiment's network: (cost, output)."""
    emb_l = L.embedding_layer(words, size=emb)
    fc1 = L.fc_layer(emb_l, size=hid, act=None)
    lstm1 = L.lstmemory(L.fc_layer(fc1, size=hid * 4, act=None,
                                   bias_attr=False), size=hid)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = L.fc_layer(L.concat_layer(inputs), size=hid, act=None)
        lstm = L.lstmemory(L.fc_layer(fc, size=hid * 4, act=None,
                                      bias_attr=False),
                           size=hid, reverse=(i % 2 == 0))
        inputs = [fc, lstm]
    fc_last = L.pooling_layer(inputs[0], pooling_type=L.pooling.Max)
    lstm_last = L.pooling_layer(inputs[1], pooling_type=L.pooling.Max)
    out = L.fc_layer(L.concat_layer([fc_last, lstm_last]), size=2,
                     act="softmax")
    return L.classification_cost(out, label), out


def lr_net(words, label, emb=64):
    """quick_start's lr network: (cost, output)."""
    emb_l = L.embedding_layer(words, size=emb)
    pooled = L.pooling_layer(emb_l, pooling_type=L.pooling.Sum)
    out = L.fc_layer(pooled, size=2, act="softmax")
    return L.classification_cost(out, label), out


def cnn_net(words, label, emb=128):
    """quick_start's cnn network: (cost, output)."""
    emb_l = L.embedding_layer(words, size=emb)
    conv = L.networks.sequence_conv_pool(emb_l, context_len=3,
                                         hidden_size=256)
    out = L.fc_layer(conv, size=2, act="softmax")
    return L.classification_cost(out, label), out


def lstm_net(words, label, hid=128, emb=128):
    """quick_start's lstm network: (cost, output)."""
    emb_l = L.embedding_layer(words, size=emb)
    lstm = L.networks.simple_lstm(emb_l, size=hid)
    pooled = L.pooling_layer(lstm, pooling_type=L.pooling.Max)
    out = L.fc_layer(pooled, size=2, act="softmax")
    return L.classification_cost(out, label), out


def nested_lstm_net(words, label, hid=128, emb=128):
    """A sentence-level LSTM over sub-sequences: (cost, output)."""
    emb_l = L.embedding_layer(words, size=emb)
    sents = L.pooling_layer(emb_l, pooling_type=L.pooling.Avg,
                            agg_level="seq")
    lstm = L.lstmemory(L.fc_layer(sents, size=hid * 4, act=None,
                                  bias_attr=False), size=hid)
    pooled = L.pooling_layer(lstm, pooling_type=L.pooling.Max)
    out = L.fc_layer(pooled, size=2, act="softmax")
    return L.classification_cost(out, label), out


def nested_group_net(words, label, hid=128, emb=128):
    """A hierarchical classifier, a nested recurrent_group over the
    sentences: (cost, output)."""
    emb_l = L.embedding_layer(words, size=emb)

    def sentence_step(sentence):
        doc = L.memory(name="doc_state", size=hid)
        lstm = L.lstmemory(L.fc_layer(sentence, size=hid * 4, act=None,
                                      bias_attr=False), size=hid)
        return L.fc_layer([L.last_seq(lstm), doc], size=hid, act="tanh",
                          name="doc_state")

    doc = L.recurrent_group(sentence_step, L.SubsequenceInput(emb_l))
    out = L.fc_layer(L.last_seq(doc), size=2, act="softmax")
    return L.classification_cost(out, label), out


_NETS = {"sentiment": stacked_lstm_net, "lr": lr_net, "cnn": cnn_net,
         "lstm": lstm_net, "nested": nested_lstm_net,
         "nested_group": nested_group_net}
_NESTED = ("nested", "nested_group")


def sentences(reader, sub_len=SUB_LEN, max_subs=MAX_SUBS):
    """``reader``'s (ids, label) samples as (sub-sequences, label): the
    review cut into consecutive pieces of ``sub_len`` tokens, the first
    ``max_subs`` of them."""
    def nested():
        for ids, label in reader():
            ids = list(ids)[:sub_len * max_subs]
            yield ([ids[i:i + sub_len] for i in range(0, len(ids), sub_len)]
                   or [[]], label)
    return nested


def build(model="sentiment", vocab=DICT_DIM, **sizes):
    """(cost, output) of ``model`` over a word vocabulary of ``vocab``,
    with a fresh layer-name registry; ``sizes`` (hid, emb) narrow it."""
    if model not in _NETS:
        raise ValueError(f"model={model!r}: one of {MODELS}")
    L.reset_names()
    words = L.data_layer("words", size=vocab, is_seq=True)
    label = L.data_layer("label", size=1)
    return _NETS[model](words, label, **sizes)


def optimizer(model="sentiment"):
    """The demo's optimizer: sentiment's Adam (lr 0.002, l2 1e-4,
    clip_norm 5.0), quick_start's (and the nested ones') Adam (lr
    0.002)."""
    if model == "sentiment":
        return Adam(learning_rate=0.002, l2=1e-4, clip_norm=5.0)
    return Adam(learning_rate=0.002)


def feeding(vocab=DICT_DIM, model="sentiment"):
    words = integer_value_sub_sequence if model in _NESTED \
        else integer_value_sequence
    return {"words": words(vocab), "label": integer_value(2)}


def config(model="sentiment", n_batches=None, batch=BATCH):
    """The dict a ``get_config()`` returns: ``model`` at the demo's
    widths, with the demos' readers (train: the imdb train split shuffled
    in a buffer of 512 with seed 0; test: the test split), in batches of
    ``batch``, each pass capped at ``n_batches`` batches (None: all)."""
    cost, out = build(model)
    train, test = imdb.train(), imdb.test()
    if model in _NESTED:
        train, test = sentences(train), sentences(test)
    return {"cost": cost, "output": out, "optimizer": optimizer(model),
            "train_reader": reader_mod.firstn(reader_mod.batch(
                reader_mod.shuffle(train, 512, seed=0), batch),
                n_batches),
            "test_reader": reader_mod.firstn(
                reader_mod.batch(test, batch), n_batches),
            "feeding": feeding(model=model)}


def get_config():
    """The CLI's entry: ``CONFIG_ARGS`` ``model`` and ``batches``."""
    args = globals().get("CONFIG_ARGS", {})
    n = int(args["batches"]) if "batches" in args else None
    return config(args.get("model", "sentiment"), n_batches=n)
