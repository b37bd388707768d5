"""MovieLens recommender (``paddle_tpu/models/recommendation.py``;
reference demo/recommendation: user / movie feature towers -> cos-sim
rating regression, the sparse-CTR config of BASELINE.json).

Parameters are a nested dict with the JAX tree's keys:

    {"user_emb": [max_user + 1, E], "gender_emb": [genders, E/8],
     "age_emb": [ages, E/8], "job_emb": [jobs, E/8],
     "user_fc": {"w": [E + 3 E/8, H], "b": [H]},
     "movie_emb": [max_movie + 1, E], "cat_emb": [categories, E/4],
     "title_emb": [title_vocab, E/2],
     "movie_fc": {"w": [E + E/4 + E/2, H], "b": [H]}}

The tables are dense, as in JAX: the sparse row update is ROADMAP A9·f
and the tables' sharding A12.  The JAX package leaves the towers to XLA,
so they are PyTorch calls here; on the card the embedding backward
accumulates its rows with atomics.
"""

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import SequenceBatch, pad_sequences
from paddle_tpu_torch.models import _image
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.ops import initializers, linear, math_ops
from paddle_tpu_torch.ops import sequence as seq_ops


def init(generator, max_user=6040, max_movie=3952, ages=7, jobs=21,
         genders=2, categories=18, title_vocab=5174, emb=256, hidden=256,
         device=None):
    """The JAX ``init``'s rules (tables U(-0.05, 0.05), tower weights
    normal with std 1/sqrt(fan_in), zero biases) on ``generator``'s
    draws, placed on ``device`` (the card unless "cpu")."""
    gen = generator
    u, n = initializers.uniform(0.05), initializers.normal()
    params = {
        "user_emb": u(gen, (max_user + 1, emb)),
        "gender_emb": u(gen, (genders, emb // 8)),
        "age_emb": u(gen, (ages, emb // 8)),
        "job_emb": u(gen, (jobs, emb // 8)),
        "user_fc": {"w": n(gen, (emb + 3 * (emb // 8), hidden)),
                    "b": torch.zeros(hidden, device=gen.device)},
        "movie_emb": u(gen, (max_movie + 1, emb)),
        "cat_emb": u(gen, (categories, emb // 4)),
        "title_emb": u(gen, (title_vocab, emb // 2)),
        "movie_fc": {"w": n(gen, (emb + emb // 4 + emb // 2, hidden)),
                     "b": torch.zeros(hidden, device=gen.device)},
    }
    return _image.on_device(params, _device.resolve(device))


def params_from_numpy(tree, device=None, **kw):
    """The JAX tree as numpy arrays -> the port's, float32 on ``device``;
    ``kw`` are ``init``'s sizes, against which keys and shapes are
    checked."""
    want = init(torch.Generator().manual_seed(0), device="cpu", **kw)
    return _image.from_numpy(tree, want, device)


def forward(params, uid, gender, age, job, mid, categories, title):
    """categories: multi-hot [B, n_cat]; title: SequenceBatch of word
    ids.  Returns the predicted rating [B] in [-5, 5] (reference: 5 *
    cos_sim)."""
    uf = torch.cat([
        emb_ops.embedding_lookup(params["user_emb"], uid),
        emb_ops.embedding_lookup(params["gender_emb"], gender),
        emb_ops.embedding_lookup(params["age_emb"], age),
        emb_ops.embedding_lookup(params["job_emb"], job),
    ], dim=-1)
    user_vec = torch.tanh(linear.matmul(uf, params["user_fc"]["w"])
                          + params["user_fc"]["b"])

    cat_vec = linear.matmul(categories, params["cat_emb"])
    title_emb = emb_ops.embedding_lookup(params["title_emb"], title.data)
    title_vec = seq_ops.seq_avg_pool(SequenceBatch(title_emb, title.lengths))
    mf = torch.cat([
        emb_ops.embedding_lookup(params["movie_emb"], mid), cat_vec,
        title_vec,
    ], dim=-1)
    movie_vec = torch.tanh(linear.matmul(mf, params["movie_fc"]["w"])
                           + params["movie_fc"]["b"])
    return 5.0 * math_ops.cos_sim(user_vec, movie_vec)[:, 0]


def loss(params, uid, gender, age, job, mid, categories, title, score):
    pred = forward(params, uid, gender, age, job, mid, categories, title)
    return torch.mean(0.5 * torch.square(pred - score))


def feed_batch(batch, n_categories=18, device=None):
    """A batch of movielens samples (``data/datasets/movielens``' 8
    slots) -> the 8 tensors ``loss`` takes, on ``device`` (the card
    unless "cpu"): the demo's ``feed_batch``
    (``demo/recommendation/train.py:19-31``): int32 ids, the categories
    multi-hot float32, the title padded with its lengths, float32
    scores."""
    dev = _device.resolve(device)

    def ids(i):
        return torch.tensor(np.asarray([b[i] for b in batch], np.int32),
                            device=dev)

    cats = np.zeros((len(batch), n_categories), np.float32)
    for i, b in enumerate(batch):
        cats[i, np.asarray(b[5], np.int64)] = 1.0
    title = pad_sequences([np.asarray(b[6], np.int32) for b in batch],
                          device=dev)
    score = torch.tensor(np.asarray([b[7] for b in batch], np.float32),
                         device=dev)
    return (ids(0), ids(1), ids(2), ids(3), ids(4),
            torch.tensor(cats, device=dev), title, score)
