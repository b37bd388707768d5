"""PTB n-gram LM (reference v2/dataset/imikolov.py: n-gram word ids).
A copy of ``paddle_tpu/data/datasets/imikolov.py``: its deterministic
synthetic stream (no download) gives the JAX loader's samples element
for element."""

import numpy as np

from paddle_tpu_torch.data.datasets._synth import rng_for

WORD_DIM = 2073


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(WORD_DIM)}


def _reader(split, n, ngram):
    def reader():
        rng = rng_for("imikolov", split)
        for _ in range(n):
            # markov-ish synthetic stream
            start = int(rng.randint(0, WORD_DIM))
            ids = [(start + k * 7) % WORD_DIM for k in range(ngram)]
            yield tuple(ids)
    return reader


def train(word_idx=None, n=5):
    return _reader("train", 4096, n)


def test(word_idx=None, n=5):
    return _reader("test", 512, n)
