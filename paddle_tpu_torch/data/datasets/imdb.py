"""IMDB sentiment (reference v2/dataset/imdb.py: word-id sequence + 0/1
label, built from the aclImdb tarball's train/{pos,neg}/*.txt reviews).

Real data: point PADDLE_TPU_DATA_DIR at a directory containing `aclImdb/`
(the extracted Stanford tarball).  Without it, a synthetic fallback keeps
air-gapped runs working: two token distributions, learnable and
deterministic.

A copy of ``paddle_tpu/data/datasets/imdb.py``: the synthetic fallback
gives its samples element for element."""

import os

import numpy as np

from paddle_tpu_torch.data.datasets._synth import local_path, rng_for, \
    tokenize as _tokenize

WORD_DIM = 5147  # compact synthetic vocab


def _acl_dir():
    return local_path("aclImdb")


def _review_files(split, polarity):
    d = os.path.join(_acl_dir(), split, polarity)
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".txt"))


_dict_cache = {}


def word_dict(cutoff=1):
    """Frequency-ordered word dict over the train split (reference
    imdb.word_dict(): ids ordered by descending frequency).  Synthetic
    fallback: identity vocab.  Built once per data dir (full corpus scan)."""
    if not os.path.isdir(_acl_dir()):
        return {f"w{i}": i for i in range(WORD_DIM)}
    key = (_acl_dir(), cutoff)
    if key in _dict_cache:
        return _dict_cache[key]
    freq = {}
    for pol in ("pos", "neg"):
        for path in _review_files("train", pol):
            with open(path, encoding="utf-8", errors="ignore") as f:
                for tok in _tokenize(f.read()):
                    freq[tok] = freq.get(tok, 0) + 1
    words = [w for w, c in sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
             if c >= cutoff]
    d = {w: i for i, w in enumerate(words)}
    d["<unk>"] = len(d)
    _dict_cache[key] = d
    return d


def _real_reader(split, word_idx):
    unk = word_idx.get("<unk>", len(word_idx) - 1)

    def read_one(path):
        with open(path, encoding="utf-8", errors="ignore") as f:
            return [word_idx.get(t, unk) for t in _tokenize(f.read())]

    def reader():
        # interleave pos/neg deterministically (the reference shuffles the
        # tarball walk; interleaving keeps batches label-balanced)
        pos = _review_files(split, "pos")
        neg = _review_files(split, "neg")
        for i in range(max(len(pos), len(neg))):
            if i < len(pos):
                yield read_one(pos[i]), 0
            if i < len(neg):
                yield read_one(neg[i]), 1
    return reader


def _synth_reader(split, n):
    def reader():
        rng = rng_for("imdb", split)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 120))
            # label polarity matches the real reader (and the reference):
            # 0 = positive (low-id skew), 1 = negative (high-id skew)
            center = WORD_DIM // 4 if label == 0 else 3 * WORD_DIM // 4
            ids = np.clip(rng.normal(center, WORD_DIM // 6, size=length),
                          0, WORD_DIM - 1).astype(np.int64)
            yield list(ids), label
    return reader


def _reader(split, n, word_idx):
    if os.path.isdir(os.path.join(_acl_dir(), split)):
        return _real_reader(split, word_idx if word_idx is not None
                            else word_dict())
    return _synth_reader(split, n)


def train(word_idx=None):
    return _reader("train", 2048, word_idx)


def test(word_idx=None):
    return _reader("test", 256, word_idx)
