"""Synthetic data helpers shared by the dataset modules
(``paddle_tpu/data/datasets/_synth.py``, a copy: the same seeds give
the same arrays)."""

import os
import zlib

import numpy as np


def data_dir():
    """Resolved at call time so a caller can set PADDLE_TPU_DATA_DIR
    after import."""
    return os.environ.get("PADDLE_TPU_DATA_DIR",
                          os.path.expanduser("~/.cache/paddle_tpu/dataset"))


def rng_for(name, split):
    # crc32, not hash(): str hash is salted per process and synthetic
    # datasets must be reproducible across runs
    key = f"{name}:{split!r}".encode()
    return np.random.RandomState(zlib.crc32(key) % (2 ** 31))


def local_path(*parts):
    return os.path.join(data_dir(), *parts)


_TOKEN = None


def tokenize(text):
    """Lowercased word tokens (shared by the text datasets)."""
    global _TOKEN
    if _TOKEN is None:
        import re
        _TOKEN = re.compile(r"[A-Za-z0-9']+")
    return [t.lower() for t in _TOKEN.findall(text)]
