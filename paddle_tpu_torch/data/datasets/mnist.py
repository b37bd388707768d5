"""MNIST (reference python/paddle/v2/dataset/mnist.py: 28x28 grays in [-1,1],
labels 0-9).  Loads IDX files from PADDLE_TPU_DATA_DIR/mnist if present,
else synthesizes class-dependent digit-like blobs (learnable, deterministic).

A copy of ``paddle_tpu/data/datasets/mnist.py``: the synthetic
fallback gives its arrays element for element."""

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.data.datasets._synth import rng_for, local_path

IMG_SIZE = 784
NUM_CLASSES = 10


def _load_idx(img_path, lab_path):
    with gzip.open(img_path, "rb") as f:
        _, n, h, w = struct.unpack(">IIII", f.read(16))
        imgs = np.frombuffer(f.read(), np.uint8).reshape(n, h * w)
    with gzip.open(lab_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        labs = np.frombuffer(f.read(), np.uint8)
    return imgs.astype(np.float32) / 127.5 - 1.0, labs.astype(np.int32)


def _synth(split, n):
    rng = rng_for("mnist", split)
    labs = rng.randint(0, NUM_CLASSES, size=n).astype(np.int32)
    protos = rng_for("mnist", "protos").randn(NUM_CLASSES, IMG_SIZE).astype(np.float32)
    imgs = np.tanh(protos[labs] + 0.3 * rng.randn(n, IMG_SIZE).astype(np.float32))
    return imgs, labs


def _reader(split, n_synth):
    files = {
        "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
    }[split]
    ip, lp = (local_path("mnist", f) for f in files)

    def reader():
        if os.path.exists(ip) and os.path.exists(lp):
            imgs, labs = _load_idx(ip, lp)
        else:
            imgs, labs = _synth(split, n_synth)
        for x, y in zip(imgs, labs):
            yield x, int(y)
    return reader


def train():
    return _reader("train", 4096)


def test():
    return _reader("test", 512)
