"""CIFAR-10/100 (reference v2/dataset/cifar.py: 3x32x32 float rows + label).

A copy of ``paddle_tpu/data/datasets/cifar.py``: the synthetic
fallback gives its arrays element for element."""

import os
import pickle

import numpy as np

from paddle_tpu_torch.data.datasets._synth import rng_for, local_path

DIM = 3 * 32 * 32


def _synth(split, n, num_classes):
    rng = rng_for("cifar", (split, num_classes))
    labs = rng.randint(0, num_classes, size=n).astype(np.int32)
    protos = rng_for("cifar", ("protos", num_classes)).randn(
        num_classes, DIM).astype(np.float32)
    imgs = np.tanh(protos[labs] * 0.5 + 0.5 * rng.randn(n, DIM).astype(np.float32))
    return imgs, labs


def _reader(split, num_classes, n_synth):
    batch_dir = local_path("cifar", "cifar-10-batches-py")

    def reader():
        if num_classes == 10 and os.path.isdir(batch_dir):
            names = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" \
                else ["test_batch"]
            for nm in names:
                with open(os.path.join(batch_dir, nm), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                for x, y in zip(d[b"data"], d[b"labels"]):
                    yield x.astype(np.float32) / 255.0, int(y)
        else:
            imgs, labs = _synth(split, n_synth, num_classes)
            for x, y in zip(imgs, labs):
                yield x, int(y)
    return reader


def train10():
    return _reader("train", 10, 4096)


def test10():
    return _reader("test", 10, 512)


def train100():
    return _reader("train", 100, 4096)


def test100():
    return _reader("test", 100, 512)
