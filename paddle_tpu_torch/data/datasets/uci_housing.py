"""UCI housing regression (reference v2/dataset/uci_housing.py: 13
features, a scalar price), a deterministic synthetic linear set (no
download).  A copy of ``paddle_tpu/data/datasets/uci_housing.py``: the
same samples element for element."""

import numpy as np

from paddle_tpu_torch.data.datasets._synth import rng_for

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                 "RAD", "TAX", "PTRATIO", "B", "LSTAT"]
DIM = 13
_W = rng_for("uci", "w").randn(DIM).astype(np.float32)


def _reader(split, n):
    def reader():
        rng = rng_for("uci_housing", split)
        for _ in range(n):
            x = rng.randn(DIM).astype(np.float32)
            y = float(x @ _W + 0.1 * rng.randn())
            yield x, np.array([y], np.float32)
    return reader


def train():
    return _reader("train", 404)


def test():
    return _reader("test", 102)
