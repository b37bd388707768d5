"""paddle.v2.dataset (``paddle_tpu/v2/dataset.py``; reference
v2/dataset/: mnist, cifar, imdb, imikolov, movielens, conll05,
uci_housing, wmt14, with download and cache through common.download):
the port's loaders.  Real files load from PADDLE_TPU_DATA_DIR; without
them each loader falls back to deterministic synthetic data with the
real schema (``data/datasets/_synth.py``).  ``common`` is left out: the
JAX package's ``data/datasets/common.py`` only downloads and waits, and
the port fetches nothing."""

from paddle_tpu_torch.data.datasets import (      # noqa: F401
    cifar, conll05, imdb, imikolov, mnist, movielens, sentiment,
    uci_housing, wmt14)
