"""The datasets of the zoo (``paddle_tpu/data/datasets``; reference
python/paddle/v2/dataset/): mnist, cifar, imdb, imikolov, movielens,
conll05, sentiment, uci_housing and wmt14.  Each loads from a local path
when present (PADDLE_TPU_DATA_DIR, the JAX package's variable) or falls
back to a deterministic synthetic generator with the same sample
schema, which gives the JAX package's samples element for element.
Nothing is downloaded (the JAX package's ``common.py`` only downloads,
so it has no twin)."""

from paddle_tpu_torch.data.datasets import (cifar, conll05, imdb, imikolov,
                                            mnist, movielens, sentiment,
                                            uci_housing, wmt14)

__all__ = ["mnist", "cifar", "imdb", "imikolov", "movielens", "conll05",
           "sentiment", "uci_housing", "wmt14"]
