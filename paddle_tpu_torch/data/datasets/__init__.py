"""The datasets of the zoo (``paddle_tpu/data/datasets``; reference
python/paddle/v2/dataset/): mnist, cifar, imdb, movielens and conll05.  Each
loads from a local path when present (PADDLE_TPU_DATA_DIR, the JAX
package's variable) and otherwise falls back to a deterministic
synthetic generator with the same sample schema, which gives the JAX
package's samples element for element.  The other text loaders
(sentiment, imikolov, uci_housing, wmt14) are not ported yet (ROADMAP
A10·b)."""

from paddle_tpu_torch.data.datasets import (cifar, conll05, imdb, mnist,
                                            movielens)

__all__ = ["mnist", "cifar", "imdb", "movielens", "conll05"]
