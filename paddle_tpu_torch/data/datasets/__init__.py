"""The image datasets of the zoo (``paddle_tpu/data/datasets``; reference
python/paddle/v2/dataset/): mnist and cifar.  Each loads from a local
path when present (PADDLE_TPU_DATA_DIR, the JAX package's variable) and
otherwise falls back to a deterministic synthetic generator with the
same sample schema, which gives the JAX package's arrays element for
element.  The text and other datasets are not ported yet (ROADMAP
A9·f)."""

from paddle_tpu_torch.data.datasets import cifar, mnist

__all__ = ["mnist", "cifar"]
