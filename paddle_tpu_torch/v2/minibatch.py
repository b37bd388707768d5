"""paddle.v2.minibatch (``paddle_tpu/v2/minibatch.py``; reference
v2/minibatch.py:1): batch(reader, size)."""

from paddle_tpu_torch.data.reader import batch  # noqa: F401
