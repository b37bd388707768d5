"""paddle.v2.reader (``paddle_tpu/v2/reader.py``; reference
v2/reader/decorator.py)."""

from paddle_tpu_torch.data.reader import (        # noqa: F401
    batch, buffered, chain, compose, firstn, map_readers, shuffle)
