"""paddle.v2.pooling (``paddle_tpu/v2/pooling.py``; reference
v2/pooling.py)."""

from paddle_tpu_torch.layers import pooling as _p

Max = _p.Max
Avg = _p.Avg
Sum = _p.Sum
SquareRootN = getattr(_p, "SquareRootN", _p.Avg)
