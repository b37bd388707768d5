"""Elementwise and small-algebra layer ops (``paddle_tpu/ops/math_ops.py``).

Reference zoo (SURVEY.md §2.2 "Dense/basic layers"): AddtoLayer,
InterpolationLayer, PowerLayer, ScalingLayer, SlopeInterceptLayer,
SumToOneNormLayer, CosSimLayer, CosSimVecMatLayer, OuterProdLayer,
TransLayer, RotateLayer, MultiplexLayer, ConvShiftLayer, TensorLayer,
FeatureMapExpandLayer, ResizeLayer, DataNormLayer, ParameterReluLayer.

Plain functions on tensors, the JAX package's formulas one for one: the
JAX package leaves them to XLA, so they are PyTorch calls here (no
kernel stands behind them).
"""

import torch

from paddle_tpu_torch.ops import activations


def addto(*xs, bias=None, act=None):
    y = xs[0]
    for x in xs[1:]:
        y = y + x
    if bias is not None:
        y = y + bias
    return activations.get(act)(y)


def _per_row(v, x):
    """A per-row scalar [...] (or [..., 1]) broadcast against x [..., D]."""
    return v[..., None] if v.dim() == x.dim() - 1 else v


def interpolation(w, a, b):
    """w in [0,1] per-row: w*a + (1-w)*b.  w: [..., 1] or [...]."""
    w = _per_row(w, a)
    return w * a + (1.0 - w) * b


def power(p, x):
    """Per-row exponent: x ** p (reference PowerLayer)."""
    return x ** _per_row(p, x)


def scaling(s, x):
    """Per-row scalar scale (reference ScalingLayer)."""
    return _per_row(s, x) * x


def slope_intercept(x, slope=1.0, intercept=0.0):
    return slope * x + intercept


def sum_to_one_norm(x, eps=1e-12):
    return x / (torch.sum(x, dim=-1, keepdim=True) + eps)


def cos_sim(a, b, scale=1.0, eps=1e-8):
    """Row-wise cosine similarity -> [..., 1] (reference CosSimLayer,
    scale=5): the product of the norms floored at ``eps``."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    na = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
    nb = torch.sqrt(torch.sum(b * b, dim=-1, keepdim=True))
    return scale * dot / torch.clamp(na * nb, min=eps)


def cos_sim_vec_mat(vec, mat, scale=1.0, eps=1e-8):
    """vec [B, D], mat [B, K, D] -> [B, K] cos sims (CosSimVecMatLayer)."""
    dot = torch.einsum("bd,bkd->bk", vec, mat)
    nv = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    nm = torch.linalg.vector_norm(mat, dim=-1)
    return scale * dot / torch.clamp(nv * nm, min=eps)


def outer_prod(a, b):
    """[B, M], [B, N] -> [B, M*N] (reference OuterProdLayer)."""
    out = torch.einsum("bm,bn->bmn", a, b)
    return out.reshape(out.shape[0], -1)


def trans(x):
    """The whole batch matrix transposed (reference TransLayer)."""
    return x.T


def rotate(x, height, width):
    """Rotate each row's [C, H, W] feature map 90° CCW (reference
    RotateLayer)."""
    b = x.shape[0]
    c = x.shape[-1] // (height * width)
    img = x.reshape(b, c, height, width)
    return torch.rot90(img, k=1, dims=(2, 3)).reshape(b, -1)


def multiplex(index, *xs):
    """Per-row select among K same-shaped inputs (reference
    MultiplexLayer).  index: int [B] or [B, 1]; xs: K tensors [B, D]."""
    stacked = torch.stack(xs, dim=1)                     # [B, K, D]
    idx = torch.clamp(index.reshape(index.shape[0]).long(), 0, len(xs) - 1)
    return stacked[torch.arange(stacked.shape[0], device=stacked.device),
                   idx]


def conv_shift(a, b):
    """Circular convolution (reference ConvShiftLayer, NTM-style shift).
    a: [B, M], b: [B, N] (N odd, N < M) -> [B, M]."""
    m, n = a.shape[-1], b.shape[-1]
    half = n // 2
    idx = (torch.arange(m, device=a.device)[:, None]
           + torch.arange(-half, half + 1, device=a.device)[None, :]) % m
    return torch.einsum("bmn,bn->bm", a[:, idx], b)


def tensor_product(a, b, w, act=None):
    """Reference TensorLayer: y_k = a @ W_k @ b^T.
    a: [B, M], b: [B, N], w: [K, M, N] -> [B, K]."""
    return activations.get(act)(torch.einsum("bm,kmn,bn->bk", a, w, b))


def feature_map_expand(x, num_filters, as_row_vector=True):
    """[B, D] -> [B, num_filters*D] by tiling (reference
    FeatureMapExpandLayer).  as_row_vector=True: num_filters copies of
    the whole row; False: each element repeated num_filters times in
    place."""
    if as_row_vector:
        tiled = x[:, None, :].expand(-1, num_filters, -1)
    else:
        tiled = x[:, :, None].expand(-1, -1, num_filters)
    return tiled.reshape(x.shape[0], -1)


def resize(x, size):
    """Reinterpret batch rows with a new row width (reference
    ResizeLayer)."""
    return x.reshape(-1, size)


def prelu(x, alpha):
    """ParameterReluLayer: per-partition learned negative slope."""
    return torch.where(x >= 0, x, alpha * x)


def data_norm(x, mean, std_inv, strategy="z-score", min_=None,
              span_inv=None):
    """DataNormLayer: z-score / min-max normalization with precomputed
    stats."""
    if strategy == "min-max":
        return (x - min_) * span_inv
    return (x - mean) * std_inv


def pad_value_replace(x, mask, value=0.0):
    return torch.where(mask > 0, x, value)
