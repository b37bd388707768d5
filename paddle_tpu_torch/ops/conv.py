"""Convolution and vision ops, NHWC (``paddle_tpu/ops/conv.py``;
reference ExpandConvLayer / CudnnConvLayer, PoolLayer, NormLayer (LRN
cross-map), MaxOutLayer, BilinearInterpLayer, BlockExpandLayer,
SpatialPyramidPoolLayer, PadLayer, PriorBox; the output-size rule of
math/MathUtils.cpp).

The JAX package's layouts stay at every function here: activations
NHWC, weights HWIO ([kh, kw, Cin / groups, Cout]), so its parameter
trees and checkpoints carry over unchanged.  On the call path the
convolutions run ``F.conv2d`` / ``F.conv_transpose2d`` on
``x.permute(0, 3, 1, 2)`` (an NCHW view, channels-last in memory where
x is a dense NHWC tensor) and ``w.permute(3, 2, 0, 1)``, and permute
back; cuDNN takes the views as they lie (making every input
channels-last first left ResNet-50's train step unchanged on the card:
PERF.md §6).  In JAX these ops are XLA's (``conv_general_dilated``,
``reduce_window``, ``jnp``); the port's kernel rule sends them to the
matching PyTorch calls, so no kernel here is the port's own.

The dtype policy (``core/dtypes``) as JAX's ``conv2d`` has it: x and w
cast to ``compute_dtype()``, the sum accumulated and returned in float32
(``preferred_element_type=float32``).  Under the float32 policy that is
``F.conv2d`` in float32 (a bf16 or float16 operand widened first; TF32
off on the card, ``device.resolve``).  Under a low-precision policy the
operands are ROUNDED to it and convolved in float32 -- never a bf16
``F.conv2d``, whose output rounds the accumulator -- and the backward
rounds the cotangent to the operand dtype before its two products and
each gradient to its operand's dtype once (``_LowConv``), as JAX's
custom vjp does.

Pools pad explicitly (max with -inf, avg with zeros) and never lean on
torch's ``ceil_mode`` / ``count_include_pad``: the reference's ceil-mode
overhang comes in as asymmetric padding, and ``avg_pool2d`` divides by
the count of real cells only where there is padding, by the window's
area otherwise, as JAX's does.
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.ops import activations

_LOW = (torch.bfloat16, torch.float16)


class _LowConv(torch.autograd.Function):
    """``fn(x, w)`` on operands already rounded to a low-precision dtype,
    computed in float32; the backward differentiates the same float32
    call with the cotangent rounded to x's dtype and rounds dx and dw to
    their operands' dtypes (JAX's ``_conv_f32acc`` vjp)."""

    @staticmethod
    def forward(ctx, x, w, fn):
        xf = x.detach().float().requires_grad_(True)
        wf = w.detach().float().requires_grad_(True)
        with torch.enable_grad():
            y = fn(xf, wf)
        ctx.graph = (xf, wf, y)
        ctx.dtypes = (x.dtype, w.dtype)
        return y.detach()

    @staticmethod
    def backward(ctx, g):
        xf, wf, y = ctx.graph
        dx, dw = torch.autograd.grad(y, (xf, wf),
                                     g.to(ctx.dtypes[0]).float())
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None


def _policy_call(fn, x, w):
    """``fn(x, w)`` (NCHW views in, NCHW out) under the dtype policy: the
    float32 accumulator of the operands in the compute dtype."""
    cd = dtypes.compute_dtype()
    if cd in _LOW:
        return _LowConv.apply(x.to(cd), w.to(cd), fn)
    if x.dtype in _LOW:
        x = x.float()
    if w.dtype in _LOW:
        w = w.float()
    return fn(x.to(cd), w.to(cd))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv_output_size(in_size, filter_size, stride, padding):
    """Reference math/MathUtils.cpp outputSize (caffeMode=True):
    (in + 2*pad - filter) / stride + 1."""
    return (in_size + 2 * padding - filter_size) // stride + 1


def conv2d(x, w, b=None, stride=(1, 1), padding=(0, 0), groups=1,
           dilation=(1, 1), act=None):
    """x: [B, H, W, Cin], w: [kh, kw, Cin/groups, Cout] -> [B, H', W',
    Cout] in float32 (the accumulator)."""
    def fn(xc, wc):
        return F.conv2d(xc, wc, stride=tuple(stride), padding=tuple(padding),
                        dilation=tuple(dilation), groups=groups)
    y = _nhwc(_policy_call(fn, _nchw(x), w.permute(3, 2, 0, 1)))
    if b is not None:
        y = y + b
    return activations.get(act)(y)


def conv2d_transpose(x, w, b=None, stride=(1, 1), padding=(0, 0), act=None):
    """Gradient-of-conv deconvolution (reference ExpandConvTransLayer).
    w: [kh, kw, Cout, Cin] stored like the forward conv's weight.  JAX's
    form -- the input dilated by the stride, convolved with w flipped
    and its channel axes swapped at padding k - 1 - p -- is
    ``F.conv_transpose2d`` with the weight [Cin, Cout, kh, kw] =
    ``w.permute(3, 2, 0, 1)``."""
    def fn(xc, wc):
        return F.conv_transpose2d(xc, wc, stride=tuple(stride),
                                  padding=tuple(padding))
    y = _nhwc(_policy_call(fn, _nchw(x), w.permute(3, 2, 0, 1)))
    if b is not None:
        y = y + b
    return activations.get(act)(y)


def _pool_pad(padding):
    """(ph, pw) symmetric or ((plo, phi), (plo, phi)) asymmetric ->
    ``F.pad``'s (w_lo, w_hi, h_lo, h_hi)."""
    ph, pw = padding
    ph = tuple(ph) if isinstance(ph, (tuple, list)) else (ph, ph)
    pw = tuple(pw) if isinstance(pw, (tuple, list)) else (pw, pw)
    return pw + ph


def max_pool2d(x, window, stride=None, padding=(0, 0)):
    """Max over windows of NHWC ``x``, padded with -inf (JAX's
    ``reduce_window`` with -inf as its init)."""
    stride = stride or window
    pad = _pool_pad(padding)
    xc = _nchw(x)
    if any(pad):
        xc = F.pad(xc, pad, value=float("-inf"))
    return _nhwc(F.max_pool2d(xc, tuple(window), tuple(stride)))


def avg_pool2d(x, window, stride=None, padding=(0, 0), exclude_pad=True):
    """Mean over windows of NHWC ``x``: with padding (and
    ``exclude_pad``) the window's sum over the count of its real cells,
    else over the window's area."""
    stride = stride or window
    pad = _pool_pad(padding)
    window, stride = tuple(window), tuple(stride)

    def window_sum(t):
        return F.avg_pool2d(F.pad(t, pad) if any(pad) else t, window,
                            stride, divisor_override=1)
    summed = window_sum(_nchw(x))
    if exclude_pad and any(pad):
        ones = torch.ones((1, 1) + x.shape[1:3], dtype=x.dtype,
                          device=x.device)
        return _nhwc(summed / torch.clamp(window_sum(ones), min=1.0))
    return _nhwc(summed / float(window[0] * window[1]))


def lrn_cross_map(x, size=5, scale=1e-4, power=0.75):
    """Local response norm across channels (reference NormProjectionLayer,
    'cmrnorm-projection'): out = x * (1 + scale/size * sum(x^2))^-power,
    the window ``size // 2`` channels in front and ``size - 1 - size //
    2`` behind, summed by the JAX package's running sum."""
    sq = torch.square(x)
    half = size // 2
    padded = F.pad(sq, (half, size - 1 - half))
    acc = torch.cumsum(padded, dim=-1)
    acc = torch.cat([torch.zeros_like(acc[..., :1]), acc], dim=-1)
    window = acc[..., size:] - acc[..., :-size]
    denom = (1.0 + (scale / size) * window) ** power
    return x / denom


def cross_channel_norm(x, scale):
    """L2-normalize across channels then scale per channel (reference
    CrossChannelNormLayer, SSD)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True)
                      + 1e-10)
    return x / norm * scale


def maxout(x, groups):
    """Channel maxout (reference MaxOutLayer): Cout = Cin/groups."""
    b, h, w, c = x.shape
    return torch.amax(x.reshape(b, h, w, c // groups, groups), dim=-1)


def _resize_weights(n_in, n_out, device):
    """The [n_in, n_out] float32 weights of ``jax.image.resize``'s
    bilinear (triangle) kernel along one axis, antialiased (its default):
    when shrinking, the kernel is widened by n_in / n_out; each column is
    normalized by its sum, and a sample outside the input is 0."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - dist, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def bilinear_interp(x, out_h, out_w):
    """Bilinear resize (reference BilinearInterpLayer) as
    ``jax.image.resize(method="bilinear")`` computes it, antialiased
    when shrinking (``F.interpolate`` is not: it differs there); an axis
    whose size stays is left as it is."""
    y = x
    if out_h != x.shape[1]:
        y = torch.einsum("bhwc,hH->bHwc", y,
                         _resize_weights(x.shape[1], out_h, x.device)
                         .to(x.dtype))
    if out_w != x.shape[2]:
        y = torch.einsum("bhwc,wW->bhWc", y,
                         _resize_weights(x.shape[2], out_w, x.device)
                         .to(x.dtype))
    return y


def pad_chw(x, pad_c=(0, 0), pad_h=(0, 0), pad_w=(0, 0)):
    """Reference PadLayer pads (C, H, W) of NCHW; here NHWC."""
    return F.pad(x, tuple(pad_c) + tuple(pad_w) + tuple(pad_h))


def block_expand(x, block, stride, padding=(0, 0)):
    """im2col as a layer (reference BlockExpandLayer): NHWC -> [B,
    num_blocks, C*block_h*block_w] patch sequence, each patch channel
    major (c, kh, kw) as JAX's ``conv_general_dilated_patches`` orders
    it, which ``F.unfold`` shares."""
    xc = F.pad(_nchw(x), (padding[1], padding[1], padding[0], padding[0]))
    patches = F.unfold(xc, tuple(block), stride=tuple(stride))
    return patches.transpose(1, 2)


def adaptive_pool2d(x, bins, pool_type="max"):
    """Pool NHWC to an exact [B, bins, bins, C] regardless of input size,
    with the JAX package's uneven window bounds: bin i spans [i*h //
    bins, max(ceil((i+1)*h / bins), i*h // bins + 1))."""
    h, w = x.shape[1], x.shape[2]

    def reduce(v):
        return torch.amax(v, dim=(1, 2)) if pool_type == "max" \
            else torch.mean(v, dim=(1, 2))
    rows = []
    for i in range(bins):
        hs = (i * h) // bins
        he = max(-(-((i + 1) * h) // bins), hs + 1)
        cols = []
        for j in range(bins):
            ws = (j * w) // bins
            we = max(-(-((j + 1) * w) // bins), ws + 1)
            cols.append(reduce(x[:, hs:he, ws:we, :]))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)


def spatial_pyramid_pool(x, pyramid_height, pool_type="max"):
    """Reference SpatialPyramidPoolLayer: the pooled maps at 1x1, 2x2,
    ... 2^(h-1) bins, each flattened NHWC, concatenated: C * sum(4^level)
    wide whatever the input's size."""
    b = x.shape[0]
    return torch.cat([adaptive_pool2d(x, 2 ** level, pool_type).reshape(
        b, -1) for level in range(pyramid_height)], dim=-1)


def prior_box(feature_shape, image_shape, min_sizes, max_sizes,
              aspect_ratios, variance=(0.1, 0.1, 0.2, 0.2), clip=True,
              device="cpu"):
    """SSD prior boxes (reference PriorBox layer): [num_priors, 8], each
    box's corners over the image's size (clipped to [0, 1]) and its
    variance, float32 on ``device``."""
    fh, fw = feature_shape
    ih, iw = image_shape
    step_h, step_w = ih / fh, iw / fw
    boxes = []
    for y in range(fh):
        for x in range(fw):
            cx, cy = (x + 0.5) * step_w, (y + 0.5) * step_h
            for k, ms in enumerate(min_sizes):
                boxes.append([cx - ms / 2, cy - ms / 2, cx + ms / 2,
                              cy + ms / 2])
                if max_sizes:
                    sz = (ms * max_sizes[k]) ** 0.5
                    boxes.append([cx - sz / 2, cy - sz / 2, cx + sz / 2,
                                  cy + sz / 2])
                for ar in aspect_ratios:
                    if abs(ar - 1.0) < 1e-6:
                        continue
                    for a in (ar, 1.0 / ar):
                        bw_, bh_ = ms * a ** 0.5, ms / a ** 0.5
                        boxes.append([cx - bw_ / 2, cy - bh_ / 2,
                                      cx + bw_ / 2, cy + bh_ / 2])
    boxes = torch.tensor(boxes, dtype=torch.float32, device=device)
    boxes = boxes / torch.tensor([iw, ih, iw, ih], dtype=torch.float32,
                                 device=device)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=device).expand(boxes.shape)
    return torch.cat([boxes, var], dim=-1)
