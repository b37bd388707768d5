"""Fused whole-sequence vanilla RNN — the DSL's ``recurrent_layer``
(``ops/rnn.simple_rnn``), the reference RecurrentLayer.

Port of ``paddle_tpu/ops/pallas/simple_rnn.py :: simple_rnn_fused``: the
forward (``pallas_call`` at :74) and the BPTT backward with its in-body
dW accumulator (:92), tied together by ``jax.custom_vjp`` there and by
``SimpleRnnFused`` here.  The kernels are ``csrc/simple_rnn.cu``
(forward, BPTT, dW); ``simple_rnn_fwd_plain`` and
``simple_rnn_bwd_plain`` are their plain PyTorch versions, Python loops
over t that follow ``_fwd_kernel`` and ``_bwd_kernel`` line for line.
The CPU takes them, and ``chip_smoke.py`` holds the kernels against
them.

Shapes (time-major): xs [T, B, D] (input projection plus bias), mask
[T, B] 0/1 float32, W [D, D]; hs, dh_out and dxs [T, B, D].  hs is the
output and the backward's only residual.  Dtypes, as the JAX kernels
take them: xs and W each float32, bf16 or float16; hs, dh_out and dxs in xs's
dtype, dW in W's.  Every operand is widened to float32 on load, the h /
dh carries and every product are float32, outputs are rounded once to
their dtype (dW accumulated in float32 and rounded once).  Each (xs, W)
dtype pair has its own instance of the kernels (``_check.suffix``), all
with one C signature; float32 with float32 is the float32 kernel.  On
the card the kernels take exactly the (B, D) that ``supported`` admits
(B % 8 == 0, D a multiple of 128 within the VMEM guard: D 128..1280)
and raise on any other; the plain versions take any shape.
"""

import torch

from paddle_tpu_torch.ops.kernels import _build, _check
from paddle_tpu_torch.utils.error import ConfigError

NAME_FWD = "simple_rnn_fwd"
NAME_BWD = "simple_rnn_bwd"
SOURCE = "paddle_tpu_torch/csrc/simple_rnn.cu"
REPLACES_FWD = "paddle_tpu/ops/pallas/simple_rnn.py:74"
REPLACES_BWD = "paddle_tpu/ops/pallas/simple_rnn.py:92"
LANES = _check.LANES
VMEM_BUDGET = _check.VMEM_BUDGET

# kernel launches since the last reset (bumped only where a kernel is
# launched; the plain versions never count).  A backward is one count
# for its BPTT kernel and the dW product that follows it.
launches_fwd = 0
launches_bwd = 0
# launches of the bf16 and float16 instances since the last reset, by row name
# ("<NAME>[<instance>]", the instance as ``_check.suffix`` names it);
# launches_* above count every instance's launches
launches_low = {}
# the C entries' (pointers, ints) before the stream, every instance
FWD_ARGS, BWD_ARGS = (5, 3), (9, 3)


def vmem_bytes(b, d):
    """The TPU backward's VMEM estimate (``simple_rnn.py:133-138``): W
    and the dW accumulator (2 D^2 f32), the dh scratch and the streamed
    per-step blocks."""
    resident = 2 * d * d + b * d
    streamed = 4 * b * d + LANES * b
    return 4 * (resident + streamed)


def supported(b, d, act, init_state):
    """The fused route's rule, ``simple_rnn.py:141-146``: tanh, no
    initial state, B % 8 == 0, D % 128 == 0, within the VMEM guard.
    ``rnn.simple_rnn`` follows it on both devices."""
    return (act == "tanh" and init_state is None
            and b % 8 == 0 and d % LANES == 0
            and vmem_bytes(b, d) <= VMEM_BUDGET)


def _shapes(name, xs, mask, w, dev):
    """(T, B, D), raising on a shape the kernels (on a CUDA ``dev``) or
    the plain versions (on the CPU) do not take."""
    if xs.dim() != 3:
        raise ValueError(f"{name}: xs must be [T, B, D], got "
                         f"{tuple(xs.shape)}")
    t, b, d = xs.shape
    if t < 1 or b < 1:
        raise ValueError(f"{name}: empty batch or sequence (T={t}, B={b})")
    if tuple(mask.shape) != (t, b) or tuple(w.shape) != (d, d):
        raise ValueError(f"{name}: want mask [T, B] and w [D, D] for xs "
                         f"{tuple(xs.shape)}; got mask {tuple(mask.shape)}, "
                         f"w {tuple(w.shape)}")
    if dev.type == "cuda" and not supported(b, d, "tanh", None):
        raise ConfigError(f"{name}: (B, D) = ({b}, {d}) is not one the fused "
                          f"kernels take (B % 8 == 0, D a multiple of {LANES} "
                          f"with vmem_bytes(B, D) <= {VMEM_BUDGET})")
    return t, b, d


def simple_rnn_fwd_plain(xs, mask, w):
    """hs [T, B, D] in xs's dtype: ``_fwd_kernel`` step by step on the
    widened operands, h_{-1} = 0, the carry float32; hs[t] is the
    carried h, also where the mask is 0."""
    xf, wf = xs.float(), w.float()
    h = xf.new_zeros(xf.shape[1:])
    hs = []
    for t in range(xf.shape[0]):
        h_new = torch.tanh(xf[t] + h @ wf)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        hs.append(h)
    return torch.stack(hs).to(xs.dtype)


def simple_rnn_bwd_plain(hs, w, mask, dh_out):
    """(dxs [T, B, D] in hs's dtype, dW [D, D] in W's):
    ``_bwd_kernel`` over reversed time on the widened operands with its
    float32 dW accumulator, h_prev = 0 at t = 0."""
    hsf, wf, dof = hs.float(), w.float(), dh_out.float()
    t_len = dof.shape[0]
    dh = torch.zeros_like(dof[0])
    dw = torch.zeros_like(wf)
    dxs = [None] * t_len
    for t in reversed(range(t_len)):
        h_t = hsf[t]
        h_prev = hsf[t - 1] if t > 0 else torch.zeros_like(h_t)
        m = mask[t][:, None]
        dh = dh + dof[t]
        dg = dh * (1.0 - h_t * h_t) * m
        dh_prev = dg @ wf.T
        dh = m * dh_prev + (1.0 - m) * dh
        dw = dw + h_prev.T @ dg
        dxs[t] = dg
    return torch.stack(dxs).to(hs.dtype), dw.to(w.dtype)


def simple_rnn_fwd(xs, mask, w):
    """hs as ``simple_rnn_fwd_plain``.  CUDA tensors launch the forward
    kernel's instance for (xs, W)'s dtypes; CPU tensors take the plain
    version."""
    global launches_fwd
    f32, rd = torch.float32, _check.RNN_DTYPES
    dev = _check.tensors(NAME_FWD, dict(xs=rd, mask=f32, w=rd),
                         xs=xs, mask=mask, w=w)
    t, b, d = _shapes(NAME_FWD, xs, mask, w, dev)
    if dev.type == "cpu":
        return simple_rnn_fwd_plain(xs, mask, w)
    sfx = _check.suffix(xs.dtype, w.dtype)
    hs = torch.empty_like(xs)
    hc = _check.f32_scratch(hs)     # the float32 carry the products read
    rc = _build.entry("simple_rnn", f"{NAME_FWD}_{sfx}", *FWD_ARGS)(
        xs.data_ptr(), mask.data_ptr(), w.data_ptr(), hs.data_ptr(),
        hc.data_ptr(), t, b, d, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME_FWD, rc)
    launches_fwd += 1
    _check.count_low(launches_low, NAME_FWD, sfx)
    return hs


def simple_rnn_bwd(hs, w, mask, dh_out):
    """(dxs, dW) as ``simple_rnn_bwd_plain``.  CUDA tensors launch the
    BPTT kernel and the dW product of the instance for (hs, W)'s
    dtypes; CPU tensors take the plain version."""
    global launches_bwd
    f32, rd = torch.float32, _check.RNN_DTYPES
    named = dict(hs=hs, w=w, mask=mask, dh_out=dh_out)
    dev = _check.tensors(NAME_BWD, dict(hs=rd, w=rd, mask=f32, dh_out=rd),
                         **named)
    _check.same_dtype(NAME_BWD, "hs", hs, dh_out=dh_out)
    t, b, d = _shapes(NAME_BWD, hs, mask, w, dev)
    if tuple(dh_out.shape) != (t, b, d):
        raise ValueError(f"{NAME_BWD}: dh_out must be [T, B, D] = "
                         f"{(t, b, d)}, got {tuple(dh_out.shape)}")
    if dev.type == "cpu":
        return simple_rnn_bwd_plain(hs, w, mask, dh_out)
    sfx = _check.suffix(hs.dtype, w.dtype)
    dxs = torch.empty_like(hs)
    dw = torch.empty_like(w)
    dh_buf = torch.empty((b, d), dtype=f32, device=dev)
    # float32 dg (the products' operand) and dW's float32 sum
    dg, dw32 = _check.f32_scratch(dxs), _check.f32_scratch(dw)
    rc = _build.entry("simple_rnn", f"{NAME_BWD}_{sfx}", *BWD_ARGS)(
        *(x.data_ptr() for x in (hs, w, mask, dh_out, dxs, dw, dh_buf, dg,
                                 dw32)),
        t, b, d, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME_BWD, rc)
    launches_bwd += 1
    _check.count_low(launches_low, NAME_BWD, sfx)
    return dxs, dw


class SimpleRnnFused(torch.autograd.Function):
    """hs [T, B, D] = the forward; its backward is the BPTT kernel with
    the dW product (``simple_rnn.py:120-130``), dxs in xs's dtype and dW
    in W's."""

    @staticmethod
    def forward(ctx, xs, w, mask):
        hs = simple_rnn_fwd(xs, mask, w)
        ctx.save_for_backward(w, mask, hs)
        return hs

    @staticmethod
    def backward(ctx, d_hs):
        w, mask, hs = ctx.saved_tensors
        dxs, dw = simple_rnn_bwd(hs, w, mask, d_hs.contiguous())
        return dxs, dw, None


def simple_rnn_fused(xs_tm, mask_tm, w):
    """Whole-sequence fused vanilla RNN (``simple_rnn.py:149-158``).

    xs_tm [T, B, D] time-major inputs (bias included), mask_tm [T, B]
    0/1.  Returns (hs_tm [T, B, D], hs[-1]): the final h is the carried
    h (on a ragged batch, a row's last live h)."""
    hs = SimpleRnnFused.apply(xs_tm.contiguous(), w.contiguous(),
                              mask_tm.to(torch.float32).contiguous())
    return hs, hs[-1]
