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

Shapes (time-major, float32): xs [T, B, D] (input projection plus
bias), mask [T, B] 0/1, W [D, D]; hs, dh_out and dxs [T, B, D].  hs is
the output and the backward's only residual.  On the card the kernels
take exactly the (B, D) that ``supported`` admits (B % 8 == 0, D a
multiple of 128 within the VMEM guard: D 128..1280) and raise on any
other; the plain versions take any shape.
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
    """hs [T, B, D]: ``_fwd_kernel`` step by step, h_{-1} = 0; hs[t] is
    the carried h, also where the mask is 0."""
    h = xs.new_zeros(xs.shape[1:])
    hs = []
    for t in range(xs.shape[0]):
        h_new = torch.tanh(xs[t] + h @ w)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        hs.append(h)
    return torch.stack(hs)


def simple_rnn_bwd_plain(hs, w, mask, dh_out):
    """(dxs [T, B, D], dW [D, D]): ``_bwd_kernel`` over reversed time
    with its dW accumulator, h_prev = 0 at t = 0."""
    t_len = dh_out.shape[0]
    dh = torch.zeros_like(dh_out[0])
    dw = torch.zeros_like(w)
    dxs = [None] * t_len
    for t in reversed(range(t_len)):
        h_t = hs[t]
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(h_t)
        m = mask[t][:, None]
        dh = dh + dh_out[t]
        dg = dh * (1.0 - h_t * h_t) * m
        dh_prev = dg @ w.T
        dh = m * dh_prev + (1.0 - m) * dh
        dw = dw + h_prev.T @ dg
        dxs[t] = dg
    return torch.stack(dxs), dw


def simple_rnn_fwd(xs, mask, w):
    """hs as ``simple_rnn_fwd_plain``.  CUDA tensors launch the forward
    kernel; CPU tensors take the plain version."""
    global launches_fwd
    f32 = torch.float32
    dev = _check.tensors(NAME_FWD, dict.fromkeys(("xs", "mask", "w"), f32),
                         xs=xs, mask=mask, w=w)
    t, b, d = _shapes(NAME_FWD, xs, mask, w, dev)
    if dev.type == "cpu":
        return simple_rnn_fwd_plain(xs, mask, w)
    hs = torch.empty_like(xs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.entry("simple_rnn", "simple_rnn_fwd_f32", 4, 3)(
        xs.data_ptr(), mask.data_ptr(), w.data_ptr(), hs.data_ptr(), t, b, d,
        stream)
    _build.check(NAME_FWD, rc)
    launches_fwd += 1
    return hs


def simple_rnn_bwd(hs, w, mask, dh_out):
    """(dxs, dW) as ``simple_rnn_bwd_plain``.  CUDA tensors launch the
    BPTT kernel and the dW product; CPU tensors take the plain version."""
    global launches_bwd
    f32 = torch.float32
    named = dict(hs=hs, w=w, mask=mask, dh_out=dh_out)
    dev = _check.tensors(NAME_BWD, dict.fromkeys(named, f32), **named)
    t, b, d = _shapes(NAME_BWD, hs, mask, w, dev)
    if tuple(dh_out.shape) != (t, b, d):
        raise ValueError(f"{NAME_BWD}: dh_out must be [T, B, D] = "
                         f"{(t, b, d)}, got {tuple(dh_out.shape)}")
    if dev.type == "cpu":
        return simple_rnn_bwd_plain(hs, w, mask, dh_out)
    dxs = torch.empty_like(hs)
    dw = torch.empty_like(w)
    dh_buf = torch.empty((b, d), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.entry("simple_rnn", "simple_rnn_bwd_f32", 7, 3)(
        hs.data_ptr(), w.data_ptr(), mask.data_ptr(), dh_out.data_ptr(),
        dxs.data_ptr(), dw.data_ptr(), dh_buf.data_ptr(), t, b, d, stream)
    _build.check(NAME_BWD, rc)
    launches_bwd += 1
    return dxs, dw


class SimpleRnnFused(torch.autograd.Function):
    """hs [T, B, D] = the forward; its backward is the BPTT kernel with
    the dW product (``simple_rnn.py:120-130``)."""

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
