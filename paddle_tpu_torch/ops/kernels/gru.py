"""Fused whole-sequence GRU — both encoder GRUs of the attention NMT
model's training path (``ops/rnn.gru``).

Port of ``paddle_tpu/ops/pallas/gru.py :: gru_fused``: the forward
(``pallas_call`` at :129, lean or residual-saving) and the BPTT backward
(:155) tied together by ``jax.custom_vjp`` there and by ``GruFused``
here.  The kernels are ``csrc/gru.cu``; ``gru_fwd_plain`` and
``gru_bwd_plain`` are their plain PyTorch versions, Python loops over t
that follow ``_fwd_kernel`` / ``_step`` and ``_bwd_kernel`` line for
line.  The CPU takes them, and ``chip_smoke.py`` holds the kernels
against them.

Shapes (time-major, float32): xs [T, B, 3D] (input projection plus
bias, gate order [update, reset, candidate]), mask [T, B] 0/1, w_gate
[D, 2D] (update | reset), w_state [D, D].  The kernels take every (B, D)
that ``supported`` admits under the default budget: any B, and D a
multiple of 128 up to 768.  The plain versions take any D.
"""

import torch

from paddle_tpu_torch.ops.kernels import _build, _check
from paddle_tpu_torch.utils.error import ConfigError

NAME_FWD = "gru_fwd"
NAME_BWD = "gru_bwd"
SOURCE = "paddle_tpu_torch/csrc/gru.cu"
REPLACES_FWD = "paddle_tpu/ops/pallas/gru.py:129"
REPLACES_BWD = "paddle_tpu/ops/pallas/gru.py:155"
LANES = _check.LANES
VMEM_BUDGET = _check.VMEM_BUDGET
# the largest D the route admits under the default 14 MiB budget; the
# kernels keep a CTA's 48 rows of W_gate and W_state resident at pitch
# D + 4, 170 KB of shared memory there
MAX_HIDDEN = 6 * LANES

# kernel launches since the last reset (bumped only where a kernel is
# launched; the plain versions never count).  A backward is one count
# for its BPTT kernel and the dW_gate / dW_state product that follows it.
launches_fwd = 0
launches_bwd = 0


def vmem_bytes(b, d):
    """The TPU backward's VMEM estimate (``gru.py:202-207``): w_gate and
    w_state plus their accumulators (6 D^2 f32), the dh scratch and the
    streamed per-step blocks."""
    resident = 6 * d * d + b * d
    streamed = 9 * b * d + LANES * b
    return 4 * (resident + streamed)


def supported(b, d, act, gate_act, init_state):
    """The fused route's rule, ``gru.py:210-218``: default activations,
    no initial state, B % 8 == 0, D % 128 == 0, within the VMEM guard.
    ``rnn.gru`` follows it on both devices."""
    return (act == "tanh" and gate_act == "sigmoid"
            and init_state is None
            and b % 8 == 0 and d % LANES == 0
            and vmem_bytes(b, d) <= VMEM_BUDGET)


def _shapes(name, xs, mask, w_gate, w_state, dev):
    """(T, B, D), raising on a shape the kernels (on a CUDA ``dev``) or
    the plain versions (on the CPU) do not take."""
    if xs.dim() != 3 or xs.shape[2] % 3:
        raise ValueError(f"{name}: xs must be [T, B, 3D], got "
                         f"{tuple(xs.shape)}")
    t, b, g = xs.shape
    d = g // 3
    if t < 1 or b < 1:
        raise ValueError(f"{name}: empty batch or sequence (T={t}, B={b})")
    if tuple(mask.shape) != (t, b) or tuple(w_gate.shape) != (d, 2 * d) \
            or tuple(w_state.shape) != (d, d):
        raise ValueError(f"{name}: want mask [T, B], w_gate [D, 2D], "
                         f"w_state [D, D] for xs {tuple(xs.shape)}; got "
                         f"mask {tuple(mask.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_state "
                         f"{tuple(w_state.shape)}")
    if dev.type == "cuda" and (d % LANES or d > MAX_HIDDEN):
        raise ConfigError(f"{name}: hidden size {d} is not one the fused "
                          f"kernel takes (a multiple of {LANES} up to "
                          f"{MAX_HIDDEN})")
    return t, b, d


def gru_fwd_plain(xs, mask, w_gate, w_state, save_residuals):
    """(hs [T, B, D], acts [T, B, 3D] or None): ``_fwd_kernel`` step by
    step.  hs holds the carried h; acts the (u, r, c~) of the computed
    step, also where the mask is 0."""
    t_len, b, g = xs.shape
    d = g // 3
    h = xs.new_zeros((b, d))
    hs, acts = [], []
    for t in range(t_len):
        x3 = xs[t]
        ru = h @ w_gate
        u = torch.sigmoid(x3[:, 0:d] + ru[:, 0:d])
        r = torch.sigmoid(x3[:, d:2 * d] + ru[:, d:2 * d])
        s = r * h
        cc = torch.tanh(x3[:, 2 * d:3 * d] + s @ w_state)
        h_new = h + u * (cc - h)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        hs.append(h)
        if save_residuals:
            acts.append(torch.cat([u, r, cc], dim=1))
    return torch.stack(hs), (torch.stack(acts) if save_residuals else None)


def gru_bwd_plain(acts, hs, w_gate, w_state, mask, dh_out):
    """(dxs [T, B, 3D], dW_gate [D, 2D], dW_state [D, D]):
    ``_bwd_kernel`` over reversed time, h_prev = 0 at t = 0."""
    t_len, b, d = dh_out.shape
    dh_c = dh_out.new_zeros((b, d))
    dwg = torch.zeros_like(w_gate)
    dws = torch.zeros_like(w_state)
    dxs = [None] * t_len
    for t in reversed(range(t_len)):
        u, r = acts[t, :, 0:d], acts[t, :, d:2 * d]
        cc = acts[t, :, 2 * d:3 * d]
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(u)
        m = mask[t][:, None]
        dh = dh_c + dh_out[t]
        du = dh * (cc - h_prev)
        dug = du * u * (1.0 - u)
        dcc = dh * u
        dccg = dcc * (1.0 - cc * cc)
        ds = dccg @ w_state.T
        dr = ds * h_prev
        drg = dr * r * (1.0 - r)
        dgates = torch.cat([dug, drg], dim=1) * m
        dccg_m = dccg * m
        dh_prev = dh * (1.0 - u) + ds * r + dgates @ w_gate.T
        dh_c = m * dh_prev + (1.0 - m) * dh
        dwg = dwg + h_prev.T @ dgates
        dws = dws + (r * h_prev).T @ dccg_m
        dxs[t] = torch.cat([dgates, dccg_m], dim=1)
    return torch.stack(dxs), dwg, dws


def gru_fwd(xs, mask, w_gate, w_state, save_residuals):
    """(hs, acts) as ``gru_fwd_plain``.  CUDA tensors launch the forward
    kernel; CPU tensors take the plain version."""
    global launches_fwd
    f32 = torch.float32
    dev = _check.tensors(NAME_FWD, dict.fromkeys(
        ("xs", "mask", "w_gate", "w_state"), f32), xs=xs, mask=mask,
        w_gate=w_gate, w_state=w_state)
    t, b, d = _shapes(NAME_FWD, xs, mask, w_gate, w_state, dev)
    if dev.type == "cpu":
        return gru_fwd_plain(xs, mask, w_gate, w_state, save_residuals)
    hs = torch.empty((t, b, d), dtype=f32, device=dev)
    acts = torch.empty_like(xs) if save_residuals else None
    sbuf = torch.empty((b, d), dtype=f32, device=dev)   # r h_{t-1}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.entry("gru", "gru_fwd_f32", 7, 4)(
        xs.data_ptr(), mask.data_ptr(), w_gate.data_ptr(),
        w_state.data_ptr(), hs.data_ptr(),
        0 if acts is None else acts.data_ptr(), sbuf.data_ptr(), t, b, d,
        int(save_residuals), stream)
    _build.check(NAME_FWD, rc)
    launches_fwd += 1
    return hs, acts


def gru_bwd(acts, hs, w_gate, w_state, mask, dh_out):
    """(dxs, dW_gate, dW_state) as ``gru_bwd_plain``.  CUDA tensors
    launch the BPTT kernel and the dW product; CPU tensors take the
    plain version."""
    global launches_bwd
    f32 = torch.float32
    named = dict(acts=acts, hs=hs, w_gate=w_gate, w_state=w_state,
                 mask=mask, dh_out=dh_out)
    dev = _check.tensors(NAME_BWD, dict.fromkeys(named, f32), **named)
    t, b, d = _shapes(NAME_BWD, acts, mask, w_gate, w_state, dev)
    for arg, x in (("hs", hs), ("dh_out", dh_out)):
        if tuple(x.shape) != (t, b, d):
            raise ValueError(f"{NAME_BWD}: {arg} must be [T, B, D] = "
                             f"{(t, b, d)}, got {tuple(x.shape)}")
    if dev.type == "cpu":
        return gru_bwd_plain(acts, hs, w_gate, w_state, mask, dh_out)
    dxs = torch.empty_like(acts)
    dwg = torch.empty_like(w_gate)
    dws = torch.empty_like(w_state)
    # the dh carry, part, and r_t h_{t-1} of steps 1..T-1 (dW_state's
    # operand, written by the BPTT)
    scratch = torch.empty((t + 1, b, d), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.entry("gru", "gru_bwd_f32", 12, 3)(
        acts.data_ptr(), hs.data_ptr(), w_gate.data_ptr(),
        w_state.data_ptr(), mask.data_ptr(), dh_out.data_ptr(),
        dxs.data_ptr(), dwg.data_ptr(), dws.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(),
        scratch[2:].data_ptr(), t, b, d, stream)
    _build.check(NAME_BWD, rc)
    launches_bwd += 1
    return dxs, dwg, dws


class GruFused(torch.autograd.Function):
    """hs [T, B, D] = the residual-saving forward; its backward is the
    BPTT kernel with the dW products (``gru.py:187-199``)."""

    @staticmethod
    def forward(ctx, xs, w_gate, w_state, mask):
        hs, acts = gru_fwd(xs, mask, w_gate, w_state, True)
        ctx.save_for_backward(w_gate, w_state, mask, hs, acts)
        return hs

    @staticmethod
    def backward(ctx, d_hs):
        w_gate, w_state, mask, hs, acts = ctx.saved_tensors
        dxs, dwg, dws = gru_bwd(acts, hs, w_gate, w_state, mask,
                                d_hs.contiguous())
        return dxs, dwg, dws, None


def gru_fused(xs_tm, mask_tm, w_gate, w_state):
    """Whole-sequence fused GRU (``gru.py:221-232``).

    xs_tm [T, B, 3D] time-major [update | reset | candidate] inputs
    (bias included), mask_tm [T, B] 0/1.  Returns (hs_tm [T, B, D],
    hs[-1]): the final h is the carried h (on a ragged batch, a row's
    last live h).  Without a gradient to take, the lean forward runs and
    saves no residuals."""
    xs = xs_tm.contiguous()
    w_gate, w_state = w_gate.contiguous(), w_state.contiguous()
    mask = mask_tm.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xs, w_gate, w_state)):
        hs = GruFused.apply(xs, w_gate, w_state, mask)
    else:
        hs, _ = gru_fwd(xs, mask, w_gate, w_state, False)
    return hs, hs[-1]
