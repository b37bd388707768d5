"""Gate-blocked fused LSTM — the LSTM forward of the training path at
hidden sizes whose W_r does not stay on chip (``ops/rnn.lstm`` where
``lstm.supported`` fails and ``supported`` here holds: D = 1280 and
2048 at B = 64, for example).

Port of ``paddle_tpu/ops/pallas/lstm_blocked.py :: lstm_fused_blocked``:
the forward (``pallas_call`` at :144, lean or residual-saving) is the
kernel ``csrc/lstm_blocked.cu``; the backward is ``_bwd_scan`` (:167),
plain JAX there and plain PyTorch here (``lstm_blocked_bwd_plain``), on
both devices; ``jax.custom_vjp`` ties them there (:227-249) and
``LstmFusedBlocked`` here.

The plain forward is the same function as the resident kernel's, so
``lstm.lstm_fwd_plain`` serves as this kernel's plain version: the CPU
takes it, and ``chip_smoke.py`` holds the kernel against it.

Shapes (time-major, float32): xs [T, B, 4D] (input projection plus
bias, gate order [a, i, f, o]), mask [T, B] 0/1, w_r [D, 4D], checks
[3, D] (peepholes i, f, o).  The kernel takes D a multiple of 128 up to
4096 and every B whose staging ring fits in shared memory (it raises
on another), which covers every (B, D) that ``supported`` admits (B a
multiple of 8 up to 1024, D up to 3456 at B = 8).  The plain versions
take any D.
"""

import ctypes

import torch

from paddle_tpu_torch.ops.kernels import _build, _check
from paddle_tpu_torch.ops.kernels.lstm import lstm_fwd_plain
from paddle_tpu_torch.utils.error import ConfigError

NAME_FWD = "lstm_blocked_fwd"
SOURCE = "paddle_tpu_torch/csrc/lstm_blocked.cu"
REPLACES_FWD = "paddle_tpu/ops/pallas/lstm_blocked.py:144"
LANES = _check.LANES
# the kernel keeps D / 128 hidden units per CTA, 32 at most
MAX_HIDDEN = 32 * LANES

# kernel launches since the last reset (bumped only where the kernel is
# launched; the plain versions never count)
launches_fwd = 0


def vmem_bytes(b, d):
    """The TPU forward's VMEM estimate (``lstm_blocked.py:252-260``):
    three [B, D] carry scratches, two pipelined [D, 4, 128] weight
    blocks and the double-buffered streamed blocks of the residual
    variant."""
    resident = 3 * b * d + 2 * d * 4 * LANES
    streamed = 2 * (b * 4 * LANES + b * LANES + 2 * b * LANES
                    + b * LANES + b * 4 * LANES)
    return 4 * (resident + streamed)


def supported(b, d, act, gate_act, state_act, init_state):
    """The blocked route's rule, ``lstm_blocked.py:263-268``: default
    activations, no initial state, B % 8 == 0, D % 128 == 0, within the
    VMEM guard.  ``rnn.lstm`` tries it after ``lstm.supported`` fails,
    on both devices."""
    return (act == "tanh" and gate_act == "sigmoid" and state_act == "tanh"
            and init_state is None
            and b % 8 == 0 and d % LANES == 0
            and vmem_bytes(b, d) <= _check.VMEM_BUDGET)


def _shapes(xs, mask, w_r, checks, dev):
    """(T, B, D), raising on a shape the kernel (on a CUDA ``dev``) or
    the plain version (on the CPU) does not take."""
    if xs.dim() != 3 or xs.shape[2] % 4:
        raise ValueError(f"{NAME_FWD}: xs must be [T, B, 4D], got "
                         f"{tuple(xs.shape)}")
    t, b, g = xs.shape
    d = g // 4
    if t < 1 or b < 1:
        raise ValueError(f"{NAME_FWD}: empty batch or sequence (T={t}, "
                         f"B={b})")
    if tuple(mask.shape) != (t, b) or tuple(w_r.shape) != (d, g) \
            or tuple(checks.shape) != (3, d):
        raise ValueError(f"{NAME_FWD}: want mask [T, B], w_r [D, 4D], "
                         f"checks [3, D] for xs {tuple(xs.shape)}; got mask "
                         f"{tuple(mask.shape)}, w_r {tuple(w_r.shape)}, "
                         f"checks {tuple(checks.shape)}")
    if dev.type == "cuda" and (d % LANES or d > MAX_HIDDEN):
        raise ConfigError(f"{NAME_FWD}: hidden size {d} is not one the "
                          f"kernel takes (a multiple of {LANES} up to "
                          f"{MAX_HIDDEN})")
    return t, b, d


def _wpack_floats(d):
    """Floats of the scratch the kernel repacks W_r's streamed rows into
    (each CTA's columns, padded to a multiple of 8)."""
    fn = _build.load("lstm_blocked").lstm_blocked_wpack_floats
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return fn(d)


def lstm_blocked_fwd(xs, mask, w_r, checks, save_residuals):
    """(hs [T, B, D], c_fin [B, D], cs, acts) as ``lstm.lstm_fwd_plain``
    (cs / acts None in the lean variant).  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    global launches_fwd
    f32 = torch.float32
    dev = _check.tensors(NAME_FWD, dict.fromkeys(
        ("xs", "mask", "w_r", "checks"), f32), xs=xs, mask=mask, w_r=w_r,
        checks=checks)
    t, b, d = _shapes(xs, mask, w_r, checks, dev)
    if dev.type == "cpu":
        return lstm_fwd_plain(xs, mask, w_r, checks, save_residuals)
    hs = torch.empty((t, b, d), dtype=f32, device=dev)
    cfin = torch.empty((b, d), dtype=f32, device=dev)
    wpack = torch.empty(_wpack_floats(d), dtype=f32, device=dev)
    cs = acts = None
    if save_residuals:
        cs = torch.empty((t, b, d), dtype=f32, device=dev)
        acts = torch.empty_like(xs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.entry("lstm_blocked", "lstm_blocked_fwd_f32", 9, 4)(
        xs.data_ptr(), mask.data_ptr(), w_r.data_ptr(), checks.data_ptr(),
        hs.data_ptr(), cfin.data_ptr(), 0 if cs is None else cs.data_ptr(),
        0 if acts is None else acts.data_ptr(), wpack.data_ptr(), t, b, d,
        int(save_residuals), stream)
    _build.check(NAME_FWD, rc)
    launches_fwd += 1
    return hs, cfin, cs, acts


def lstm_blocked_bwd_plain(w_r, checks, mask, hs, cs, acts, dh_out, dcfin):
    """(dxs [T, B, 4D], dW_r [D, 4D], dchecks [3, D]): ``_bwd_scan``
    (``lstm_blocked.py:167-224``) in PyTorch, on either device.

    The per-step math is ``_bwd_scan``'s; two things are arranged
    differently, each computing the same sums: the factors that depend
    only on the saved activations (tanh(c_t) o (1 - o) and the like) are
    formed for all steps before the reversed loop, so each step is a
    dozen tensor ops; and dW_r and the peephole partials leave the loop
    as one product ``hs_prev^T dgates`` over the T B rows and one sum
    (the JAX scan adds them up step by step).  Both move values by
    rounding only: the tests hold this against ``_bwd_scan`` at rtol
    2e-4, atol 2e-5."""
    t_len, b, d = dh_out.shape
    ci, cf, co = checks[0], checks[1], checks[2]
    a, i, f, o = acts.view(t_len, b, 4, d).unbind(2)
    cs_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
    tc = torch.tanh(cs)
    dog_f = tc * o * (1.0 - o)                        # dog = dh dog_f
    dc_f = o * (1.0 - tc * tc) + dog_f * co          # dc = dh dc_f + dc_acc
    dgate_f = torch.stack([i * (1.0 - a * a),        # dag, dig, dfg = dc x
                           a * i * (1.0 - i),
                           cs_prev * f * (1.0 - f)], dim=2)
    live = mask[:, :, None] > 0                      # [T, B, 1]
    dxs = torch.empty_like(acts)
    dg = dxs.view(t_len, b, 4, d)
    dh_acc = torch.zeros_like(dh_out[0])
    dc_acc = dcfin
    w_t = w_r.t()
    for t in reversed(range(t_len)):
        m = mask[t][:, None]
        dh = dh_acc + dh_out[t]
        dc = torch.addcmul(dc_acc, dh, dc_f[t])
        torch.mul(dc[:, None], dgate_f[t], out=dg[t, :, :3])
        torch.mul(dh, dog_f[t], out=dg[t, :, 3])
        dg[t].mul_(m[:, :, None])                    # dgates = [...] m
        dig, dfg = dg[t, :, 1], dg[t, :, 2]
        dc_prev = torch.addcmul(torch.addcmul(dc * f[t], dig, ci), dfg, cf)
        dh_acc = torch.where(live[t], dxs[t] @ w_t, dh)
        dc_acc = torch.where(live[t], dc_prev, dc_acc)
    # h_{-1} = 0: step 0 adds nothing to dW_r
    dwr = hs[:-1].reshape(-1, d).t() @ dxs[1:].reshape(-1, 4 * d)
    dchk = torch.stack([(dg[:, :, 1] * cs_prev).sum((0, 1)),
                        (dg[:, :, 2] * cs_prev).sum((0, 1)),
                        (dg[:, :, 3] * cs).sum((0, 1))])
    return dxs, dwr, dchk


class LstmFusedBlocked(torch.autograd.Function):
    """(hs [T, B, D], c_fin [B, D]) = the residual-saving blocked
    forward; its backward is ``lstm_blocked_bwd_plain``
    (``lstm_blocked.py:234-246``)."""

    @staticmethod
    def forward(ctx, xs, w_r, checks, mask):
        hs, cfin, cs, acts = lstm_blocked_fwd(xs, mask, w_r, checks, True)
        ctx.save_for_backward(w_r, checks, mask, hs, cs, acts)
        return hs, cfin

    @staticmethod
    def backward(ctx, d_hs, d_cfin):
        # a cotangent that never reached an output (c_fin unused, say)
        # arrives as zeros: autograd materializes it by default
        w_r, checks, mask, hs, cs, acts = ctx.saved_tensors
        dxs, dwr, dchk = lstm_blocked_bwd_plain(w_r, checks, mask, hs, cs,
                                                acts, d_hs, d_cfin)
        return dxs, dwr, dchk, None


def lstm_fused_blocked(xs_tm, mask_tm, w_r, check_i, check_f, check_o):
    """Whole-sequence gate-blocked LSTM (``lstm_blocked.py:271-298``),
    the contract of ``lstm.lstm_fused``: xs_tm [T, B, 4D] time-major gate
    inputs (bias included), mask_tm [T, B] 0/1 -> (hs_tm [T, B, D],
    (h_fin, c_fin)); h_fin is ``hs[-1]``.  A missing peephole is zeros.
    The TPU kernel pads T to even for its parity buffers (a step with
    mask 0); the kernel here needs no padding.  Without a gradient to
    take, the lean forward runs and saves no residuals."""
    d = xs_tm.shape[-1] // 4
    checks = torch.stack([
        xs_tm.new_zeros(d) if v is None else v.to(torch.float32)
        for v in (check_i, check_f, check_o)])
    xs, w_r = xs_tm.contiguous(), w_r.contiguous()
    mask = mask_tm.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xs, w_r, checks)):
        hs, cfin = LstmFusedBlocked.apply(xs, w_r, checks, mask)
    else:
        hs, cfin, _, _ = lstm_blocked_fwd(xs, mask, w_r, checks, False)
    return hs, (hs[-1], cfin)
