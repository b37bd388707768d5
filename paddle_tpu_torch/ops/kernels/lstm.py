"""Fused whole-sequence LSTM — every LSTM forward and backward of the
training path (``ops/rnn.lstm``).

Port of ``paddle_tpu/ops/pallas/lstm.py :: lstm_fused``: the forward
(``pallas_call`` at :177, lean or residual-saving) and the BPTT backward
(:209) tied together by ``jax.custom_vjp`` there and by ``LstmFused``
here.  The kernels are ``csrc/lstm.cu``; ``lstm_fwd_plain`` and
``lstm_bwd_plain`` are their plain PyTorch versions, Python loops over t
that follow ``_fwd_kernel`` / ``_bwd_kernel`` line for line.  The CPU
takes them, and ``chip_smoke.py`` holds the kernels against them.

Shapes (time-major, float32): xs [T, B, 4D] (input projection plus
bias, gate order [a, i, f, o]), mask [T, B] 0/1, w_r [D, 4D], checks
[3, D] (peepholes i, f, o).  ``supported`` is the route's rule, the JAX
package's, and on a CUDA device the wrappers take exactly the (B, D) it
admits (D 128 to 640: B up to 1448 at D 128, 168 at D 512, 32 at D 640)
and raise ``ConfigError`` on any other; larger D go to the gate-blocked
variant (``lstm_blocked``).  The plain versions take any D.
"""

import torch

from paddle_tpu_torch.ops.kernels import _build, _check
from paddle_tpu_torch.utils.error import ConfigError

NAME_FWD = "lstm_fwd"
NAME_BWD = "lstm_bwd"
SOURCE = "paddle_tpu_torch/csrc/lstm.cu"
REPLACES_FWD = "paddle_tpu/ops/pallas/lstm.py:177"
REPLACES_BWD = "paddle_tpu/ops/pallas/lstm.py:209"
LANES = _check.LANES

# kernel launches since the last reset (bumped only where a kernel is
# launched; the plain versions never count).  A backward is one count
# for its BPTT kernel and the dW_r product that follows it.
launches_fwd = 0
launches_bwd = 0


def vmem_bytes(b, d):
    """The TPU backward's VMEM estimate (``lstm.py:265-273``): W_r and
    the dW_r accumulator (8 D^2 f32), the dh / dc / dchecks scratch and
    the streamed per-step blocks."""
    resident = 8 * d * d + 3 * d + 5 * b * d
    streamed = 13 * b * d + LANES * b
    return 4 * (resident + streamed)


def shape_supported(b, d):
    """The (B, D) half of ``supported``: B % 8 == 0, D % 128 == 0,
    within the VMEM guard (W_r alone is 26 MB at D = 1280)."""
    return (b % 8 == 0 and d % LANES == 0
            and vmem_bytes(b, d) <= _check.VMEM_BUDGET)


def supported(b, d, act, gate_act, state_act, init_state):
    """The resident route's rule, ``lstm.py:276-285``: default
    activations, no initial state and ``shape_supported(b, d)``.
    ``rnn.lstm`` follows it on both devices."""
    return (act == "tanh" and gate_act == "sigmoid" and state_act == "tanh"
            and init_state is None and shape_supported(b, d))


def _shapes(name, xs, mask, w_r, checks, dev):
    """(T, B, D), raising on a shape the kernels (on a CUDA ``dev``) or
    the plain versions (on the CPU) do not take."""
    if xs.dim() != 3 or xs.shape[2] % 4:
        raise ValueError(f"{name}: xs must be [T, B, 4D], got "
                         f"{tuple(xs.shape)}")
    t, b, g = xs.shape
    d = g // 4
    if t < 1 or b < 1:
        raise ValueError(f"{name}: empty batch or sequence (T={t}, B={b})")
    if tuple(mask.shape) != (t, b) or tuple(w_r.shape) != (d, g) \
            or tuple(checks.shape) != (3, d):
        raise ValueError(f"{name}: want mask [T, B], w_r [D, 4D], checks "
                         f"[3, D] for xs {tuple(xs.shape)}; got mask "
                         f"{tuple(mask.shape)}, w_r {tuple(w_r.shape)}, "
                         f"checks {tuple(checks.shape)}")
    if dev.type == "cuda" and not shape_supported(b, d):
        raise ConfigError(f"{name}: (B, D) = ({b}, {d}) is outside the "
                          f"resident route's rule (B % 8 == 0, D % 128 == "
                          f"0, within its VMEM guard), so the fused kernel "
                          f"does not take it")
    return t, b, d


def lstm_fwd_plain(xs, mask, w_r, checks, save_residuals):
    """(hs [T, B, D], c_fin [B, D], cs, acts): ``_fwd_kernel`` step by
    step; cs / acts are None in the lean variant."""
    t_len, b, g = xs.shape
    d = g // 4
    h = xs.new_zeros((b, d))
    c = xs.new_zeros((b, d))
    ci, cf, co = checks[0:1], checks[1:2], checks[2:3]
    hs, cs, acts = [], [], []
    for t in range(t_len):
        gates = xs[t] + h @ w_r
        a = torch.tanh(gates[:, 0:d])
        i = torch.sigmoid(gates[:, d:2 * d] + c * ci)
        f = torch.sigmoid(gates[:, 2 * d:3 * d] + c * cf)
        c_new = a * i + c * f
        o = torch.sigmoid(gates[:, 3 * d:] + c_new * co)
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h)
        if save_residuals:
            cs.append(c)
            acts.append(torch.cat([a, i, f, o], dim=1))
    if not save_residuals:
        return torch.stack(hs), c, None, None
    return torch.stack(hs), c, torch.stack(cs), torch.stack(acts)


def lstm_bwd_plain(acts, cs, hs, w_r, checks, mask, dh_out, dcfin):
    """(dxs [T, B, 4D], dW_r [D, 4D], dchecks [3, D]): ``_bwd_kernel``
    over reversed time, the peephole partials summed over B after the
    loop as ``lstm.py:245`` does."""
    t_len, b, d = dh_out.shape
    ci, cf, co = checks[0:1], checks[1:2], checks[2:3]
    dh_c = dh_out.new_zeros((b, d))
    dc_c = dcfin
    dwr = torch.zeros_like(w_r)
    dchk = dh_out.new_zeros((b, 3 * d))
    dxs = [None] * t_len
    for t in reversed(range(t_len)):
        a, i = acts[t, :, 0:d], acts[t, :, d:2 * d]
        f, o = acts[t, :, 2 * d:3 * d], acts[t, :, 3 * d:]
        c_t = cs[t]
        c_prev = cs[t - 1] if t > 0 else torch.zeros_like(c_t)
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(c_t)
        m = mask[t][:, None]
        dh = dh_c + dh_out[t]
        dc_merged = dc_c
        tc = torch.tanh(c_t)
        dog = dh * tc * o * (1.0 - o)
        dc = dh * o * (1.0 - tc * tc) + dc_merged + dog * co
        dag = dc * i * (1.0 - a * a)
        dig = dc * a * i * (1.0 - i)
        dfg = dc * c_prev * f * (1.0 - f)
        dgates = torch.cat([dag, dig, dfg, dog], dim=1) * m
        dh_prev = dgates @ w_r.T
        dc_prev = dc * f + dig * ci + dfg * cf
        dh_c = m * dh_prev + (1.0 - m) * dh
        dc_c = m * dc_prev + (1.0 - m) * dc_merged
        dwr = dwr + h_prev.T @ dgates
        dchk = dchk + torch.cat([m * dig * c_prev, m * dfg * c_prev,
                                 m * dog * c_t], dim=1)
        dxs[t] = dgates
    return torch.stack(dxs), dwr, dchk.sum(0).reshape(3, d)


def lstm_fwd(xs, mask, w_r, checks, save_residuals):
    """(hs, c_fin, cs, acts) as ``lstm_fwd_plain``.  CUDA tensors launch
    the forward kernel; CPU tensors take the plain version."""
    global launches_fwd
    f32 = torch.float32
    dev = _check.tensors(NAME_FWD, dict.fromkeys(
        ("xs", "mask", "w_r", "checks"), f32), xs=xs, mask=mask, w_r=w_r,
        checks=checks)
    t, b, d = _shapes(NAME_FWD, xs, mask, w_r, checks, dev)
    if dev.type == "cpu":
        return lstm_fwd_plain(xs, mask, w_r, checks, save_residuals)
    hs = torch.empty((t, b, d), dtype=f32, device=dev)
    cfin = torch.empty((b, d), dtype=f32, device=dev)
    cs = acts = None
    if save_residuals:
        cs = torch.empty((t, b, d), dtype=f32, device=dev)
        acts = torch.empty_like(xs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.entry("lstm", "lstm_fwd_f32", 8, 4)(
        xs.data_ptr(), mask.data_ptr(), w_r.data_ptr(), checks.data_ptr(),
        hs.data_ptr(), cfin.data_ptr(), 0 if cs is None else cs.data_ptr(),
        0 if acts is None else acts.data_ptr(), t, b, d, int(save_residuals),
        stream)
    _build.check(NAME_FWD, rc)
    launches_fwd += 1
    return hs, cfin, cs, acts


def lstm_bwd(acts, cs, hs, w_r, checks, mask, dh_out, dcfin):
    """(dxs, dW_r, dchecks) as ``lstm_bwd_plain``.  CUDA tensors launch
    the BPTT kernel and the dW_r product; CPU tensors take the plain
    version."""
    global launches_bwd
    f32 = torch.float32
    named = dict(acts=acts, cs=cs, hs=hs, w_r=w_r, checks=checks, mask=mask,
                 dh_out=dh_out, dcfin=dcfin)
    dev = _check.tensors(NAME_BWD, dict.fromkeys(named, f32), **named)
    t, b, d = _shapes(NAME_BWD, acts, mask, w_r, checks, dev)
    for arg, x in (("cs", cs), ("hs", hs), ("dh_out", dh_out)):
        if tuple(x.shape) != (t, b, d):
            raise ValueError(f"{NAME_BWD}: {arg} must be [T, B, D] = "
                             f"{(t, b, d)}, got {tuple(x.shape)}")
    if tuple(dcfin.shape) != (b, d):
        raise ValueError(f"{NAME_BWD}: dcfin must be [B, D] = {(b, d)}, got "
                         f"{tuple(dcfin.shape)}")
    if dev.type == "cpu":
        return lstm_bwd_plain(acts, cs, hs, w_r, checks, mask, dh_out, dcfin)
    dxs = torch.empty_like(acts)
    dwr = torch.empty_like(w_r)
    dchk = torch.empty((b, 3 * d), dtype=f32, device=dev)
    carry = torch.empty((2, b, d), dtype=f32, device=dev)
    # dh_prev's partial sums, one per 16-unit block, by step parity
    part = torch.empty((2, d // 16, b, d), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.entry("lstm", "lstm_bwd_f32", 14, 3)(
        acts.data_ptr(), cs.data_ptr(), hs.data_ptr(), w_r.data_ptr(),
        checks.data_ptr(), mask.data_ptr(), dh_out.data_ptr(),
        dcfin.data_ptr(), dxs.data_ptr(), dwr.data_ptr(), dchk.data_ptr(),
        carry[0].data_ptr(), carry[1].data_ptr(), part.data_ptr(), t, b, d,
        stream)
    _build.check(NAME_BWD, rc)
    launches_bwd += 1
    return dxs, dwr, dchk.sum(0).reshape(3, d)


class LstmFused(torch.autograd.Function):
    """(hs [T, B, D], c_fin [B, D]) = the residual-saving forward; its
    backward is the BPTT kernel (``lstm.py:249-262``)."""

    @staticmethod
    def forward(ctx, xs, w_r, checks, mask):
        hs, cfin, cs, acts = lstm_fwd(xs, mask, w_r, checks, True)
        ctx.save_for_backward(w_r, checks, mask, hs, cs, acts)
        return hs, cfin

    @staticmethod
    def backward(ctx, d_hs, d_cfin):
        # a cotangent that never reached an output (c_fin unused, say)
        # arrives as zeros: autograd materializes it by default
        w_r, checks, mask, hs, cs, acts = ctx.saved_tensors
        dxs, dwr, dchk = lstm_bwd(acts, cs, hs, w_r, checks, mask,
                                  d_hs.contiguous(), d_cfin.contiguous())
        return dxs, dwr, dchk, None


def lstm_fused(xs_tm, mask_tm, w_r, check_i, check_f, check_o):
    """Whole-sequence fused LSTM (``lstm.py:288-305``).

    xs_tm [T, B, 4D] time-major gate inputs (bias included), mask_tm
    [T, B] 0/1.  Returns (hs_tm [T, B, D], (h_fin, c_fin)); h_fin is
    ``hs[-1]``, the carried h (on a ragged batch, a row's last live h).
    A missing peephole is zeros.  Without a gradient to take, the lean
    forward runs and saves no residuals."""
    d = xs_tm.shape[-1] // 4
    checks = torch.stack([
        xs_tm.new_zeros(d) if v is None else v.to(torch.float32)
        for v in (check_i, check_f, check_o)])
    xs, w_r = xs_tm.contiguous(), w_r.contiguous()
    mask = mask_tm.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xs, w_r, checks)):
        hs, cfin = LstmFused.apply(xs, w_r, checks, mask)
    else:
        hs, cfin, _, _ = lstm_fwd(xs, mask, w_r, checks, False)
    return hs, (hs[-1], cfin)
