"""The LSTM, GRU and vanilla RNN of ``paddle_tpu/ops/rnn.py``: cells,
masked scan, the fused whole-sequence routes, bidirectional concat.

Reference: LstmLayer/LstmCompute + hl_lstm_ops.cuh:46-66 (gate order
[a, input_gate, forget_gate, output_gate], peepholes checkI/F/O) and
GatedRecurrentLayer/GruCompute + hl_gru_ops.cuh:37-80 (gate order
[update, reset, candidate], h = prev - u*prev + u*c~) and
RecurrentLayer (h = act(x + h_prev W)).  The
input-to-hidden projection for all steps is hoisted out by the caller;
masked steps carry the state through unchanged, so padded batches match
the reference's padding-free semantics.

Dispatch has no mode flag: both follow the JAX package's rules exactly,
on either device.  ``lstm`` tries the resident route's rule
(``ops/kernels/lstm.supported``: ``LstmFused``), then the gate-blocked
route's (``ops/kernels/lstm_blocked.supported``: ``LstmFusedBlocked``,
for hidden sizes whose W_r does not stay on chip), then runs the masked
scan of ``lstm_cell``.  ``gru`` follows ``ops/kernels/gru.supported``:
where it holds, the fused route (``GruFused``), else the masked scan of
``gru_cell``; ``simple_rnn`` likewise by ``ops/kernels/simple_rnn.
supported`` (``SimpleRnnFused``), else the masked scan of
``simple_rnn_cell``.  A fused route runs its CUDA kernels on the card
(which raise on a shape they do not take) and their plain versions on
the CPU; the scans run on either device, as the reference routes them.
``recurrent_group`` and ``md_lstm_2d`` are not ported yet (ROADMAP).
"""

from typing import NamedTuple

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops.kernels import gru as _gru_kernel
from paddle_tpu_torch.ops.kernels import lstm as _kernel
from paddle_tpu_torch.ops.kernels import lstm_blocked as _blocked
from paddle_tpu_torch.ops.kernels import simple_rnn as _rnn_kernel
from paddle_tpu_torch.ops.linear import matmul


class LstmState(NamedTuple):
    h: torch.Tensor  # [B, D] hidden (output)
    c: torch.Tensor  # [B, D] cell state


class _HCarry(NamedTuple):
    h: torch.Tensor  # [B, D]: the GRU's and RNN's scan carry (a tuple)


def lstm_cell(x4, state: LstmState, w_r, check_i=None, check_f=None,
              check_o=None, act="tanh", gate_act="sigmoid", state_act="tanh"):
    """One LSTM step.  x4 [B, 4D] is the projected input in gate order
    [a, i, f, o]; w_r [D, 4D]; check_* [D] peepholes (optional)."""
    gates = x4 + matmul(state.h, w_r)
    a, ig, fg, og = torch.chunk(gates, 4, dim=-1)
    gate_f = activations.get(gate_act)
    a = activations.get(act)(a)
    if check_i is not None:
        ig = ig + state.c * check_i
    if check_f is not None:
        fg = fg + state.c * check_f
    i = gate_f(ig)
    f = gate_f(fg)
    c = a * i + state.c * f
    if check_o is not None:
        og = og + c * check_o
    h = gate_f(og) * activations.get(state_act)(c)
    return LstmState(h=h, c=c)


def gru_cell(x3, h_prev, w_gate, w_state, act="tanh", gate_act="sigmoid"):
    """One GRU step (reference hl_gru_ops.cuh:37-80).  x3 [B, 3D] is the
    projected input in gate order [update, reset, candidate]; w_gate
    [D, 2D] (update | reset), w_state [D, D].
    h = prev - u*prev + u*c~,  c~ = act(x_c + (r*prev) @ w_state)."""
    d = h_prev.shape[-1]
    xu, xr, xc = x3[..., :d], x3[..., d:2 * d], x3[..., 2 * d:]
    ru = matmul(h_prev, w_gate)
    gate_f = activations.get(gate_act)
    u = gate_f(xu + ru[..., :d])
    r = gate_f(xr + ru[..., d:])
    c = activations.get(act)(xc + matmul(r * h_prev, w_state))
    return h_prev - u * h_prev + u * c


def simple_rnn_cell(x, h_prev, w_r, act="tanh"):
    """Reference RecurrentLayer: h = act(x + h_prev @ w_r)."""
    return activations.get(act)(x + matmul(h_prev, w_r))


def _masked_scan(step, init_carry, xs_tm, ms_tm, reverse=False):
    """Loop over time; where the mask is 0 the carry (a tuple of [B, ...]
    tensors) passes through unchanged.  Returns (final carry, carries
    stacked over time in their time order)."""
    carry, outs = init_carry, [None] * xs_tm.shape[0]
    order = range(xs_tm.shape[0] - 1, -1, -1) if reverse \
        else range(xs_tm.shape[0])
    for t in order:
        new = step(carry, xs_tm[t])
        m = ms_tm[t] > 0
        carry = type(carry)(*(
            torch.where(m.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, carry)))
        outs[t] = carry
    return carry, type(carry)(*(torch.stack(xs) for xs in zip(*outs)))


def _fused_seq_apply(seq, xs, ms, reverse, kernel_fn):
    """reverse = the forward kernel over time-flipped arrays, flipped back
    (valid because sequences are left-aligned and masked steps freeze the
    carry either way).  Returns (SequenceBatch, final state) from
    kernel_fn(xs_tm, ms_tm)."""
    if reverse:
        xs, ms = torch.flip(xs, [0]), torch.flip(ms, [0])
    hs_tm, final = kernel_fn(xs, ms)
    if reverse:
        hs_tm = torch.flip(hs_tm, [0])
    out = hs_tm.transpose(0, 1) * seq.mask(hs_tm.dtype)[..., None]
    return SequenceBatch(data=out, lengths=seq.lengths), final


def lstm(seq: SequenceBatch, w_r, bias=None, check_i=None, check_f=None,
         check_o=None, reverse=False, act="tanh", gate_act="sigmoid",
         state_act="tanh", init_state=None):
    """Whole-sequence LSTM (reference LstmLayer + SequenceToBatch).

    seq.data [B, T, 4D] pre-projected gate inputs; bias [4D].  Returns
    (SequenceBatch of h [B, T, D] zeroed at padding, final LstmState)."""
    b, _, d4 = seq.data.shape
    d = d4 // 4
    x = seq.data if bias is None else seq.data + bias
    xs = x.transpose(0, 1)                         # time-major [T, B, 4D]
    ms = seq.mask(x.dtype).transpose(0, 1)         # [T, B]

    rule = (b, d, act, gate_act, state_act, init_state)
    fused = (_kernel.lstm_fused if _kernel.supported(*rule)
             else _blocked.lstm_fused_blocked if _blocked.supported(*rule)
             else None)
    if fused is not None:
        sb, (fh, fc) = _fused_seq_apply(
            seq, xs, ms, reverse,
            lambda x_, m_: fused(x_, m_, w_r, check_i, check_f, check_o))
        return sb, LstmState(h=fh, c=fc)

    if init_state is None:
        init_state = LstmState(h=x.new_zeros((b, d)), c=x.new_zeros((b, d)))

    def step(state, x4):
        return lstm_cell(x4, state, w_r, check_i, check_f, check_o,
                         act, gate_act, state_act)

    final, hs = _masked_scan(step, init_state, xs, ms, reverse=reverse)
    out = hs.h.transpose(0, 1) * seq.mask(hs.h.dtype)[..., None]
    return SequenceBatch(data=out, lengths=seq.lengths), final


def gru(seq: SequenceBatch, w_gate, w_state, bias=None, reverse=False,
        act="tanh", gate_act="sigmoid", init_state=None):
    """Whole-sequence GRU (reference GatedRecurrentLayer).

    seq.data [B, T, 3D] pre-projected [update | reset | candidate]
    inputs; bias [3D].  Returns (SequenceBatch of h [B, T, D] zeroed at
    padding, final h [B, D])."""
    b, _, d3 = seq.data.shape
    d = d3 // 3
    x = seq.data if bias is None else seq.data + bias
    xs = x.transpose(0, 1)                         # time-major [T, B, 3D]
    ms = seq.mask(x.dtype).transpose(0, 1)         # [T, B]

    if _gru_kernel.supported(b, d, act, gate_act, init_state):
        return _fused_seq_apply(
            seq, xs, ms, reverse,
            lambda x_, m_: _gru_kernel.gru_fused(x_, m_, w_gate, w_state))

    if init_state is None:
        init_state = x.new_zeros((b, d))

    def step(carry, x3):
        return _HCarry(gru_cell(x3, carry.h, w_gate, w_state, act,
                                  gate_act))

    (final,), (hs,) = _masked_scan(step, _HCarry(init_state), xs, ms,
                                   reverse=reverse)
    out = hs.transpose(0, 1) * seq.mask(hs.dtype)[..., None]
    return SequenceBatch(data=out, lengths=seq.lengths), final


def simple_rnn(seq: SequenceBatch, w_r, bias=None, reverse=False, act="tanh",
               init_state=None):
    """Reference RecurrentLayer over a whole sequence.

    seq.data [B, T, D] pre-projected inputs; bias [D].  Returns
    (SequenceBatch of h [B, T, D] zeroed at padding, final h [B, D])."""
    b, _, d = seq.data.shape
    x = seq.data if bias is None else seq.data + bias
    xs = x.transpose(0, 1)                         # time-major [T, B, D]
    ms = seq.mask(x.dtype).transpose(0, 1)         # [T, B]

    if _rnn_kernel.supported(b, d, act, init_state):
        return _fused_seq_apply(
            seq, xs, ms, reverse,
            lambda x_, m_: _rnn_kernel.simple_rnn_fused(x_, m_, w_r))

    if init_state is None:
        init_state = x.new_zeros((b, d))

    def step(carry, xt):
        return _HCarry(simple_rnn_cell(xt, carry.h, w_r, act))

    (final,), (hs,) = _masked_scan(step, _HCarry(init_state), xs, ms,
                                   reverse=reverse)
    out = hs.transpose(0, 1) * seq.mask(hs.dtype)[..., None]
    return SequenceBatch(data=out, lengths=seq.lengths), final


def bidirectional(fwd_out: SequenceBatch, bwd_out: SequenceBatch):
    """Concat forward and reverse passes (reference bidirectional_lstm)."""
    return SequenceBatch(data=torch.cat([fwd_out.data, bwd_out.data], dim=-1),
                         lengths=fwd_out.lengths)
