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

``recurrent_group`` is the generic engine under the layer DSL's
``recurrent_group``: a loop over time of a step function over memories,
finished rows' memories frozen by a masked merge;
``nested_recurrent_group`` is its two-level twin, an outer loop over
sub-sequences.  ``md_lstm_2d`` is the 2-D LSTM of ``mdlstmemory``, a
loop over rows with a loop over columns inside.  JAX's three are
``lax.scan``s of plain ops, so the port's are plain loops on both
devices.
"""

from typing import NamedTuple

import torch

from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch
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
    [a, i, f, o]; w_r [D, 4D], or None where x4 already holds the
    recurrent product (``lstm_step_layer``: JAX's zero w_r, whose product
    adds nothing); check_* [D] peepholes (optional)."""
    gates = x4 if w_r is None else x4 + matmul(state.h, w_r)
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


def _merge(m, new, old):
    """Row-wise: ``new`` where the step's mask ``m`` [B] is set, else
    ``old`` (a finished row keeps its carry)."""
    return torch.where(m.reshape((-1,) + (1,) * (new.dim() - 1)) > 0, new,
                       old)


def _time_order(t, reverse):
    return range(t - 1, -1, -1) if reverse else range(t)


def _masked_scan(step, init_carry, xs_tm, ms_tm, reverse=False):
    """Loop over time; where the mask is 0 the carry (a tuple of [B, ...]
    tensors) passes through unchanged.  Returns (final carry, carries
    stacked over time in their time order)."""
    # unbind: one view a step, whose backward stacks the steps' gradients
    # once (indexing would zero-fill a [T, ...] gradient every step)
    xs, carry, outs = xs_tm.unbind(0), init_carry, [None] * xs_tm.shape[0]
    for t in _time_order(len(xs), reverse):
        new = step(carry, xs[t])
        carry = type(carry)(*(_merge(ms_tm[t], n, o)
                              for n, o in zip(new, carry)))
        outs[t] = carry
    return carry, type(carry)(*(torch.stack(xs) for xs in zip(*outs)))


def _step_generators(generator, t):
    """T generators on ``generator``'s device, each its own stream,
    seeded from one draw of ``generator`` (JAX splits one key T ways)."""
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return [torch.Generator(device=generator.device).manual_seed(base + i)
            for i in range(t)]


def recurrent_group(step_fn, inputs, boot_memories, reverse=False,
                    generator=None):
    """The generic dynamic-RNN engine (JAX's ``ops/rnn.recurrent_group``;
    reference RecurrentGradientMachine forward :379).

    inputs: a SequenceBatch or a tuple of them sharing lengths, sliced
    time-major.  step_fn(memories, frames) -> (new_memories, outputs):
    memories a tuple of [B, ...] tensors (booted by ``boot_memories``),
    frames the inputs' slices at one step, outputs a tensor or a tuple
    of [B, ...] tensors.  With a ``generator`` step_fn is called as
    step_fn(memories, frames, step_generator), each time position t
    drawing from its own stream, so dropout masks decorrelate across
    time.  ``reverse`` runs t from T - 1 down to 0 over the padded time
    axis, as ``lax.scan(reverse=True)`` does.

    Where a row has finished its memories are frozen (the masking
    equivalent of the reference's batch shrinking) and its outputs are
    zeroed.  Returns (the outputs as SequenceBatches, in the step's
    structure; the final memories)."""
    seqs = (inputs,) if isinstance(inputs, SequenceBatch) else tuple(inputs)
    ref = seqs[0]
    t_len = ref.data.shape[1]
    # one view a step, as _masked_scan takes them
    xs_tm = [s.data.transpose(0, 1).unbind(0) for s in seqs]
    ms_tm = ref.mask().transpose(0, 1)
    gens = _step_generators(generator, t_len) if generator is not None \
        else None
    mems, outs = tuple(boot_memories), [None] * t_len
    for t in _time_order(t_len, reverse):
        frames = tuple(x[t] for x in xs_tm)
        if gens is None:
            new, out = step_fn(mems, frames)
        else:
            new, out = step_fn(mems, frames, gens[t])
        mems = tuple(_merge(ms_tm[t], n, o) for n, o in zip(new, mems))
        outs[t] = out

    def collect(steps):
        o = torch.stack(steps, dim=1)                   # [B, T, ...]
        m = ref.mask(o.dtype).reshape(ref.data.shape[:2]
                                      + (1,) * (o.dim() - 2))
        return SequenceBatch(data=o * m, lengths=ref.lengths)

    if isinstance(outs[0], tuple):
        result = tuple(collect(list(steps)) for steps in zip(*outs))
    else:
        result = collect(outs)
    return result, mems


def nested_recurrent_group(step_fn, inputs, boot_memories, reverse=False,
                           generator=None):
    """The two-level (sub-sequence) engine (JAX's ``ops/rnn.
    nested_recurrent_group``; reference RecurrentGradientMachine
    createInFrameInfo with sub-sequence inputs): the outer loop iterates
    sub-sequences, and at outer step j step_fn sees each input's j-th
    sub-sequence as a whole SequenceBatch, ``inner_lengths[:, j]`` its
    lengths, so an inner ``recurrent_group`` in the step runs over it.

    inputs: a tuple of NestedSequenceBatches sharing outer lengths.
    step_fn(memories, frames[, step_generator]) -> (new_memories,
    outputs), as for ``recurrent_group``; outer memories are frozen at
    padded outer steps.  A [B, ...] step output stacks into a
    SequenceBatch over the outer axis (zeroed at padded outer steps), a
    SequenceBatch step output into a NestedSequenceBatch (its inner
    lengths times the outer mask, its data zeroed by the inner mask).
    Returns (the outputs in the step's structure, the final
    memories)."""
    nests = tuple(inputs)
    ref = nests[0]
    s_len = ref.data.shape[1]
    # one view an outer step, as _masked_scan takes them
    datas = [n.data.unbind(1) for n in nests]
    ilens = [n.inner_lengths.unbind(1) for n in nests]
    om = ref.outer_mask()
    om_sm = om.unbind(1)
    gens = _step_generators(generator, s_len) if generator is not None \
        else None
    mems, outs = tuple(boot_memories), [None] * s_len
    for j in _time_order(s_len, reverse):
        frames = tuple(SequenceBatch(data=d[j], lengths=ln[j])
                       for d, ln in zip(datas, ilens))
        if gens is None:
            new, out = step_fn(mems, frames)
        else:
            new, out = step_fn(mems, frames, gens[j])
        mems = tuple(_merge(om_sm[j], n, o) for n, o in zip(new, mems))
        outs[j] = out

    def collect(steps):
        if isinstance(steps[0], SequenceBatch):
            data = torch.stack([o.data for o in steps], dim=1)
            inner = torch.stack([o.lengths for o in steps], dim=1) \
                * ref.outer_mask(torch.int32)
            nsb = NestedSequenceBatch(data=data,
                                      outer_lengths=ref.outer_lengths,
                                      inner_lengths=inner)
            m = nsb.inner_mask(data.dtype)
            return nsb._replace(
                data=data * m.reshape(m.shape + (1,) * (data.dim() - 3)))
        data = torch.stack(steps, dim=1)                 # [B, S, ...]
        m = om.to(data.dtype)
        return SequenceBatch(
            data=data * m.reshape(m.shape + (1,) * (data.dim() - 2)),
            lengths=ref.outer_lengths)

    if isinstance(outs[0], tuple) and not isinstance(outs[0], SequenceBatch):
        result = tuple(collect(list(steps)) for steps in zip(*outs))
    else:
        result = collect(outs)
    return result, mems


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


def md_lstm_2d(x5, w_r_row, w_r_col, check_i_row=None, check_i_col=None,
               check_f_row=None, check_f_col=None, check_o=None,
               act="tanh", gate_act="sigmoid", state_act="tanh"):
    """2-D multi-dimensional LSTM (JAX's ``ops/rnn.md_lstm_2d``;
    reference MDLstmLayer): each cell sees its top and its left
    neighbour, each with its own recurrent weight and forget gate:

      gates = x5 + h_top @ w_r_row + h_left @ w_r_col (+ peepholes)
      c = act(a) * gate(ig) + gate(fg_row) * c_top + gate(fg_col) * c_left

    x5: [B, H, W, 5D] pre-projected in the order (a, ig, fg_row,
    fg_col, og); w_r_row / w_r_col [D, 5D]; check_* [D] peepholes
    (optional).  A loop over rows carrying the previous row's (h, c),
    and inside it a loop over columns carrying (h_left, c_left); the
    top neighbours' product is taken for a whole row at once, since the
    previous row is done.  Returns h [B, H, W, D]."""
    b, _, w, d5 = x5.shape
    d = d5 // 5
    act_f, gate_f, state_f = (activations.get(act), activations.get(gate_act),
                              activations.get(state_act))
    zeros = x5.new_zeros((b, d))

    def cell(x, h_top, c_top, h_left, c_left):
        gates = x + matmul(h_left, w_r_col)
        a, ig, fg_r, fg_c, og = torch.chunk(gates, 5, dim=-1)
        if check_i_row is not None:
            ig = ig + c_top * check_i_row
        if check_i_col is not None:
            ig = ig + c_left * check_i_col
        if check_f_row is not None:
            fg_r = fg_r + c_top * check_f_row
        if check_f_col is not None:
            fg_c = fg_c + c_left * check_f_col
        c = (act_f(a) * gate_f(ig) + gate_f(fg_r) * c_top
             + gate_f(fg_c) * c_left)
        if check_o is not None:
            og = og + c * check_o
        return gate_f(og) * state_f(c), c

    h_top, c_top = [zeros] * w, [zeros] * w
    rows = []
    # unbind: one view a row and a column (see _masked_scan)
    for x_row in x5.unbind(1):
        top = x_row + matmul(torch.stack(h_top, dim=1), w_r_row)
        h_left = c_left = zeros
        hs, cs = [], []
        for j, x in enumerate(top.unbind(1)):
            h_left, c_left = cell(x, h_top[j], c_top[j], h_left, c_left)
            hs.append(h_left)
            cs.append(c_left)
        h_top, c_top = hs, cs
        rows.append(torch.stack(hs, dim=1))
    return torch.stack(rows, dim=1)
