"""Variable-length sequence ops over padded batches
(``paddle_tpu/ops/sequence.py``; reference SequencePoolLayer family,
ExpandLayer, SequenceConcatLayer, SequenceReshapeLayer,
SubSequenceLayer, ContextProjection, EosIdCheckLayer, MaxIdLayer,
SamplingIdLayer).  Every op takes the padded data plus lengths and
keeps padding out of its result: max pools pad at -1e30, an empty
sequence pools to 0, and the ops that move steps zero every step past
a sequence's new length.  ``nested_seq_pool`` pools a
``NestedSequenceBatch`` within each sub-sequence or over all of it."""

import numpy as np
import torch

from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch

_NEG = -1e30


def seq_max_pool(seq: SequenceBatch):
    """[B, T, D] -> [B, D] max over valid steps (reference MaxLayer).
    The padding value is -1e30 cast to the data's dtype, as JAX casts
    it: -inf in float16 (a Python scalar that overflows float16 would be
    refused on a CUDA tensor)."""
    m = seq.mask(seq.data.dtype)[..., None]
    neg = torch.tensor(_NEG, device=seq.data.device).to(seq.data.dtype)
    out = torch.where(m > 0, seq.data, neg).max(dim=1).values
    any_valid = (seq.lengths > 0)[:, None]
    return torch.where(any_valid, out, 0.0)


def seq_avg_pool(seq: SequenceBatch):
    """Average over valid steps (reference AverageLayer 'average')."""
    s = seq_sum_pool(seq)
    n = torch.clamp(seq.lengths.to(s.dtype), min=1.0)[:, None]
    return s / n


def seq_sum_pool(seq: SequenceBatch):
    """Sum over valid steps (reference AverageLayer 'sum')."""
    return (seq.data * seq.mask(seq.data.dtype)[..., None]).sum(dim=1)


def seq_sqrt_pool(seq: SequenceBatch):
    """sum / sqrt(len) (reference AverageLayer 'squarerootn')."""
    s = seq_sum_pool(seq)
    n = torch.sqrt(torch.clamp(seq.lengths.to(s.dtype), min=1.0))[:, None]
    return s / n


def seq_last(seq: SequenceBatch):
    """Last valid step (reference SequenceLastInstanceLayer); step 0 for
    an empty sequence."""
    idx = torch.clamp(seq.lengths.long() - 1, min=0)
    return seq.data[torch.arange(seq.batch_size, device=idx.device), idx]


def seq_first(seq: SequenceBatch):
    """First step (reference first_seq)."""
    return seq.data[:, 0]


def seq_pool(seq: SequenceBatch, pooling: str):
    return {
        "max": seq_max_pool,
        "avg": seq_avg_pool,
        "average": seq_avg_pool,
        "sum": seq_sum_pool,
        "sqrt": seq_sqrt_pool,
        "last": seq_last,
        "first": seq_first,
    }[pooling](seq)


def context_projection(seq: SequenceBatch, context_len: int,
                       context_start: int, padding_weights=None):
    """Sliding-window concat over time (reference ContextProjection,
    function/ContextProjectionOp.cpp:392): step t gets
    [x_{t+start}, ..., x_{t+start+len-1}] concatenated (D * len wide).
    Out-of-range positions read zeros, or the trainable padding rows
    ``padding_weights`` [pad_rows, D]: ``max(0, -start)`` head rows, then
    the tail rows, indexed from each sequence's own length.  Steps past a
    sequence's length are zero."""
    b, t, d = seq.data.shape
    lengths = seq.lengths
    steps = torch.arange(t, device=seq.data.device)
    cols = []
    for k in range(context_len):
        idx = steps + (context_start + k)
        oob_head = idx < 0
        oob_tail = idx[None, :] >= lengths[:, None]
        col = seq.data[:, torch.clamp(idx, 0, t - 1), :]
        if padding_weights is not None:
            last_row = padding_weights.shape[0] - 1
            n_head = max(0, -context_start)
            if n_head:
                head_row = torch.clamp(idx + n_head, 0, n_head - 1)
                head_pad = padding_weights[torch.clamp(head_row, 0, last_row)]
                col = torch.where(oob_head[None, :, None], head_pad[None], col)
            n_tail = max(0, context_start + context_len - 1)
            if n_tail:
                tail_row = n_head + torch.clamp(
                    idx[None, :] - lengths[:, None], 0, n_tail - 1)
                tail_pad = padding_weights[torch.clamp(tail_row, 0, last_row)]
                col = torch.where(oob_tail[..., None], tail_pad, col)
        else:
            col = torch.where(oob_head[None, :, None] | oob_tail[..., None],
                              0.0, col)
        cols.append(col)
    out = torch.cat(cols, dim=-1)
    return SequenceBatch(data=out * seq.mask(out.dtype)[..., None],
                         lengths=lengths)


def _take_steps(data, idx):
    """data [B, T, ...] at per-row step indices idx [B, W] -> [B, W, ...]
    (JAX's ``take_along_axis`` over the time axis)."""
    rows = torch.arange(data.shape[0], device=data.device)[:, None]
    return data[rows, idx.long()]


def _zero_past(data, lengths):
    """``data`` [B, W, ...] with every step at or past ``lengths`` zeroed:
    a SequenceBatch of those lengths."""
    out = SequenceBatch(data=data, lengths=lengths)
    mask = out.mask(data.dtype).reshape(data.shape[:2]
                                        + (1,) * (data.dim() - 2))
    return SequenceBatch(data=data * mask, lengths=lengths)


def expand(vec, like: SequenceBatch):
    """[B, D] -> [B, T, D]: one row per sequence broadcast across its
    steps, zero past its length (reference ExpandLayer)."""
    data = vec[:, None, :].expand(vec.shape[0], like.max_len, vec.shape[-1])
    data = data * like.mask(vec.dtype)[..., None]
    return SequenceBatch(data=data, lengths=like.lengths)


def seq_concat(a: SequenceBatch, b: SequenceBatch) -> SequenceBatch:
    """Concatenate along time: [a_i ; b_i] per sample (reference
    SequenceConcatLayer), padded to Ta + Tb."""
    ta, tb = a.max_len, b.max_len
    out_len = a.lengths + b.lengths
    pos = torch.arange(ta + tb, device=a.data.device)[None, :]
    in_a = pos < a.lengths[:, None]
    ga = _take_steps(a.data, torch.clamp(pos, 0, ta - 1).expand(
        a.batch_size, -1))
    gb = _take_steps(b.data, torch.clamp(pos - a.lengths[:, None], 0,
                                         tb - 1))
    data = torch.where(in_a[..., None], ga, gb)
    return _zero_past(data, out_len)


def seq_reshape(seq: SequenceBatch, new_dim: int) -> SequenceBatch:
    """Re-chunk each sequence's flattened valid tokens into rows of
    ``new_dim`` (reference SequenceReshapeLayer): the payload past each
    sequence's end is zeroed first and each new length is rounded up, so
    the last row of a sequence whose len * d is not a multiple of
    new_dim is zero-padded and the batch's padded length changes
    nothing."""
    b, t, d = seq.data.shape
    data = seq.data * seq.mask(seq.data.dtype)[..., None]
    rows = -(-(t * d) // new_dim)
    flat = torch.nn.functional.pad(data.reshape(b, t * d),
                                   (0, rows * new_dim - t * d))
    new_len = -(-(seq.lengths.long() * d) // new_dim)
    return SequenceBatch(data=flat.reshape(b, rows, new_dim),
                         lengths=new_len.to(torch.int32))


def sub_seq(seq: SequenceBatch, offsets, sizes, max_out: int
            ) -> SequenceBatch:
    """Per-sample slice [offset, offset + size) (reference
    SubSequenceLayer), padded to ``max_out`` steps."""
    pos = torch.arange(max_out, device=seq.data.device)[None, :]
    idx = torch.clamp(offsets[:, None].long() + pos, 0, seq.max_len - 1)
    return _zero_past(_take_steps(seq.data, idx), sizes.to(torch.int32))


def seq_slice(seq: SequenceBatch, starts=None, ends=None) -> SequenceBatch:
    """Steps [start, end) of each sequence; ``starts`` default to 0 and
    ``ends`` to the lengths (and are cut to them)."""
    starts = torch.zeros_like(seq.lengths) if starts is None else starts
    ends = seq.lengths if ends is None else torch.minimum(
        ends.to(seq.lengths.dtype), seq.lengths)
    return sub_seq(seq, starts, ends - starts, seq.max_len)


def max_id(x):
    """argmax over the feature axis, the first maximum on a tie as
    ``jnp.argmax`` takes it (reference MaxIdLayer)."""
    return torch.argmax(x, dim=-1).to(torch.int32)


def eos_check(ids, eos_id):
    """1.0 where id == eos (reference EosIdCheckLayer)."""
    return (ids == eos_id).to(torch.float32)


def sampling_id(uniform, probs):
    """One id per row drawn from the distribution ``probs`` [..., V]
    (reference SamplingIdLayer) by its inverse CDF at ``uniform``, U[0,
    1) draws of shape probs.shape[:-1].  Probabilities are floored at
    1e-20 and need not sum to 1, as JAX's categorical over
    log(max(p, 1e-20)) reads them."""
    cdf = torch.cumsum(torch.clamp(probs.detach().float(), min=1e-20), -1)
    target = (uniform.to(cdf.device).float() * cdf[..., -1])[..., None]
    ids = torch.searchsorted(cdf.contiguous(), target.contiguous(),
                             right=True)[..., 0]
    return torch.clamp(ids, max=probs.shape[-1] - 1).to(torch.int32)


def scatter_rows_to_steps(seq: SequenceBatch):
    """[B, T, D] + lengths -> flat [sum_len, D] on the host (the inverse of
    padding): a numpy array, for evaluation and I/O."""
    data = seq.data.detach().cpu().numpy()
    lens = seq.lengths.cpu().numpy()
    return np.concatenate([data[i, :n] for i, n in enumerate(lens)], axis=0)


def seq_strided_pool(seq: SequenceBatch, pooling: str, stride: int
                     ) -> SequenceBatch:
    """last / first over non-overlapping windows of ``stride`` steps: a
    shorter sequence of ceil(len / stride) steps (reference
    SequenceLastInstanceLayer / first with stride > 0).  "last" takes the
    last valid step inside each window."""
    b, t = seq.data.shape[:2]
    n_win = -(-t // stride)
    w = torch.arange(n_win, device=seq.data.device)[None, :]
    if pooling == "first":
        idx = (w * stride).expand(b, n_win)
    elif pooling == "last":
        end = torch.minimum((w + 1) * stride, seq.lengths[:, None].long())
        idx = torch.clamp(end - 1, min=0)
    else:
        raise ValueError(f"strided seq pool supports last/first, "
                         f"got {pooling!r}")
    out_len = (-(-seq.lengths.long() // stride)).to(torch.int32)
    return _zero_past(_take_steps(seq.data, idx), out_len)


def nested_seq_pool(nested: NestedSequenceBatch, pooling: str,
                    each_sequence: bool = False):
    """Pooling over a NestedSequenceBatch (the reference's sequence
    levels).  each_sequence (AggregateLevel.TO_SEQUENCE): pool within
    each sub-sequence -> SequenceBatch [B, S, D] over the outer lengths,
    the rows past them zero.  Otherwise pool over every valid element ->
    [B, D], with JAX's choices kept: "first" reads element (0, 0) even
    where the first sub-sequence is empty, "last" the last element of
    the last valid sub-sequence, "max" over no valid element gives 0."""
    b, s = nested.data.shape[:2]
    if each_sequence:
        pooled = seq_pool(nested.flatten_outer(), pooling)      # [B*S, D]
        data = pooled.reshape((b, s) + tuple(pooled.shape[1:]))
        data = data * nested.outer_mask(data.dtype).reshape(
            (b, s) + (1,) * (data.ndim - 2))
        return SequenceBatch(data=data, lengths=nested.outer_lengths)
    if pooling == "last":
        outer_idx = torch.clamp(nested.outer_lengths.long() - 1, min=0)
        per_sub = nested_seq_pool(nested, "last", each_sequence=True)
        return per_sub.data[torch.arange(b, device=outer_idx.device),
                            outer_idx]
    if pooling == "first":
        return nested.data[:, 0, 0]
    # max / avg / sum / sqrt over every valid element of both levels: the
    # mask is not a prefix, so no flat pool applies
    flat = nested.data.reshape((b, -1) + tuple(nested.data.shape[3:]))
    mask = nested.inner_mask().reshape(b, -1)
    m = mask.reshape(tuple(mask.shape) + (1,) * (flat.ndim - 2))
    if pooling == "max":
        neg = torch.tensor(_NEG, device=flat.device).to(flat.dtype)
        out = torch.where(m > 0, flat, neg).max(dim=1).values
        return torch.where((mask.sum(1) > 0)[:, None], out, 0.0)
    total = (flat * m).sum(dim=1)
    n = torch.clamp(mask.sum(dim=1), min=1.0)[:, None]
    if pooling in ("avg", "average"):
        return total / n
    if pooling == "sqrt":
        return total / torch.sqrt(n)
    if pooling == "sum":
        return total
    raise ValueError(f"unsupported nested pooling {pooling!r}")
