"""Pooling over the time axis of a padded sequence batch and the
sliding-window ``context_projection`` (``paddle_tpu/ops/sequence.py``;
reference SequencePoolLayer family, ContextProjection).  Padding never
leaks into a result: max pools pad at -1e30 and an empty sequence pools
to 0.  The other sequence ops (expand, concat, reshape, slices, maxid,
eos, sampling) are not ported yet (ROADMAP A10·b)."""

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch

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
