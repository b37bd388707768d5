"""Ragged sequence batches as padded dense data plus lengths
(``paddle_tpu/core/sequence.py``).

``SequenceBatch`` — data [B, T, ...] + lengths [B], one sequence level;
``NestedSequenceBatch`` — data [B, S, T, ...] + outer lengths [B] and
inner lengths [B, S], two levels (the reference's sub-sequences);
``bucket_boundaries``, ``bucket_for`` and ``pack_sequences`` (host-side
numpy) for the data path.  Lengths are int32, as JAX's are.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import device as _device


class SequenceBatch(NamedTuple):
    data: torch.Tensor      # [B, T, ...] padded values (or int ids)
    lengths: torch.Tensor   # [B] int32 true lengths

    @property
    def batch_size(self):
        return self.data.shape[0]

    @property
    def max_len(self):
        return self.data.shape[1]

    def bool_mask(self):
        """[B, T] True where valid."""
        t = torch.arange(self.max_len, device=self.lengths.device)
        return t[None, :] < self.lengths[:, None]

    def mask(self, dtype=torch.float32):
        """[B, T] 1.0 where valid, 0.0 at padding."""
        return self.bool_mask().to(dtype)

    def with_data(self, data):
        return SequenceBatch(data=data, lengths=self.lengths)


class NestedSequenceBatch(NamedTuple):
    data: torch.Tensor           # [B, S, T, ...]
    outer_lengths: torch.Tensor  # [B]    number of valid sub-sequences
    inner_lengths: torch.Tensor  # [B, S] length of each sub-sequence

    def outer_mask(self, dtype=torch.float32):
        """[B, S] 1 where the sub-sequence is valid."""
        s = torch.arange(self.data.shape[1], device=self.outer_lengths.device)
        return (s[None, :] < self.outer_lengths[:, None]).to(dtype)

    def inner_mask(self, dtype=torch.float32):
        """[B, S, T] 1 where the element is valid (inside a valid
        sub-sequence)."""
        t = torch.arange(self.data.shape[2], device=self.inner_lengths.device)
        m = (t[None, None, :] < self.inner_lengths[:, :, None]).to(dtype)
        return m * self.outer_mask(dtype)[:, :, None]

    def flatten_outer(self) -> SequenceBatch:
        """Each sub-sequence as a sequence of its own: [B*S, T, ...], the
        sub-sequences past a sample's outer length at length 0."""
        b, s = self.data.shape[:2]
        data = self.data.reshape((b * s,) + tuple(self.data.shape[2:]))
        lengths = torch.where(self.outer_mask(torch.int32).reshape(-1) > 0,
                              self.inner_lengths.reshape(-1), 0)
        return SequenceBatch(data=data, lengths=lengths.to(torch.int32))


def pad_sequences(seqs: Sequence[np.ndarray], max_len: Optional[int] = None,
                  pad_value=0, dtype=None, device=None) -> SequenceBatch:
    """Host-side: list of per-sequence arrays -> padded SequenceBatch on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = _device.resolve(device)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    tmax = int(max_len or (lengths.max() if len(seqs) else 1))
    first = np.asarray(seqs[0])
    dtype = dtype or first.dtype
    out = np.full((len(seqs), tmax) + first.shape[1:], pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        n = min(len(s), tmax)
        out[i, :n] = np.asarray(s)[:n]
    return SequenceBatch(data=torch.tensor(out, device=dev),
                         lengths=torch.tensor(np.minimum(lengths, tmax),
                                              device=dev))


def pad_nested_sequences(seqs, max_outer=None, max_inner=None, pad_value=0,
                         dtype=None, device=None) -> NestedSequenceBatch:
    """Host-side: a list (per sample) of lists (sub-sequences) of arrays
    -> NestedSequenceBatch on ``device`` (the card unless "cpu")."""
    dev = _device.resolve(device)
    data, outer, inner = nested_arrays(seqs, max_outer, max_inner, pad_value,
                                       dtype)
    return NestedSequenceBatch(
        data=torch.tensor(data, device=dev),
        outer_lengths=torch.tensor(outer, device=dev),
        inner_lengths=torch.tensor(inner, device=dev))


def nested_arrays(seqs, max_outer=None, max_inner=None, pad_value=0,
                  dtype=None):
    """``pad_nested_sequences``' (data [B, S, T, ...], outer [B], inner
    [B, S]) as numpy, int32 lengths: S and T the widest unless given
    (at least 1), longer ones cut."""
    outer = np.array([len(s) for s in seqs], dtype=np.int32)
    smax = int(max_outer or max(outer.max(), 1))
    inner = np.zeros((len(seqs), smax), dtype=np.int32)
    for i, s in enumerate(seqs):
        for j, sub in enumerate(s[:smax]):
            inner[i, j] = len(sub)
    tmax = int(max_inner or max(int(inner.max()), 1))
    probe = np.asarray(seqs[0][0])
    dtype = dtype or probe.dtype
    out = np.full((len(seqs), smax, tmax) + probe.shape[1:], pad_value,
                  dtype=dtype)
    for i, s in enumerate(seqs):
        for j, sub in enumerate(s[:smax]):
            n = min(len(sub), tmax)
            out[i, j, :n] = np.asarray(sub)[:n]
    return out, np.minimum(outer, smax), np.minimum(inner, tmax)


def bucket_boundaries(lengths, num_buckets=4, multiple=8):
    """Padded-length buckets: the length quantiles rounded up to
    ``multiple`` (one bucket per static shape, in place of the
    reference's batch-shrinking dynamic shapes)."""
    lengths = np.asarray(lengths)
    qs = np.quantile(lengths, np.linspace(0, 1, num_buckets + 1)[1:])
    return sorted({int(-(-q // multiple) * multiple) for q in qs})


def bucket_for(length: int, bounds) -> int:
    """The smallest bound >= ``length`` (the largest bound past them)."""
    for b in bounds:
        if length <= b:
            return b
    return bounds[-1]


def pack_sequences(seqs, max_len, pad_value=0):
    """Greedy first-fit packing of ragged sequences into [B, max_len]
    rows: several short sequences share one row.  Returns (data [B,
    max_len], segment_ids [B, max_len] — 1-based per row, 0 = padding —
    and positions [B, max_len], the within-segment token index), numpy
    arrays.  Sequences longer than max_len are truncated."""
    rows = []          # list of (free, [seq, ...])
    for s in seqs:
        s = np.asarray(s)[:max_len]
        placed = False
        for row in rows:
            if row[0] >= len(s):
                row[1].append(s)
                row[0] -= len(s)
                placed = True
                break
        if not placed:
            rows.append([max_len - len(s), [s]])
    b = len(rows)
    data = np.full((b, max_len), pad_value,
                   rows[0][1][0].dtype if rows else np.int32)
    seg = np.zeros((b, max_len), np.int32)
    pos = np.zeros((b, max_len), np.int32)
    for i, (_, members) in enumerate(rows):
        t = 0
        for j, s in enumerate(members):
            data[i, t:t + len(s)] = s
            seg[i, t:t + len(s)] = j + 1
            pos[i, t:t + len(s)] = np.arange(len(s))
            t += len(s)
    return data, seg, pos
