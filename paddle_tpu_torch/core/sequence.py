"""Ragged sequence batches as padded dense data plus lengths
(``paddle_tpu/core/sequence.py``).

``SequenceBatch`` — data [B, T, ...] + lengths [B], one sequence level;
``bucket_for`` and ``pack_sequences`` (host-side numpy) for the data
path.  Nested batches are not ported yet (ROADMAP).
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
