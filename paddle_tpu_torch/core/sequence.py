"""Ragged sequence batches as padded dense data plus lengths
(``paddle_tpu/core/sequence.py``).

``SequenceBatch`` — data [B, T, ...] + lengths [B], one sequence level.
Nested batches, bucketing and packing are not ported yet (ROADMAP).
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
