"""DataFeeder: host samples -> device tensors and SequenceBatches
(``paddle_tpu/data/feeder.py``; reference python/paddle/v2/data_feeder.py).

Ragged samples are padded with numpy into a ``SequenceBatch`` (padded
[B, T, ...] plus lengths), sparse vectors are densified, and the result
lands on the feeder's device (the card unless "cpu") as int32 / float32
tensors.  ``bucket_bounds`` rounds each sequence slot's padded length up
to a bound (sequences past the largest bound are truncated to it,
warned once per slot); ``pad_batch_to`` repeats the last sample to fill
a short final batch.  A sub-sequence slot becomes a
``NestedSequenceBatch`` (padded [B, S, T, ...] with int32 outer and
inner lengths, not bucketed), as JAX's feeder packs it.
"""

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch, bucket_for, nested_arrays
from paddle_tpu_torch.data.provider import InputType, SeqType
from paddle_tpu_torch.utils.logging import logger


def _pad(seqs, max_len, dtype):
    """(data [B, max_len, ...], lengths [B]) numpy, zero-padded; longer
    sequences are cut to max_len."""
    lengths = np.minimum([len(s) for s in seqs], max_len).astype(np.int32)
    out = np.zeros((len(seqs), max_len) + np.shape(seqs[0])[1:], dtype)
    for i, (s, n) in enumerate(zip(seqs, lengths)):
        out[i, :n] = s[:n]
    return out, lengths


def _dense_rows(itype, rows):
    """[N, dim] float32 from N sparse rows (ids, or (id, value) pairs)."""
    out = np.zeros((len(rows), itype.dim), np.float32)
    for i, row in enumerate(rows):
        if itype.kind == "sparse_binary":
            out[i, np.asarray(row, np.int64)] = 1.0
        else:
            for j, v in row:
                out[i, j] = v
    return out


class DataFeeder:
    def __init__(self, feeding, bucket_bounds=None, pad_batch_to=None,
                 device=None):
        """feeding: {name: InputType}, in the order of a tuple sample's
        fields.  device: where the tensors land (the card unless
        "cpu")."""
        self.feeding = feeding
        self.bucket_bounds = sorted(bucket_bounds) if bucket_bounds else None
        self.pad_batch_to = pad_batch_to
        self.device = _device.resolve(device)
        self._warned_truncate = set()   # slot names already warned

    def _convert_one(self, name, itype: InputType, columns):
        """One slot of the batch as numpy: an array, (data, lengths) for
        a sequence slot, or a NestedSequenceBatch of numpy arrays for a
        sub-sequence slot."""
        # py2-era providers yield lazy iterables (map objects etc.)
        columns = [list(c) if not isinstance(c, (list, tuple, np.ndarray,
                                                 int, float, np.integer))
                   and hasattr(c, "__iter__") else c for c in columns]
        if itype.seq_type == SeqType.NO_SEQUENCE:
            if itype.kind == "index":
                return np.asarray(columns, np.int32).reshape(len(columns))
            if itype.kind == "dense":
                return np.asarray(columns, np.float32)
            return _dense_rows(itype, columns)
        if itype.seq_type == SeqType.SUB_SEQUENCE:
            dtype = np.int32 if itype.kind == "index" else np.float32
            return NestedSequenceBatch(*nested_arrays(
                [[np.asarray(sub, dtype) for sub in s] for s in columns]))
        if itype.kind == "index":
            seqs = [np.asarray(s, np.int32) for s in columns]
        elif itype.kind == "dense":
            seqs = [np.asarray(s, np.float32) for s in columns]
        else:
            seqs = [_dense_rows(itype, s) for s in columns]
        max_len = max(len(s) for s in seqs)
        if self.bucket_bounds:
            if max_len > self.bucket_bounds[-1] \
                    and name not in self._warned_truncate:
                self._warned_truncate.add(name)
                logger.warning(
                    "DataFeeder: %r sequences of length %d exceed the "
                    "largest bucket (%d) and are TRUNCATED to it; raise "
                    "the bucket bounds if this is not intended",
                    name, max_len, self.bucket_bounds[-1])
            max_len = bucket_for(max_len, self.bucket_bounds)
        return _pad(seqs, max_len, seqs[0].dtype)

    def __call__(self, batch):
        """batch: list of dicts {name: sample} or tuples in feeding
        order -> {name: tensor, SequenceBatch or NestedSequenceBatch} on
        the device."""
        names = list(self.feeding)
        if self.pad_batch_to and len(batch) < self.pad_batch_to:
            batch = list(batch) + [batch[-1]] * (self.pad_batch_to - len(batch))
        feed = {}
        for idx, name in enumerate(names):
            if isinstance(batch[0], dict):
                columns = [b[name] for b in batch]
            else:
                columns = [b[idx] for b in batch]
            value = self._convert_one(name, self.feeding[name], columns)
            if isinstance(value, NestedSequenceBatch):
                feed[name] = NestedSequenceBatch(
                    *(torch.from_numpy(a).to(self.device) for a in value))
            elif isinstance(value, tuple):
                feed[name] = SequenceBatch(
                    data=torch.from_numpy(value[0]).to(self.device),
                    lengths=torch.from_numpy(value[1]).to(self.device))
            else:
                feed[name] = torch.from_numpy(value).to(self.device)
        return feed
