"""Data path (``paddle_tpu/data``): reader decorators, the input type
declarations with ``@provider`` and its cache types, the DataFeeder, the
device prefetcher (``data.prefetch``), the reference's proto data files
(``data.proto_format``) and the datasets of the zoo
(``data.datasets``)."""

from paddle_tpu_torch.data import reader
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.data.prefetch import ShardedPrefetcher, device_placer
from paddle_tpu_torch.data.provider import (
    CacheType, InputType, SeqType, dense_vector, dense_vector_sequence,
    integer_value, integer_value_sequence, integer_value_sub_sequence,
    provider, sparse_binary_vector, sparse_binary_vector_sequence,
    sparse_float_vector, sparse_float_vector_sequence)

__all__ = [
    "reader", "provider", "DataFeeder", "ShardedPrefetcher",
    "device_placer", "dense_vector", "sparse_binary_vector",
    "sparse_float_vector", "integer_value", "dense_vector_sequence",
    "sparse_binary_vector_sequence", "sparse_float_vector_sequence",
    "integer_value_sequence", "integer_value_sub_sequence", "SeqType",
    "InputType", "CacheType",
]
