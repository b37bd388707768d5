"""Data path (``paddle_tpu/data``): reader decorators, the input type
declarations, the DataFeeder and four datasets of the zoo
(``data.datasets``: mnist, cifar, imdb, movielens).  The ``@provider`` decorator, the
prefetcher and the rest of the zoo are not ported yet (ROADMAP A9·f)."""

from paddle_tpu_torch.data import reader
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.data.provider import (
    InputType, SeqType, dense_vector, dense_vector_sequence, integer_value,
    integer_value_sequence, integer_value_sub_sequence, sparse_binary_vector,
    sparse_binary_vector_sequence, sparse_float_vector,
    sparse_float_vector_sequence)

__all__ = [
    "reader", "DataFeeder", "dense_vector", "sparse_binary_vector",
    "sparse_float_vector", "integer_value", "dense_vector_sequence",
    "sparse_binary_vector_sequence", "sparse_float_vector_sequence",
    "integer_value_sequence", "integer_value_sub_sequence", "SeqType",
    "InputType",
]
