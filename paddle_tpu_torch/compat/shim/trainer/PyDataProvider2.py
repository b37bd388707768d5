"""``from paddle.trainer.PyDataProvider2 import *`` during a port parse
(reference python/paddle/trainer/PyDataProvider2.py) ->
``paddle_tpu_torch.data.provider``, with the reference's slot aliases."""

from paddle_tpu_torch.data.provider import (  # noqa: F401
    provider, CacheType, SeqType, InputType,
    dense_vector, sparse_binary_vector, sparse_float_vector, integer_value,
    dense_vector_sequence, sparse_binary_vector_sequence,
    sparse_float_vector_sequence, integer_value_sequence,
    integer_value_sub_sequence,
)

# reference aliases
dense_slot = dense_vector
sparse_binary_slot = sparse_binary_vector
sparse_float_slot = sparse_float_vector
index_slot = integer_value

__all__ = [
    "provider", "CacheType", "SeqType", "InputType",
    "dense_vector", "sparse_binary_vector", "sparse_float_vector",
    "integer_value", "dense_vector_sequence",
    "sparse_binary_vector_sequence", "sparse_float_vector_sequence",
    "integer_value_sequence", "integer_value_sub_sequence",
    "dense_slot", "sparse_binary_slot", "sparse_float_slot", "index_slot",
]
