"""Input type declarations (``paddle_tpu/data/provider.py:16-63``;
reference python/paddle/trainer/PyDataProvider2.py:25-120): dense,
sparse-binary, sparse-float and integer inputs, each with no sequence,
a sequence or sub-sequences.  They tell ``DataFeeder`` how to pack a
slot.  The ``@provider`` decorator and its cache types are not ported
yet (ROADMAP A9·f).
"""

import dataclasses
from enum import Enum


class SeqType(Enum):
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


@dataclasses.dataclass(frozen=True)
class InputType:
    dim: int
    seq_type: SeqType
    kind: str  # dense | sparse_binary | sparse_float | index


def dense_vector(dim, seq_type=SeqType.NO_SEQUENCE):
    return InputType(dim, seq_type, "dense")


def sparse_binary_vector(dim, seq_type=SeqType.NO_SEQUENCE):
    return InputType(dim, seq_type, "sparse_binary")


def sparse_float_vector(dim, seq_type=SeqType.NO_SEQUENCE):
    return InputType(dim, seq_type, "sparse_float")


def integer_value(value_range, seq_type=SeqType.NO_SEQUENCE):
    return InputType(value_range, seq_type, "index")


def dense_vector_sequence(dim):
    return dense_vector(dim, SeqType.SEQUENCE)


def sparse_binary_vector_sequence(dim):
    return sparse_binary_vector(dim, SeqType.SEQUENCE)


def sparse_float_vector_sequence(dim):
    return sparse_float_vector(dim, SeqType.SEQUENCE)


def integer_value_sequence(value_range):
    return integer_value(value_range, SeqType.SEQUENCE)


def integer_value_sub_sequence(value_range):
    return integer_value(value_range, SeqType.SUB_SEQUENCE)
