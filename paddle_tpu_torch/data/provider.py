"""The PyDataProvider2-compatible ``@provider`` decorator and the input
type declarations (``paddle_tpu/data/provider.py``; reference
python/paddle/trainer/PyDataProvider2.py:25-210): dense, sparse-binary,
sparse-float and integer inputs, each with no sequence, a sequence or
sub-sequences, which tell ``DataFeeder`` how to pack a slot; the cache
types; and ``@provider``, which turns a generator into a reader factory.
"""

import dataclasses
import functools
import logging
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


class CacheType(Enum):
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


def provider(input_types=None, cache=CacheType.NO_CACHE, should_shuffle=None,
             init_hook=None, min_pool_size=-1, pool_size=-1,
             calc_batch_size=None, check=False, check_fail_continue=False,
             **outer_kwargs):
    """``@provider(input_types={'word': integer_value_sequence(n), ...})``.

    The generator has the signature gen(settings, filename) and yields
    dicts keyed by input name (or tuples in declaration order).  Returns
    a reader factory: fn(file_list, **kw) -> a reader for
    ``trainer.SGD``, whose ``input_types`` are the declared ones or what
    ``init_hook`` put on the settings (``input_types``, or the legacy
    ``slots``).  init_hook(settings, file_list=..., **kw) runs before
    reading; without one the keywords become settings attributes.
    CACHE_PASS_IN_MEM keeps the first pass's samples and replays them.
    pool_size, calc_batch_size and check* are accepted for config
    compatibility; shuffling and pooling are the reader pipeline's."""
    def deco(gen):
        @functools.wraps(gen)
        def make_reader(file_list, **kw):
            files = [file_list] if isinstance(file_list, str) \
                else list(file_list)

            class Settings:
                pass

            settings = Settings()
            settings.input_types = input_types
            settings.logger = logging.getLogger("provider")
            if init_hook is not None:
                # the reference passes file_list to the hook
                init_hook(settings, file_list=files,
                          **{**outer_kwargs, **kw})
            else:
                for k, v in {**outer_kwargs, **kw}.items():
                    setattr(settings, k, v)

            cached = []

            def reader():
                if cache == CacheType.CACHE_PASS_IN_MEM and cached:
                    yield from cached
                    return
                for f in files:
                    for sample in gen(settings, f):
                        if cache == CacheType.CACHE_PASS_IN_MEM:
                            cached.append(sample)
                        yield sample
            reader.input_types = (getattr(settings, "input_types", None)
                                  or getattr(settings, "slots", None))
            return reader
        make_reader.input_types = input_types
        return make_reader
    return deco
