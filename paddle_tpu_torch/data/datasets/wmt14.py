"""WMT14 fr-en NMT (reference v2/dataset/wmt14.py: (src_ids, trg_ids,
trg_next_ids) triples with <s>/<e>/<unk>), the small-vocab surface: a
deterministic synthetic corpus (no download) in the same triple format,
whose "translation" is the source reversed and offset.  A copy of
``paddle_tpu/data/datasets/wmt14.py``: the same samples element for
element."""

import numpy as np

from paddle_tpu_torch.data.datasets._synth import rng_for

SRC_DICT_SIZE = 3000
TRG_DICT_SIZE = 3000
START, END, UNK = 0, 1, 2


def _reader(split, n):
    def reader():
        rng = rng_for("wmt14", split)
        for _ in range(n):
            slen = int(rng.randint(3, 30))
            src = list(rng.randint(3, SRC_DICT_SIZE, size=slen))
            # synthetic "translation": reversed + offset, teaches copying
            trg = [(t + 7) % (TRG_DICT_SIZE - 3) + 3 for t in src[::-1]]
            trg_in = [START] + trg
            trg_next = trg + [END]
            yield src, trg_in, trg_next
    return reader


def train(dict_size=SRC_DICT_SIZE):
    return _reader("train", 2048)


def test(dict_size=SRC_DICT_SIZE):
    return _reader("test", 256)
