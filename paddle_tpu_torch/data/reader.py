"""Reader decorators (a JAX-free copy of ``paddle_tpu/data/reader.py``).

Reference: python/paddle/v2/reader/decorator.py — map_readers, buffered,
shuffle, batched(+minibatch.py), compose, chain, firstn — and the creator
helpers.  A reader is a zero-arg callable returning an iterator of samples.
"""

import itertools
import random
import threading
import queue as _queue


def map_readers(func, *readers):
    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return reader


def shuffle(reader, buf_size, seed=None):
    def new_reader():
        rng = random.Random(seed)
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf
    return new_reader


def buffered(reader, size):
    """Async prefetch thread (reference DoubleBuffer, DataProvider.h:251)."""
    _end = object()

    def new_reader():
        q = _queue.Queue(maxsize=size)

        def fill():
            try:
                for item in reader():
                    q.put(item)
            finally:
                q.put(_end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _end:
                break
            yield item
    return new_reader


def batch(reader, batch_size, drop_last=False):
    def new_reader():
        it = reader()
        while True:
            chunk = list(itertools.islice(it, batch_size))
            if not chunk:
                return
            if len(chunk) < batch_size and drop_last:
                return
            yield chunk
    return new_reader


batched = batch


def compose(*readers):
    def new_reader():
        for items in zip(*[r() for r in readers]):
            out = []
            for x in items:
                if isinstance(x, tuple):
                    out.extend(x)
                else:
                    out.append(x)
            yield tuple(out)
    return new_reader


def chain(*readers):
    def new_reader():
        for r in readers:
            yield from r()
    return new_reader


def firstn(reader, n):
    def new_reader():
        yield from itertools.islice(reader(), n)
    return new_reader


def cache(reader):
    data = []
    filled = []

    def new_reader():
        if not filled:
            data.extend(reader())
            filled.append(True)
        yield from data
    return new_reader


def mix(readers_and_ratios, seed=0):
    """Interleave readers with given sampling ratios (reference
    MultiDataProvider, gserver/dataproviders/MultiDataProvider.cpp: mixes
    sub-providers by config ratio).  readers_and_ratios: [(reader, ratio)].
    Exhausted readers drop out; stops when all are exhausted."""
    import numpy as np

    def new_reader():
        rng = np.random.RandomState(seed)
        iters = [iter(r()) for r, _ in readers_and_ratios]
        weights = np.asarray([float(w) for _, w in readers_and_ratios])
        alive = [True] * len(iters)
        while any(alive):
            w = np.where(alive, weights, 0.0)
            total = w.sum()
            if total <= 0:
                break
            i = int(rng.choice(len(iters), p=w / total))
            try:
                yield next(iters[i])
            except StopIteration:
                alive[i] = False
    return new_reader


def packed(reader, max_len, buffer_size=256, pad_value=0):
    """Pack a reader of ragged token sequences into (data, segment_ids,
    positions) rows of width max_len (core.sequence.pack_sequences):
    several short sequences share a row, and the segment ids keep
    attention block-diagonal per segment (``ops/attention``'s
    ``segment_mask`` / ``chunked_attention``; the LM's packed-row entry,
    ``models/transformer.encode(segment_ids=)``, is ROADMAP A2).  Buffers
    `buffer_size` sequences per packing round
    so first-fit has material to work with; yields one packed ROW per
    item (compose with batch() for [B, max_len] feeds).  Sequences longer
    than max_len are TRUNCATED to it (warned once per stream — split long
    documents upstream if the tail matters)."""
    from paddle_tpu_torch.core.sequence import pack_sequences
    from paddle_tpu_torch.utils.logging import logger

    def new_reader():
        buf = []
        warned = [False]

        def flush():
            data, seg, pos = pack_sequences(buf, max_len,
                                            pad_value=pad_value)
            # clear BEFORE yielding: a consumer that abandons the stream
            # mid-flush (zip with a shorter iterator) must not leave the
            # buffer populated in the suspended frame
            buf.clear()
            for i in range(data.shape[0]):
                yield data[i], seg[i], pos[i]

        for s in reader():
            if len(s) > max_len and not warned[0]:
                warned[0] = True
                logger.warning(
                    "packed(): sequence of %d tokens truncated to "
                    "max_len=%d (further truncations not logged)",
                    len(s), max_len)
            buf.append(s)
            if len(buf) >= buffer_size:
                yield from flush()
        if buf:
            yield from flush()
    return new_reader
