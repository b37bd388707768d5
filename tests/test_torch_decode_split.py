"""The split-KV chunk kernels' arithmetic (``split_kernel`` in
``paddle_tpu_torch/csrc/decode_attention.cu``, behind
``decode_attention_slab_chunk`` and ``decode_attention_paged_chunk``),
emulated in plain torch: each (row, KV head, group of query vectors)'s
columns [0, hi] cut into splits of the kernel's fixed length (read from
the source), a (m, l, acc) per live vector and split (the dot in P
interleaved parts of 4-dim chunks with four sums each, P.V in G
interleaved column groups, P and G chosen as the kernel chooses them),
the splits merged in split order as an online softmax over the records,
an int8 cache widened code by code.

The emulation is held within 1e-5 of JAX's interpret-mode kernels
(``paddle_tpu/ops/pallas/decode_attention.py``, run as
``test_torch_decode_attention.py`` and ``test_torch_paged.py`` run them)
and of the port's plain versions: float32 on all sides, summed in other
orders (a few ulps on O(1) values).  An int8 emulation equals the
float32 one on the dequantized cache bit for bit, and a row's result
depends on its own inputs alone: the row computed alone, inside more
rows and inside a longer span is the same bit for bit.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.quant.kv import dequantize_heads, quantize_heads

TOL = 1e-5
_SRC = open(os.path.join(_build.CSRC, "decode_attention.cu")).read()
# the kernel's constants, read from its source
_SPLIT = tuple(int(x) for x in re.search(
    r"return width <= 128 \? (\d+) : width == 256 \? (\d+) : (\d+);",
    _SRC).groups())
VECS = int(re.search(r"constexpr int kVecs = (\d+);", _SRC).group(1))
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _SRC).group(1))
NEG = -1e30


def compiled_width(dh):
    return next(w for w in (16, 32, 64, 128) if dh <= w) if dh <= 128 else dh


def split_cols(width):
    return _SPLIT[0] if width <= 128 else _SPLIT[1] if width == 256 \
        else _SPLIT[2]


def _dot(qv, keys, parts):
    """q . each key row [n, W] as the kernel sums it: 4-dim chunk ch in
    part ch % parts, each part four running sums (one a lane of the
    chunk) added as (a0 + a1) + (a2 + a3), the parts added in order."""
    prod = (qv[None, :] * keys).reshape(keys.shape[0], -1, 4)
    total = None
    for p in range(parts):
        acc = torch.zeros(keys.shape[0], 4)
        for ch in range(p, prod.shape[1], parts):
            acc = acc + prod[:, ch]
        part = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])
        total = part if total is None else total + part
    return total


def _pv(p, vals, groups):
    """sum_c p[c] vals[c] as the kernel sums it: column c in group c %
    groups, each group's columns in order, the groups added in order."""
    total = None
    for grp in range(groups):
        acc = torch.zeros(vals.shape[1])
        for c in range(grp, vals.shape[0], groups):
            acc = acc + p[c] * vals[c]
        total = acc if total is None else total + acc
    return total


def emulate(q, k, v, qpos, num_heads, tables=None, kscale=None,
            vscale=None):
    """The split kernel's result for q [S, K, D], k/v a slab [S, T, Dkv]
    or (``tables`` [S, nb_row]) a pool [NB, bs, Dkv], float32 or int8
    codes with ``kscale``/``vscale``."""
    s, kk, d = q.shape
    dkv = k.shape[-1]
    dh = d // num_heads
    hkv = dkv // dh
    group = num_heads // hkv
    width = compiled_width(dh)
    length = split_cols(width)
    span = tables.shape[1] * k.shape[1] if tables is not None else k.shape[1]
    scale = 1.0 / np.sqrt(dh)
    nq = kk * group
    out = torch.zeros_like(q)

    def widened(x, sc, rows, g):
        vals = x.reshape(-1, dkv)[rows, g * dh:(g + 1) * dh].to(torch.float32)
        if sc is not None:
            vals = vals * sc.reshape(-1, hkv)[rows, g][:, None]
        return torch.nn.functional.pad(vals, (0, width - dh))

    for r in range(s):
        decode = bool(qpos[r, -1] == qpos[r, 0])
        for g in range(hkv):
            for z in range(0, nq, VECS):
                pos = {j: int(qpos[r, j // group])
                       for j in range(z, min(nq, z + VECS))
                       if not decode or j // group == 0}
                if not pos:
                    continue
                hi = min(max(pos.values()), span - 1)
                records = []
                for s0 in range(0, hi + 1, length):
                    cols = torch.arange(s0, min(s0 + length, hi + 1))
                    if tables is not None:
                        bs = k.shape[1]
                        rows = tables[r, cols // bs].long() * bs + cols % bs
                    else:
                        rows = r * span + cols
                    keys = widened(k, kscale, rows, g)
                    vals = widened(v, vscale, rows, g)
                    live = [j for j in pos if pos[j] >= s0]
                    nv, nin = len(live), len(cols)
                    parts = 1
                    while 2 * parts * nin <= THREADS \
                            and 2 * parts <= width // 4:
                        parts *= 2
                    groups = 1
                    while 2 * groups * nv * (width // 4) <= THREADS \
                            and 2 * groups <= nin:
                        groups *= 2
                    rec = {}
                    for j in live:
                        h = g * group + j % group
                        qv = torch.nn.functional.pad(
                            q[r, j // group, h * dh:(h + 1) * dh],
                            (0, width - dh))
                        keep = cols <= pos[j]
                        sc = torch.where(keep, _dot(qv, keys, parts) * scale,
                                         torch.tensor(NEG))
                        m = sc.max()
                        p = torch.where(keep, torch.exp(sc - m),
                                        torch.tensor(0.0))
                        rec[j] = (m, p.sum(), _pv(p, vals, groups))
                    records.append(rec)
                for j, pj in pos.items():
                    recs = records[:min(pj, hi) // length + 1]
                    mx, num, den = torch.tensor(NEG), 0.0, 0.0
                    for rc in recs:
                        m, l, acc = rc[j]
                        mn = torch.maximum(mx, m)
                        alpha, w = torch.exp(mx - mn), torch.exp(m - mn)
                        num = num * alpha + acc * w
                        den = den * alpha + l * w
                        mx = mn
                    h = g * group + j % group
                    out[r, j // group, h * dh:(h + 1) * dh] = (
                        num / torch.clamp(den, min=1e-30))[:dh]
    return out


def _qpos(rows, kk):
    """[S, K] positions from (live lanes, lane-0 position) rows: inactive
    lanes repeat the last live lane's position, as the engine builds
    them."""
    return np.asarray([start + np.minimum(np.arange(kk), live - 1)
                       for live, start in rows], np.int32)


SLAB = {
    # name: (rows, K, T, H, Hkv, dh, int8)
    "mixed": ([(1, 140), (4, 0), (3, 150), (4, 190), (1, 0)], 4, 200, 2, 2,
              16, False),
    "gqa": ([(1, 190), (3, 5), (4, 170), (2, 0)], 4, 192, 4, 2, 16, False),
    "dh24": ([(3, 150), (1, 159), (2, 10)], 3, 160, 2, 1, 24, False),
    "int8": ([(1, 259), (4, 60), (2, 0), (1, 0)], 4, 260, 2, 2, 32, True),
    "long": ([(1, 2047), (2, 1500), (1, 5)], 2, 2048, 2, 1, 16, False),
}
PAGED = {
    # name: (rows, K, block size, H, Hkv, dh, int8)
    "mixed": ([(1, 170), (4, 0), (3, 140), (4, 200), (1, 0)], 4, 8, 2, 2, 16,
              False),
    "gqa_int8": ([(2, 150), (1, 277), (4, 30), (1, 0)], 4, 16, 4, 2, 32,
                 True),
    "dh24": ([(3, 130), (1, 147)], 3, 8, 2, 1, 24, False),
    "long": ([(1, 2047), (2, 600), (1, 0)], 2, 16, 2, 1, 16, False),
}


def _quant(x, hkv):
    codes, scales = quantize_heads(torch.tensor(x), hkv)
    return codes.numpy(), scales.numpy()


@functools.lru_cache(maxsize=None)
def slab_case(name):
    """Seeded inputs of a SLAB case and JAX's interpret-mode result:
    (q, k, v, qpos, h, kscale, vscale, jax_out) as numpy."""
    rows, kk, t, h, hkv, dh, int8 = SLAB[name]
    rng = np.random.RandomState(len(name) * 7919 + t)
    q = rng.standard_normal((len(rows), kk, h * dh)).astype(np.float32)
    k, v = (rng.standard_normal((len(rows), t, hkv * dh)).astype(np.float32)
            for _ in range(2))
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = _quant(k, hkv), _quant(v, hkv)
    qpos = _qpos(rows, kk)
    extra = {} if ks is None else dict(kscale=jnp.asarray(ks),
                                       vscale=jnp.asarray(vs))
    want = np.asarray(jax_dk.decode_attention_slab_chunk(
        *map(jnp.asarray, (q, k, v, qpos)), h, interpret=True, **extra))
    return q, k, v, qpos, h, ks, vs, want


@functools.lru_cache(maxsize=None)
def paged_case(name):
    """Seeded inputs of a PAGED case and JAX's interpret-mode result:
    (q, k, v, qpos, tables, h, kscale, vscale, jax_out) as numpy.  The
    pool holds each row's blocks (shuffled ids), row 2 sharing row 1's
    leading blocks, the last row free on scratch block 0, and a stale
    block (NaN, or NaN scales on an int8 pool) that table entries past
    each row's furthest block point at."""
    rows, kk, bs, h, hkv, dh, int8 = PAGED[name]
    rng = np.random.RandomState(len(name) * 104729 + bs)
    s = len(rows)
    qpos = _qpos(rows, kk)
    need = qpos[:, -1] // bs + 1
    nb_row = int(need.max()) + 2
    num_blocks = int(need.sum()) + 2
    ids = list(rng.permutation(np.arange(1, num_blocks)))
    stale = ids.pop()
    tables = np.full((s, nb_row), stale, np.int32)
    for r in range(s - 1):
        tables[r, :need[r]] = [ids.pop() for _ in range(need[r])]
    share = int(min(need[1], need[2])) if s > 2 else 0
    tables[2 % s, :share] = tables[1 % s, :share]
    tables[s - 1] = 0
    q = rng.standard_normal((s, kk, h * dh)).astype(np.float32)
    k, v = (rng.standard_normal((num_blocks, bs, hkv * dh))
            .astype(np.float32) for _ in range(2))
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = _quant(k, hkv), _quant(v, hkv)
        ks[stale] = np.nan
        vs[stale] = np.nan
    else:
        k[stale] = np.nan
        v[stale] = np.nan
    extra = {} if ks is None else dict(kscale=jnp.asarray(ks),
                                       vscale=jnp.asarray(vs))
    want = np.asarray(jax_dk.decode_attention_paged_chunk(
        *map(jnp.asarray, (q, k, v, qpos, tables)), h, interpret=True,
        **extra))
    return q, k, v, qpos, tables, h, ks, vs, want


def _t(x):
    return None if x is None else torch.tensor(x)


def test_split_lengths_cover_many_splits():
    """Every case's furthest row crosses two or more splits of the
    kernel's length, so the merge runs; the long ones at least 16."""
    def splits(rows, dh):
        return max(p for _, p in rows) // split_cols(compiled_width(dh)) + 1

    for name, (rows, *_, dh, _int8) in list(SLAB.items()) \
            + list(PAGED.items()):
        assert splits(rows, dh) >= (16 if name == "long" else 2), name


@pytest.mark.parametrize("name", sorted(SLAB))
def test_slab_emulation_matches_jax_and_plain(name):
    q, k, v, qpos, h, ks, vs, want = slab_case(name)
    args = [_t(x) for x in (q, k, v, qpos)]
    got = emulate(*args, h, kscale=_t(ks), vscale=_t(vs)).numpy()
    plain = dk.decode_attention_slab_chunk_plain(
        *args, h, kscale=_t(ks), vscale=_t(vs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)
    decode = qpos[:, -1] == qpos[:, 0]
    assert not got[decode, 1:].any()          # the fast path's zeros


@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_emulation_matches_jax_and_plain(name):
    q, k, v, qpos, tables, h, ks, vs, want = paged_case(name)
    args = [_t(x) for x in (q, k, v, qpos)]
    got = emulate(*args, h, tables=_t(tables), kscale=_t(ks),
                  vscale=_t(vs)).numpy()
    plain = dk.decode_attention_paged_chunk_plain(
        *args, _t(tables), h, kscale=_t(ks), vscale=_t(vs)).numpy()
    # finite: no stale block (NaN) was read, the free row read block 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)
    decode = qpos[:, -1] == qpos[:, 0]
    assert not got[decode, 1:].any()


@pytest.mark.parametrize("paged", [False, True])
def test_int8_equals_float32_on_dequantized_bit_for_bit(paged):
    if paged:
        q, k, v, qpos, tables, h, ks, vs, _ = paged_case("gqa_int8")
    else:
        q, k, v, qpos, h, ks, vs, _ = slab_case("int8")
        tables = None
    args = [_t(x) for x in (q, k, v, qpos)]
    got = emulate(*args, h, tables=_t(tables), kscale=_t(ks), vscale=_t(vs))
    kw, vw = dequantize_heads(_t(k), _t(ks)), dequantize_heads(_t(v), _t(vs))
    twin = emulate(_t(q), kw, vw, _t(qpos), h, tables=_t(tables))
    assert torch.equal(got, twin)


def test_slab_row_independent_of_s_and_t():
    """Each row alone, inside more rows and inside a longer slab: the
    same bits as in the batch."""
    q, k, v, qpos, h, _, _, _ = slab_case("mixed")
    q, k, v, qpos = (_t(x) for x in (q, k, v, qpos))
    batch = emulate(q, k, v, qpos, h)
    rng = np.random.RandomState(5)
    longer = [torch.cat([x, torch.tensor(rng.standard_normal(
        (x.shape[0], 200, x.shape[2])).astype(np.float32))], 1)
        for x in (k, v)]
    assert torch.equal(emulate(q, *longer, qpos, h), batch)
    more = emulate(torch.cat([q, torch.randn(3, *q.shape[1:])]),
                   torch.cat([k, torch.randn(3, *k.shape[1:])]),
                   torch.cat([v, torch.randn(3, *v.shape[1:])]),
                   torch.cat([qpos, qpos[:3]]), h)
    assert torch.equal(more[:q.shape[0]], batch)
    for r in range(q.shape[0]):
        rows = slice(r, r + 1)
        assert torch.equal(emulate(q[rows], k[rows], v[rows], qpos[rows], h),
                           batch[rows])


def test_paged_row_independent_of_s_and_span():
    """Each row alone, inside more rows and with a longer block table
    (entries past its furthest block on the stale block): the same bits
    as in the batch."""
    q, k, v, qpos, tables, h, _, _, _ = paged_case("mixed")
    q, k, v, qpos, tables = (_t(x) for x in (q, k, v, qpos, tables))
    batch = emulate(q, k, v, qpos, h, tables=tables)
    stale = int(tables[0, -1])
    wide = torch.cat([tables, torch.full((tables.shape[0], 30), stale,
                                         dtype=torch.int32)], 1)
    assert torch.equal(emulate(q, k, v, qpos, h, tables=wide), batch)
    more = emulate(torch.cat([q, q[:2]]), k, v, torch.cat([qpos, qpos[:2]]),
                   h, tables=torch.cat([tables, tables[:2]]))
    assert torch.equal(more[:q.shape[0]], batch)
    for r in range(q.shape[0]):
        rows = slice(r, r + 1)
        assert torch.equal(emulate(q[rows], k, v, qpos[rows], h,
                                   tables=tables[rows]), batch[rows])
