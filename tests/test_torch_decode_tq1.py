"""The Tq=1 decode kernels' arithmetic on the split-KV template
(``split_kernel`` in ``paddle_tpu_torch/csrc/decode_attention.cu`` at
K = 1, behind ``decode_attention_slab`` and ``decode_attention_paged``),
emulated in plain torch on the CPU.

The emulation is ``tests/test_torch_decode_split.py``'s (each (row, KV
head, group of query vectors)'s columns [0, hi] cut into splits, a
(m, l, acc) per live vector and split, the dot and P.V in the kernel's
parts and groups, the records merged in split order), run at K = 1.
(At H = Hkv the kernel holds one query vector a CTA, not kVecs; a row
then has one vector a KV head, which makes one group at any count a
CTA, so the chunked emulation's grouping holds.)  It is
held within 1e-5 of JAX's interpret-mode kernels
(``paddle_tpu/ops/pallas/decode_attention.py``'s ``decode_attention_slab``
and ``decode_attention_paged``) and of the port's plain versions at
ragged spans, a span of 2048 crossing many splits, GQA, padded head dims
and the wide 256; an int8 emulation equals the float32 one on the
dequantized cache bit for bit; and a row's result depends on its own
inputs alone (alone, inside more rows, inside a longer span: the same
bits).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_decode_split as split_emu
from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.quant.kv import dequantize_heads, quantize_heads

TOL = 1e-5


def emulate(q, k, v, pos, num_heads, tables=None, kscale=None,
            vscale=None):
    """The Tq=1 kernel's result for q [S, D], positions [S]: the split
    template's at K = 1."""
    return split_emu.emulate(q[:, None], k, v, pos[:, None], num_heads,
                             tables=tables, kscale=kscale,
                             vscale=vscale)[:, 0]


CASES = {
    # name: (positions, span (slab T, or the pool's block size), H, Hkv,
    #        dh, int8, paged)
    "slab": ([140, 0, 199, 57, 128], 200, 2, 2, 16, False, False),
    "slab_gqa": ([191, 5, 130], 192, 4, 2, 16, False, False),
    "slab_dh24": ([159, 0, 77], 160, 2, 1, 24, False, False),
    "slab_int8": ([259, 60, 0, 131], 260, 2, 2, 32, True, False),
    "slab_long": ([2047, 1500, 5], 2048, 2, 1, 16, False, False),
    "slab_dh256": ([70, 33, 0], 72, 2, 2, 256, False, False),
    "paged": ([170, 0, 140, 200], 8, 2, 2, 16, False, True),
    "paged_gqa_int8": ([150, 277, 30, 0], 16, 4, 2, 32, True, True),
    "paged_long": ([2047, 600, 0], 16, 2, 1, 16, False, True),
}


def _quant(x, hkv):
    codes, scales = quantize_heads(torch.tensor(x), hkv)
    return codes.numpy(), scales.numpy()


@functools.lru_cache(maxsize=None)
def case(name):
    """Seeded inputs of a case and JAX's interpret-mode result: (q, k,
    v, pos, tables or None, h, kscale, vscale, jax_out) as numpy.  A
    paged case's pool holds each row's blocks (shuffled ids), row 2
    sharing row 1's leading blocks, the last row free on scratch block
    0, and a stale block (NaN, or NaN scales) that table entries past
    each row's furthest block point at."""
    pos, span, h, hkv, dh, int8, paged = CASES[name]
    pos = np.asarray(pos, np.int32)
    s = len(pos)
    rng = np.random.RandomState(len(name) * 7919 + span + dh)
    q = rng.standard_normal((s, h * dh)).astype(np.float32)
    tables = None
    if paged:
        bs = span
        need = pos // bs + 1
        nb_row = int(need.max()) + 2
        num_blocks = int(need.sum()) + 2
        ids = list(rng.permutation(np.arange(1, num_blocks)))
        stale = ids.pop()
        tables = np.full((s, nb_row), stale, np.int32)
        for r in range(s - 1):
            tables[r, :need[r]] = [ids.pop() for _ in range(need[r])]
        share = int(min(need[1], need[2]))
        tables[2, :share] = tables[1, :share]
        tables[s - 1] = 0
        pos[s - 1] = 0
        shape = (num_blocks, bs, hkv * dh)
    else:
        shape = (s, span, hkv * dh)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = _quant(k, hkv), _quant(v, hkv)
    if paged:
        bad = (ks, vs) if int8 else (k, v)
        for x in bad:
            x[stale] = np.nan
    extra = {} if ks is None else dict(kscale=jnp.asarray(ks),
                                       vscale=jnp.asarray(vs))
    fn = jax_dk.decode_attention_paged if paged \
        else jax_dk.decode_attention_slab
    args = (q, k, v, pos) + ((tables,) if paged else ())
    want = np.asarray(fn(*map(jnp.asarray, args), h, interpret=True,
                         **extra))
    return q, k, v, pos, tables, h, ks, vs, want


def _t(x):
    return None if x is None else torch.tensor(x)


def test_cases_cross_many_splits():
    """Every case's furthest row crosses two or more splits, so the
    merge runs; the long ones at least 16."""
    for name, (pos, *_, dh, _int8, _paged) in CASES.items():
        width = split_emu.compiled_width(dh)
        splits = max(pos) // split_emu.split_cols(width) + 1
        assert splits >= (16 if name.endswith("long") else 2), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_jax_and_plain(name):
    q, k, v, pos, tables, h, ks, vs, want = case(name)
    args = [_t(x) for x in (q, k, v, pos)]
    got = emulate(*args, h, tables=_t(tables), kscale=_t(ks),
                  vscale=_t(vs)).numpy()
    if tables is None:
        plain = dk.decode_attention_slab_plain(*args, h, kscale=_t(ks),
                                               vscale=_t(vs)).numpy()
    else:
        plain = dk.decode_attention_paged_plain(*args, _t(tables), h,
                                                kscale=_t(ks),
                                                vscale=_t(vs)).numpy()
    # finite: no stale block was read, the free row read block 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["slab_int8", "paged_gqa_int8"])
def test_int8_equals_float32_on_dequantized_bit_for_bit(name):
    q, k, v, pos, tables, h, ks, vs, _ = case(name)
    got = emulate(_t(q), _t(k), _t(v), _t(pos), h, tables=_t(tables),
                  kscale=_t(ks), vscale=_t(vs))
    kw, vw = dequantize_heads(_t(k), _t(ks)), dequantize_heads(_t(v), _t(vs))
    twin = emulate(_t(q), kw, vw, _t(pos), h, tables=_t(tables))
    assert torch.equal(got, twin)


def test_row_independent_of_s_and_span():
    """Each row alone, inside more rows and inside a longer slab (or a
    longer table on the stale block): the same bits as in the batch."""
    q, k, v, pos, _, h, _, _, _ = case("slab")
    q, k, v, pos = (_t(x) for x in (q, k, v, pos))
    batch = emulate(q, k, v, pos, h)
    rng = np.random.RandomState(5)
    longer = [torch.cat([x, torch.tensor(rng.standard_normal(
        (x.shape[0], 300, x.shape[2])).astype(np.float32))], 1)
        for x in (k, v)]
    assert torch.equal(emulate(q, *longer, pos, h), batch)
    for r in range(q.shape[0]):
        rows = slice(r, r + 1)
        assert torch.equal(emulate(q[rows], k[rows], v[rows], pos[rows], h),
                           batch[rows])
    q, k, v, pos, tables, h, _, _, _ = case("paged")
    q, k, v, pos, tables = (_t(x) for x in (q, k, v, pos, tables))
    batch = emulate(q, k, v, pos, h, tables=tables)
    stale = int(tables[0, -1])
    wide = torch.cat([tables, torch.full((tables.shape[0], 30), stale,
                                         dtype=torch.int32)], 1)
    assert torch.equal(emulate(q, k, v, pos, h, tables=wide), batch)
    more = emulate(torch.cat([q, q[:2]]), k, v, torch.cat([pos, pos[:2]]),
                   h, tables=torch.cat([tables, tables[:2]]))
    assert torch.equal(more[:q.shape[0]], batch)
