"""The port's paged KV layout on the CPU: the paged decode-attention
kernels' plain versions against the JAX Pallas kernels in interpret mode,
``serving/kv_pool.py`` against the JAX allocator on one seeded script,
``lm_decode_chunk_paged`` / ``lm_decode_step_paged`` against their JAX
twins, and the paged engine (prefix cache, copy-on-write, pool-pressure
preemption) against the port's ``lm_generate`` and its own slab layout.

Tolerance 1e-4 (``tests/test_torch_lm.py``): float32 on both sides, sums
in different orders (the Pallas kernels run a blocked online softmax, the
plain versions a materialized one; observed differences ~1e-6).  Engine
streams are held against ``lm_generate`` while the reference's
top-1/top-2 logit margin exceeds MARGIN (the chunked step and prefill +
decode step round differently, ~1e-7); the port's own paged and slab
layouts share every plain path and are held token for token.
"""

import threading
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu.serving import kv_pool as jax_pool
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.serving import (DecodeEngine, GenerationBatcher,
                                      InvalidRequestError)
from paddle_tpu_torch.serving import kv_pool
from paddle_tpu_torch.utils.error import ConfigError

TOL = 1e-4
MARGIN = 1e-5
VOCAB, D_MODEL, LAYERS, HEADS, DFF = 64, 32, 2, 2, 64
MAX_LEN, SLOTS, K, BS = 48, 4, 4, 4


# ------------------------------------------------------------ kernels

# name: (rows as (live lanes, lane-0 position), K, block size, H, Hkv,
#        dh).  The last row is a free row (position 0, table all scratch);
#        rows 1 and 2 share their leading blocks.
CASES = {
    "mixed": ([(1, 9), (4, 8), (2, 17), (4, 20), (1, 0)], 4, 4, 2, 2, 16),
    "gqa_boundaries": ([(1, 15), (3, 13), (4, 28), (2, 7), (1, 0)], 4, 8,
                       4, 2, 16),
    "k1": ([(1, 3), (1, 7), (1, 16), (1, 0)], 1, 8, 2, 1, 16),
    "ragged_dh32": ([(5, 0), (8, 11), (3, 30), (1, 0)], 8, 4, 2, 2, 32),
}


def _paged_inputs(name, rng):
    """(q [S, K, D], pool k/v [NB, bs, Dkv], qpos [S, K], tables [S, nb],
    H, stale block id).  Blocks are drawn shuffled from the pool; table
    entries past a row's furthest block point at a NaN-poisoned stale
    block that no row may read."""
    rows, kk, bs, h, hkv, dh = CASES[name]
    s = len(rows)
    qpos = np.asarray([start + np.minimum(np.arange(kk), live - 1)
                       for live, start in rows], np.int32)
    span = qpos[:, -1] // bs + 1                 # blocks each row reads
    nb_row = int(span.max()) + 1
    num_blocks = int(span.sum()) + 2             # + scratch + stale
    ids = rng.permutation(np.arange(1, num_blocks))
    stale, ids = int(ids[0]), list(ids[1:])
    tables = np.full((s, nb_row), stale, np.int32)
    for r in range(s - 1):
        tables[r, :span[r]] = [ids.pop() for _ in range(span[r])]
    share = int(min(span[1], span[2]))
    tables[2, :share] = tables[1, :share]        # a shared prefix
    tables[s - 1] = kv_pool.SCRATCH_BLOCK        # the free row
    q = rng.standard_normal((s, kk, h * dh)).astype(np.float32)
    k = rng.standard_normal((num_blocks, bs, hkv * dh)).astype(np.float32)
    v = rng.standard_normal((num_blocks, bs, hkv * dh)).astype(np.float32)
    k[stale] = np.nan
    v[stale] = np.nan
    return q, k, v, qpos, tables, h


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_chunk_plain_matches_jax_kernel_interpret(np_rng, name):
    q, k, v, qpos, tables, h = _paged_inputs(name, np_rng)
    want = np.asarray(jax_dk.decode_attention_paged_chunk(
        *map(jnp.asarray, (q, k, v, qpos, tables)), h, interpret=True))
    got = dk.decode_attention_paged_chunk_plain(
        *_t(q, k, v, qpos, tables), h).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    decode = qpos[:, -1] == qpos[:, 0]
    assert not got[decode, 1:].any() and not want[decode, 1:].any()
    # the wrapper on CPU tensors is the plain version and counts nothing
    before = dk.launches_paged_chunk
    np.testing.assert_array_equal(dk.decode_attention_paged_chunk(
        *_t(q, k, v, qpos, tables), h).numpy(), got)
    assert dk.launches_paged_chunk == before


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_tq1_plain_matches_jax_kernel_interpret(np_rng, name):
    q, k, v, qpos, tables, h = _paged_inputs(name, np_rng)
    q1, pos = np.ascontiguousarray(q[:, 0]), qpos[:, 0].copy()
    want = np.asarray(jax_dk.decode_attention_paged(
        *map(jnp.asarray, (q1, k, v, pos, tables)), h, interpret=True))
    got = dk.decode_attention_paged_plain(*_t(q1, k, v, pos, tables),
                                          h).numpy()
    assert got.shape == q1.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    before = dk.launches_paged
    np.testing.assert_array_equal(dk.decode_attention_paged(
        *_t(q1, k, v, pos, tables), h).numpy(), got)
    assert dk.launches_paged == before


@pytest.mark.parametrize("name", sorted(CASES))
def test_slab_tq1_plain_matches_jax_kernel_interpret(np_rng, name):
    rows, _kk, _bs, h, hkv, dh = CASES[name]
    s, t = len(rows), 40
    q = np_rng.standard_normal((s, h * dh)).astype(np.float32)
    k = np_rng.standard_normal((s, t, hkv * dh)).astype(np.float32)
    v = np_rng.standard_normal((s, t, hkv * dh)).astype(np.float32)
    pos = np.asarray([min(start, t - 1) for _l, start in rows], np.int32)
    pos[0] = t - 1                                  # a row ending at T-1
    want = np.asarray(jax_dk.decode_attention_slab(
        *map(jnp.asarray, (q, k, v, pos)), h, block_k=8, interpret=True))
    got = dk.decode_attention_slab_plain(*_t(q, k, v, pos), h).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    before = dk.launches_slab
    np.testing.assert_array_equal(
        dk.decode_attention_slab(*_t(q, k, v, pos), h).numpy(), got)
    assert dk.launches_slab == before


def _good_paged(np_rng):
    q, k, v, qpos, tables, h = _paged_inputs("mixed", np_rng)
    return dict(q=torch.tensor(q), k=torch.tensor(k), v=torch.tensor(v),
                qpos=torch.tensor(qpos), tables=torch.tensor(tables),
                num_heads=h)


def _dh160(args):
    """One head of width 160: neither up to 128 nor a multiple of it."""
    s, kk, _ = args["q"].shape
    nb, bs, _ = args["k"].shape
    return dict(args, q=torch.zeros(s, kk, 160), k=torch.zeros(nb, bs, 160),
                v=torch.zeros(nb, bs, 160), num_heads=1)


@pytest.mark.parametrize("bad, exc", [
    (lambda a: dict(a, tables=a["tables"].long()), TypeError),
    (lambda a: dict(a, tables=a["tables"][:-1].contiguous()), ValueError),
    (lambda a: dict(a, tables=a["tables"][:, 0].contiguous()), ValueError),
    (lambda a: dict(a, qpos=a["qpos"][:-1].contiguous()), ValueError),
    (lambda a: dict(a, v=a["v"][:-1].contiguous()), ValueError),
    (lambda a: _dh160(a), ValueError),    # head dim 160: JAX refuses too
])
def test_paged_wrappers_bad_arguments_raise(np_rng, bad, exc):
    args = bad(_good_paged(np_rng))
    with pytest.raises(exc):
        dk.decode_attention_paged_chunk(**args)
    one = dict(args, q=args["q"][:, 0].contiguous(),
               positions=args.pop("qpos")[:, 0].contiguous())
    with pytest.raises(exc):
        dk.decode_attention_paged(**one)


# ------------------------------------------------------------ kv_pool


def test_block_pool_alloc_share_release_and_errors():
    pool = kv_pool.BlockPool(num_blocks=5, block_size=4)
    assert pool.num_allocatable == 4 and pool.num_free == 4
    a, b = pool.alloc(), pool.alloc()
    assert {a, b}.isdisjoint({kv_pool.SCRATCH_BLOCK})
    pool.share(a)
    assert pool.refcount(a) == 2
    pool.release(a)
    pool.release(a)
    assert pool.num_free == 3
    with pytest.raises(RuntimeError, match="double free"):
        pool.release(a)
    with pytest.raises(RuntimeError, match="unowned"):
        pool.share(a)
    c, d = pool.alloc(), pool.alloc()
    assert pool.alloc() is not None and pool.alloc() is None
    pool.check()
    pool.release(b), pool.release(c), pool.release(d)
    pool._ref[2] += 1                   # a manufactured leak
    with pytest.raises(AssertionError):
        pool.check()
    with pytest.raises(ConfigError):
        kv_pool.BlockPool(num_blocks=1, block_size=4)
    with pytest.raises(ConfigError):
        kv_pool.BlockPool(num_blocks=4, block_size=0)


def test_prefix_index_longest_match_and_lru():
    pool = kv_pool.BlockPool(num_blocks=12, block_size=4)
    chain = [pool.alloc() for _ in range(3)]
    idx = kv_pool.PrefixIndex(pool)
    toks = list(range(1, 11))               # 10 tokens = 2.5 blocks
    idx.register(toks, chain)
    assert len(idx) == 3                    # [0:4], [0:8], exact 10
    assert idx.lookup(toks) == (10, chain)
    assert idx.lookup(toks[:8] + [99, 98, 97]) == (8, chain[:2])
    assert idx.lookup(toks[:4] + [99] * 6) == (4, chain[:1])
    assert idx.lookup([99, 98]) == (0, [])
    assert sum(map(len, idx.chains())) == 6 and pool.refcount(chain[0]) == 4
    while idx.evict_lru():
        pass
    assert len(idx) == 0 and not idx.chains()
    for b in chain:
        assert pool.refcount(b) == 1
        pool.release(b)
    pool.check()


def test_paged_state_seating_cow_victim_and_atomic_exhaustion():
    st = kv_pool.PagedKVState(num_slots=2, num_blocks=6, block_size=4,
                              max_len=16)
    chain = st.seat_fresh(0, 6)
    st.register_prefix(list(range(1, 7)), 0)
    st.seat_shared(1, chain, 6)
    plan = st.write_plan(1, 5)              # inside the shared tail block
    assert plan[0] == "cow" and plan[2] == chain[1]
    assert st.tables[1, 1] == plan[3] != chain[1]
    assert st.write_plan(1, 8)[0] == "alloc"
    with pytest.raises(kv_pool.InsufficientBlocksError):
        st.seat_fresh(None, 99)
    st.check()
    assert st.victim(exclude=set()) == 1 and st.victim(exclude={1}) == 0
    assert st.truncate(1, 5) == 1           # drops the block grown at 8
    st.evict(1)
    st.evict(0)
    st.check()
    assert (st.tables == kv_pool.SCRATCH_BLOCK).all()
    assert kv_pool.slab_equivalent_blocks(4, 48, 4) \
        == jax_pool.slab_equivalent_blocks(4, 48, 4) == 49


def _pool_script(mod, seed):
    """One seeded script of seat / share / write_plan / evict / lookup /
    victim / truncate operations on ``mod.PagedKVState``; returns every
    outcome, table and refcount along the way."""
    rng = np.random.RandomState(seed)
    nb, bs, max_len = 10, 4, 32
    st = mod.PagedKVState(num_slots=4, num_blocks=nb, block_size=bs,
                          max_len=max_len)
    prompts = [rng.randint(1, 9, n).tolist() for n in (6, 9, 4)]
    pos, log = {}, []
    for _ in range(150):
        op = rng.randint(8)
        free = [s for s in range(4) if s not in pos]
        busy = sorted(pos)
        try:
            if op == 0 and free:
                p = prompts[rng.randint(3)] \
                    + rng.randint(1, 9, rng.randint(0, 4)).tolist()
                covered, chain = st.lookup_prefix(p)
                if covered:
                    pre = min(covered, len(p) - 1)
                    out = st.seat_shared(free[0], chain, pre + 1)
                    pos[free[0]] = pre
                else:
                    out = st.seat_fresh(free[0], len(p))
                    st.register_prefix(p, free[0])
                    pos[free[0]] = len(p)
                log.append(("seat", free[0], covered, [int(b) for b in out]))
            elif op in (1, 2, 3, 4) and busy:
                s = busy[rng.randint(len(busy))]
                if pos[s] < max_len:
                    plan = st.write_plan(s, pos[s])
                    pos[s] += 1
                    log.append(("plan", s, None if plan is None else
                                (plan[0],) + tuple(map(int, plan[1:]))))
            elif op == 5 and busy:
                s = busy[rng.randint(len(busy))]
                st.evict(s)
                del pos[s]
                log.append(("evict", s))
            elif op == 6 and busy:
                s = busy[0]
                keep = max(1, pos[s] - int(rng.randint(0, 6)))
                log.append(("truncate", s, st.truncate(s, keep + 1)))
                pos[s] = keep
            elif op == 7:
                log.append(("victim", st.victim(exclude=set(busy[:1])),
                            st.can_admit(int(rng.randint(1, 40)))))
        except mod.InsufficientBlocksError:
            v = st.victim(exclude=set())
            log.append(("dry", v))
            if v is not None:
                st.evict(v)
                del pos[v]
        st.check()
        log.append((st.tables.tolist(),
                    [st.pool.refcount(b) for b in range(nb)],
                    sorted(st.pool._free)))
    return log


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kv_pool_matches_jax_allocator_on_a_seeded_script(seed):
    got = _pool_script(kv_pool, seed)
    want = _pool_script(jax_pool, seed)
    assert got == want
    kinds = {entry[0] for entry in got if isinstance(entry[0], str)}
    assert {"seat", "plan", "evict", "dry"} <= kinds
    plans = {entry[2][0] for entry in got
             if entry[0] == "plan" and entry[2] is not None}
    assert plans == {"alloc", "cow"}


# ------------------------------------------------------------ model


@pytest.fixture(scope="module", params=["learned", "gqa_rope"])
def pair(request):
    cfg = (dict(d_model=D_MODEL, num_heads=HEADS)
           if request.param == "learned"
           else dict(d_model=64, num_heads=4, num_kv_heads=2,
                     pos_type="rope"))
    jp = jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                     dff=DFF, enc_layers=LAYERS, dec_layers=0,
                     max_len=MAX_LEN, **cfg)
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    return cfg["num_heads"], cfg.get("pos_type", "learned"), jp, tp


def _tables(rng, nb_row=12, num_blocks=40):
    """Four rows of distinct shuffled blocks (row 2 reading row 0's first
    two, never writing them) and a free row on scratch."""
    perm = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((4, nb_row), np.int32)
    tables[0, :6] = perm[:6]
    tables[1, :4] = perm[6:10]
    tables[2, :2] = tables[0, :2]
    tables[2, 2:6] = perm[10:14]
    return tables


def _pools_close(got, want):
    # block 0 is scratch: several free rows write it, in either order
    for g, w in zip(got, want):
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy()[1:],
                                       np.asarray(w[key])[1:], atol=TOL,
                                       rtol=TOL)


def test_chunk_and_tq1_paged_steps_match_jax(pair, np_rng):
    heads, pos_type, jp, tp = pair
    tables = _tables(np_rng)
    jc = jax_tf.init_lm_cache_paged(jp, 40, BS, max_len=MAX_LEN)
    tc = torch_tf.init_lm_cache_paged(tp, 40, BS, max_len=MAX_LEN)
    pos = np.asarray([0, 2, 8, 0], np.int32)
    for lens in ([4, 3, 2, 1], [4, 1, 4, 1], [2, 4, 1, 1]):
        lens = np.asarray(lens, np.int32)
        toks = np_rng.randint(1, VOCAB, (4, K)).astype(np.int32)
        jl, jc = jax_tf.lm_decode_chunk_paged(
            jp, *map(jnp.asarray, (toks, pos, lens)), jc,
            jnp.asarray(tables), heads, pos_type=pos_type)
        tl, tc = torch_tf.lm_decode_chunk_paged(
            tp, toks, pos, lens, tc, tables, heads, pos_type=pos_type)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        _pools_close(tc, jc)
        pos = pos + lens
    pos[3] = 0                                    # the free row
    for _ in range(2):
        toks = np_rng.randint(1, VOCAB, 4).astype(np.int32)
        jl, jc = jax_tf.lm_decode_step_paged(
            jp, jnp.asarray(toks), jnp.asarray(pos), jc,
            jnp.asarray(tables), heads, pos_type=pos_type)
        tl, tc = torch_tf.lm_decode_step_paged(tp, toks, pos, tc, tables,
                                               heads, pos_type=pos_type)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        _pools_close(tc, jc)
        pos = pos + np.asarray([1, 1, 1, 0], np.int32)


def test_chunk_fed_pool_matches_own_prefill(pair, np_rng):
    """A prompt fed K lanes at a time through the paged chunk step over a
    shuffled chain leaves, at every position, the K/V the port's own
    lm_prefill writes, and the last chunk's logits are the prefill's
    last position's."""
    heads, pos_type, _jp, tp = pair
    n = 23
    prompt = np_rng.randint(1, VOCAB, n).astype(np.int32)
    hidden, want = torch_tf.lm_prefill(tp, prompt[None], MAX_LEN, heads,
                                       pos_type=pos_type)
    chain = np_rng.permutation(np.arange(1, 20))[:-(-n // BS)]
    tables = np.zeros((1, MAX_LEN // BS), np.int32)
    tables[0, :chain.size] = chain
    pool = torch_tf.init_lm_cache_paged(tp, 20, BS, max_len=MAX_LEN)
    for start in range(0, n, K):
        piece = prompt[start:start + K]
        toks = np.zeros((1, K), np.int32)
        toks[0, :piece.size] = piece
        logits, pool = torch_tf.lm_decode_chunk_paged(
            tp, toks, [start], [piece.size], pool, tables, heads,
            pos_type=pos_type)
    for g, w in zip(pool, want):
        for key in ("k", "v"):
            rows = g[key][torch.tensor(chain)].reshape(-1, g[key].shape[-1])
            np.testing.assert_allclose(rows[:n].numpy(),
                                       w[key][0, :n].numpy(), atol=TOL,
                                       rtol=TOL)
    np.testing.assert_allclose(
        logits.numpy(), torch_tf._lm_project(tp, hidden[:, -1]).numpy(),
        atol=TOL, rtol=TOL)
    # all_lanes (the speculative verify surface): every fed lane's
    # logits equal the slab twin's over the same prompt, lane by lane
    slab = torch_tf.init_lm_cache(tp, 1, MAX_LEN)
    pool = torch_tf.init_lm_cache_paged(tp, 20, BS, max_len=MAX_LEN)
    for start in range(0, n, K):
        piece = prompt[start:start + K]
        toks = np.zeros((1, K), np.int32)
        toks[0, :piece.size] = piece
        got, pool = torch_tf.lm_decode_chunk_paged(
            tp, toks, [start], [piece.size], pool, tables, heads,
            pos_type=pos_type, all_lanes=True)
        want, slab = torch_tf.lm_decode_chunk_slots(
            tp, toks, [start], [piece.size], slab, heads,
            pos_type=pos_type, all_lanes=True)
        assert got.shape == (1, K, VOCAB)
        np.testing.assert_allclose(got[0, :piece.size].numpy(),
                                   want[0, :piece.size].numpy(), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(
            got[0, :piece.size].numpy(),
            torch_tf._lm_project(tp, hidden[0, start:start + piece.size])
            .numpy(), atol=TOL, rtol=TOL)


# ------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def params():
    return torch_tf.init_lm(torch.Generator().manual_seed(0), VOCAB,
                            D_MODEL, HEADS, DFF, LAYERS, MAX_LEN,
                            device="cpu")


def _paged(params, **kw):
    kw.setdefault("prefill_chunk", K)
    kw.setdefault("kv_block_size", BS)
    return DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                        max_len=MAX_LEN, kv_layout="paged", device="cpu",
                        **kw)


def _reference(params, prompt, n_tok):
    """(lm_generate's continuation, its top-1/top-2 margins per step)."""
    ids = torch_tf.lm_generate(params, np.asarray([prompt]),
                               len(prompt) + n_tok, HEADS)
    hidden, _ = torch_tf.lm_prefill(params, ids, ids.shape[1], HEADS)
    top2 = torch.topk(torch_tf._lm_project(params, hidden), 2, dim=-1)
    margin = (top2.values[0, :, 0] - top2.values[0, :, 1]).numpy()
    return ids[0, len(prompt):].tolist(), margin[len(prompt) - 1:]


def check_streams(params, cases, outs):
    """Every stream equals lm_generate while the reference margin is
    clear; most tokens must have been compared."""
    checked = total = 0
    for (prompt, n_tok), toks in zip(cases, outs):
        ref, margin = _reference(params, prompt, n_tok)
        assert len(toks) == n_tok
        for t, tok in enumerate(toks):
            if margin[t] < MARGIN:
                break
            assert tok == ref[t], (len(prompt), t, toks, ref)
            checked += 1
        total += n_tok
    assert checked >= 0.9 * total


def _audit(eng):
    """The refcount ledger balances, every slot is free, and only
    prefix-index references hold blocks."""
    eng._paged.check()
    assert eng.free_slots == eng.num_slots
    idx = eng._paged.index
    held = len({b for chain in idx.chains() for b in chain}) if idx else 0
    assert eng._paged.pool.num_used == held


def pressure_cases(rng, preamble):
    """A leader, an exact duplicate (copy-on-write at its first write), a
    prompt sharing the aligned preamble, and long requests whose growth
    outruns a small pool."""
    div = np.concatenate([preamble[:8], rng.randint(1, VOCAB, 5)])
    return ([(preamble.tolist(), 8)],
            [(preamble.tolist(), 8), (div.tolist(), 8)]
            + [(rng.randint(1, VOCAB, 16).tolist(), 16) for _ in range(4)])


def test_paged_engine_prefix_hits_cow_and_preemption_match_lm_generate(
        params):
    rng = np.random.RandomState(1)
    preamble = rng.randint(1, VOCAB, 10)           # 2.5 blocks
    lead, rest = pressure_cases(rng, preamble)
    eng = _paged(params, kv_num_blocks=14)
    with GenerationBatcher(eng) as gen:
        outs = [gen.generate(lead[0][0], max_tokens=8,
                             timeout=60)["tokens"]]
        futs = [gen.submit(p, max_tokens=n) for p, n in rest]
        outs += [f.result(timeout=120)["tokens"] for f in futs]
    snap = eng.metrics.snapshot()
    assert snap["prefix_cache_hits_total"] >= 2
    assert snap["cow_forks_total"] >= 1
    assert snap["evictions"]["pool_exhausted"] >= 1
    assert snap["slot_reprefills_total"] >= 1
    assert snap["kv_blocks_total"] == 13
    check_streams(params, lead + rest, outs)
    _audit(eng)


def test_paged_prefix_cache_off_still_matches(params):
    eng = _paged(params, prefix_cache=False)
    p = np.random.RandomState(4).randint(1, VOCAB, 10).tolist()
    with GenerationBatcher(eng) as gen:
        a = gen.generate(p, max_tokens=6, timeout=60)["tokens"]
        b = gen.generate(p, max_tokens=6, timeout=60)["tokens"]
    assert a == b
    check_streams(params, [(p, 6)], [a])
    snap = eng.metrics.snapshot()
    assert snap["prefix_cache_hits_total"] == 0
    assert snap["prefix_cache_misses_total"] == 2
    assert eng._paged.pool.num_used == 0
    eng._paged.check()


def _staggered(gen, cases, stagger_s=0.003):
    outs = [None] * len(cases)

    def client(i):
        time.sleep(stagger_s * i)
        outs[i] = gen.generate(cases[i][0], max_tokens=cases[i][1],
                               timeout=120)["tokens"]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(cases))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(180)
    return outs


def test_paged_equals_slab_token_for_token(params):
    """The port's own bit-identity: the two layouts run the same plain
    paths, so the same staggered requests give the same streams."""
    rng = np.random.RandomState(3)
    cases = [(rng.randint(1, VOCAB, rng.randint(2, 30)).tolist(),
              int(rng.randint(2, 12))) for _ in range(8)]
    outs = {}
    for layout in ("paged", "slab"):
        eng = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                           max_len=MAX_LEN, prefill_chunk=K,
                           kv_layout=layout, kv_block_size=BS, device="cpu")
        with GenerationBatcher(eng) as gen:
            outs[layout] = _staggered(gen, cases)
    assert outs["paged"] == outs["slab"]


def test_paged_config_validation_and_auto_sizing(params):
    eng = _paged(params, warm=False)
    per_row = MAX_LEN // BS
    assert eng._paged.pool.num_blocks == SLOTS * per_row + 1
    assert eng._cache[0]["k"].shape == (SLOTS * per_row + 1, BS, D_MODEL)
    assert eng.metrics.snapshot()["kv_blocks_free"] == SLOTS * per_row
    with pytest.raises(ConfigError):
        _paged(params, kv_block_size=0, warm=False)
    with pytest.raises(ConfigError):
        DecodeEngine(params, num_heads=HEADS, kv_layout="bogus",
                     device="cpu", warm=False)
    small = _paged(params, kv_num_blocks=3, warm=False)
    gen = GenerationBatcher(small)
    with pytest.raises(InvalidRequestError, match="KV blocks"):
        gen.submit(list(range(1, 13)), max_tokens=8)
    gen.close()
    text = eng.metrics.render_prometheus()
    assert f"{eng.metrics.name}_kv_blocks_total {SLOTS * per_row}" in text
    assert 'slot_evictions_total{reason="pool_exhausted"} 0' in text
