"""The port's host KV tier (``serving/kv_pool.py`` HostTier + the wire
format, ``DecodeEngine(kv_host_bytes=...)``, ``perf/analytic.py``)
against the JAX package's, on the CPU.

- The chain wire format is plain numpy + JSON: the port's
  ``serialize_chain`` is byte for byte JAX's on the same seeded
  ``(tokens, covered, arrays, trunk_sig)``, and both packages reject the
  same broken blobs with the same exception classes.
- ``HostTier``'s LRU order, bytes and lookups equal JAX's over one
  sequence of puts; the engine refuses the options JAX refuses; at the
  ``cpu`` spec the three predictors equal JAX's to 1e-12.
- The engine scenarios of JAX's ``tests/test_kv_spill.py`` on a tiny
  pool: with the tier, a spilled prefix restores and seats by reference
  with no chunk lanes, every stream bit for bit the port without the
  tier, a clean ledger after each; the streams equal JAX's engine (same
  trunk, ``params_from_numpy``) up to the first top-1/top-2 margin below
  MARGIN (float32 on both sides, summed in different orders).  A blob
  JAX's engine exports seats in the port's engine by restore, and the
  port's blobs pass JAX's envelope check with K/V within 1e-5 of JAX's.
"""

import threading
import time

import numpy as np
import pytest
import jax
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.perf import analytic as jax_analytic
from paddle_tpu.serving import GenerationBatcher as JaxBatcher
from paddle_tpu.serving import kv_pool as jax_pool
from paddle_tpu.serving.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.perf import analytic
from paddle_tpu_torch.serving import (DecodeEngine, GenerationBatcher,
                                      ServingMetrics)
from paddle_tpu_torch.serving import kv_pool
from paddle_tpu_torch.utils.error import ConfigError

VOCAB, D_MODEL, LAYERS, HEADS, DFF = 64, 32, 2, 2, 64
MAX_LEN, SLOTS, BS, CHUNK = 48, 4, 8, 8
# two slots' worth of blocks + scratch: churn evicts the shared chain
POOL_BLOCKS = 2 * (MAX_LEN // BS) + 1
SIG = f"L{LAYERS}.d{D_MODEL}.dkv{D_MODEL}.h{HEADS}.float32.b{BS}"
MARGIN = 2e-3
KV_TOL = 1e-5
ENGINE_KW = dict(num_heads=HEADS, num_slots=SLOTS, max_len=MAX_LEN,
                 kv_layout="paged", kv_block_size=BS,
                 kv_num_blocks=POOL_BLOCKS, prefill_chunk=CHUNK)


@pytest.fixture(scope="module")
def jax_tree():
    return jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                       d_model=D_MODEL, num_heads=HEADS, dff=DFF,
                       enc_layers=LAYERS, dec_layers=0, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def params(jax_tree):
    return transformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_tree), "cpu")


@pytest.fixture(scope="module")
def spill_eng(params):
    return DecodeEngine(params, name="spill_lm", kv_host_bytes=64 << 20,
                        device="cpu", **ENGINE_KW)


@pytest.fixture(scope="module")
def twin_eng(params):
    return DecodeEngine(params, name="spill_twin", device="cpu",
                        **ENGINE_KW)


@pytest.fixture(scope="module")
def jax_eng(jax_tree):
    return JaxEngine(jax_tree, prefill_buckets=(8, 16), name="jax_spill",
                     kv_host_bytes=64 << 20, warm=False, **ENGINE_KW)


def _fresh(eng):
    eng.reset()
    if eng.host_tier is not None:
        eng.host_tier.clear()
    eng.metrics = ServingMetrics()
    return eng


def _prompt(rng, n):
    return rng.randint(1, VOCAB, n).astype(np.int32)


def _arrays(rng, blocks, dims=(16, 16, HEADS)):
    return [(name, rng.standard_normal((blocks, BS, d)).astype(np.float32))
            for name, d in zip(("k0", "v0", "scale"), dims)]


def _audit(eng):
    eng._paged.check()
    assert eng.free_slots == eng.num_slots
    assert not eng._paged._pending, "leaked pending restore claims"


def _scenario(eng, batcher_cls, shared, churn, revisits):
    """shared, then the churn prompts (each evicting it), then the
    revisits, one after another; the tokens of every request."""
    bat = batcher_cls(eng)
    outs = [bat.submit(p, max_tokens=n).result(120)["tokens"]
            for p, n in [(shared, 6)] + churn + revisits]
    bat.close()
    return outs


def check_vs_jax(params, cases, outs, want):
    """Each stream against JAX's up to the first position whose margin
    (the port's teacher-forced logits over JAX's stream) is below
    MARGIN; returns the tokens compared."""
    checked = 0
    for (prompt, _n), got, ref in zip(cases, outs, want):
        ids = torch.as_tensor(np.concatenate([prompt, ref])[None],
                              dtype=torch.int32)
        with torch.no_grad():
            hidden, _ = transformer.lm_prefill(params, ids, ids.shape[1],
                                               HEADS)
            top = torch.topk(transformer._lm_project(params, hidden), 2,
                             dim=-1).values[0]
        marg = (top[:, 0] - top[:, 1]).numpy()[len(prompt) - 1:]
        for g, r, m in zip(got, ref, marg):
            if m < MARGIN:
                break
            assert g == r
            checked += 1
    assert checked > 0
    return checked


# ------------------------------------------------------- wire format

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_format_byte_identical_to_jax(seed):
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(1, 5))
    tokens = [int(t) for t in rng.integers(1, VOCAB, n_blocks * BS)]
    arrays = [(f"[{i}]['{k}']",
               (rng.standard_normal((n_blocks, BS, int(rng.integers(1, 9))))
                * 8).astype(dt))
              for i, (k, dt) in enumerate([("k", np.float32),
                                           ("ks", np.int8),
                                           ("v", np.float32)])]
    blob = kv_pool.serialize_chain(tokens, n_blocks * BS, arrays, SIG)
    assert blob == jax_pool.serialize_chain(tokens, n_blocks * BS, arrays,
                                            SIG)
    toks, covered, out = kv_pool.restore_chain(blob, SIG)
    assert toks == tuple(tokens) and covered == n_blocks * BS
    for (n1, a), (n2, b) in zip(arrays, out):
        assert n1 == n2 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert kv_pool.peek_chain_header(blob, SIG) \
        == jax_pool.peek_chain_header(blob, SIG)


def _broken(case):
    rng = np.random.RandomState(1)
    tokens = _prompt(rng, BS).tolist()
    blob = kv_pool.serialize_chain(tokens, BS, _arrays(rng, 1), SIG)
    other = SIG.replace(f"L{LAYERS}", f"L{LAYERS + 1}")
    return {"truncated_payload": (blob[:-3], SIG, None),
            "truncated_envelope": (b"\x01\x00", SIG, None),
            "trailing": (blob + b"xx", SIG, None),
            "oversized": (blob, SIG, len(blob) - 1),
            "foreign_trunk": (blob, other, None),
            "version_byte": (bytes([kv_pool.WIRE_VERSION + 1]) + blob[1:],
                             SIG, None)}[case]


@pytest.mark.parametrize("case", ["truncated_payload", "truncated_envelope",
                                  "trailing", "oversized", "foreign_trunk",
                                  "version_byte"])
def test_wire_rejections_match_jax(case):
    blob, sig, max_bytes = _broken(case)
    with pytest.raises(jax_pool.WireFormatError) as want:
        jax_pool.restore_chain(blob, sig, max_bytes)
    with pytest.raises(kv_pool.WireFormatError) as got:
        kv_pool.restore_chain(blob, sig, max_bytes)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_lying_header_rejected_by_both_engines(params, jax_eng):
    """A blob whose header declares more coverage than its key: both
    engines' deliver_chain_blob refuse it before the tier sees it."""
    eng = DecodeEngine(params, name="liar", kv_host_bytes=1 << 20,
                       device="cpu", warm=False, **ENGINE_KW)
    assert eng._trunk_sig == jax_eng._trunk_sig == SIG
    assert eng._cache_leaf_names == jax_eng._cache_leaf_names
    rng = np.random.RandomState(2)
    tokens = _prompt(rng, BS).tolist()
    blob = kv_pool.serialize_chain(tokens, 2 * BS, _arrays(rng, 1), SIG)
    with pytest.raises(jax_pool.WireFormatError, match="covered"):
        jax_eng.deliver_chain_blob(blob)
    with pytest.raises(kv_pool.WireFormatError, match="covered"):
        eng.deliver_chain_blob(blob)
    assert len(eng.host_tier) == 0
    with pytest.raises(ConfigError, match="host tier"):
        DecodeEngine(params, name="no_tier", device="cpu", warm=False,
                     **ENGINE_KW).deliver_chain_blob(blob)


# --------------------------------------------------------- host tier

def test_host_tier_lru_bytes_and_lookup_match_jax():
    rng = np.random.RandomState(3)
    blob = kv_pool.serialize_chain([1] * BS, BS, _arrays(rng, 1), SIG)
    tiers = (kv_pool.HostTier(cap_bytes=int(len(blob) * 3.5)),
             jax_pool.HostTier(cap_bytes=int(len(blob) * 3.5)))
    t1, t2 = tuple(range(1, BS + 1)), tuple(range(101, 101 + BS))
    long_key = t1 + tuple(range(51, 51 + BS))
    script = [("put", t1, BS, blob), ("put", t2, BS, blob),
              ("lookup", list(t1) + [7, 8, 9]), ("lookup", [9] * BS),
              ("put", long_key, 2 * BS, blob + blob[9:]),
              ("covers", t1), ("covers", t2 + (1,)), ("lookup", list(t1)),
              ("put", tuple(range(201, 201 + BS)), BS, blob),
              ("lookup", list(t2)), ("pop", long_key), ("lookup", [0] * 2)]
    for op in script:
        got, want = ([getattr(t, op[0])(*op[1:]) if op[0] != "lookup"
                      else t.lookup(op[1], BS) for t in tiers])
        assert got == want, op
        assert tiers[0].bytes == tiers[1].bytes
        assert list(tiers[0]._entries) == list(tiers[1]._entries)
    with pytest.raises(ConfigError):
        kv_pool.HostTier(cap_bytes=-1)


@pytest.mark.parametrize("kw,match", [
    (dict(kv_layout="slab", kv_host_bytes=1), "paged"),
    (dict(prefix_cache=False, kv_host_bytes=1), "prefix"),
    (dict(kv_host_bytes=-1), ">= 0")])
def test_engine_config_validation_matches_jax(params, jax_tree, kw, match):
    base = dict(ENGINE_KW, **{k: kw[k] for k in kw if k == "kv_layout"})
    rest = {k: v for k, v in kw.items() if k != "kv_layout"}
    with pytest.raises(Exception, match=match) as want:
        JaxEngine(jax_tree, prefill_buckets=(8, 16), warm=False, **base,
                  **rest)
    with pytest.raises(ConfigError, match=match) as got:
        DecodeEngine(params, device="cpu", warm=False, **base, **rest)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("covered,kv_dtype,chunk", [
    (4, "float32", 8), (32, "float32", 8), (96, "int8", 8),
    (200, "float32", 0)])
def test_predictors_equal_jax_at_cpu_spec(covered, kv_dtype, chunk):
    args = (covered, LAYERS, D_MODEL, HEADS, kv_dtype)
    for ours, theirs in ((analytic.predicted_restore_ms,
                          jax_analytic.predicted_restore_ms),
                         (analytic.predicted_handoff_ms,
                          jax_analytic.predicted_handoff_ms)):
        np.testing.assert_allclose(ours(*args, chip="cpu"),
                                   theirs(*args, chip="cpu"), rtol=1e-12)
    k = chunk or covered + 1
    np.testing.assert_allclose(
        analytic.predicted_recompute_ms(covered, 1234567, 4938268, k, "cpu"),
        jax_analytic.predicted_recompute_ms(covered, 1234567, 4938268, k,
                                            "cpu"), rtol=1e-12)


def test_restore_vs_recompute_routing_directions(params):
    eng = DecodeEngine(params, name="route_lm", kv_host_bytes=1 << 20,
                       device="cpu", warm=False,
                       **dict(ENGINE_KW, kv_num_blocks=0))
    long_v, long_r, long_c = eng._restore_predicted_faster(4 * BS)
    short_v, short_r, short_c = eng._restore_predicted_faster(CHUNK // 2)
    assert long_v and long_r < long_c, (long_r, long_c)
    assert not short_v and short_c < short_r, (short_r, short_c)
    assert eng._handoff_predicted_faster(4 * BS)[0]
    assert not eng._handoff_predicted_faster(CHUNK // 2)[0]


# ------------------------------------------------- spill -> restore

def test_spill_restore_bit_identical_zero_lanes(params, spill_eng,
                                                twin_eng, jax_eng):
    """A block-aligned shared prefix registers, churn evicts (spills) it,
    and its return visit restores and seats by reference with no chunk
    lanes; every stream is the tier-less twin's bit for bit and JAX's
    engine's up to the margin, with JAX's counts."""
    eng, twin = _fresh(spill_eng), _fresh(twin_eng)
    jax_eng.reset()
    jax_eng.host_tier.clear()
    rng = np.random.RandomState(3)
    shared = _prompt(rng, 4 * BS)
    churn = [(_prompt(rng, 28), 4) for _ in range(4)]
    bat = GenerationBatcher(eng)
    r1 = bat.submit(shared, max_tokens=6).result(60)["tokens"]
    outs = [bat.submit(p, max_tokens=n).result(60)["tokens"]
            for p, n in churn]
    assert eng._paged.lookup_prefix(shared)[0] == 0
    snap = eng.metrics.snapshot()
    assert snap["kv_spill_blocks_total"] > 0
    assert eng.host_tier.covers(tuple(int(t) for t in shared))
    lanes0 = snap["prefill_chunk_lanes_total"]
    r2 = bat.submit(shared, max_tokens=6).result(60)["tokens"]
    bat.close()
    snap = eng.metrics.snapshot()
    assert snap["kv_restore_hits_total"] == 1
    assert snap["kv_restore_bytes_total"] > 0
    assert snap["host_tier_bytes"] == eng.host_tier.bytes
    assert snap["prefill_chunk_lanes_total"] == lanes0
    cases = [(shared, 6)] + churn + [(shared, 6)]
    got = [r1] + outs + [r2]
    assert _scenario(twin, GenerationBatcher, shared, churn,
                     [(shared, 6)]) == got
    _audit(eng)
    want = _scenario(jax_eng, JaxBatcher, shared, churn, [(shared, 6)])
    jsnap = jax_eng.metrics.snapshot()
    assert jsnap["kv_restore_hits_total"] == 1
    assert jsnap["kv_spill_blocks_total"] == snap["kv_spill_blocks_total"]
    check_vs_jax(params, cases, got, want)


def test_spill_restore_int8_pool_bit_identical(params):
    """The same over an int8 pool: the blob carries the codes and the
    scale sidecars, and the restored stream is the tier-less twin's."""
    kw = dict(ENGINE_KW, kv_dtype="int8", kv_num_blocks=POOL_BLOCKS)
    eng = DecodeEngine(params, name="spill_i8", kv_host_bytes=64 << 20,
                       device="cpu", **kw)
    twin = DecodeEngine(params, name="twin_i8", device="cpu", **kw)
    rng = np.random.RandomState(4)
    shared = _prompt(rng, 4 * BS)
    churn = [(_prompt(rng, 28), 4) for _ in range(4)]
    got = _scenario(eng, GenerationBatcher, shared, churn, [(shared, 6)])
    snap = eng.metrics.snapshot()
    assert snap["kv_restore_hits_total"] == 1
    blob = eng.host_tier._entries and next(iter(
        eng.host_tier._entries.values()))[1]
    names = [a["name"] for a in kv_pool.peek_chain_header(blob)["arrays"]] \
        if blob else []
    assert names[:4] == ["[0]['k']", "[0]['ks']", "[0]['v']", "[0]['vs']"]
    assert _scenario(twin, GenerationBatcher, shared, churn,
                     [(shared, 6)]) == got
    _audit(eng)


def test_reset_races_inflight_restore_epoch_guard(spill_eng):
    """A reset while a restore is in flight: the landing is dropped
    (never written into the fresh pool), the blob survives, and the next
    visit restores with the pre-reset stream."""
    eng = _fresh(spill_eng)
    rng = np.random.RandomState(4)
    shared = _prompt(rng, 4 * BS)
    bat = GenerationBatcher(eng)
    r1 = bat.submit(shared, max_tokens=6).result(60)
    for _ in range(4):
        bat.submit(_prompt(rng, 28), max_tokens=4).result(60)
    bat.close()
    assert eng._paged.lookup_prefix(shared)[0] == 0
    pending = eng._maybe_begin_restore(shared)
    assert isinstance(pending, kv_pool.RestorePendingError)
    assert eng._paged._pending
    eng.reset()
    assert not eng._pending_restores and not eng._paged._pending
    time.sleep(0.2)
    assert eng.poll_restores(timeout=0.05) == 0
    assert len(eng._paged.index) == 0
    assert eng.metrics.snapshot()["kv_restore_hits_total"] == 0
    eng._paged.check()
    bat = GenerationBatcher(eng)
    r2 = bat.submit(shared, max_tokens=6).result(60)
    bat.close()
    assert r2["tokens"] == r1["tokens"]
    assert eng.metrics.snapshot()["kv_restore_hits_total"] == 1
    _audit(eng)


def test_cow_fork_on_restored_chain_bit_identical(spill_eng, twin_eng):
    """A restored chain is an ordinary prefix-cache entry: an exact
    duplicate (a copy-on-write fork in the shared tail) and a divergent
    follower seat on it, each stream the twin's bit for bit."""
    eng, twin = _fresh(spill_eng), _fresh(twin_eng)
    rng = np.random.RandomState(5)
    shared = _prompt(rng, 4 * BS)
    churn = [(_prompt(rng, 28), 4) for _ in range(4)]
    revisits = [(shared, 6), (shared, 6),
                (np.concatenate([shared, _prompt(rng, 4)]), 6)]
    got = _scenario(eng, GenerationBatcher, shared, churn, revisits)
    snap = eng.metrics.snapshot()
    assert snap["kv_restore_hits_total"] >= 1 and snap["cow_forks_total"] >= 1
    assert _scenario(twin, GenerationBatcher, shared, churn, revisits) == got
    _audit(eng)


@pytest.mark.parametrize("seed", [11, 12])
def test_spill_storm_staggered_admissions_bit_identical(params, seed):
    """Staggered concurrent clients with a recurring shared prefix over a
    pool too small for all: evictions spill, returns restore, preemptions
    ride the defer seams, and every stream is the twin's."""
    rng = np.random.RandomState(seed)
    shared = _prompt(rng, 4 * BS)
    cases = [(shared, 5) if i % 3 == 0
             else (_prompt(rng, int(rng.randint(20, 33))), 4 + i % 4)
             for i in range(10)]

    def drive(eng):
        bat = GenerationBatcher(eng)
        results, excs = [None] * len(cases), []

        def client(i):
            try:
                time.sleep(0.003 * i)
                results[i] = bat.submit(
                    cases[i][0], max_tokens=cases[i][1]).result(120)
            except Exception as e:      # noqa: BLE001
                excs.append((i, e))

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(cases))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
            assert not t.is_alive(), "client wedged"
        bat.close()
        assert not excs, excs
        return [r["tokens"] for r in results]

    eng = DecodeEngine(params, name=f"storm_{seed}", kv_host_bytes=64 << 20,
                       device="cpu", **ENGINE_KW)
    twin = DecodeEngine(params, name=f"storm_twin_{seed}", device="cpu",
                        **ENGINE_KW)
    assert drive(eng) == drive(twin)
    assert eng.metrics.snapshot()["kv_spill_blocks_total"] > 0
    _audit(eng)


# ------------------------------------------------- across packages

def test_blobs_cross_between_the_packages(params, jax_eng, spill_eng):
    """JAX's engine exports a resident chain; the port's engine seats it
    by restore and streams JAX's tokens up to the margin.  The port's
    export of the same chain passes JAX's envelope check, JAX's
    restore_chain reads it, and its K/V is JAX's within 1e-5."""
    jax_eng.reset()
    jax_eng.host_tier.clear()
    rng = np.random.RandomState(6)
    shared = _prompt(rng, 4 * BS)
    prompt = np.concatenate([shared, _prompt(rng, 3)])
    jbat = JaxBatcher(jax_eng)
    want = jbat.submit(prompt, max_tokens=6).result(120)["tokens"]
    jbat.close()
    _jkey, jcov, jblob = jax_eng.export_chain(shared)
    assert jcov == 4 * BS
    eng = _fresh(spill_eng)
    assert eng.deliver_chain_blob(jblob) == (tuple(int(t) for t in shared),
                                             4 * BS)
    bat = GenerationBatcher(eng)
    got = bat.submit(prompt, max_tokens=6).result(60)["tokens"]
    snap = eng.metrics.snapshot()
    assert snap["kv_restore_hits_total"] == 1
    check_vs_jax(params, [(prompt, 6)], [got], [want])
    key, cov, blob = bat.export_chain(shared.tolist())
    bat.close()
    assert cov == 4 * BS and key == tuple(int(t) for t in shared)
    assert jax_pool.peek_chain_header(blob, jax_eng._trunk_sig)["covered"] \
        == cov
    ours = dict(jax_pool.restore_chain(blob, jax_eng._trunk_sig)[2])
    theirs = dict(jax_pool.restore_chain(jblob, jax_eng._trunk_sig)[2])
    assert list(ours) == list(theirs) == jax_eng._cache_leaf_names
    for name in ours:
        np.testing.assert_allclose(ours[name], theirs[name], atol=KV_TOL,
                                   rtol=KV_TOL)
    _audit(eng)
