"""Supervised recovery on the port (``resilience/supervisor.py``,
``GenerationBatcher(supervisor=...)``, the engine's epoch guard) against
the JAX package's, on the CPU.

- ``CircuitBreaker``'s states on a fake clock and ``retry_transient``'s
  attempts and delays for one seed equal JAX's.
- The chaos scenarios of JAX's ``tests/test_resilience.py`` on a 4-slot
  engine, chunked (K 4) and on the prefill ladder: requests submitted in
  a chain (each once its predecessor's first token is out, or it ended)
  so the schedule depends on the steps alone.  A faulted run's streams
  are the port's clean run bit for bit; the same fault plan gives the
  same ``evictions{reason}`` counts and the same failed requests as
  JAX's engine; a hang past the watchdog deadline is abandoned and the
  late step commits nothing.  The clean streams equal JAX's up to the
  first top-1/top-2 margin below MARGIN (float32, sums in different
  orders).
"""

import threading
import time

import numpy as np
import pytest
import jax
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.resilience import supervisor as jax_sup
from paddle_tpu.serving import GenerationBatcher as JaxBatcher
from paddle_tpu.serving import ServingMetrics as JaxMetrics
from paddle_tpu.serving.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.resilience import (BreakerOpenError, CircuitBreaker,
                                         InjectedFault, Supervisor, faults,
                                         retry_transient)
from paddle_tpu_torch.resilience import supervisor as port_sup
from paddle_tpu_torch.serving import (BatchExecutionError, DecodeEngine,
                                      GenerationBatcher, ServingMetrics)

VOCAB, D_MODEL, LAYERS, HEADS, DFF = 64, 32, 2, 2, 64
MAX_LEN, SLOTS, CHUNK, BUCKETS = 48, 4, 4, (8, 16)
MARGIN = 2e-3
KINDS = {"chunked": dict(prefill_chunk=CHUNK),
         "ladder": dict(prefill_chunk=0, prefill_buckets=BUCKETS,
                        prefill_batch_buckets=(4,))}


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    faults.clear()
    jax_faults.clear()


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
def engines(params):
    return {kind: DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                               max_len=MAX_LEN, name=f"sup_{kind}",
                               device="cpu", **kw)
            for kind, kw in KINDS.items()}


@pytest.fixture(scope="module")
def jax_engines(jax_tree):
    return {kind: JaxEngine(jax_tree, num_heads=HEADS, num_slots=SLOTS,
                            max_len=MAX_LEN, name=f"jax_sup_{kind}",
                            warm=False, **dict(
                                dict(prefill_buckets=BUCKETS), **kw))
            for kind, kw in KINDS.items()}


def _cases(seed, n, max_tokens=None):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, VOCAB, rng.randint(3, BUCKETS[-1] + 1))
             .astype(np.int32), max_tokens or 4 + i % 5) for i in range(n)]


def _chained(bat, cases):
    """Submit ``cases`` in a chain: request i+1 once request i has
    emitted its first token or ended (both on the batcher's worker
    thread, so the schedule is a function of the steps alone).  Returns
    per request its tokens or its error's class name."""
    futs = [None] * len(cases)
    all_in = threading.Event()

    def submit(i):
        if i == len(cases):
            all_in.set()
            return
        fired = []

        def nxt(*_):
            if not fired:
                fired.append(1)
                submit(i + 1)

        prompt, n = cases[i]
        futs[i] = bat.submit(prompt, max_tokens=n, on_token=nxt)
        futs[i].add_done_callback(nxt)

    submit(0)
    assert all_in.wait(120), "chain stalled"
    out = []
    for f in futs:
        try:
            out.append(f.result(120)["tokens"])
        except Exception as e:      # noqa: BLE001
            out.append(type(e).__name__)
    return out


def _run(eng, cases, spec="", sup=None, batcher=GenerationBatcher,
         fault_mod=faults, metrics=ServingMetrics):
    """One chained run on a reset engine: (outcomes, metrics snapshot,
    faults fired)."""
    eng.reset()
    eng.metrics = metrics()
    bat = batcher(eng, supervisor=sup)
    if spec:
        fault_mod.install_spec(spec)
    try:
        out = _chained(bat, cases)
    finally:
        fired = fault_mod.fired_counts()
        fault_mod.clear()
        bat.close()
    return out, eng.metrics.snapshot(), fired


def _check_vs_jax(params, cases, got, want):
    checked = 0
    for (prompt, _n), g, r in zip(cases, got, want):
        ids = torch.as_tensor(np.concatenate([prompt, r])[None],
                              dtype=torch.int32)
        with torch.no_grad():
            hidden, _ = transformer.lm_prefill(params, ids, ids.shape[1],
                                               HEADS)
            top = torch.topk(transformer._lm_project(params, hidden), 2,
                             dim=-1).values[0]
        for a, b, m in zip(g, r, (top[:, 0] - top[:, 1]).numpy()[
                len(prompt) - 1:]):
            if m < MARGIN:
                break
            assert a == b
            checked += 1
    assert checked > 0


# ------------------------------------------------------------ units

def test_breaker_states_on_fake_clock_equal_jax():
    now = [0.0]
    ours = CircuitBreaker(threshold=2, cooldown_s=0.25,
                          clock=lambda: now[0])
    theirs = jax_sup.CircuitBreaker(threshold=2, cooldown_s=0.25,
                                    clock=lambda: now[0])
    script = ["failure", "admit", "failure", "admit", "success", "tick",
              "admit", "failure", "tick", "seconds", "admit", "admit",
              "release", "admit", "failure", "seconds", "tick", "tick",
              "admit", "success", "admit", "seconds"]
    for op in script:
        if op == "tick":
            now[0] += 0.2
            continue
        got, want = [{"failure": b.record_failure,
                      "success": b.record_success,
                      "admit": b.admit, "release": b.release_probe,
                      "seconds": b.seconds_until_probe}[op]()
                     for b in (ours, theirs)]
        assert got == want, op
        assert (ours.state, ours.opened_total) \
            == (theirs.state, theirs.opened_total), op
    assert ours.opened_total >= 2
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=0)


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_transient_same_attempts_and_delays(monkeypatch, seed):
    runs = {}
    for name, mod, err in (("port", port_sup, faults.TransientError),
                           ("jax", jax_sup, jax_faults.TransientError)):
        delays, retries, calls = [], [], [0]
        monkeypatch.setattr(mod.time, "sleep", delays.append)

        def fn():
            calls[0] += 1
            if calls[0] <= 3:
                raise err("transient")
            return "ok"
        assert mod.retry_transient(fn, budget=3, base_delay_s=0.01,
                                   seed=seed,
                                   on_retry=lambda a, e: retries.append(a)) \
            == "ok"
        with pytest.raises(err):
            mod.retry_transient(lambda: (_ for _ in ()).throw(err("x")),
                                budget=2, seed=seed)
        runs[name] = (delays, retries, calls[0])
    assert runs["port"] == runs["jax"]
    assert runs["port"][1] == [1, 2, 3]
    with pytest.raises(KeyError):           # non-transient: no retry
        retry_transient(lambda: {}["x"], budget=3)


# ------------------------------------------------------------ decode step

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("budget", [5, 0])
def test_decode_step_fault_recovery_bit_identical_under_load(
        params, engines, jax_engines, kind, budget):
    """Two injected step errors under 10 chained requests: with a
    recovery budget every stream is the clean run bit for bit; with none
    the requests in flight at each error fail.  Either way the
    evictions, failures and fires equal JAX's under the same plan."""
    cases = _cases(1, 10)
    spec = "serving.decode_step:every=7,times=2"
    eng, jeng = engines[kind], jax_engines[kind]
    clean, _, _ = _run(eng, cases)
    out, snap, fired = _run(eng, cases, spec,
                            Supervisor(breaker_threshold=10,
                                       max_request_recoveries=budget))
    assert fired == {"serving.decode_step": 2}
    for o, c in zip(out, clean):
        assert o == c or (budget == 0 and o == "BatchExecutionError")
    failed = [i for i, o in enumerate(out) if isinstance(o, str)]
    assert bool(failed) == (budget == 0)
    jout, jsnap, jfired = _run(
        jeng, cases, spec, jax_sup.Supervisor(breaker_threshold=10,
                                              max_request_recoveries=budget),
        JaxBatcher, jax_faults, JaxMetrics)
    assert jfired == fired
    assert [i for i, o in enumerate(jout) if isinstance(o, str)] == failed
    assert snap["evictions"] == jsnap["evictions"]
    assert snap["slot_reprefills_total"] == jsnap["slot_reprefills_total"]
    if budget:
        assert snap["evictions"]["recovered"] >= 2
        _check_vs_jax(params, cases, clean, jout)
    assert eng.free_slots == SLOTS


@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_step_hang_watchdog_rebuild_bit_identical(engines, kind):
    """A step hung past the watchdog deadline is abandoned, the cache
    rebuilt and the streams recovered bit for bit; the hung step, when
    it wakes, runs on the orphaned cache and commits nothing."""
    eng = engines[kind]
    cases = _cases(2, 6, max_tokens=5)
    clean, _, _ = _run(eng, cases)
    stale = []
    real_step = eng.step

    def step():
        try:
            return real_step()
        except RuntimeError as e:
            if "reset mid-step" in str(e):
                stale.append(eng._cache)
            raise

    eng.step = step
    sup = Supervisor(step_deadline_s=0.3, breaker_threshold=10)
    try:
        out, snap, fired = _run(
            eng, cases, "serving.decode_step:at=5,action=hang,hang_s=0.8",
            sup)
        deadline = time.time() + 5
        while not stale and time.time() < deadline:
            time.sleep(0.02)
    finally:
        del eng.step
    assert out == clean
    assert sup.watchdog_trips == 1 and snap["watchdog_trips_total"] == 1
    assert snap["slot_reprefills_total"] >= 1
    assert snap["evictions"]["recovered"] >= 1
    assert len(stale) == 1, "the late step did not reach its epoch check"
    with pytest.raises(RuntimeError, match="reset"):
        eng.reset()
        eng.advance(0, 1)


def test_supervised_no_faults_is_zero_cost(engines):
    eng = engines["chunked"]
    cases = _cases(3, 6, max_tokens=5)
    plain, psnap, _ = _run(eng, cases)
    out, snap, _ = _run(eng, cases, sup=Supervisor(breaker_threshold=3))
    assert out == plain
    assert snap["decode_steps_total"] == psnap["decode_steps_total"]
    for key in ("slot_reprefills_total", "watchdog_trips_total",
                "retries_total", "breaker_state", "breaker_open_total"):
        assert snap[key] == 0, key
    assert snap["faults_fired"] == {}


def test_submit_retry_transient_with_idempotence(engines):
    eng = engines["chunked"]
    eng.metrics = ServingMetrics()
    bat = GenerationBatcher(eng)
    prompt = _cases(5, 1)[0][0]
    retried = []
    faults.install_spec("batcher.submit:every=1,times=2")
    fut = retry_transient(lambda: bat.submit(prompt, max_tokens=3),
                          budget=3, base_delay_s=0.001, seed=0,
                          on_retry=lambda a, e: retried.append(a))
    assert len(fut.result(60)["tokens"]) == 3
    assert retried == [1, 2]
    assert eng.metrics.snapshot()["requests_total"] == 1
    faults.install_spec("batcher.submit:every=1")
    with pytest.raises(InjectedFault):
        retry_transient(lambda: bat.submit(prompt, max_tokens=3),
                        budget=2, base_delay_s=0.001, seed=0)
    faults.clear()
    assert eng.metrics.snapshot()["requests_total"] == 1
    bat.close()


def test_breaker_opens_sheds_and_recloses(engines):
    eng = engines["chunked"]
    prompt, n = _cases(6, 1, max_tokens=3)[0]
    clean, _, _ = _run(eng, [(prompt, n)])
    eng.metrics = ServingMetrics()
    sup = Supervisor(breaker_threshold=2, breaker_cooldown_s=0.3,
                     max_request_recoveries=1)
    bat = GenerationBatcher(eng, supervisor=sup)
    faults.install_spec("serving.decode_step:every=1")
    with pytest.raises(BatchExecutionError):
        bat.submit(prompt, max_tokens=n).result(60)
    deadline = time.time() + 5
    while sup.breaker.state != "open" and time.time() < deadline:
        time.sleep(0.01)
    assert sup.breaker.state == "open" and not bat.ready
    with pytest.raises(BreakerOpenError) as ei:
        bat.submit(prompt, max_tokens=n)
    assert ei.value.retry_after_s > 0
    snap = eng.metrics.snapshot()
    assert snap["rejected"]["breaker"] == 1
    assert snap["breaker_state"] == 2 and snap["breaker_open_total"] == 1
    assert 'slot_evictions_total{reason="recovered"} 1' \
        in eng.metrics.render_prometheus()
    faults.clear()
    time.sleep(0.35)
    assert bat.submit(prompt, max_tokens=n).result(60)["tokens"] == clean[0]
    deadline = time.time() + 5
    while sup.breaker.state != "closed" and time.time() < deadline:
        time.sleep(0.01)
    assert sup.breaker.state == "closed" and bat.ready
    bat.close()


def test_supervisor_chaos_with_tier_bit_identical(params):
    """A step fault on a paged engine with the host tier: the tier
    survives the reset, recovery re-seats every stream, the outputs are
    the tier-less twin's and the ledger is clean."""
    kw = dict(num_heads=HEADS, num_slots=SLOTS, max_len=MAX_LEN,
              kv_layout="paged", kv_block_size=8, kv_num_blocks=13,
              prefill_chunk=8, device="cpu")
    eng = DecodeEngine(params, name="chaos_tier", kv_host_bytes=64 << 20,
                       **kw)
    twin = DecodeEngine(params, name="chaos_twin", **kw)
    rng = np.random.RandomState(9)
    shared = rng.randint(1, VOCAB, 32).astype(np.int32)
    cases = [(shared, 6)] + [(rng.randint(1, VOCAB, 28).astype(np.int32), 5)
                             for _ in range(4)] + [(shared, 6)]
    out, snap, fired = _run(eng, cases, "serving.decode_step:at=7",
                            Supervisor(breaker_threshold=10))
    assert fired == {"serving.decode_step": 1}
    assert snap["evictions"]["recovered"] >= 1
    assert out == _run(twin, cases)[0]
    eng._paged.check()
    assert not eng._paged._pending and eng.free_slots == SLOTS
