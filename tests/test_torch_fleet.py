"""The replica fleet on the port (``serving/fleet.py``) and the serving
CLI's fleet-facing flags (``serving/server.py``).

Fast lane: ``ReplicaSupervisor`` over stub commands held against JAX's
with the same seed (the jittered crash-restart delays, the restart-storm
trip and every counter; a ``fleet.spawn`` fault accounted as a crash),
the scaling and drain primitives with ``roles=``, the CLI's
``--demo-generate`` / ``--role`` / ``--port-file`` / ``--gen-*``
options, a replica on its default device refusing a machine without a
card, and ONE real replica subprocess (``--demo-generate --device
cpu --port 0 --port-file``): its port file, ``/readyz``, its role on
``/metrics``, a stream bit for bit the in-process engine from the same
seed, and a kill -9 followed by the seeded restart.

Slow lane (``-m slow``), the port's twins of JAX's own slow fleet
tests: kill -9 one of two replicas under 8 concurrent streaming clients
(every stream bit for bit), the victim's seeded restart, and a rolling
drain with zero failed requests.
"""

import http.client
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.serving import fleet as jax_fleet
from paddle_tpu_torch.resilience import faults as torch_faults
from paddle_tpu_torch.serving import fleet as torch_fleet
from paddle_tpu_torch.serving import server
from paddle_tpu_torch.serving.router import Router, demo_reference

PACKAGES = {"jax": (jax_fleet, jax_faults), "torch": (torch_fleet,
                                                      torch_faults)}
CRASH = ["-c", "import sys; sys.exit(3)"]
SLEEP = ["-c", "import time; time.sleep(60)"]
CPU = ["--device", "cpu"]
REPLICA_ARGS = ["--gen-slots", "2", "--gen-max-len", "32",
                "--gen-max-tokens", "6", *CPU]


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    jax_faults.clear()
    torch_faults.clear()


def _wait(pred, timeout=30.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


def _seeded_delays(seed, n, base, cap, rid_index=0):
    rng = random.Random(seed * 7919 + rid_index)
    return [round(min(base * 2 ** k, cap) * (0.5 + 0.5 * rng.random()), 4)
            for k in range(n)]


# ------------------------------------------------------- supervisor twins


def _storm(mod, out, key):
    sup = mod.ReplicaSupervisor(
        n_replicas=1, cmd=CRASH, backoff_base_s=0.05, backoff_max_s=0.4,
        storm_threshold=4, storm_window_s=30.0, seed=11, name=key)
    sup.start()
    try:
        _wait(lambda: sup.snapshot()["r0"]["storm_tripped"], 30)
        time.sleep(0.3)     # tripped: nothing more may be scheduled
        out[key] = sup.snapshot()["r0"]
    finally:
        sup.stop()


def test_supervisor_backoff_and_storm_breaker_equal_to_jax():
    """A replica that dies at once is restarted on the seeded jittered
    schedule until the storm breaker trips — the port's delays, counts
    and states are JAX's with the same seed, and the seeded formula."""
    out = {}
    threads = [threading.Thread(target=_storm, args=(mod, out, key))
               for key, (mod, _f) in PACKAGES.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    jsnap, tsnap = out["jax"], out["torch"]
    for key in ("state", "role", "port", "pid", "restarts_total",
                "drains_total", "consecutive_failures", "backoff_delays_s",
                "storm_tripped"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["state"] == "failed" and tsnap["storm_tripped"]
    assert tsnap["restarts_total"] == 3
    assert tsnap["consecutive_failures"] == 4
    assert tsnap["backoff_delays_s"] == _seeded_delays(11, 3, 0.05, 0.4)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_spawn_fault_becomes_backoff_restart(pkg):
    """An injected ``fleet.spawn`` failure at start() is an instant
    crash: one seeded backoff delay, then the monitor spawns it."""
    mod, faults = PACKAGES[pkg]
    faults.install_spec("fleet.spawn:at=1")
    sup = mod.ReplicaSupervisor(n_replicas=1, cmd=SLEEP,
                                backoff_base_s=0.05, backoff_max_s=0.4,
                                seed=11, name=f"spawn_fault_{pkg}")
    sup.start()
    try:
        assert _wait(lambda: sup.snapshot()["r0"]["pid"] is not None, 10)
        snap = sup.snapshot()["r0"]
        assert snap["consecutive_failures"] == 1
        assert snap["restarts_total"] == 1
        assert snap["backoff_delays_s"] == _seeded_delays(11, 1, 0.05, 0.4)
        assert faults.fired_counts()["fleet.spawn"] == 1
    finally:
        sup.stop()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_scaling_roles_and_drain_primitives(pkg, tmp_path):
    """roles= pins --role on the named replicas; add_replica mints a
    fresh rid (with its own seeded stream) and raises with nothing
    registered on a spawn fault; drain SIGTERMs and respawns without
    crash accounting; remove_replica forgets a replica; a replica
    without a published port is not an endpoint."""
    mod, faults = PACKAGES[pkg]
    sup = mod.ReplicaSupervisor(n_replicas=2, cmd=SLEEP,
                                roles=("prefill", "decode"), seed=3,
                                base_dir=str(tmp_path), name=f"ops_{pkg}")
    sup.start()
    try:
        assert [sup.replicas[r].cmd[-2:] for r in ("r0", "r1")] \
            == [["--role", "prefill"], ["--role", "decode"]]
        assert sup.endpoints() == []            # no port file published
        faults.install_spec("fleet.spawn:at=1")
        with pytest.raises(faults.InjectedFault):
            sup.add_replica(role="decode")
        assert sorted(sup.replicas) == ["r0", "r1"]
        rid = sup.add_replica(role="decode")
        assert rid == "r2" and sup.replicas[rid].role == "decode"
        pid = sup.snapshot()["r0"]["pid"]
        sup.drain("r0", timeout=10)
        snap = sup.snapshot()
        assert snap["r0"]["drains_total"] == 1
        assert snap["r0"]["restarts_total"] == 0
        assert snap["r0"]["pid"] not in (None, pid)
        sup.remove_replica("r2", drain_timeout=10)
        assert sorted(sup.snapshot()) == ["r0", "r1"]
        with pytest.raises(ValueError):
            mod.ReplicaSupervisor(n_replicas=0)
    finally:
        sup.stop()
    assert all(r["state"] == "stopped" for r in sup.snapshot().values())


def test_default_replica_is_the_ports_demo_server():
    assert torch_fleet.DEFAULT_REPLICA_CMD == (
        "-m", "paddle_tpu_torch.serving", "--demo-generate")
    assert torch_fleet.STATES == jax_fleet.STATES


# ------------------------------------------------------------ server CLI


def test_cli_fleet_flags_parse_and_effect(tmp_path):
    """--gen-* read as the port's --slots/--max-len/--max-tokens, the
    ladder's buckets reach the engine, --demo-generate builds JAX's tiny
    trunk, --role reaches /metrics, --port-file is written atomically."""
    args = server.parse_args(
        ["--demo-generate", "--gen-slots", "3", "--gen-max-len", "40",
         "--gen-max-tokens", "5", "--gen-prefill-buckets", "8,16",
         "--prefill-chunk", "0", "--role", "decode", *CPU])
    assert (args.slots, args.max_len, args.max_tokens) == (3, 40, 5)
    assert args.prefill_buckets == "8,16" and args.role == "decode"
    same = server.parse_args(["--slots", "3", "--max-len", "40",
                              "--max-tokens", "5"])
    assert (same.slots, same.max_len, same.max_tokens) == (3, 40, 5)
    default = server.parse_args([])
    assert default.role == "mixed" and not default.demo_generate
    assert default.port_file is None
    gen = server.batcher_from_args(args)
    try:
        eng = gen.engine
        assert eng.name == "demo_lm" and eng.num_slots == 3
        assert eng.max_len == 40 and eng.prefill_buckets == (8, 16)
        assert gen.default_max_tokens == 5
        assert tuple(eng.params["src_emb"].shape) == (256, 32)
        assert len(eng.params["enc"]) == 2
        text = gen.metrics.render_prometheus()
        assert '_serving_role{role="decode"} 1' in text
    finally:
        gen.close()
    with pytest.raises(SystemExit):
        server.parse_args(["--role", "both"])
    path = str(tmp_path / "r.port")
    server._write_port_file(path, 4321)
    assert open(path).read() == "4321\n"
    assert os.listdir(tmp_path) == ["r.port"]


def test_replica_without_a_card_raises_rather_than_serving_on_the_cpu():
    """A replica left to its default device refuses to start on a machine
    with no card: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the replica would serve")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving", "--demo-generate",
         "--port", "0"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr


# --------------------------------------------------- one real subprocess


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _generate(url, prompt, n):
    req = urllib.request.Request(
        f"{url}/v1/generate",
        data=json.dumps({"prompt": prompt, "max_tokens": n}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["tokens"]


def test_real_replica_port_file_role_and_seeded_restart(tmp_path):
    prompt = [5, 9, 2, 77, 31]
    ref, _eng = demo_reference(REPLICA_ARGS, [prompt], 6)
    sup = torch_fleet.ReplicaSupervisor(
        n_replicas=1, extra_args=REPLICA_ARGS, roles=("decode",),
        backoff_base_s=0.3, seed=5, base_dir=str(tmp_path),
        name="one_replica")
    sup.start()
    try:
        assert sup.wait_ready(timeout=120), open(
            tmp_path / "r0.log").read()[-2000:]
        (rid, url), = sup.endpoints()
        port = int(open(tmp_path / "r0.port").read())
        assert url == f"http://127.0.0.1:{port}"
        assert _get(f"{url}/readyz")[0] == 200
        status, text = _get(f"{url}/metrics")
        assert '_serving_role{role="decode"} 1' in text
        assert _generate(url, prompt, 6) == ref[0]
        sup.kill("r0", signal.SIGKILL)
        assert _wait(lambda: sup.snapshot()["r0"]["restarts_total"] == 1,
                     30)
        assert sup.wait_ready(timeout=120, rids=("r0",))
        snap = sup.snapshot()["r0"]
        assert snap["backoff_delays_s"] == _seeded_delays(5, 1, 0.3, 10.0)
        assert snap["storm_tripped"] is False and snap["role"] == "decode"
        (_rid, url2), = sup.endpoints()
        assert _generate(url2, prompt, 6) == ref[0]
    finally:
        sup.stop()
    assert not os.path.exists(tmp_path / "r0.port.tmp")


# ------------------------------------------------ subprocess fleet (slow)

FLEET_MAX_LEN, FLEET_TOKENS = 64, 20
FLEET_BASE = ["--gen-slots", "4", "--gen-max-len", str(FLEET_MAX_LEN),
              "--gen-prefill-buckets", "8,16",
              "--gen-max-tokens", str(FLEET_TOKENS), *CPU]
FLEET_ARGS = FLEET_BASE + [
    "--fault-spec", "serving.decode_step:every=1,action=hang,hang_s=0.02"]
FLEET_SEED = 0


@pytest.fixture(scope="module")
def fleet():
    sup = torch_fleet.ReplicaSupervisor(n_replicas=2, extra_args=FLEET_ARGS,
                                        backoff_base_s=0.3, seed=FLEET_SEED,
                                        name="test_torch_fleet")
    sup.start()
    if not sup.wait_ready(timeout=300):
        sup.stop()
        pytest.fail("fleet replicas never became ready")
    router = Router(supervisor=sup, poll_interval_s=0.1, eject_threshold=2,
                    eject_cooldown_s=1.0, retry_budget=3, hedge_ms=0)
    httpd = router.start(port=0)
    # every replica ready before the router is used (Router.ready turns
    # true once ANY replica is)
    assert _wait(lambda: len([s for s in router.replica_states().values()
                              if s["ready"]]) == 2, 30)
    yield sup, router, httpd.port
    router.close()
    sup.stop()


@pytest.mark.slow
def test_fleet_kill9_midstream_under_concurrent_load(fleet):
    sup, router, port = fleet
    n_clients = 8
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 256, int(rng.randint(3, 17))).tolist()
               for _ in range(n_clients)]
    oracle, _eng = demo_reference(FLEET_BASE, prompts, FLEET_TOKENS)
    results, errs = [None] * n_clients, []
    seen2 = threading.Barrier(n_clients + 1, timeout=120)

    def hit(i):
        armed = True
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)
            conn.request("POST", "/v1/generate",
                         json.dumps({"prompt": prompts[i],
                                     "max_tokens": FLEET_TOKENS,
                                     "stream": True}).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            toks, done = [], None
            while True:
                line = resp.readline()
                if not line:
                    break
                rec = json.loads(line)
                if "token" in rec:
                    toks.append(rec["token"])
                    if armed and len(toks) >= 2:
                        armed = False
                        seen2.wait()
                if rec.get("done"):
                    done = rec
                    break
            conn.close()
            if armed:
                seen2.wait()
            results[i] = (toks, done)
        except Exception as e:      # noqa: BLE001
            errs.append(f"client {i}: {type(e).__name__}: {e}")
            if armed:
                try:
                    seen2.wait()
                except threading.BrokenBarrierError:
                    pass

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    seen2.wait()
    sup.kill("r0", signal.SIGKILL)
    for t in threads:
        t.join(180)
        assert not t.is_alive(), "client thread wedged"
    assert not errs, errs
    for i, (toks, done) in enumerate(results):
        assert toks == oracle[i], f"stream {i} diverged after the kill"
        assert done is not None and done["tokens"] == oracle[i]
    snap = router.metrics.snapshot()
    assert snap["midstream_failovers_total"] >= 1
    assert snap["failovers_total"] >= snap["midstream_failovers_total"]


@pytest.mark.slow
def test_fleet_victim_restarted_with_seeded_backoff(fleet):
    sup, router, _port = fleet
    assert sup.wait_ready(timeout=300, rids=("r0",)), sup.snapshot()
    snap = sup.snapshot()["r0"]
    assert snap["restarts_total"] == 1 and snap["storm_tripped"] is False
    assert snap["backoff_delays_s"] == _seeded_delays(FLEET_SEED, 1, 0.3,
                                                      10.0)
    assert _wait(lambda: router.replica_states().get("r0", {})
                 .get("ready", False), 30)


@pytest.mark.slow
def test_fleet_rolling_drain_zero_failed_requests(fleet):
    sup, router, port = fleet
    restarts_before = {rid: r["restarts_total"]
                       for rid, r in sup.snapshot().items()}
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 256, int(rng.randint(3, 17))).tolist()
               for _ in range(4)]
    oracle, _eng = demo_reference(FLEET_BASE, prompts, 6)
    stop = threading.Event()
    failures, completed = [], [0]

    def client(i):
        while not stop.is_set():
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/generate",
                    data=json.dumps({"prompt": prompts[i],
                                     "max_tokens": 6}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    out = json.loads(r.read())
                if out["tokens"] != oracle[i]:
                    failures.append((i, out))
                completed[0] += 1
            except Exception as e:      # noqa: BLE001
                failures.append((i, f"{type(e).__name__}: {e}"))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    try:
        sup.rolling_restart(ready_timeout=300)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
    assert not failures, failures[:5]
    assert completed[0] > 0
    fsnap = sup.snapshot()
    assert all(r["drains_total"] == 1 for r in fsnap.values()), fsnap
    for rid, r in fsnap.items():
        assert r["restarts_total"] == restarts_before[rid], fsnap
