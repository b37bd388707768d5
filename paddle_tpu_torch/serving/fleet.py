"""Supervised replica fleet: spawn, health-check, restart N serving
replicas (``paddle_tpu/serving/fleet.py``).

One serving process (server.py) is one failure domain: a crash, a wedged
drain, or a poisoned engine takes every resident stream with it, and the
in-process recovery (resilience/supervisor.py) cannot outlive the
process.  The fleet tier runs N independent ``python -m
paddle_tpu_torch.serving`` replica SUBPROCESSES
— same model, same flags, own port each — under a supervisor that:

* spawns each replica with ``--port 0 --port-file <path>`` (the replica
  binds an ephemeral port and publishes it atomically), so replicas
  never fight over ports and a restarted replica simply appears at a
  new address;
* watches for crashes (any exit the supervisor did not ask for — a
  kill -9 looks exactly like a device wedge) and restarts with
  EXPONENTIAL BACKOFF plus seeded jitter
  (``min(base * 2**k, max) * uniform(0.5, 1.0)``, one
  ``random.Random(seed)`` stream per replica — deterministic under
  test, de-synchronized in production);
* trips a RESTART-STORM breaker when ``storm_threshold`` crashes land
  within ``storm_window_s`` — a replica that cannot stay up stops being
  restarted (state ``failed``) instead of burning the host on a crash
  loop, mirroring the request-level ``CircuitBreaker``;
* supports ROLLING DRAIN (``drain``/``rolling_restart``): SIGTERM one
  replica at a time — the replica finishes queued work under its drain
  deadline while the router routes around it via ``/readyz`` — then
  respawn and wait ready before touching the next one: zero-downtime
  restarts, zero failed requests.

The supervisor owns PROCESS health only; request-level health (readiness
gating, outlier ejection, failover) is the router's job
(serving/router.py) — the two compose through ``endpoints()``.

Each replica runs on the card unless its arguments say ``--device cpu``
(``extra_args``); the supervisor never picks a device for it.
"""

import os
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time

from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.utils.logging import logger

# the default replica: the built-in tiny-LM generation server (bring-up/
# smoke); production fleets pass their own cmd/extra_args
DEFAULT_REPLICA_CMD = ("-m", "paddle_tpu_torch.serving", "--demo-generate")

# replica lifecycle states (snapshot()/endpoints() surface)
STATES = ("starting", "running", "backoff", "draining", "failed", "stopped")


class _Replica:
    """One managed replica subprocess (all mutation under the
    supervisor's lock)."""

    def __init__(self, rid, cmd, port_file, log_path, role=None):
        self.rid = rid
        self.cmd = list(cmd)
        self.port_file = port_file
        self.log_path = log_path
        self.role = role                  # disaggregated serving role
        #                                   (prefill|decode|mixed|None)
        self.proc = None
        self.port = None                  # read lazily from port_file
        self.state = "stopped"
        self.started_at = 0.0
        self.restarts_total = 0           # crash-driven respawns
        self.drains_total = 0             # deliberate (rolling) restarts
        self.consecutive_failures = 0     # crashes since last healthy uptime
        self.backoff_delays = []          # applied (jittered) delays, seconds
        self.crash_times = []             # monotonic, for the storm window
        self.next_restart_at = None
        self.expected_exit = False        # drain()/stop() asked for it
        self.storm_tripped = False

    @property
    def base_url(self):
        return (f"http://127.0.0.1:{self.port}"
                if self.port is not None else None)


class ReplicaSupervisor:
    """Spawn + supervise ``n_replicas`` serving subprocesses.

    cmd: argv AFTER the interpreter (default: the built-in
    ``--demo-generate`` server) — ``--port 0 --port-file <path>`` is
    always appended; extra_args: appended before the port args (model/
    scale flags).  backoff_base_s/backoff_max_s: crash-restart schedule;
    storm_threshold/storm_window_s: the restart-storm breaker;
    healthy_uptime_s: a replica alive this long resets its consecutive-
    failure count (the backoff exponent); seed: the jitter streams.
    base_dir: where port files + replica logs live (default: a fresh
    temp dir).  roles: optional per-replica disaggregated-serving roles
    (a sequence matched to r0..rN-1, entries from prefill|decode|mixed
    or None) — each named replica is spawned with ``--role <role>`` and
    KEEPS that role across crash restarts.
    """

    def __init__(self, n_replicas=2, cmd=None, extra_args=(),
                 backoff_base_s=0.5, backoff_max_s=10.0, storm_threshold=5,
                 storm_window_s=30.0, healthy_uptime_s=5.0, seed=0,
                 env=None, base_dir=None, name="fleet", roles=None):
        if int(n_replicas) < 1:
            raise ValueError("n_replicas must be >= 1")
        self.name = name
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self.healthy_uptime_s = float(healthy_uptime_s)
        self.seed = int(seed)
        self.env = dict(env) if env is not None else dict(os.environ)
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="pt_fleet_")
        os.makedirs(self.base_dir, exist_ok=True)
        base = ([sys.executable]
                + (list(cmd) if cmd is not None
                   else list(DEFAULT_REPLICA_CMD))
                + list(extra_args))
        self._base_cmd = base       # template for add_replica clones
        self._lock = threading.RLock()
        self._stopping = False
        self.replicas = {}
        self._rngs = {}
        roles = list(roles or ())
        for i in range(int(n_replicas)):
            rid = f"r{i}"
            pf = os.path.join(self.base_dir, f"{rid}.port")
            role = roles[i] if i < len(roles) else None
            self.replicas[rid] = _Replica(
                rid, base + (["--role", role] if role else []), pf,
                os.path.join(self.base_dir, f"{rid}.log"), role=role)
            # one seeded jitter stream per replica: deterministic replays
            # under test, de-synchronized restarts in production
            self._rngs[rid] = random.Random(self.seed * 7919 + i)
        self._next_idx = int(n_replicas)    # rids are never reused: a
        #                                     scaled-in then scaled-out
        #                                     replica is a NEW identity
        self._monitor = None

    # ------------------------------------------------------------ lifecycle

    def start(self):
        """Spawn every replica and start the crash monitor (idempotent)."""
        with self._lock:
            self._stopping = False
            for rep in self.replicas.values():
                if rep.proc is None or rep.proc.poll() is not None:
                    if not rep.storm_tripped:
                        self._try_spawn(rep)
            if self._monitor is None or not self._monitor.is_alive():
                self._monitor = threading.Thread(
                    target=self._monitor_loop, daemon=True,
                    name=f"{self.name}-monitor")
                self._monitor.start()
        return self

    def _spawn(self, rep):
        # the fleet.spawn fault point models a replica that fails (or
        # hangs) AT spawn, before it could ever publish a port or answer
        # /readyz — the autoscaler's scale-out chaos case.  An injected
        # error propagates to the caller exactly like a real Popen
        # failure (OSError); _try_spawn turns both into backoff restarts.
        faults.hit("fleet.spawn")
        try:
            os.remove(rep.port_file)
        except OSError:
            pass
        rep.port = None
        log = open(rep.log_path, "ab")
        rep.proc = subprocess.Popen(
            rep.cmd + ["--port", "0", "--port-file", rep.port_file],
            stdout=log, stderr=subprocess.STDOUT, env=self.env)
        log.close()                 # the child holds its own fd now
        rep.started_at = time.monotonic()
        rep.expected_exit = False
        rep.state = "starting"
        logger.info("%s: %s spawned (pid %d)", self.name, rep.rid,
                    rep.proc.pid)

    def _try_spawn(self, rep):
        """_spawn, with a failed spawn (injected fleet.spawn fault, a
        real fork/exec failure) accounted like an instant crash: backoff
        restart or storm trip — never an unhandled exception in the
        monitor thread.  Returns True when the subprocess exists."""
        try:
            self._spawn(rep)
            return True
        except Exception as e:    # noqa: BLE001 — spawn failure == crash
            logger.warning("%s: %s spawn failed: %s: %s", self.name,
                           rep.rid, type(e).__name__, e)
            self._on_spawn_failure(rep, time.monotonic())
            return False

    def _read_port(self, rep):
        if rep.port is None:
            try:
                with open(rep.port_file) as f:
                    rep.port = int(f.read().strip())
                rep.state = "running"
            except (OSError, ValueError):
                pass
        return rep.port

    def _monitor_loop(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
                now = time.monotonic()
                for rep in self.replicas.values():
                    if rep.state in ("starting", "running"):
                        self._read_port(rep)
                        if rep.proc.poll() is None:
                            # alive long enough: the crash streak is over
                            if rep.consecutive_failures \
                                    and now - rep.started_at \
                                    >= self.healthy_uptime_s:
                                rep.consecutive_failures = 0
                        elif not rep.expected_exit:
                            self._on_crash(rep, now)
                    elif rep.state == "backoff" \
                            and now >= rep.next_restart_at:
                        if self._try_spawn(rep):
                            rep.restarts_total += 1
            time.sleep(0.05)

    def _on_crash(self, rep, now):
        """An exit nobody asked for (crash, OOM kill, kill -9): schedule
        a backoff restart, or trip the storm breaker."""
        self._schedule_restart(rep, now, rep.proc.returncode)

    def _on_spawn_failure(self, rep, now):
        """The subprocess never came to exist (fleet.spawn fault, fork/
        exec failure): same backoff/storm accounting as an instant
        crash."""
        rep.state = "backoff"       # there is no proc to poll
        self._schedule_restart(rep, now, "spawn_failed")

    def _schedule_restart(self, rep, now, rc):
        rep.consecutive_failures += 1
        rep.crash_times.append(now)
        in_window = [t for t in rep.crash_times
                     if now - t <= self.storm_window_s]
        if len(in_window) >= self.storm_threshold:
            rep.state = "failed"
            rep.storm_tripped = True
            logger.warning(
                "%s: %s crashed %d times within %.0fs (last rc=%s) — "
                "restart-storm breaker OPEN, giving up on this replica",
                self.name, rep.rid, len(in_window), self.storm_window_s, rc)
            return
        k = rep.consecutive_failures - 1
        delay = min(self.backoff_base_s * (2 ** k), self.backoff_max_s)
        delay *= 0.5 + 0.5 * self._rngs[rep.rid].random()
        rep.backoff_delays.append(delay)
        rep.next_restart_at = now + delay
        rep.state = "backoff"
        logger.warning("%s: %s exited rc=%s (crash #%d); restarting in "
                       "%.2fs", self.name, rep.rid, rc,
                       rep.consecutive_failures, delay)

    # ------------------------------------------------------------ scaling

    def add_replica(self, role=None):
        """Scale-out primitive (serving/autoscaler.py): spawn ONE new
        replica under supervision and return its rid.  The rid is fresh
        (never reuses a removed replica's identity, so the router builds
        a clean view with a fresh breaker).  ``role`` optionally pins a
        disaggregated-serving role (``--role prefill|decode|mixed``) on
        the new replica.  Raises when the spawn itself fails
        (fleet.spawn fault, fork/exec failure) — the caller owns the
        retry policy; nothing is registered on failure, so a failed
        scale-out leaves the fleet exactly as it was."""
        with self._lock:
            if self._stopping:
                raise RuntimeError(f"{self.name} is stopping")
            i = self._next_idx
            rid = f"r{i}"
            pf = os.path.join(self.base_dir, f"{rid}.port")
            rep = _Replica(rid,
                           self._base_cmd
                           + (["--role", role] if role else []), pf,
                           os.path.join(self.base_dir, f"{rid}.log"),
                           role=role)
            self._spawn(rep)        # raises on failure: register nothing
            self._next_idx = i + 1
            self.replicas[rid] = rep
            self._rngs[rid] = random.Random(self.seed * 7919 + i)
        logger.info("%s: scaled OUT to %d replicas (+%s)", self.name,
                    len(self.replicas), rid)
        return rid

    def remove_replica(self, rid, drain_timeout=60.0):
        """Scale-in primitive: gracefully drain the replica (SIGTERM —
        it finishes queued work under its drain deadline while the
        router routes around it), then FORGET it (endpoints()/snapshot()
        no longer list it; the monitor never restarts it).  A replica
        with no live process (spawn failed, backoff, storm-tripped) is
        CLAIMED under the monitor's lock before being forgotten — the
        not-running check and the state flip happen in ONE lock
        acquisition, so the monitor's backoff branch can never respawn
        a replica this removal is about to drop (which would leak an
        orphaned, unsupervised subprocess)."""
        for _ in range(3):
            with self._lock:
                rep = self.replicas.get(rid)
                if rep is None:
                    return
                if rep.proc is None or rep.proc.poll() is not None:
                    # dead/backoff: state leaves the monitor's respawn
                    # set ATOMICALLY with the liveness check
                    rep.expected_exit = True
                    rep.state = "stopped"
                    self.replicas.pop(rid, None)
                    self._rngs.pop(rid, None)
                    n = len(self.replicas)
                    logger.info("%s: scaled IN to %d replicas (-%s, "
                                "was not running)", self.name, n, rid)
                    return
            try:
                self.drain(rid, timeout=drain_timeout, restart=False)
                break
            except RuntimeError:
                # the process exited between the check and the drain
                # (crash, or the monitor replaced it) — re-examine
                continue
        with self._lock:
            rep = self.replicas.pop(rid, None)
            self._rngs.pop(rid, None)
            if rep is not None and rep.proc is not None \
                    and rep.proc.poll() is None:
                # backstop (retry loop exhausted by repeated races): a
                # forgotten replica must never keep a live process
                rep.expected_exit = True
                try:
                    os.kill(rep.proc.pid, signal.SIGTERM)
                except OSError:
                    pass
        logger.info("%s: scaled IN to %d replicas (-%s)", self.name,
                    len(self.replicas), rid)

    # ------------------------------------------------------------ chaos/ops

    def kill(self, rid, sig=signal.SIGKILL):
        """Chaos helper: signal a replica (default kill -9).  The monitor
        sees the crash and schedules the backoff restart."""
        with self._lock:
            rep = self.replicas[rid]
            if rep.proc is not None and rep.proc.poll() is None:
                os.kill(rep.proc.pid, sig)

    def drain(self, rid, timeout=60.0, restart=True):
        """Deliberate rolling-restart step: SIGTERM the replica (it stops
        admissions, finishes queued work under its drain deadline — the
        router routes around it via /readyz meanwhile), wait for exit,
        then respawn.  Not a crash: no backoff, no storm accounting."""
        with self._lock:
            rep = self.replicas[rid]
            proc = rep.proc
            if proc is None or proc.poll() is not None:
                raise RuntimeError(f"{rid} is not running")
            rep.expected_exit = True
            rep.state = "draining"
            os.kill(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            logger.warning("%s: %s did not drain within %.0fs; killing",
                           self.name, rid, timeout)
            proc.kill()
            proc.wait(10)
        with self._lock:
            rep.drains_total += 1
            if restart and not self._stopping:
                self._try_spawn(rep)
            else:
                rep.state = "stopped"

    def rolling_restart(self, ready_timeout=120.0, drain_timeout=60.0):
        """Zero-downtime restart sweep: one replica at a time — drain,
        respawn, wait until IT answers /readyz 200 — so N-1 replicas
        serve throughout."""
        for rid in sorted(self.replicas):
            self.drain(rid, timeout=drain_timeout, restart=True)
            if not self.wait_ready(timeout=ready_timeout, rids=(rid,)):
                raise RuntimeError(
                    f"{rid} not ready {ready_timeout:.0f}s after its "
                    "rolling restart")

    def stop(self, timeout=30.0):
        """SIGTERM every replica, wait, SIGKILL stragglers.  Idempotent."""
        with self._lock:
            self._stopping = True
            procs = []
            for rep in self.replicas.values():
                rep.expected_exit = True
                if rep.proc is not None and rep.proc.poll() is None:
                    try:
                        os.kill(rep.proc.pid, signal.SIGTERM)
                    except OSError:
                        pass
                    procs.append(rep.proc)
                rep.state = "stopped"
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(10)
        if self._monitor is not None:
            self._monitor.join(5)

    # ------------------------------------------------------------ discovery

    def endpoints(self):
        """[(rid, base_url)] of replicas with a live process AND a
        published port — the router's replica set.  Backoff/failed/
        stopped replicas are absent (not merely unready): the router
        must not even health-poll an address nobody listens on."""
        out = []
        with self._lock:
            for rep in self.replicas.values():
                if rep.state in ("starting", "running", "draining") \
                        and rep.proc is not None \
                        and rep.proc.poll() is None:
                    self._read_port(rep)
                    if rep.port is not None:
                        out.append((rep.rid, rep.base_url))
        return out

    def wait_ready(self, timeout=120.0, rids=None, poll_s=0.2):
        """Block until every (selected) replica answers /readyz 200;
        returns True on success, False on timeout."""
        import urllib.request
        want = set(rids if rids is not None else self.replicas)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ready = set()
            for rid, url in self.endpoints():
                if rid not in want:
                    continue
                try:
                    with urllib.request.urlopen(f"{url}/readyz",
                                                timeout=5) as r:
                        if r.status == 200:
                            ready.add(rid)
                except Exception:   # noqa: BLE001 — not up yet
                    pass
            if ready >= want:
                return True
            time.sleep(poll_s)
        return False

    # ------------------------------------------------------------ evidence

    def snapshot(self):
        """Per-replica supervision counters (the smoke JSON / /metrics
        evidence): state, port, restarts, drains, backoff delays, storm
        breaker."""
        with self._lock:
            return {
                rep.rid: {
                    "state": rep.state,
                    "role": rep.role,
                    "port": rep.port,
                    "pid": (rep.proc.pid if rep.proc is not None
                            and rep.proc.poll() is None else None),
                    "restarts_total": rep.restarts_total,
                    "drains_total": rep.drains_total,
                    "consecutive_failures": rep.consecutive_failures,
                    "backoff_delays_s": [round(d, 4)
                                         for d in rep.backoff_delays],
                    "storm_tripped": rep.storm_tripped,
                } for rep in self.replicas.values()
            }

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
