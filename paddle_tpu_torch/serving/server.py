"""Stdlib HTTP front-end + CLI for the serving runtime
(``paddle_tpu/serving/server.py``, less its ``--smoke-*`` self-tests).

Endpoints:
  POST /v1/infer   {"feed": {slot: array}, "deadline_ms": opt}
                   -> {"outputs": ..., "latency_ms": ...} (the inference
                   plane: ``Batcher`` over ``InferenceEngine``; plain-array
                   feed slots only — sequence slots are an in-process
                   engine feature)
  POST /v1/generate {"prompt": [ids], "max_tokens": N, "eos_id": opt,
                    "deadline_ms": opt, "stream": false, "replay": opt,
                    "kv_handoff": opt}
                   -> {"tokens": [...], "finish_reason": "eos"|"length",
                       "ttft_ms": ..., "latency_ms": ...}
                   "stream": true streams newline-delimited JSON chunks
                   ({"token": id} per emitted token, then a {"done":
                   true, ...} record) over chunked transfer encoding.
                   "replay": [ids] continues a stream another server
                   began (those tokens are teacher-forced, never
                   re-emitted); "kv_handoff": {"source": url, "tokens":
                   [ids]} first pulls the stream's KV chain from that
                   replica's /v1/kv/export into the host tier (any
                   failure falls back to recompute; the outcome is in
                   the response).
  POST /v1/kv/export {"tokens": [ids]}
                   -> the longest resident KV coverage of that prefix as
                   one length-prefixed wire-format blob (application/
                   octet-stream), serialized by the batcher's worker
                   between steps; 404 = no coverage (the peer recomputes)
  GET  /healthz    LIVENESS: 200 while the process can answer (even
                   draining)
  GET  /readyz     READINESS: 200 when warm, the circuit breaker not
                   open and no drain begun; else 503 with the reasons
                   (warming, breaker_open, draining) and Retry-After
  GET  /metrics    Prometheus text (serving/metrics.py)
  GET  /debug/traces  recent request spans + the slowest recent requests'
                   trace_ids (obs/trace.py; {"enabled": false, ...} when
                   tracing is off)

Errors map to status codes — invalid 400, overload 429, breaker open or
shutdown 503, deadline 504, step failure 500 — always with a JSON body
holding "error"; every 429 and 503 carries a Retry-After derived from its
cause (``_retry_after_for``: the breaker's cooldown left, the queue's
expected drain time, the drain deadline).  Submits retry transient
injected faults with bounded backoff (``resilience_retry_budget``).

Each connection thread blocks on its request's Future while one batcher
thread a plane runs the engine.  With tracing on, every POST is a
``server.request`` span that continues an incoming ``traceparent``
header's trace (or starts one); its trace_id is echoed in the
``X-Trace-Id`` header and the response body, and the batchers' spans
parent to it.

CLI (``python -m paddle_tpu_torch.serving``): serves the Transformer-base
decoder-only LM (vocab 32000, d_model 512, 8 heads, dff 2048, 6 layers,
learned positions, tied embedding) with random weights drawn from
``--seed``, on the card unless ``--device cpu`` (a replica asked for the
card on a machine without one raises: it never serves on the CPU);
``--demo-generate`` serves JAX's tiny demo LM instead (vocab 256,
d_model 32, 2 heads, dff 64, 2 layers; weights from ``--seed``), the
fleet's default replica.  8 slots, max_len 256, chunk K = 8 by default
(``--slots`` / ``--max-len`` / ``--max-tokens``, also under JAX's names
``--gen-slots`` / ``--gen-max-len`` / ``--gen-max-tokens``;
``--prefill-chunk 0``: the legacy prefill ladder over
``--gen-prefill-buckets``; ``--prefill-chunk-budget N`` caps the
prompt lanes a step feeds across all slots), over the slab KV layout
or, with ``--kv-layout paged``, the paged block pool
(``--kv-block-size``, ``--kv-num-blocks``, ``--kv-prefix-cache``,
``--kv-host-bytes`` for the host spill tier),
with a float32 or (``--kv-dtype int8``) an int8 KV cache;
``--quant-weights 1`` serves the trunk's per-channel int8 weights
(``quant/weights.quantize_lm``), and ``--speculate-k K`` decodes
speculatively with a draft of the target's first ``--draft-layers``
blocks.  The generation plane is supervised (``--step-deadline-ms``
arms the watchdog, ``--breaker-threshold`` / ``--breaker-cooldown-s``
tune the breaker).  ``--role prefill|decode|mixed`` names the replica's
role in a disaggregated fleet (advertised on /metrics as
``serving_role{role=...}``; the router sends new prompts to the prefill
pool and hands each stream to a decode replica at its first token), and
``--port-file PATH`` publishes the bound port atomically once listening
(with ``--port 0``: the fleet supervisor's replicas).  ``--demo`` also
serves JAX's built-in MLP (16 -> 32
tanh -> 4 softmax) on /v1/infer (``--buckets``, ``--max-batch-size``,
``--max-delay-ms``), sharing one /metrics.  ``--deadline-ms`` sets the
default per-request deadline; ``--fault-spec`` installs a fault plan
(``resilience/faults.py``) and ``--obs-trace 1`` turns tracing on.  The
options' defaults come from ``utils/flags.FLAGS`` where JAX's CLI takes
them from there.  SIGTERM/SIGINT drain gracefully under the
``--drain-timeout-s`` hard deadline; a second signal exits at once.
"""

import argparse
import json
import os
import queue as _queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from paddle_tpu_torch.obs import trace as obstrace
from paddle_tpu_torch.resilience.supervisor import (BreakerOpenError,
                                                    Supervisor,
                                                    retry_transient)
from paddle_tpu_torch.serving import transfer as kv_transfer
from paddle_tpu_torch.serving.engine import ShapeDtype, tree_map
from paddle_tpu_torch.serving.errors import (DeadlineExceededError,
                                             InvalidRequestError,
                                             OverloadedError, ShutdownError)
from paddle_tpu_torch.utils.logging import log_context, logger

_STATUS = ((InvalidRequestError, 400), (OverloadedError, 429),
           (BreakerOpenError, 503), (ShutdownError, 503),
           (DeadlineExceededError, 504))


def _retry_after_for(e, metrics, drain_timeout_s=None):
    """Retry-After seconds for a shedding response (429/503), from its
    cause: the breaker -> its remaining cooldown; overload -> the queue's
    expected drain time (depth x recent p50 batch time, or the request
    latency's p50 on the generation plane, whose batch histogram is
    empty), within [1, 30]; drain -> the effective drain deadline."""
    if isinstance(e, BreakerOpenError):
        return max(1, int(round(e.retry_after_s + 0.5)))
    if isinstance(e, OverloadedError):
        p50 = depth = 0
        if metrics is not None:
            p50 = metrics.batch_time.percentiles((50,)).get(50, 0.0) \
                or metrics.latency.percentiles((50,)).get(50, 0.0)
            depth = metrics.queue_depth()
        return max(1, min(30, int(round(depth * p50 + 0.5))))
    if isinstance(e, ShutdownError):
        if drain_timeout_s is None:
            from paddle_tpu_torch.utils.flags import FLAGS
            drain_timeout_s = FLAGS.serving_drain_timeout_s
        return max(1, int(drain_timeout_s))
    return None


def _json_to_row(engine, obj):
    """JSON feed dict -> one per-row numpy feed matching the engine spec
    (dtype cast here; shapes are the engine's to check)."""
    if not isinstance(obj, dict):
        raise InvalidRequestError("'feed' must be an object of "
                                  "{slot: array}")
    spec_row = engine.bucket_spec(1)
    if not isinstance(spec_row, dict):
        raise InvalidRequestError(
            "this model's feed is not a flat dict; the JSON front-end "
            "serves plain-array slots only")
    row = {}
    for name, sds in spec_row.items():
        if not isinstance(sds, ShapeDtype):
            raise InvalidRequestError(
                f"feed slot {name!r} is structured (SequenceBatch); the "
                "JSON front-end serves plain-array slots only")
        if name not in obj:
            raise InvalidRequestError(f"missing feed slot {name!r}")
        try:
            row[name] = np.asarray(obj[name], dtype=sds.dtype)
        except (TypeError, ValueError) as e:
            raise InvalidRequestError(
                f"feed slot {name!r}: cannot convert to {sds.dtype}: {e}") \
                from e
    extra = sorted(set(obj) - set(spec_row))
    if extra:
        raise InvalidRequestError(f"unknown feed slot(s) {extra}")
    return row


def _id_list(req, key):
    ids = req[key]
    if not isinstance(ids, list) or not ids \
            or not all(isinstance(t, int) for t in ids):
        raise InvalidRequestError(
            f"'{key}' must be a non-empty list of int token ids")
    try:
        return np.asarray(ids, np.int64)
    except OverflowError as e:
        raise InvalidRequestError(f"{key} ids out of range: {e}") from e


class ServingHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # the request's root span, set by do_POST; GETs and disabled tracing
    # leave the NULL singleton (empty trace_id)
    _obs = obstrace.NULL

    def log_message(self, fmt, *args):   # route access logs to our logger
        logger.debug("http: " + fmt, *args)

    def _reply(self, code, payload, content_type="application/json",
               headers=None):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if self._obs.trace_id:
            self.send_header("X-Trace-Id", self._obs.trace_id)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _error_reply(self, e, metrics=None):
        for etype, code in _STATUS:
            if isinstance(e, etype):
                break
        else:
            code = 500
        headers = {}
        if code in (429, 503):
            ra = _retry_after_for(e, metrics,
                                  drain_timeout_s=self.server.drain_timeout_s)
            if ra is not None:
                headers["Retry-After"] = ra
        self._reply(code, {"error": f"{type(e).__name__}: {e}"},
                    headers=headers)

    # ------------------------------------------------------------ GET

    def do_GET(self):
        # keep-alive: one handler serves several requests; drop a
        # previous POST's span
        self._obs = obstrace.NULL
        batchers = [b for b in (self.server.batcher,
                                self.server.gen_batcher) if b is not None]
        batcher = batchers[0]
        if self.path == "/healthz":
            engine = batcher.engine
            self._reply(200, {
                "status": "ok",
                "draining": any(b.closed for b in batchers),
                "model": engine.name,
                "buckets": list(getattr(engine, "buckets", None)
                                or getattr(engine, "prefill_buckets", ())),
                "queue_depth": batcher.metrics.queue_depth()})
        elif self.path == "/readyz":
            reasons, retry_after = [], 1.0
            for b in batchers:
                if b.closed:
                    reasons.append("draining")
                    # the process goes away within the drain window
                    retry_after = max(retry_after,
                                      self.server.drain_timeout_s or 1.0)
                elif not b.engine.ready:
                    reasons.append("warming")
                elif not b.ready:
                    # warm and accepting: the breaker is open (a
                    # supervised generation plane), or a close() raced
                    # these checks
                    sup = getattr(b, "supervisor", None)
                    if sup is not None and sup.breaker.state != "closed":
                        reasons.append("breaker_open")
                        retry_after = max(retry_after,
                                          sup.breaker.seconds_until_probe())
                    else:
                        reasons.append("draining")
            reasons = sorted(set(reasons))
            if reasons:
                self._reply(503, {"status": "unready", "reasons": reasons},
                            headers={"Retry-After":
                                     max(1, int(round(retry_after)))})
            else:
                self._reply(200, {"status": "ready"})
        elif self.path == "/metrics":
            self._reply(200, batcher.metrics.render_prometheus().encode(),
                        content_type="text/plain; version=0.0.4")
        elif self.path == "/debug/traces":
            self._reply(200, obstrace.debug_payload())
        else:
            self._reply(404, {"error": f"no route {self.path!r}"})

    # ------------------------------------------------------------ POST

    def _read_json(self):
        length = int(self.headers.get("Content-Length") or 0)
        try:
            req = json.loads(self.rfile.read(length) or b"")
        except ValueError as e:
            raise InvalidRequestError(f"malformed JSON: {e}") from e
        if not isinstance(req, dict):
            raise InvalidRequestError("body must be a JSON object")
        return req

    @staticmethod
    def _deadline_ms(req):
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None and (
                not isinstance(deadline_ms, (int, float))
                or deadline_ms <= 0):
            raise InvalidRequestError("deadline_ms must be a positive "
                                      "number")
        return deadline_ms

    def _submit_retrying(self, batcher, fn):
        """Submit under the bounded transient-failure retry (budget
        ``resilience_retry_budget``, retries counted into /metrics); safe
        because submit's fault point fires before any queue mutation."""
        from paddle_tpu_torch.utils.flags import FLAGS
        return retry_transient(
            fn, budget=FLAGS.resilience_retry_budget,
            on_retry=lambda _a, _e: batcher.metrics.observe_retry())

    def do_POST(self):
        # the request's root span: a propagated traceparent continues
        # that trace, a direct client starts one; the trace_id is also
        # the log correlation id
        ctx = obstrace.extract(self.headers.get("traceparent"))
        with obstrace.span("server.request", ctx=ctx, root=True,
                           route=self.path) as sp, \
                log_context(trace_id=sp.trace_id, request_id=sp.span_id):
            self._obs = sp
            if self.path == "/v1/generate":
                self._post_generate()
            elif self.path == kv_transfer.EXPORT_PATH:
                self._post_kv_export()
            elif self.path == "/v1/infer":
                self._post_infer()
            else:
                self._reply(404, {"error": f"no route {self.path!r}"})

    def _post_infer(self):
        t0 = time.perf_counter()
        batcher = self.server.batcher
        if batcher is None:
            self._reply(404, {"error": "no inference model is being "
                                       "served (generation-only server)"})
            return
        try:
            req = self._read_json()
            if "feed" not in req:
                raise InvalidRequestError('body must be {"feed": {...}}')
            deadline_ms = self._deadline_ms(req)
            row = _json_to_row(batcher.engine, req["feed"])
            fut = self._submit_retrying(
                batcher, lambda: batcher.submit(row,
                                                deadline_ms=deadline_ms))
            out = fut.result(timeout=600)
            resp = {"outputs": tree_map(lambda a: np.asarray(a).tolist(),
                                        out),
                    "latency_ms": round((time.perf_counter() - t0) * 1e3,
                                        3)}
            if self._obs.trace_id:
                resp["trace_id"] = self._obs.trace_id
            self._reply(200, resp)
        except Exception as e:    # noqa: BLE001 — every error is a response
            self._error_reply(e, metrics=batcher.metrics)

    def _post_kv_export(self):
        """The handoff's SOURCE side: a peer asks for our longest resident
        KV coverage of a token prefix.  The worker serializes it between
        steps (``GenerationBatcher.export_chain``); this handler ships the
        blob behind its 8-byte length prefix."""
        from paddle_tpu_torch.utils.flags import FLAGS
        gen = self.server.gen_batcher
        if gen is None:
            self._reply(404, {"error": "no generation plane on this "
                                       "replica: nothing to export"})
            return
        try:
            tokens = self._read_json().get("tokens")
            if not isinstance(tokens, list) or not tokens \
                    or not all(isinstance(t, int) for t in tokens):
                raise InvalidRequestError(
                    "'tokens' must be a non-empty list of int token ids")
        except Exception as e:   # noqa: BLE001 — every error is a response
            self._error_reply(e, metrics=gen.metrics)
            return
        _key, covered, blob = gen.export_chain(
            tokens, timeout=FLAGS.serving_handoff_timeout_s)
        if blob is None:
            # no resident coverage (or a wedged worker): the peer falls
            # back to recompute; an outcome, not a failure
            self._reply(404, {"error": "no resident KV coverage for the "
                                       "requested tokens"})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(8 + len(blob)))
        self.send_header("X-KV-Covered", str(int(covered)))
        if self._obs.trace_id:
            self.send_header("X-Trace-Id", self._obs.trace_id)
        self.end_headers()
        kv_transfer.write_blob(self.wfile, blob)
        gen.metrics.observe_kv_handoff("sent", len(blob))

    def _receive_handoff(self, gen, hint):
        """The handoff's RECEIVE side: ``hint`` = ``{"source": url,
        "tokens": [ids]}`` names the replica holding this stream's KV.
        Fetch, check and park the chain in the host tier before
        admission, so the request's seat probe restores it.  Any failure
        (a dead peer, a foreign or oversized blob, the model preferring
        recompute, a malformed hint) is the recompute fallback."""
        from paddle_tpu_torch.utils.flags import FLAGS
        if not FLAGS.serving_handoff:
            gen.metrics.observe_kv_handoff("fallback")
            return {"outcome": "fallback", "bytes": 0, "covered": 0,
                    "ms": 0.0, "reason": "disabled"}
        source = hint.get("source") if isinstance(hint, dict) else None
        tokens = hint.get("tokens") if isinstance(hint, dict) else None
        if not isinstance(source, str) \
                or not isinstance(tokens, list) or not tokens \
                or not all(isinstance(t, int) for t in tokens):
            gen.metrics.observe_kv_handoff("fallback")
            return {"outcome": "fallback", "bytes": 0, "covered": 0,
                    "ms": 0.0, "reason": "malformed_hint"}
        return kv_transfer.receive_chain(
            gen.engine, source, tokens, metrics=gen.metrics,
            max_bytes=FLAGS.serving_handoff_max_bytes,
            timeout=FLAGS.serving_handoff_timeout_s)

    def _post_generate(self):
        t0 = time.perf_counter()
        gen = self.server.gen_batcher
        if gen is None:
            self._reply(404, {"error": "no generation model is being "
                                       "served (inference-only server)"})
            return
        try:
            req = self._read_json()
            if "prompt" not in req:
                raise InvalidRequestError('body must be {"prompt": [ids]}')
            prompt = _id_list(req, "prompt")
            replay = (_id_list(req, "replay")
                      if req.get("replay") is not None else None)
            handoff = None
            if req.get("kv_handoff") is not None:
                handoff = self._receive_handoff(gen, req["kv_handoff"])
            kw = dict(max_tokens=req.get("max_tokens"),
                      eos_id=req.get("eos_id"),
                      deadline_ms=self._deadline_ms(req), replay=replay)
            if req.get("stream"):
                self._generate_stream(gen, prompt, kw, t0, handoff)
                return
            out = dict(self._submit_retrying(
                gen, lambda: gen.submit(prompt, **kw)).result(timeout=600))
            if handoff is not None:
                out["kv_handoff"] = handoff
            out["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            if self._obs.trace_id:
                out["trace_id"] = self._obs.trace_id
            self._obs.set(ttft_ms=out.get("ttft_ms"))
            self._reply(200, out)
        except Exception as e:    # noqa: BLE001 — every error is a response
            self._error_reply(e, metrics=gen.metrics)

    def _generate_stream(self, gen, prompt, kw, t0, handoff=None):
        """Chunked-transfer NDJSON stream.  Admission errors raise before
        any bytes go out, so they keep their status codes; a failure
        mid-stream ends the stream with an {"error": ...} record."""
        events = _queue.Queue()
        fut = self._submit_retrying(
            gen, lambda: gen.submit(
                prompt, on_token=lambda t: events.put(("token", t)), **kw))
        # the callback fires in the worker strictly before the future
        # resolves, so the queue orders tokens before done
        fut.add_done_callback(lambda f: events.put(("done", f)))
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        if self._obs.trace_id:
            self.send_header("X-Trace-Id", self._obs.trace_id)
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        try:
            streamed = 0
            while True:
                kind, val = events.get(timeout=600)
                if kind == "token":
                    if streamed == 0:
                        self._obs.event("first_token")
                    streamed += 1
                    chunk({"token": int(val)})
                    continue
                exc = val.exception()
                if exc is not None:
                    chunk({"error": f"{type(exc).__name__}: {exc}"})
                else:
                    out = dict(val.result())
                    out["done"] = True
                    if handoff is not None:
                        out["kv_handoff"] = handoff
                    out["latency_ms"] = round(
                        (time.perf_counter() - t0) * 1e3, 3)
                    if self._obs.trace_id:
                        out["trace_id"] = self._obs.trace_id
                    self._obs.set(ttft_ms=out.get("ttft_ms"))
                    chunk(out)
                break
            self.wfile.write(b"0\r\n\r\n")
        except (OSError, _queue.Empty) as e:
            # the reader is gone (or the engine wedged): reclaim the slot
            # and drop the connection
            logger.warning("generate stream aborted: %s: %s",
                           type(e).__name__, e)
            gen.abandon(fut)
            self.close_connection = True


def make_server(batcher=None, host="127.0.0.1", port=0, gen_batcher=None):
    """Bind (port 0 = ephemeral) and return the server; the caller runs
    ``serve_forever()``.  ``server.port`` carries the bound port.

    batcher: the /v1/infer ``Batcher`` (None for a generation-only
    server); gen_batcher: the /v1/generate ``GenerationBatcher`` (None
    for an inference-only server).  At least one must be given."""
    if batcher is None and gen_batcher is None:
        raise ValueError("make_server needs a batcher, a gen_batcher, or "
                         "both")
    httpd = ThreadingHTTPServer((host, port), ServingHandler)
    httpd.daemon_threads = True
    httpd.batcher = batcher
    httpd.gen_batcher = gen_batcher
    httpd.port = httpd.server_address[1]
    # the effective drain deadline (the ShutdownError Retry-After);
    # _serve() sets the CLI's --drain-timeout-s
    httpd.drain_timeout_s = None
    return httpd


# ------------------------------------------------------------------- CLI

# Transformer-base decoder-only LM: paddle_tpu transformer.init defaults
# with dec_layers=0 (the trunk bench.py's transformer_lm_decode runs)
BASE_LM = dict(vocab=32000, d_model=512, num_heads=8, dff=2048, layers=6)
# JAX's --demo-generate trunk (server.py _demo_gen_batcher): the fleet's
# default replica
DEMO_LM = dict(vocab=256, d_model=32, num_heads=2, dff=64, layers=2)


def build_gen_batcher(seed=0, slots=8, max_len=256, prefill_chunk=8,
                      prefill_chunk_budget=0, max_tokens=64,
                      queue_size=256, device=None,
                      metrics=None, kv_layout="slab", kv_block_size=16,
                      kv_num_blocks=0, kv_prefix_cache=True,
                      kv_dtype="float32", quant_weights=False,
                      speculate_k=0, draft_layers=1, kv_host_bytes=0,
                      step_deadline_ms=None, breaker_threshold=None,
                      breaker_cooldown_s=None, deadline_ms=None,
                      prefill_buckets=None, name="base_lm", **model):
    """The full-width trunk from ``seed`` behind a ``DecodeEngine`` +
    ``GenerationBatcher`` (``model`` overrides ``BASE_LM`` keys;
    ``prefill_chunk=0`` selects the legacy prefill ladder;
    ``prefill_chunk_budget`` caps the teacher-forced lanes a step feeds
    across all slots (0 = unbounded); ``kv_dtype=
    "int8"`` the quantized KV cache; ``quant_weights`` the int8 trunk;
    ``speculate_k`` > 0 speculative decoding with a ``draft_layers``-deep
    draft of the (quantized) target; ``kv_host_bytes`` the paged host
    tier; ``prefill_buckets`` the legacy ladder's prompt buckets, the
    engine's default when None).  Supervised, as JAX's demo generation
    plane: the breaker and
    recovery cost nothing absent failures, and the watchdog arms only
    with ``step_deadline_ms``; the breaker's defaults come from
    ``FLAGS``."""
    from paddle_tpu_torch import device as _device
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.quant.weights import quantize_lm
    from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                        GenerationBatcher)
    from paddle_tpu_torch.serving.speculative import make_draft
    from paddle_tpu_torch.utils.flags import FLAGS
    dev = _device.resolve(device)
    cfg = dict(BASE_LM, **model)
    params = transformer.init_lm(torch.Generator().manual_seed(seed),
                                 cfg["vocab"], cfg["d_model"],
                                 cfg["num_heads"], cfg["dff"], cfg["layers"],
                                 max_len, device=dev)
    if quant_weights:
        params = quantize_lm(params)
    # the draft shares the target's (quantized) embedding and vocab
    draft = make_draft(params, layers=draft_layers) if speculate_k else None
    ladder = {} if prefill_buckets is None else dict(
        prefill_buckets=tuple(prefill_buckets))
    engine = DecodeEngine(params, num_heads=cfg["num_heads"],
                          num_slots=slots, max_len=max_len,
                          prefill_chunk=prefill_chunk,
                          prefill_chunk_budget=prefill_chunk_budget,
                          metrics=metrics,
                          kv_layout=kv_layout, kv_block_size=kv_block_size,
                          kv_num_blocks=kv_num_blocks,
                          prefix_cache=kv_prefix_cache, kv_dtype=kv_dtype,
                          speculate_k=speculate_k, draft=draft,
                          kv_host_bytes=kv_host_bytes, name=name,
                          device=dev, **ladder)
    sup = Supervisor(
        step_deadline_s=step_deadline_ms / 1e3 if step_deadline_ms else None,
        breaker_threshold=(breaker_threshold if breaker_threshold is not None
                           else FLAGS.resilience_breaker_threshold),
        breaker_cooldown_s=(breaker_cooldown_s if breaker_cooldown_s
                            is not None
                            else FLAGS.resilience_breaker_cooldown_s))
    return GenerationBatcher(engine, queue_size=queue_size,
                             default_deadline_ms=deadline_ms,
                             default_max_tokens=max_tokens, supervisor=sup)


def demo_batcher(buckets=(1, 4, 16, 64), max_batch_size=None,
                 max_delay_ms=5.0, queue_size=256, deadline_ms=None,
                 device=None, metrics=None, warm=True):
    """JAX's built-in demo MLP (``serving_demo_x`` 16 -> fc 32 tanh ->
    fc 4 softmax, parameters from seed 0) behind an ``InferenceEngine``
    + ``Batcher``: the /v1/infer plane without a trained model."""
    from paddle_tpu_torch import device as _device
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.layers.graph import Topology
    from paddle_tpu_torch.serving.batcher import Batcher
    from paddle_tpu_torch.serving.engine import InferenceEngine
    dev = _device.resolve(device)
    L.reset_names()
    x = L.data_layer("serving_demo_x", size=16)
    h = L.fc_layer(input=x, size=32, act="tanh")
    out = L.fc_layer(input=h, size=4, act="softmax")
    params = Topology([out]).init(torch.Generator().manual_seed(0),
                                  device=dev)
    spec = {"serving_demo_x": ShapeDtype((1, 16), np.dtype(np.float32))}
    engine = InferenceEngine.from_topology(
        out, params, spec, buckets=buckets, warm=warm, name="demo",
        metrics=metrics, device=dev)
    return Batcher(engine, max_batch_size=max_batch_size,
                   max_delay_ms=max_delay_ms, queue_size=queue_size,
                   default_deadline_ms=deadline_ms)


def _flag_bool(v):
    return v.lower() in ("1", "true", "yes")


def parse_args(argv=None):
    """The CLI's flags (the JAX CLI's names), their defaults from
    ``utils/flags.FLAGS`` where JAX's take them from there."""
    from paddle_tpu_torch.utils.flags import FLAGS
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving",
        description="Serve the Transformer-base decoder-only LM (random "
                    "weights from --seed) over /v1/generate")
    ap.add_argument("--demo-generate", action="store_true",
                    help="serve JAX's tiny demo LM (vocab 256, d_model 32, "
                         "2 heads, dff 64, 2 layers) instead of the "
                         "Transformer-base LM: the fleet's default replica")
    ap.add_argument("--role", default=FLAGS.serving_role,
                    choices=("prefill", "decode", "mixed"),
                    help="disaggregated-serving role, advertised on "
                         "/metrics as serving_role{role=...}: the router "
                         "sends new prompts to the prefill pool and hands "
                         "each stream to a decode replica at its first "
                         "token; mixed (the default) serves both phases")
    ap.add_argument("--port-file",
                    help="write the bound port here once listening "
                         "(atomic; with --port 0 for fleet-managed "
                         "replicas)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=FLAGS.serving_port)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--demo", action="store_true",
                    help="also serve the built-in tiny MLP on /v1/infer")
    ap.add_argument("--buckets", default=FLAGS.serving_buckets,
                    help="batch bucket ladder of the --demo engine")
    ap.add_argument("--max-batch-size", type=int,
                    default=FLAGS.serving_max_batch_size or None)
    ap.add_argument("--max-delay-ms", type=float,
                    default=FLAGS.serving_max_delay_ms)
    ap.add_argument("--slots", "--gen-slots", dest="slots", type=int,
                    default=FLAGS.serving_gen_slots)
    ap.add_argument("--max-len", "--gen-max-len", dest="max_len", type=int,
                    default=FLAGS.serving_gen_max_len)
    ap.add_argument("--gen-prefill-buckets", dest="prefill_buckets",
                    default=FLAGS.serving_gen_prefill_buckets,
                    help="prompt-length buckets of the legacy prefill "
                         "ladder (--prefill-chunk 0)")
    ap.add_argument("--prefill-chunk", type=int,
                    default=FLAGS.serving_prefill_chunk,
                    help="prompt lanes per slot per step (0 = the legacy "
                         "prefill ladder)")
    ap.add_argument("--prefill-chunk-budget", type=int,
                    default=FLAGS.serving_prefill_chunk_budget,
                    help="max teacher-forced chunk lanes per step across "
                         "all slots (bounds TPOT jitter; 0 = unbounded)")
    ap.add_argument("--kv-layout", default=FLAGS.serving_kv_layout,
                    choices=("slab", "paged"),
                    help="decode KV-cache layout: slab reserves max_len "
                         "per slot; paged packs a shared block pool with "
                         "prefix sharing")
    ap.add_argument("--kv-block-size", type=int,
                    default=FLAGS.serving_kv_block_size)
    ap.add_argument("--kv-num-blocks", type=int,
                    default=FLAGS.serving_kv_num_blocks,
                    help="paged pool size incl. the scratch block "
                         "(0 = the slab-equivalent byte budget)")
    ap.add_argument("--kv-prefix-cache", type=_flag_bool,
                    default=FLAGS.serving_kv_prefix_cache)
    ap.add_argument("--kv-host-bytes", type=int,
                    default=FLAGS.serving_kv_host_bytes,
                    help="host-RAM spill-tier byte cap: evicted prefix "
                         "chains spill to host and restore on the next "
                         "hit when the analytic model predicts restore "
                         "beats recompute (0 = tier off; paged + "
                         "prefix-cache only)")
    ap.add_argument("--kv-dtype", default=FLAGS.serving_kv_dtype,
                    choices=("float32", "int8"),
                    help="KV-cache storage: int8 codes + per-(position, "
                         "head) f32 scales, or float32")
    ap.add_argument("--quant-weights", type=int,
                    default=int(FLAGS.quant_weights),
                    help="1 = serve per-channel int8 trunk weights "
                         "(quant/weights.py)")
    ap.add_argument("--speculate-k", type=int,
                    default=FLAGS.serving_speculate_k,
                    help="draft tokens per slot per step (0 = no "
                         "speculative decoding; needs --prefill-chunk > 0)")
    ap.add_argument("--draft-layers", type=int,
                    default=FLAGS.serving_draft_layers,
                    help="trunk depth of the draft derived from the "
                         "target (--speculate-k)")
    ap.add_argument("--max-tokens", "--gen-max-tokens", dest="max_tokens",
                    type=int,
                    default=FLAGS.serving_gen_max_tokens,
                    help="default per-request emission cap")
    ap.add_argument("--queue-size", type=int,
                    default=FLAGS.serving_queue_size)
    ap.add_argument("--deadline-ms", type=float,
                    default=FLAGS.serving_deadline_ms or None,
                    help="default per-request deadline (unset = none)")
    ap.add_argument("--drain-timeout-s", type=float,
                    default=FLAGS.serving_drain_timeout_s,
                    help="hard deadline for the SIGTERM graceful drain")
    ap.add_argument("--step-deadline-ms", type=float,
                    default=FLAGS.resilience_step_deadline_ms or None,
                    help="decode-step watchdog deadline (unset = off)")
    ap.add_argument("--breaker-threshold", type=int,
                    default=FLAGS.resilience_breaker_threshold)
    ap.add_argument("--breaker-cooldown-s", type=float,
                    default=FLAGS.resilience_breaker_cooldown_s)
    ap.add_argument("--fault-spec", default=FLAGS.resilience_fault_spec,
                    help="deterministic fault-injection spec "
                         "(resilience/faults.py; chaos testing only)")
    ap.add_argument("--obs-trace", type=_flag_bool,
                    default=FLAGS.obs_trace_enable,
                    help="per-request span tracing: /debug/traces + "
                         "trace_id propagation and echo")
    ap.add_argument("--obs-trace-sample", type=float,
                    default=FLAGS.obs_trace_sample)
    ap.add_argument("--obs-trace-ring", type=int,
                    default=FLAGS.obs_trace_ring)
    return ap.parse_args(argv)


def batcher_from_args(args, metrics=None, **model):
    """``build_gen_batcher`` as the flags ``args`` ask, supervised
    (``model`` overrides ``BASE_LM`` keys, or ``DEMO_LM``'s under
    ``--demo-generate``); the metrics carry ``--role``."""
    if args.demo_generate:
        model = dict(DEMO_LM, name="demo_lm", **model)
    gen = build_gen_batcher(seed=args.seed, slots=args.slots,
                             max_len=args.max_len,
                             prefill_chunk=args.prefill_chunk,
                             prefill_chunk_budget=args.prefill_chunk_budget,
                             max_tokens=args.max_tokens,
                             queue_size=args.queue_size, device=args.device,
                             metrics=metrics, kv_layout=args.kv_layout,
                             kv_block_size=args.kv_block_size,
                             kv_num_blocks=args.kv_num_blocks,
                             kv_prefix_cache=args.kv_prefix_cache,
                             kv_dtype=args.kv_dtype,
                             quant_weights=bool(args.quant_weights),
                             speculate_k=args.speculate_k,
                             draft_layers=args.draft_layers,
                             kv_host_bytes=args.kv_host_bytes,
                             step_deadline_ms=args.step_deadline_ms,
                             breaker_threshold=args.breaker_threshold,
                             breaker_cooldown_s=args.breaker_cooldown_s,
                             deadline_ms=args.deadline_ms,
                             prefill_buckets=tuple(
                                 int(b) for b in
                                 args.prefill_buckets.split(",")), **model)
    gen.metrics.set_serving_role(args.role)
    return gen


def _write_port_file(path, port):
    """Publish the bound port (meaningful with ``--port 0``) atomically:
    the fleet supervisor discovers its replicas here, and a partial read
    must be impossible."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{port}\n")
    os.replace(tmp, path)


def _make_drain_handler(httpd, state, drain_timeout_s, force_exit):
    """The SIGTERM/SIGINT handler: the first signal starts a graceful
    drain (``httpd.shutdown`` off the signal frame) and arms a watchdog
    that force-exits (code 3) if the drain has not finished within
    ``drain_timeout_s``; a second signal force-exits at once (code
    130)."""
    def _drain(signum, frame):
        state["signals"] = state.get("signals", 0) + 1
        if state["signals"] > 1:
            logger.warning("second SIGTERM: forcing immediate exit")
            force_exit(130)
            return
        logger.info("SIGTERM: draining (no new admissions; hard deadline "
                    "%.0fs, a second signal forces exit)",
                    drain_timeout_s or 0.0)
        threading.Thread(target=httpd.shutdown, daemon=True).start()
        if drain_timeout_s and drain_timeout_s > 0:
            def watchdog():
                time.sleep(drain_timeout_s)
                if not state.get("drained"):
                    logger.warning("drain did not complete within %.0fs; "
                                   "forcing exit", drain_timeout_s)
                    force_exit(3)
            threading.Thread(target=watchdog, daemon=True,
                             name="drain-deadline").start()
    return _drain


def _serve(httpd, drain_timeout_s):
    """``serve_forever`` with the drain handler installed; on shutdown
    the batchers drain (resolving every in-flight future) before the
    handler threads are joined, so their responses reach the sockets."""
    httpd.drain_timeout_s = drain_timeout_s
    state = {}
    handler = _make_drain_handler(httpd, state, drain_timeout_s, os._exit)
    try:
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
    except ValueError:
        pass        # not the main thread (embedded use)
    try:
        httpd.serve_forever()
    finally:
        for b in (httpd.batcher, httpd.gen_batcher):
            if b is not None:
                b.close(drain=True)
        state["drained"] = True     # disarms the drain watchdog
        httpd.server_close()
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.fault_spec:
        from paddle_tpu_torch.resilience import faults
        faults.install_spec(args.fault_spec)
        logger.warning("fault injection ACTIVE: %s", args.fault_spec)
    if args.obs_trace:
        obstrace.enable(sample=args.obs_trace_sample,
                        capacity=args.obs_trace_ring)
    gen = batcher_from_args(args)
    batcher = None
    if args.demo:
        # one /metrics for both planes: the demo shares the generation
        # plane's metrics object
        batcher = demo_batcher(
            tuple(int(b) for b in args.buckets.split(",")),
            max_batch_size=args.max_batch_size,
            max_delay_ms=args.max_delay_ms, queue_size=args.queue_size,
            deadline_ms=args.deadline_ms, device=args.device,
            metrics=gen.metrics)
    httpd = make_server(batcher, host=args.host, port=args.port,
                        gen_batcher=gen)
    obstrace.set_process(f"replica:{httpd.port}")
    if args.port_file:
        _write_port_file(args.port_file, httpd.port)
    logger.info("serving %s as %s on http://%s:%d (/v1/generate%s)",
                gen.engine.name, args.role, args.host, httpd.port,
                ", /v1/infer" if batcher else "")
    return _serve(httpd, args.drain_timeout_s)
