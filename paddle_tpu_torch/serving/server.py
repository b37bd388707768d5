"""Stdlib HTTP front-end + CLI for the generation server
(``paddle_tpu/serving/server.py``'s generation plane).

Endpoints:
  POST /v1/generate {"prompt": [ids], "max_tokens": N, "eos_id": opt,
                    "deadline_ms": opt, "stream": false}
                   -> {"tokens": [...], "finish_reason": "eos"|"length",
                       "ttft_ms": ..., "latency_ms": ...}
                   "stream": true streams newline-delimited JSON chunks
                   ({"token": id} per emitted token, then a {"done":
                   true, ...} record) over chunked transfer encoding.
                   Errors: invalid request 400, overload 429, shutdown
                   503, deadline 504, step failure 500 — always a JSON
                   body with "error"; 429/503 carry Retry-After.
  GET  /healthz    LIVENESS: 200 while the process can answer
  GET  /metrics    Prometheus text (serving/metrics.py)

Each connection thread blocks on its request's Future while the one
batcher thread runs the decode steps.

CLI (``python -m paddle_tpu_torch.serving``): serves the Transformer-base
decoder-only LM (vocab 32000, d_model 512, 8 heads, dff 2048, 6 layers,
learned positions, tied embedding) with random weights drawn from
``--seed``, on the card unless ``--device cpu``; 8 slots, max_len 256,
chunk K = 8 by default (``--prefill-chunk 0``: the legacy prefill
ladder), over the slab KV layout or, with ``--kv-layout paged``, the
paged block pool (``--kv-block-size``, ``--kv-num-blocks``,
``--kv-prefix-cache``), with a float32 or (``--kv-dtype int8``) an int8
KV cache; ``--quant-weights 1`` serves the trunk's per-channel int8
weights (``quant/weights.quantize_lm``), and ``--speculate-k K`` decodes
speculatively with a draft of the target's first ``--draft-layers``
blocks (derived from the quantized target when both are given).
SIGTERM/SIGINT drain gracefully.
"""

import argparse
import json
import queue as _queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from paddle_tpu_torch.serving.errors import (DeadlineExceededError,
                                             InvalidRequestError,
                                             OverloadedError, ShutdownError)
from paddle_tpu_torch.utils.logging import logger

_STATUS = ((InvalidRequestError, 400), (OverloadedError, 429),
           (ShutdownError, 503), (DeadlineExceededError, 504))


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

    def log_message(self, fmt, *args):   # route access logs to our logger
        logger.debug("http: " + fmt, *args)

    def _reply(self, code, payload, content_type="application/json",
               headers=None):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _error_reply(self, e):
        for etype, code in _STATUS:
            if isinstance(e, etype):
                break
        else:
            code = 500
        headers = {"Retry-After": 1} if code in (429, 503) else None
        self._reply(code, {"error": f"{type(e).__name__}: {e}"},
                    headers=headers)

    def do_GET(self):
        gen = self.server.gen_batcher
        if self.path == "/healthz":
            self._reply(200, {"status": "ok", "draining": gen.closed,
                              "model": gen.engine.name,
                              "queue_depth": gen.metrics.queue_depth()})
        elif self.path == "/metrics":
            self._reply(200, gen.metrics.render_prometheus().encode(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._reply(404, {"error": f"no route {self.path!r}"})

    def do_POST(self):
        if self.path != "/v1/generate":
            self._reply(404, {"error": f"no route {self.path!r}"})
            return
        t0 = time.perf_counter()
        gen = self.server.gen_batcher
        try:
            length = int(self.headers.get("Content-Length") or 0)
            try:
                req = json.loads(self.rfile.read(length) or b"")
            except ValueError as e:
                raise InvalidRequestError(f"malformed JSON: {e}") from e
            if not isinstance(req, dict) or "prompt" not in req:
                raise InvalidRequestError('body must be {"prompt": [ids]}')
            prompt = _id_list(req, "prompt")
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None and (
                    not isinstance(deadline_ms, (int, float))
                    or deadline_ms <= 0):
                raise InvalidRequestError("deadline_ms must be a positive "
                                          "number")
            kw = dict(max_tokens=req.get("max_tokens"),
                      eos_id=req.get("eos_id"), deadline_ms=deadline_ms)
            if req.get("stream"):
                self._generate_stream(gen, prompt, kw, t0)
                return
            out = dict(gen.submit(prompt, **kw).result(timeout=600))
            out["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            self._reply(200, out)
        except Exception as e:    # noqa: BLE001 — every error is a response
            self._error_reply(e)

    def _generate_stream(self, gen, prompt, kw, t0):
        """Chunked-transfer NDJSON stream.  Admission errors raise before
        any bytes go out, so they keep their status codes; a failure
        mid-stream ends the stream with an {"error": ...} record."""
        events = _queue.Queue()
        fut = gen.submit(prompt, on_token=lambda t: events.put(("token", t)),
                         **kw)
        # the callback fires in the worker strictly before the future
        # resolves, so the queue orders tokens before done
        fut.add_done_callback(lambda f: events.put(("done", f)))
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        try:
            while True:
                kind, val = events.get(timeout=600)
                if kind == "token":
                    chunk({"token": int(val)})
                    continue
                exc = val.exception()
                if exc is not None:
                    chunk({"error": f"{type(exc).__name__}: {exc}"})
                else:
                    out = dict(val.result())
                    out["done"] = True
                    out["latency_ms"] = round(
                        (time.perf_counter() - t0) * 1e3, 3)
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


def make_server(gen_batcher, host="127.0.0.1", port=0):
    """Bind (port 0 = ephemeral) and return the server serving
    ``gen_batcher`` on /v1/generate; the caller runs ``serve_forever()``.
    ``server.port`` carries the bound port."""
    if gen_batcher is None:
        raise ValueError("make_server needs a GenerationBatcher")
    httpd = ThreadingHTTPServer((host, port), ServingHandler)
    httpd.daemon_threads = True
    httpd.gen_batcher = gen_batcher
    httpd.port = httpd.server_address[1]
    return httpd


# ------------------------------------------------------------------- CLI

# Transformer-base decoder-only LM: paddle_tpu transformer.init defaults
# with dec_layers=0 (the trunk bench.py's transformer_lm_decode runs)
BASE_LM = dict(vocab=32000, d_model=512, num_heads=8, dff=2048, layers=6)


def build_gen_batcher(seed=0, slots=8, max_len=256, prefill_chunk=8,
                      max_tokens=64, queue_size=256, device=None,
                      metrics=None, kv_layout="slab", kv_block_size=16,
                      kv_num_blocks=0, kv_prefix_cache=True,
                      kv_dtype="float32", quant_weights=False,
                      speculate_k=0, draft_layers=1, **model):
    """The full-width trunk from ``seed`` behind a ``DecodeEngine`` +
    ``GenerationBatcher`` (``model`` overrides ``BASE_LM`` keys;
    ``prefill_chunk=0`` selects the legacy prefill ladder; ``kv_dtype=
    "int8"`` the quantized KV cache; ``quant_weights`` the int8 trunk;
    ``speculate_k`` > 0 speculative decoding with a ``draft_layers``-deep
    draft of the (quantized) target)."""
    from paddle_tpu_torch import device as _device
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.quant.weights import quantize_lm
    from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                        GenerationBatcher)
    from paddle_tpu_torch.serving.speculative import make_draft
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
    engine = DecodeEngine(params, num_heads=cfg["num_heads"],
                          num_slots=slots, max_len=max_len,
                          prefill_chunk=prefill_chunk, metrics=metrics,
                          kv_layout=kv_layout, kv_block_size=kv_block_size,
                          kv_num_blocks=kv_num_blocks,
                          prefix_cache=kv_prefix_cache, kv_dtype=kv_dtype,
                          speculate_k=speculate_k, draft=draft,
                          name="base_lm", device=dev)
    return GenerationBatcher(engine, queue_size=queue_size,
                             default_max_tokens=max_tokens)


def parse_args(argv=None):
    """The CLI's flags (the JAX CLI's names and defaults)."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving",
        description="Serve the Transformer-base decoder-only LM (random "
                    "weights from --seed) over /v1/generate")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt lanes per slot per step (0 = the legacy "
                         "prefill ladder)")
    ap.add_argument("--kv-layout", default="slab",
                    choices=("slab", "paged"),
                    help="decode KV-cache layout: slab reserves max_len "
                         "per slot; paged packs a shared block pool with "
                         "prefix sharing")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-num-blocks", type=int, default=0,
                    help="paged pool size incl. the scratch block "
                         "(0 = the slab-equivalent byte budget)")
    ap.add_argument("--kv-prefix-cache",
                    type=lambda v: v.lower() in ("1", "true", "yes"),
                    default=True)
    ap.add_argument("--kv-dtype", default="float32",
                    choices=("float32", "int8"),
                    help="KV-cache storage: int8 codes + per-(position, "
                         "head) f32 scales, or float32")
    ap.add_argument("--quant-weights", type=int, default=0,
                    help="1 = serve per-channel int8 trunk weights "
                         "(quant/weights.py)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="draft tokens per slot per step (0 = no "
                         "speculative decoding; needs --prefill-chunk > 0)")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="trunk depth of the draft derived from the "
                         "target (--speculate-k)")
    ap.add_argument("--max-tokens", type=int, default=64,
                    help="default per-request emission cap")
    ap.add_argument("--queue-size", type=int, default=256)
    return ap.parse_args(argv)


def batcher_from_args(args, **model):
    """``build_gen_batcher`` as the flags ``args`` ask (``model``
    overrides ``BASE_LM`` keys)."""
    return build_gen_batcher(seed=args.seed, slots=args.slots,
                             max_len=args.max_len,
                             prefill_chunk=args.prefill_chunk,
                             max_tokens=args.max_tokens,
                             queue_size=args.queue_size, device=args.device,
                             kv_layout=args.kv_layout,
                             kv_block_size=args.kv_block_size,
                             kv_num_blocks=args.kv_num_blocks,
                             kv_prefix_cache=args.kv_prefix_cache,
                             kv_dtype=args.kv_dtype,
                             quant_weights=bool(args.quant_weights),
                             speculate_k=args.speculate_k,
                             draft_layers=args.draft_layers, **model)


def main(argv=None):
    args = parse_args(argv)
    gen = batcher_from_args(args)
    httpd = make_server(gen, host=args.host, port=args.port)
    logger.info("serving on http://%s:%d (/v1/generate)", args.host,
                httpd.port)

    def _drain(signum, frame):
        # stop admissions and finish in-flight streams, off the signal
        # handler's frame (shutdown() blocks until serve_forever returns)
        def stop():
            gen.close(drain=True)
            httpd.shutdown()
        threading.Thread(target=stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    return 0
