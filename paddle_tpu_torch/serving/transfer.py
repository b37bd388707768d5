"""Cross-replica KV-block handoff (``paddle_tpu/serving/transfer.py``):
the socket leg of disaggregated prefill/decode serving.

A prefix chain's K/V is a relocatable blob (``kv_pool.serialize_chain``:
versioned, trunk-signed, no block ids), so it can ride a socket:

* SOURCE side — a replica exposes its resident chains at ``POST
  /v1/kv/export`` (the route is in ``serving/server.py``; the wire
  helpers here).  The gather reads the committed cache, the batcher
  worker's, so the handler queues the export and the worker serializes it
  between steps (``GenerationBatcher.export_chain``).  The response is
  the blob behind an 8-byte little-endian length prefix, in bounded
  chunks.

* RECEIVER side — ``receive_chain`` fetches the blob, bounds the
  declared length before any buffer grows to it, checks the envelope
  (version byte and trunk signature, ``kv_pool.peek_chain_header``) and
  parks it in the engine's host tier (``DecodeEngine.
  deliver_chain_blob``).  The request's seat probe then finds it like a
  locally spilled chain and restores it.

Every failure — a dead peer, a timeout, an oversized, foreign or garbled
blob, the analytic model preferring recompute — is a FALLBACK, never an
error: the request recomputes its context and the greedy stream is the
same.  ``kv_handoffs_total{outcome=sent|received|fallback}`` on both
sides' ``/metrics`` show which path ran.
"""

import http.client
import json
import time
from urllib.parse import urlsplit

from paddle_tpu_torch.obs import trace as obstrace
from paddle_tpu_torch.serving.kv_pool import (MAX_CHAIN_BLOB_BYTES,
                                        WireFormatError,
                                        peek_chain_header)
from paddle_tpu_torch.utils.logging import logger

# the one export route (server.py serves it; fetch_chain calls it)
EXPORT_PATH = "/v1/kv/export"

# streaming granularity for both directions: bounded chunks, so neither
# side ever materializes more than the (already length-bounded) blob
_CHUNK = 1 << 16


class HandoffError(RuntimeError):
    """The socket leg of a KV handoff failed (peer unreachable or dead,
    truncated stream, oversized declared length, non-200 export).
    Always caught by ``receive_chain`` — a handoff failure is a
    recompute fallback, never a client-visible error."""


# --------------------------------------------------------------- wire

def write_blob(wfile, blob):
    """Stream one blob: 8-byte little-endian length prefix, then the
    payload in bounded chunks (the source side of the length-prefixed
    framing ``read_blob`` consumes)."""
    wfile.write(len(blob).to_bytes(8, "little"))
    view = memoryview(blob)
    for off in range(0, len(view), _CHUNK):
        wfile.write(view[off:off + _CHUNK])


def read_blob(rfile, max_bytes=MAX_CHAIN_BLOB_BYTES):
    """Read one length-prefixed blob from a stream.  The DECLARED
    length is checked against ``max_bytes`` before the receive buffer
    grows toward it, and the actual stream must deliver exactly that
    many bytes — a malicious or garbled peer can neither OOM the
    receiver nor smuggle trailing bytes."""
    prefix = rfile.read(8)
    if len(prefix) != 8:
        raise HandoffError(
            f"handoff stream ended inside the length prefix "
            f"({len(prefix)} byte(s))")
    n = int.from_bytes(prefix, "little")
    if n > int(max_bytes):
        raise HandoffError(
            f"handoff blob declares {n} byte(s), over the "
            f"{int(max_bytes)}-byte receive bound")
    buf = bytearray()
    while len(buf) < n:
        chunk = rfile.read(min(_CHUNK, n - len(buf)))
        if not chunk:
            raise HandoffError(
                f"handoff stream truncated at {len(buf)}/{n} byte(s)")
        buf += chunk
    return bytes(buf)


def fetch_chain(source, tokens, trunk_sig, max_bytes=MAX_CHAIN_BLOB_BYTES,
                timeout=5.0):
    """Fetch the longest exported coverage of ``tokens`` from a peer
    replica's ``/v1/kv/export``.  Returns ``(covered, blob)`` with the
    blob's envelope already verified against ``trunk_sig`` (version
    byte, header, signature, size bound) — the payload itself is
    validated again by ``restore_chain`` when the restore stages.

    Raises ``HandoffError`` on any socket/HTTP failure and
    ``WireFormatError``/``WireVersionError`` on a foreign or garbled
    blob."""
    u = urlsplit(source)
    body = json.dumps({"tokens": [int(t) for t in tokens]},
                      sort_keys=True).encode("utf-8")
    conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                      timeout=timeout)
    try:
        try:
            conn.request("POST", EXPORT_PATH, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                detail = resp.read(256)
                raise HandoffError(
                    f"export from {source} failed: HTTP {resp.status} "
                    f"{detail[:120]!r}")
            blob = read_blob(resp, max_bytes=max_bytes)
        except (OSError, http.client.HTTPException) as e:
            raise HandoffError(f"export from {source} failed: "
                               f"{type(e).__name__}: {e}") from e
    finally:
        conn.close()
    header = peek_chain_header(blob, trunk_sig, max_bytes)
    return int(header["covered"]), blob


# ----------------------------------------------------------- receiver

def receive_chain(engine, source, tokens, metrics=None,
                  max_bytes=MAX_CHAIN_BLOB_BYTES, timeout=5.0):
    """The decode-replica receive path: decide (analytic model), fetch
    (socket), verify (envelope) and deliver (host tier) one handed-off
    chain, so the request that follows seats it by reference through
    the existing restore pipeline.

    NEVER raises — every failure mode IS the fallback (the caller
    submits the request unchanged and continuation-replay recomputes
    the context, bit-identically).  Returns an outcome dict:
    ``{"outcome": "received"|"fallback", "bytes", "covered",
    "ms", "reason"}``; counters/histograms land on ``metrics``
    (``ServingMetrics.observe_kv_handoff``) when given."""
    t0 = time.perf_counter()

    def _fallback(reason):
        if metrics is not None:
            metrics.observe_kv_handoff("fallback")
        obstrace.instant("kv.handoff_fallback", reason=reason,
                         source=str(source))
        return {"outcome": "fallback", "bytes": 0, "covered": 0,
                "ms": round((time.perf_counter() - t0) * 1e3, 3),
                "reason": reason}

    if engine.host_tier is None:
        return _fallback("no_host_tier")
    toks = [int(t) for t in tokens]
    est = (len(toks) // engine.block_size) * engine.block_size
    if est <= 0:
        return _fallback("below_block")
    key, covered, _blob = engine.host_tier.lookup(toks, engine.block_size)
    if key is not None:
        # an earlier handoff (e.g. a failover retry) already delivered
        # this coverage — nothing to fetch, the seat probe will hit it
        return {"outcome": "received", "bytes": 0, "covered": covered,
                "ms": round((time.perf_counter() - t0) * 1e3, 3),
                "reason": "resident"}
    faster, handoff_ms, recompute_ms = \
        engine._handoff_predicted_faster(est)
    obstrace.instant("kv.handoff_route", covered=int(est),
                     handoff_ms=round(handoff_ms, 4),
                     recompute_ms=round(recompute_ms, 4),
                     handoff=faster)
    if not faster:
        return _fallback("analytic")
    try:
        covered, blob = fetch_chain(source, toks, engine._trunk_sig,
                                    max_bytes=max_bytes, timeout=timeout)
        key, covered = engine.deliver_chain_blob(blob,
                                                 max_bytes=max_bytes)
    except (HandoffError, WireFormatError, ValueError) as e:
        logger.warning("kv handoff from %s fell back to recompute: "
                       "%s: %s", source, type(e).__name__, e)
        return _fallback(type(e).__name__)
    dt = time.perf_counter() - t0
    if metrics is not None:
        metrics.observe_kv_handoff("received", len(blob), dt)
    obstrace.instant("kv.handoff_recv", bytes=len(blob),
                     covered=int(covered), source=str(source),
                     ms=round(dt * 1e3, 3))
    return {"outcome": "received", "bytes": len(blob),
            "covered": int(covered), "ms": round(dt * 1e3, 3),
            "reason": None}
