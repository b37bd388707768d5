"""Continuation replay and the cross-replica KV handoff on the port
(``DecodeEngine.validate_continuation``, ``GenerationBatcher.submit(
replay=...)``, ``serving/transfer.py``, ``/v1/kv/export`` and the
``kv_handoff`` hint of ``/v1/generate``), on the CPU.

- ``validate_continuation`` refuses what JAX's refuses, with JAX's
  messages.
- On the chunked slab, ladder and paged engines, replaying a clean
  stream's first n tokens yields the rest of that stream bit for bit and
  emits none of the replayed tokens (JAX's contract: greedy decode is
  deterministic, and the replayed context is teacher-forced).
- Two in-process servers hand a stream off: the prefill server answers
  the first token, the decode server pulls the prompt's KV chain over
  ``/v1/kv/export`` into its host tier, restores it and continues the
  stream, which equals a single engine's run bit for bit.  A dead
  source, a foreign blob (another trunk signature) and a malformed hint
  each fall back to recompute with the same stream, and both servers'
  ``/metrics`` count the outcomes (``kv_handoffs_total{outcome}``).
"""

import io
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.serving.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.serving import (DecodeEngine, GenerationBatcher,
                                      InvalidRequestError, make_server)
from paddle_tpu_torch.serving import transfer

VOCAB, D_MODEL, LAYERS, HEADS, DFF = 64, 32, 2, 2, 64
MAX_LEN, SLOTS, BS, CHUNK = 64, 4, 8, 8
KINDS = {"slab": dict(prefill_chunk=CHUNK),
         "ladder": dict(prefill_chunk=0, prefill_buckets=(8, 16),
                        prefill_batch_buckets=(4,)),
         "paged": dict(prefill_chunk=CHUNK, kv_layout="paged",
                       kv_block_size=BS)}


@pytest.fixture(scope="module")
def jax_tree():
    return jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                       d_model=D_MODEL, num_heads=HEADS, dff=DFF,
                       enc_layers=LAYERS, dec_layers=0, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def params(jax_tree):
    return transformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_tree), "cpu")


def _engine(params, name, **kw):
    base = dict(num_heads=HEADS, num_slots=SLOTS, max_len=MAX_LEN,
                device="cpu", name=name)
    return DecodeEngine(params, **dict(base, **kw))


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, n).astype(np.int32) for n in lengths]


# ------------------------------------------------------------ validation

@pytest.mark.parametrize("case", ["empty_replay", "float_replay",
                                  "replay_out_of_vocab", "2d_replay",
                                  "over_max_len", "bad_max_tokens",
                                  "pool_fit"])
def test_validate_continuation_refusals_equal_jax(params, jax_tree, case):
    kw = dict(num_heads=HEADS, num_slots=SLOTS, max_len=MAX_LEN,
              prefill_chunk=CHUNK, kv_layout="paged", kv_block_size=BS,
              kv_num_blocks=5)
    ours = DecodeEngine(params, device="cpu", warm=False, **kw)
    theirs = JaxEngine(jax_tree, warm=False, **kw)
    prompt = np.arange(1, 9, dtype=np.int32)
    replay, max_tokens = {
        "empty_replay": ([], 4), "float_replay": ([1.5, 2.0], 4),
        "replay_out_of_vocab": ([3, VOCAB], 4),
        "2d_replay": ([[1, 2]], 4), "over_max_len": ([1] * 50, 7),
        "bad_max_tokens": ([3], "x"), "pool_fit": ([3] * 30, 4)}[case]
    with pytest.raises(Exception) as want:
        theirs.validate_continuation(prompt, np.asarray(replay), max_tokens)
    with pytest.raises(InvalidRequestError) as got:
        ours.validate_continuation(prompt, np.asarray(replay), max_tokens)
    assert type(want.value).__name__ == "InvalidRequestError"
    assert str(got.value) == str(want.value)
    p, r, n = ours.validate_continuation(prompt, [3, 4], 5)
    assert p.dtype == r.dtype == np.int32 and n == 5


# ------------------------------------------------------------ replay

@pytest.mark.parametrize("kind", list(KINDS))
def test_replay_yields_the_rest_of_the_stream(params, kind):
    """The clean stream of each prompt, then each continued from its
    first n tokens: the new tokens are the stream's tail bit for bit and
    on_token sees only them.  On the ladder the context outgrows the
    ladder top (16)."""
    eng = _engine(params, f"replay_{kind}", **KINDS[kind])
    bat = GenerationBatcher(eng)
    prompts = _prompts(3, (5, 14, 9))
    n_tok = 10
    clean = [bat.submit(p, max_tokens=n_tok).result(60)["tokens"]
             for p in prompts]
    for prompt, stream in zip(prompts, clean):
        for n in (1, 4, 7):
            seen = []
            out = bat.submit(prompt, max_tokens=n_tok - n,
                             replay=stream[:n],
                             on_token=seen.append).result(60)
            assert out["tokens"] == stream[n:] == seen, (kind, n)
    snap = eng.metrics.snapshot()
    bat.close()
    assert snap["errors_total"] == 0
    if kind == "paged":
        eng._paged.check()
    with pytest.raises(InvalidRequestError):
        GenerationBatcher(eng).submit(prompts[0], max_tokens=MAX_LEN,
                                      replay=[1, 2])


# ------------------------------------------------------------ handoff

class _Server:
    def __init__(self, gen):
        self.gen = gen
        self.httpd = make_server(None, port=0, gen_batcher=gen)
        self.url = f"http://127.0.0.1:{self.httpd.port}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def post(self, body):
        req = urllib.request.Request(
            f"{self.url}/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def metrics(self):
        with urllib.request.urlopen(f"{self.url}/metrics", timeout=30) as r:
            return r.read().decode()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.gen.close()


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def servers(params):
    paged = dict(prefill_chunk=CHUNK, kv_layout="paged", kv_block_size=BS)
    out = {"prefill": _Server(GenerationBatcher(_engine(params, "prefill",
                                                        **paged))),
           "foreign": _Server(GenerationBatcher(_engine(
               params, "foreign", **dict(paged, kv_block_size=4)))),
           "single": GenerationBatcher(_engine(params, "single",
                                               prefill_chunk=CHUNK))}
    yield out
    for key in ("prefill", "foreign"):
        out[key].close()
    out["single"].close()


@pytest.mark.parametrize("how", ["received", "dead_source", "foreign_blob",
                                 "malformed_hint"])
def test_two_server_handoff_equals_single_engine(params, servers, how):
    prompt = _prompts(4, (41,))[0].tolist()
    n_tok = 8
    want = servers["single"].submit(prompt,
                                    max_tokens=n_tok).result(60)["tokens"]
    source = servers["foreign" if how == "foreign_blob" else "prefill"]
    first = source.post({"prompt": prompt, "max_tokens": 1})["tokens"]
    assert first == want[:1]
    hint = {"source": _dead_url() if how == "dead_source" else source.url,
            "tokens": prompt + first}
    if how == "malformed_hint":
        hint = {"source": 5}
    decode = _Server(GenerationBatcher(_engine(
        params, f"decode_{how}", prefill_chunk=CHUNK, kv_layout="paged",
        kv_block_size=BS, kv_host_bytes=16 << 20)))
    try:
        sent0 = source.metrics()
        out = decode.post({"prompt": prompt, "replay": first,
                           "max_tokens": n_tok - 1, "kv_handoff": hint})
        assert first + out["tokens"] == want
        handoff = out["kv_handoff"]
        outcome = "received" if how == "received" else "fallback"
        assert handoff["outcome"] == outcome, handoff
        text = decode.metrics()
        name = decode.gen.metrics.name
        assert f'{name}_kv_handoffs_total{{outcome="{outcome}"}} 1' in text
        snap = decode.gen.metrics.snapshot()
        if how == "received":
            assert handoff["covered"] == 40 and handoff["bytes"] > 0
            assert snap["kv_restore_hits_total"] == 1
            assert snap["prefill_chunk_lanes_total"] < len(prompt)
            sent = source.metrics()
            assert f'kv_handoffs_total{{outcome="sent"}}' in sent
            assert sent != sent0
        else:
            assert snap["kv_restore_hits_total"] == 0
    finally:
        decode.close()


def test_export_route_and_wire_helpers(servers):
    """/v1/kv/export answers a resident prefix with a length-prefixed
    blob (fetch_chain checks its envelope), 404 on a miss and 400 on a
    malformed body; read_blob bounds the declared length."""
    src = servers["prefill"]
    prompt = _prompts(5, (24,))[0].tolist()
    src.post({"prompt": prompt, "max_tokens": 1})
    sig = src.gen.engine._trunk_sig
    covered, blob = transfer.fetch_chain(src.url, prompt, sig)
    assert covered == 24 and blob[0] == 1
    with pytest.raises(transfer.HandoffError, match="HTTP 404"):
        transfer.fetch_chain(src.url, [1, 2, 3], sig)
    with pytest.raises(Exception, match="trunk signature"):
        transfer.fetch_chain(src.url, prompt, sig + "x")
    req = urllib.request.Request(f"{src.url}{transfer.EXPORT_PATH}",
                                 data=b'{"tokens": []}')
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    with pytest.raises(transfer.HandoffError, match="receive bound"):
        transfer.read_blob(io.BytesIO((1 << 40).to_bytes(8, "little")),
                           max_bytes=1 << 20)
    buf = io.BytesIO()
    transfer.write_blob(buf, blob)
    buf.seek(0)
    assert transfer.read_blob(buf) == blob
