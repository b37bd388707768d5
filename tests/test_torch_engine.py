"""The port's serving slice on the CPU: ``DecodeEngine(device="cpu")`` +
``GenerationBatcher`` + ``make_server``, driven by concurrent staggered
HTTP clients (plain and streamed).  Every stream is held against the
port's single-request ``lm_generate``; one drive runs the engine on JAX
weights and holds it against the JAX ``lm_generate``.

Token comparisons: the chunked slab step and lm_generate's prefill +
decode step round differently (~1e-7 on these logits); a token is
compared while the reference's top-1/top-2 logit margin exceeds MARGIN
(1e-5, 100x that), and the tests assert most tokens were compared.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.serving import (BatchExecutionError,
                                      DeadlineExceededError, DecodeEngine,
                                      GenerationBatcher, InvalidRequestError,
                                      ServingMetrics, ShutdownError,
                                      make_server)
from paddle_tpu_torch.utils.error import ConfigError

VOCAB, D_MODEL, LAYERS, HEADS, DFF = 64, 32, 2, 2, 64
MAX_LEN, SLOTS, K = 48, 4, 4
MARGIN = 1e-5


@pytest.fixture(scope="module")
def params():
    return torch_tf.init_lm(torch.Generator().manual_seed(0), VOCAB,
                            D_MODEL, HEADS, DFF, LAYERS, MAX_LEN,
                            device="cpu")


def _engine(params, **kw):
    kw.setdefault("prefill_chunk", K)
    return DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                        max_len=MAX_LEN, device="cpu", **kw)


def _margins(params, ids):
    hidden, _ = torch_tf.lm_prefill(params, ids, ids.shape[1], HEADS)
    top2 = torch.topk(torch_tf._lm_project(params, hidden), 2, dim=-1)
    return (top2.values[..., 0] - top2.values[..., 1]).numpy()


def _check_stream(tokens, ref_ids, n_prompt, margins):
    """Compare a stream with the reference continuation while margins are
    clear; returns how many tokens were compared."""
    n = 0
    for t, tok in enumerate(tokens):
        if margins[n_prompt - 1 + t] < MARGIN:
            break
        assert tok == int(ref_ids[n_prompt + t]), (t, tokens, ref_ids)
        n += 1
    return n


def _post(base, body, timeout=120):
    req = urllib.request.Request(f"{base}/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def test_http_clients_streams_match_lm_generate(params):
    metrics = ServingMetrics()
    gen = GenerationBatcher(_engine(params, metrics=metrics),
                            default_max_tokens=8)
    httpd = make_server(gen_batcher=gen)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.port}"
    rng = np.random.RandomState(1)
    cases = [(rng.randint(1, VOCAB, n).tolist(), m, i % 2 == 1)
             for i, (n, m) in enumerate([(3, 10), (17, 6), (9, 12), (1, 5),
                                         (26, 8), (5, 14), (12, 9),
                                         (30, 11)])]
    results = [None] * len(cases)

    def client(i):
        prompt, n_tok, stream = cases[i]
        time.sleep(0.01 * i)        # staggered: admissions land mid-decode
        status, raw = _post(base, {"prompt": prompt, "max_tokens": n_tok,
                                   "stream": stream})
        if stream:
            lines = [json.loads(ln) for ln in raw.decode().splitlines()]
            toks = [ln["token"] for ln in lines if "token" in ln]
            done = lines[-1]
            assert done["done"] and done["tokens"] == toks
            results[i] = (status, toks, done["finish_reason"])
        else:
            out = json.loads(raw)
            results[i] = (status, out["tokens"], out["finish_reason"])

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(cases))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            text = r.read().decode()
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(base, {"prompt": [1, 2, VOCAB]})
        with pytest.raises(urllib.error.HTTPError) as long_:
            _post(base, {"prompt": [1] * 40, "max_tokens": 9})
    finally:
        httpd.shutdown()
        httpd.server_close()
        gen.close()
    assert health["status"] == "ok" and not health["draining"]
    assert bad.value.code == 400 and long_.value.code == 400
    snap = metrics.snapshot()
    assert snap["responses_total"] == len(cases)
    assert snap["prefill_chunks_total"] > 0     # prompts rode the chunks
    assert f"{metrics.name}_gen_tokens_total {snap['gen_tokens_total']}" \
        in text
    checked = total = 0
    for (prompt, n_tok, _), (status, toks, reason) in zip(cases, results):
        assert status == 200 and reason == "length" and len(toks) == n_tok
        ref = torch_tf.lm_generate(params, np.asarray([prompt]),
                                   len(prompt) + n_tok, HEADS)[0]
        checked += _check_stream(toks, ref.numpy(), len(prompt),
                                 _margins(params, ref[None])[0])
        total += n_tok
    assert checked >= 0.9 * total


def test_engine_on_jax_weights_matches_jax_lm_generate():
    """The whole serving slice across frameworks: the port's engine on
    JAX weights (GQA, rope) against the JAX lm_generate."""
    jp = jax_tf.init(jax.random.PRNGKey(2), src_vocab=VOCAB, trg_vocab=1,
                     d_model=64, num_heads=4, num_kv_heads=2, dff=DFF,
                     enc_layers=LAYERS, dec_layers=0, max_len=MAX_LEN,
                     pos_type="rope")
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    eng = DecodeEngine(tp, num_heads=4, num_slots=SLOTS, max_len=MAX_LEN,
                       prefill_chunk=K, pos_type="rope", device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, VOCAB, n) for n in (2, 11, 7, 19, 5)]
    with GenerationBatcher(eng) as gen:
        futs = [gen.submit(p, max_tokens=10) for p in prompts]
        outs = [f.result(timeout=120)["tokens"] for f in futs]
    # one ragged JAX batch (each row continues exactly as it would alone)
    lengths = np.asarray([p.size for p in prompts])
    padded = np.zeros((len(prompts), lengths.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :p.size] = p
    ids = np.asarray(jax_tf.lm_generate(jp, padded, lengths.max() + 10, 4,
                                        prompt_lengths=lengths,
                                        pos_type="rope"))
    hidden, _ = jax_tf.lm_prefill(jp, jnp.asarray(ids), ids.shape[1], 4,
                                  pos_type="rope")
    top2 = np.sort(np.asarray(jax_tf._lm_project(jp, hidden)), -1)
    margins = top2[..., -1] - top2[..., -2]
    checked = sum(_check_stream(toks, ids[i], lengths[i], margins[i])
                  for i, toks in enumerate(outs))
    assert checked >= 0.9 * 10 * len(prompts)


def test_eos_finish_deadline_and_step_failure_isolation(params):
    eng = _engine(params)
    with GenerationBatcher(eng) as gen:
        prompt = [7, 8, 9, 10, 11]
        free = gen.generate(prompt, max_tokens=6, timeout=60)["tokens"]
        eos = free[2]
        out = gen.generate(prompt, max_tokens=6, eos_id=eos, timeout=60)
        assert out["finish_reason"] == "eos"
        assert out["tokens"] == free[:free.index(eos) + 1]
        with pytest.raises(InvalidRequestError):
            gen.submit(prompt, max_tokens=0)
        with pytest.raises(DeadlineExceededError):   # expired in queue
            gen.generate(prompt, max_tokens=2, deadline_ms=1e-3, timeout=60)
        # a failing step fails the requests in flight, resets the engine,
        # and the next request is served normally
        real_run = eng._run
        calls = []

        def failing(*a):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected step failure")
            return real_run(*a)

        eng._run = failing
        with pytest.raises(BatchExecutionError):
            gen.generate(prompt, max_tokens=3, timeout=60)
        eng._run = real_run
        assert gen.generate(prompt, max_tokens=6, timeout=60)["tokens"] \
            == free
    assert eng.metrics.snapshot()["evictions"]["error"] == 1


def test_chunk_budget_caps_lanes_per_step_and_keeps_streams(params):
    prompts = [[5 + i] * (9 + 4 * i) for i in range(3)]
    outs = {}
    for budget in (0, 2):
        eng = _engine(params, prefill_chunk_budget=budget)
        with GenerationBatcher(eng) as gen:
            futs = [gen.submit(p, max_tokens=6) for p in prompts]
            outs[budget] = [f.result(timeout=60)["tokens"] for f in futs]
        snap = eng.metrics.snapshot()
        if budget:
            # every step fed at most `budget` teacher-forced lanes, so
            # ingestion took more steps than the unbounded engine's
            assert eng.metrics.prefill_lane_steps_total \
                <= budget * snap["decode_steps_total"]
            assert snap["decode_steps_total"] > steps_unbounded
        else:
            steps_unbounded = snap["decode_steps_total"]
    assert outs[2] == outs[0]


def test_close_drains_inflight_then_rejects(params):
    gen = GenerationBatcher(_engine(params))
    futs = [gen.submit([3 + i, 4, 5], max_tokens=5) for i in range(6)]
    gen.close(drain=True)
    assert [len(f.result(timeout=60)["tokens"]) for f in futs] == [5] * 6
    assert gen.closed and not gen.ready
    with pytest.raises(ShutdownError):
        gen.submit([1, 2], max_tokens=2)


@pytest.mark.parametrize("kw", [dict(kv_layout="paged",
                                     kv_host_bytes=1 << 20),
                                dict(kv_layout="paged", speculate_k=2,
                                     kv_host_bytes=1 << 20),
                                dict(kv_dtype="int8", mesh=object()),
                                dict(speculate_k=2, mesh=object()),
                                dict(mesh=object()),
                                dict(kv_host_bytes=1 << 20)])
def test_options_not_yet_ported_raise_config_error(params, kw):
    with pytest.raises(ConfigError, match="not yet ported"):
        _engine(params, warm=False, **kw)


def test_supervisor_not_yet_ported_and_no_silent_cpu_fallback(params):
    eng = _engine(params, warm=False)
    with pytest.raises(ConfigError, match="not yet ported"):
        GenerationBatcher(eng, supervisor=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                         max_len=MAX_LEN)
