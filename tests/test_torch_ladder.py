"""The port's legacy prefill ladder (``DecodeEngine(prefill_chunk=0)``)
on the CPU, over both KV layouts: ``lm_decode_step_slots`` against its
JAX twin, ``prefill`` + ``admit`` against the port's own ``lm_prefill``,
and the ladder engine's streams (slab, paged, paged with prefix hits and
pool-pressure preemption, and over HTTP) against ``lm_generate``.

Tolerance 1e-4 (``tests/test_torch_lm.py``): float32 on both sides, sums
in different orders.  Streams are held against ``lm_generate`` while the
reference's top-1/top-2 logit margin exceeds MARGIN; the port's two
layouts share every plain path and are held token for token.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.serving import (DecodeEngine, GenerationBatcher,
                                      InvalidRequestError, make_server)
from paddle_tpu_torch.serving import server as torch_server
from paddle_tpu_torch.utils.error import ConfigError
from test_torch_paged import (_audit, _staggered, check_streams,
                              pressure_cases)

TOL = 1e-4
VOCAB, D_MODEL, LAYERS, HEADS, DFF = 64, 32, 2, 2, 64
MAX_LEN, SLOTS, BS = 48, 4, 4
BUCKETS = (8, 24)


@pytest.fixture(scope="module")
def params():
    return torch_tf.init_lm(torch.Generator().manual_seed(0), VOCAB,
                            D_MODEL, HEADS, DFF, LAYERS, MAX_LEN,
                            device="cpu")


def _ladder(params, layout="slab", **kw):
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("prefill_buckets", BUCKETS)
    return DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                        max_len=MAX_LEN, prefill_chunk=0, kv_layout=layout,
                        device="cpu", **kw)


# ------------------------------------------------------------ model


@pytest.mark.parametrize("cfg", [
    dict(d_model=D_MODEL, num_heads=HEADS),
    dict(d_model=64, num_heads=4, num_kv_heads=2, pos_type="rope")],
    ids=["learned", "gqa_rope"])
def test_slots_step_matches_jax(np_rng, cfg):
    heads, pos_type = cfg["num_heads"], cfg.get("pos_type", "learned")
    jp = jax_tf.init(jax.random.PRNGKey(1), src_vocab=VOCAB, trg_vocab=1,
                     dff=DFF, enc_layers=LAYERS, dec_layers=0,
                     max_len=MAX_LEN, **cfg)
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    jc = jax_tf.init_lm_cache(jp, 4, MAX_LEN)
    tc = torch_tf.init_lm_cache(tp, 4, MAX_LEN)
    pos = np.asarray([0, 5, MAX_LEN - 3, 15], np.int32)  # 15: block edge
    for _ in range(3):
        toks = np_rng.randint(1, VOCAB, 4).astype(np.int32)
        jl, jc = jax_tf.lm_decode_step_slots(
            jp, jnp.asarray(toks), jnp.asarray(pos), jc, heads,
            pos_type=pos_type)
        tl, tc = torch_tf.lm_decode_step_slots(tp, toks, pos, tc, heads,
                                               pos_type=pos_type)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        for g, w in zip(tc, jc):
            for key in ("k", "v"):
                np.testing.assert_allclose(g[key].numpy(),
                                           np.asarray(w[key]), atol=TOL,
                                           rtol=TOL)
        pos = pos + 1


def test_tq1_paged_step_equals_slots_step_on_cpu(params, np_rng):
    """The paged Tq=1 step over a shuffled chain gives the slab step's
    logits exactly: the plain versions read the same values at every
    unmasked position."""
    slab = torch_tf.init_lm_cache(params, 3, MAX_LEN)
    nb_row = MAX_LEN // BS
    pool = torch_tf.init_lm_cache_paged(params, 3 * nb_row + 1, BS,
                                        max_len=MAX_LEN)
    tables = np_rng.permutation(np.arange(1, 3 * nb_row + 1)) \
        .reshape(3, nb_row).astype(np.int32)
    pos = np.zeros(3, np.int32)
    for t in range(2 * BS + 1):
        toks = np_rng.randint(1, VOCAB, 3).astype(np.int32)
        a, slab = torch_tf.lm_decode_step_slots(params, toks, pos, slab,
                                                HEADS)
        b, pool = torch_tf.lm_decode_step_paged(params, toks, pos, pool,
                                                tables, HEADS)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        pos = pos + np.asarray([1, 1, t % 2], np.int32)


# ------------------------------------------------------------ engine


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_prefill_and_admit_write_lm_prefill_rows(params, np_rng, layout):
    eng = _ladder(params, layout, warm=False)
    prompts = np.zeros((2, 11), np.int32)
    lengths = np.asarray([11, 6], np.int32)
    for i, n in enumerate(lengths):
        prompts[i, :n] = np_rng.randint(1, VOCAB, n)
    first, rows = eng.prefill(prompts, lengths)
    assert eng.prefill_bucket_for(11) == 24 and len(rows) == 2
    assert rows[0][0]["k"].shape == (24, D_MODEL)
    for i, n in enumerate(lengths):
        hidden, want = torch_tf.lm_prefill(params, prompts[i:i + 1, :n],
                                           MAX_LEN, HEADS)
        logits = torch_tf._lm_project(params, hidden[:, -1])
        assert int(first[i]) == int(torch.argmax(logits, -1)[0])
        slot = eng.admit(first[i], rows[i], int(n), tokens=prompts[i, :n])
        for c, w in zip(eng._cache, want):
            for key in ("k", "v"):
                if layout == "slab":
                    got = c[key][slot, :n]
                else:
                    chain = torch.tensor(eng._paged._chains[slot])
                    got = c[key][chain].reshape(-1, D_MODEL)[:n]
                np.testing.assert_allclose(got.numpy(), w[key][0, :n].numpy(),
                                           atol=TOL, rtol=TOL)
        assert int(eng._pos[slot]) == n and int(eng._tokens[slot]) == first[i]
    if layout == "paged":
        assert eng.prefix_lookup(prompts[0, :11])[0] == 11
        assert eng._paged.pool.num_used == 3 + 2   # 11 and 6 positions
        eng._paged.check()


def test_prefill_batch_buckets_group_rows(params):
    eng = _ladder(params, warm=False, prefill_batch_buckets=(1, 4))
    for n, batches in ((1, 1), (3, 1), (5, 2)):
        before = eng.prefill_batches_total
        first, rows = eng.prefill(np.ones((n, 5), np.int32),
                                  np.full(n, 5, np.int32))
        assert len(first) == len(rows) == n
        assert eng.prefill_batches_total - before == batches


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_ladder_streams_match_lm_generate(params, layout):
    rng = np.random.RandomState(5)
    cases = [(rng.randint(1, VOCAB, n).tolist(), m)
             for n, m in ((1, 6), (8, 10), (24, 12), (5, 3), (13, 9),
                          (9, 1), (20, 7), (3, 14))]
    eng = _ladder(params, layout)
    with GenerationBatcher(eng) as gen:
        outs = _staggered(gen, cases)
    check_streams(params, cases, outs)
    snap = eng.metrics.snapshot()
    assert snap["prefill_chunk_size"] == 0 and snap["prefill_chunks_total"] \
        == 0
    assert eng.prefill_batches_total >= 1 and snap["responses_total"] == 8
    if layout == "paged":
        _audit(eng)


def test_ladder_paged_equals_slab_token_for_token(params):
    rng = np.random.RandomState(6)
    cases = [(rng.randint(1, VOCAB, rng.randint(1, 25)).tolist(),
              int(rng.randint(2, 12))) for _ in range(8)]
    outs = {}
    for layout in ("paged", "slab"):
        with GenerationBatcher(_ladder(params, layout)) as gen:
            outs[layout] = _staggered(gen, cases)
    assert outs["paged"] == outs["slab"]


def test_ladder_paged_prefix_hits_and_preemption_match_lm_generate(params):
    """Duplicates of a resident prompt seat by reference (a prefix hit,
    then copy-on-write at the first write into the shared tail block);
    long requests outgrow a small pool and are preempted and re-seated."""
    rng = np.random.RandomState(1)
    preamble = rng.randint(1, VOCAB, 10)
    lead, rest = pressure_cases(rng, preamble)
    eng = _ladder(params, "paged", kv_num_blocks=14)
    with GenerationBatcher(eng) as gen:
        outs = [gen.generate(lead[0][0], max_tokens=8,
                             timeout=60)["tokens"]]
        futs = [gen.submit(p, max_tokens=n) for p, n in rest]
        outs += [f.result(timeout=120)["tokens"] for f in futs]
    snap = eng.metrics.snapshot()
    assert snap["prefix_cache_hits_total"] >= 1
    assert snap["cow_forks_total"] >= 1
    assert snap["evictions"]["pool_exhausted"] >= 1
    assert snap["slot_reprefills_total"] >= 1
    check_streams(params, lead + rest, outs)
    _audit(eng)


def test_ladder_validation(params):
    eng = _ladder(params, warm=False)
    assert [eng.prefill_bucket_for(n) for n in (1, 8, 9, 24, 25)] \
        == [8, 8, 24, 24, None]
    gen = GenerationBatcher(eng)
    with pytest.raises(InvalidRequestError, match="ladder top"):
        gen.submit(list(range(1, 26)), max_tokens=2)
    gen.close()
    with pytest.raises(InvalidRequestError, match="ladder top"):
        eng.prefill(np.ones((1, 25), np.int32), [25])
    with pytest.raises(ConfigError, match="no room"):
        DecodeEngine(params, num_heads=HEADS, max_len=MAX_LEN,
                     prefill_chunk=0, prefill_buckets=(8, MAX_LEN),
                     device="cpu", warm=False)
    with pytest.raises(ConfigError):
        _ladder(params, warm=False, prefill_buckets=())


def test_http_server_ladder_on_paged_layout():
    """``build_gen_batcher`` with the JAX CLI's flags (``prefill_chunk=0``,
    ``kv_layout="paged"``) serves plain and streamed requests over HTTP
    and reports the pool on /metrics (max_len above the default ladder
    top, 64)."""
    max_len = 80
    gen = torch_server.build_gen_batcher(
        slots=SLOTS, max_len=max_len, prefill_chunk=0, device="cpu",
        kv_layout="paged", kv_block_size=BS, vocab=VOCAB, d_model=D_MODEL,
        num_heads=HEADS, dff=DFF, layers=LAYERS)
    eng = gen.engine
    assert eng._paged is not None and not eng.chunked
    httpd = make_server(gen_batcher=gen)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.port}"
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    outs = []
    try:
        for stream in (False, True):
            req = urllib.request.Request(
                f"{base}/v1/generate",
                data=json.dumps({"prompt": prompt, "max_tokens": 6,
                                 "stream": stream}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                raw = r.read().decode()
            lines = [json.loads(ln) for ln in raw.splitlines()]
            outs.append(lines[-1]["tokens"])
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        gen.close()
    assert outs[0] == outs[1]
    check_streams(eng.params, [(prompt, 6)], outs[:1])
    name = eng.metrics.name
    assert f"{name}_prefill_chunk_size 0" in text
    assert f"{name}_kv_blocks_total {SLOTS * max_len // BS}" in text
    assert f"{name}_prefix_cache_hits_total 1" in text


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal without a card")
@pytest.mark.parametrize("kw", [dict(kv_layout="paged"),
                                dict(prefill_chunk=0),
                                dict(prefill_chunk=0, kv_layout="paged")])
def test_no_card_refuses_without_device_cpu(params, kw):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                     max_len=MAX_LEN, **kw)
    argv = ["--kv-layout", kw.get("kv_layout", "slab"),
            "--prefill-chunk", str(kw.get("prefill_chunk", 8))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_server.main(argv)
