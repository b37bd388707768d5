"""Speculative decoding in the port (``paddle_tpu_torch/serving/
speculative.py`` and ``DecodeEngine(speculate_k=, draft=)``) on the CPU.

Against the JAX package: ``make_draft``, ``DraftTrunk.rollout`` (JAX's
``DraftTrunk`` on the same params and feeds) and
``lm_decode_chunk_paged(all_lanes=True)``.  Then the cases of JAX's
``tests/test_speculative.py`` on the port's engine (``device="cpu"``):
streams equal to the non-speculating twin and to ``lm_generate`` on
slab and paged at k 1, 2, 4; an adversarial draft (another seed's trunk)
still netting at least one token a verify step; EOS inside an accepted
run; ``max_tokens`` ending a run; the config checks with JAX's
messages; the metrics; int8 KV with an int8 draft; and ``/v1/generate``
through the server's ``--speculate-k``.

Token comparisons: a speculating step projects every lane ([S, K, D] x
[D, V]) where the twin projects one lane a row, and the two products may
round a logit apart in its last bits.  So a stream is compared with its
reference while the reference's top-1/top-2 logit margin exceeds MARGIN
(1e-5, 100x the observed rounding), and the tests assert that most
tokens were compared; the draft's tokens likewise, up to the first
margin below MARGIN in the JAX draft's own rollout.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.quant import weights as jax_qw
from paddle_tpu.serving import speculative as jax_spec
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.quant import weights as qw
from paddle_tpu_torch.serving import (DecodeEngine, GenerationBatcher,
                                      ServingMetrics, make_server)
from paddle_tpu_torch.serving import server
from paddle_tpu_torch.serving.speculative import DraftTrunk, make_draft
from paddle_tpu_torch.utils.error import ConfigError

VOCAB, D_MODEL, LAYERS, HEADS, DFF = 64, 32, 2, 2, 64
MAX_LEN, SLOTS, BS, SPEC_K, CHUNK = 48, 4, 8, 3, 4
MARGIN = 1e-5
TOL = 1e-4


def _init(seed):
    return torch_tf.init_lm(torch.Generator().manual_seed(seed), VOCAB,
                            D_MODEL, HEADS, DFF, LAYERS, MAX_LEN,
                            device="cpu")


@pytest.fixture(scope="module")
def params():
    return _init(0)


@pytest.fixture(scope="module")
def adversarial_params():
    # independently drawn: near-zero agreement with `params`' argmaxes
    return _init(7)


def _engine(params, **kw):
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("speculate_k", SPEC_K)
    if kw["speculate_k"] and "draft" not in kw:
        kw["draft"] = make_draft(params, layers=1)
    return DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                        max_len=MAX_LEN, device="cpu", **kw)


def _prompt(rng, n=None):
    return rng.randint(1, VOCAB, n or rng.randint(1, 30)).astype(np.int32)


def _drive(bat, cases, stagger_s=0.002):
    """Concurrent client threads (admissions land mid-verify)."""
    results, excs = [None] * len(cases), [None] * len(cases)

    def client(i):
        prompt, n = cases[i]
        try:
            time.sleep(stagger_s * i)
            results[i] = bat.submit(prompt, max_tokens=n).result(120)
        except Exception as e:      # noqa: BLE001
            excs[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
        assert not t.is_alive(), "client thread wedged"
    assert all(e is None for e in excs), excs
    return [r["tokens"] for r in results]


def _check_verify_runs(runs, snap):
    """``runs`` (the batcher's ``verify_runs``: tokens a verify run
    delivered -> runs): one run for each speculating slot-step, each
    delivering at least one token and at most its accepted lanes plus
    the target's own."""
    assert runs and min(runs) >= 1, runs
    assert sum(runs.values()) == snap["spec_slot_steps_total"], (runs, snap)
    assert sum(n * c for n, c in runs.items()) <= (
        snap["accepted_tokens_total"] + snap["spec_slot_steps_total"]), (
        runs, snap)


def _margins(params, prompt, toks, kv_dtype=None):
    """Top-1 minus top-2 logit at each emitted position of prompt + toks
    (one teacher-forced prefill)."""
    ids = np.concatenate([prompt, np.asarray(toks, np.int32)])[None]
    hidden, _ = torch_tf.lm_prefill(params, ids, ids.shape[1], HEADS,
                                    kv_dtype=kv_dtype)
    top2 = torch.topk(torch_tf._lm_project(params, hidden), 2, dim=-1)
    m = (top2.values[0, :, 0] - top2.values[0, :, 1]).numpy()
    return m[prompt.size - 1:]


def _compare(params, cases, got, want, kv_dtype=None):
    """Streams ``got`` against ``want`` token by token while the margins
    over ``want`` clear MARGIN; returns (tokens compared, total)."""
    checked = total = 0
    for (prompt, _n), g, w in zip(cases, got, want):
        assert len(g) == len(w)
        marg = _margins(params, prompt, w, kv_dtype)
        for t, (a, b) in enumerate(zip(g, w)):
            if marg[t] < MARGIN:
                break
            assert a == b, (t, g, w)
            checked += 1
        total += len(w)
    return checked, total


def _oracle(params, prompt, n, kv_dtype=None):
    ids = torch_tf.lm_generate(params, prompt[None], prompt.size + n, HEADS,
                               kv_dtype=kv_dtype)
    return ids[0, prompt.size:].tolist()


# --------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def jax_pair():
    jp = jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                     d_model=D_MODEL, num_heads=HEADS, dff=DFF,
                     enc_layers=LAYERS, dec_layers=0, max_len=MAX_LEN)
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    return jp, tp


def test_make_draft_bounds_shared_tensors_and_quantize(params, jax_pair):
    for bad in (0, LAYERS + 1):
        with pytest.raises(ConfigError, match="layers"):
            make_draft(params, layers=bad)
        with pytest.raises(Exception, match="layers"):
            jax_spec.make_draft(jax_pair[0], layers=bad)
    d = make_draft(params, layers=1)
    assert len(d["enc"]) == 1 and len(params["enc"]) == LAYERS
    for key in ("src_emb", "pos", "ln_f"):
        assert d[key] is params[key]        # shared, not copied
    assert d["enc"][0] is params["enc"][0]
    dq = make_draft(params, layers=2, quantize=True)
    assert qw.is_quantized_leaf(dq["src_emb"])
    assert qw.is_quantized_leaf(dq["enc"][1]["ffn"]["w1"])
    assert not qw.is_quantized_leaf(dq["pos"])
    assert not qw.is_quantized_tree(params)   # the target untouched
    # the same layout as JAX's draft, leaf for leaf
    jd = jax_spec.make_draft(jax_pair[0], layers=1, quantize=True)
    td = make_draft(jax_pair[1], layers=1, quantize=True)
    assert qw.quantized_weight_shapes(td) \
        == [tuple(s) for s in jax_qw.quantized_weight_shapes(jd)]


def _jax_rollout(jp, cache, tokens, positions, lengths, k):
    """JAX's rollout body unrolled here for its logits: (drafts [S, k],
    margins [S, k], cache)."""
    logits, cache = jax_tf.lm_decode_chunk_slots(
        jp, tokens, positions, lengths, cache, HEADS)
    out, margs = [], []
    base = positions + lengths
    for i in range(k):
        top2 = np.sort(np.asarray(logits), -1)
        margs.append(top2[:, -1] - top2[:, -2])
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(nxt))
        if i < k - 1:
            logits, cache = jax_tf.lm_decode_step_slots(
                jp, nxt, jnp.minimum(base + i, MAX_LEN - 1), cache, HEADS)
    return np.stack(out, 1), np.stack(margs, 1), cache


@pytest.mark.parametrize("quantize", [False, True])
def test_draft_rollout_matches_jax(jax_pair, quantize):
    """Two rollouts on one cache (ingest chunks of 1-6 committed tokens,
    then continue from there): the port's drafts equal JAX's DraftTrunk's
    up to the first margin below MARGIN of each row."""
    jp, tp = jax_pair
    k, chunk = 4, 6
    jd = jax_spec.make_draft(jp, layers=1, quantize=quantize)
    td = make_draft(tp, layers=1, quantize=quantize)
    jt = jax_spec.DraftTrunk(jd, k=k, num_slots=SLOTS, max_len=MAX_LEN,
                             chunk=chunk, num_heads=HEADS)
    tt = DraftTrunk(td, k=k, num_slots=SLOTS, max_len=MAX_LEN, chunk=chunk,
                    num_heads=HEADS, device="cpu", warm=True)
    rng = np.random.RandomState(5)
    cache = jax_tf.init_lm_cache(jd, SLOTS, MAX_LEN)
    pos = np.asarray([0, 3, 10, MAX_LEN - 2], np.int32)
    checked = 0
    for lens in ([6, 2, 1, 1], [1, 4, 3, 1]):
        lens = np.asarray(lens, np.int32)
        toks = rng.randint(1, VOCAB, (SLOTS, chunk)).astype(np.int32)
        want = jt.rollout(toks, pos, lens)
        mine, marg, cache = _jax_rollout(jd, cache, *map(
            jnp.asarray, (toks, pos, lens)), k)
        np.testing.assert_array_equal(mine, want)   # the unrolled body
        got = tt.rollout(toks, pos, lens)
        assert got.shape == (SLOTS, k) and got.dtype == np.int32
        for r in range(SLOTS):
            for i in range(k):
                if marg[r, i] < MARGIN:
                    break
                assert got[r, i] == want[r, i], (r, i, got, want)
                checked += 1
        pos = np.minimum(pos + lens, MAX_LEN - 1)
    assert checked >= SLOTS * k


def test_draft_reset_races_and_mesh(params, monkeypatch):
    """reset() during a rollout: the rollout returns None and the fresh
    cache is untouched (the in-flight writes land in the old one); a
    mesh raises naming A12."""
    tt = DraftTrunk(make_draft(params, 1), k=2, num_slots=SLOTS,
                    max_len=MAX_LEN, chunk=4, num_heads=HEADS,
                    device="cpu")
    feed = (np.ones((SLOTS, 4), np.int32), np.zeros(SLOTS, np.int32),
            np.full(SLOTS, 4, np.int32))
    real = torch_tf.lm_decode_chunk_slots

    def racing(*a, **kw):
        tt.reset()
        return real(*a, **kw)

    monkeypatch.setattr(torch_tf, "lm_decode_chunk_slots", racing)
    assert tt.rollout(*feed) is None
    assert all(float(c["k"].abs().sum()) == 0.0 for c in tt._cache)
    monkeypatch.setattr(torch_tf, "lm_decode_chunk_slots", real)
    assert tt.rollout(*feed).shape == (SLOTS, 2)
    with pytest.raises(ConfigError, match="A12"):
        DraftTrunk(params, k=2, num_slots=SLOTS, max_len=MAX_LEN, chunk=4,
                   mesh=object(), device="cpu")


def test_paged_all_lanes_matches_jax(jax_pair):
    """lm_decode_chunk_paged(all_lanes=True) over shuffled chains: every
    fed lane's logits against JAX's, two steps."""
    jp, tp = jax_pair
    rng = np.random.RandomState(6)
    nb = 1 + SLOTS * 4
    tables = np.zeros((SLOTS, MAX_LEN // BS), np.int32)
    tables[:, :4] = 1 + rng.permutation(SLOTS * 4).reshape(SLOTS, 4)
    jc = jax_tf.init_lm_cache_paged(jp, nb, BS, max_len=MAX_LEN)
    tc = torch_tf.init_lm_cache_paged(tp, nb, BS, max_len=MAX_LEN)
    pos = np.asarray([0, 5, 9, 20], np.int32)
    for lens in ([4, 1, 3, 2], [1, 4, 4, 1]):
        lens = np.asarray(lens, np.int32)
        toks = rng.randint(1, VOCAB, (SLOTS, CHUNK)).astype(np.int32)
        jl, jc = jax_tf.lm_decode_chunk_paged(
            jp, *map(jnp.asarray, (toks, pos, lens)), jc,
            jnp.asarray(tables), HEADS, all_lanes=True)
        tl, tc = torch_tf.lm_decode_chunk_paged(
            tp, toks, pos, lens, tc, tables, HEADS, all_lanes=True)
        assert tuple(tl.shape) == (SLOTS, CHUNK, VOCAB)
        fed = np.arange(CHUNK)[None] < lens[:, None]
        np.testing.assert_allclose(tl.numpy()[fed], np.asarray(jl)[fed],
                                   atol=TOL, rtol=TOL)
        pos = pos + lens


# --------------------------------------------------- the engine


@pytest.fixture(scope="module")
def spec_engine(params):
    """One paged speculating engine shared by the boundary cases (paged:
    the layout with rollback, chain truncation).  Its draft is the
    target's whole depth, so it accepts almost every lane and the runs
    are long enough for an EOS or max_tokens to land inside one."""
    return _engine(params, name="spec_shared", kv_layout="paged",
                   kv_block_size=BS, draft=make_draft(params, LAYERS))


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_streams_equal_twin_and_lm_generate(params, layout, k):
    kw = {"kv_layout": layout, "kv_block_size": BS}
    eng = _engine(params, name=f"spec_{layout}_{k}", speculate_k=k, **kw)
    twin = _engine(params, name=f"twin_{layout}_{k}", speculate_k=0, **kw)
    rng = np.random.RandomState(10 + k)
    cases = [(_prompt(rng), 4 + (i % 6)) for i in range(6)]
    with GenerationBatcher(eng) as bat:
        got = _drive(bat, cases)
    runs = bat.verify_runs
    with GenerationBatcher(twin) as bat:
        ref = _drive(bat, cases)
    checked, total = _compare(params, cases, got, ref)
    assert checked >= 0.9 * total
    oracle = [_oracle(params, p, n) for p, n in cases]
    checked, total = _compare(params, cases, got, oracle)
    assert checked >= 0.9 * total
    snap = eng.metrics.snapshot()
    assert snap["drafted_tokens_total"] > 0, snap
    _check_verify_runs(runs, snap)
    assert snap["speculate_k"] == k
    if k == 1:
        assert snap["spec_tokens_per_step"] <= 2.0, snap
    if layout == "paged":
        eng._paged.check()


def test_adversarial_draft_nets_one_token_a_step(params, adversarial_params):
    """A draft that (almost) never agrees costs speed, never
    correctness: streams equal lm_generate's, every verify step nets at
    least one token."""
    eng = _engine(params, name="spec_adv",
                  draft=make_draft(adversarial_params, layers=1))
    rng = np.random.RandomState(2)
    cases = [(_prompt(rng), 5 + (i % 5)) for i in range(5)]
    with GenerationBatcher(eng) as bat:
        got = _drive(bat, cases)
    checked, total = _compare(params, cases, got,
                              [_oracle(params, p, n) for p, n in cases])
    assert checked >= 0.9 * total
    snap = eng.metrics.snapshot()
    assert snap["drafted_tokens_total"] > 0, snap
    _check_verify_runs(bat.verify_runs, snap)
    assert snap["spec_acceptance_rate"] < 0.5, snap


def test_eos_inside_accepted_run(params, spec_engine):
    """An EOS inside an accepted run ends the stream exactly where plain
    decode stops, finish_reason eos; an EOS as the first token too."""
    rng = np.random.RandomState(4)
    with GenerationBatcher(spec_engine) as bat:
        for _ in range(40):
            prompt = _prompt(rng, 9)
            full = _oracle(params, prompt, 12)
            # an EOS id first emitted at index >= 2 with a clear margin
            marg = _margins(params, prompt, full)
            firsts = [i for i in range(2, 8)
                      if full[i] not in full[:i] and marg[:i + 1].min()
                      >= MARGIN]
            if firsts:
                break
        i = firsts[0]
        res = bat.submit(prompt, max_tokens=12, eos_id=full[i]).result(60)
        assert res["finish_reason"] == "eos", res
        assert res["tokens"] == full[:i + 1], (res["tokens"], full)
        res = bat.submit(prompt, max_tokens=12, eos_id=full[0]).result(60)
        assert res["finish_reason"] == "eos" and res["tokens"] == [full[0]]
    snap = spec_engine.metrics.snapshot()
    assert snap["accepted_tokens_total"] > 0, snap
    spec_engine._paged.check()


def test_max_tokens_boundary_mid_run(params, spec_engine):
    rng = np.random.RandomState(5)
    prompt = _prompt(rng, 7)
    full = _oracle(params, prompt, SPEC_K + 2)
    assert _margins(params, prompt, full).min() >= MARGIN
    with GenerationBatcher(spec_engine) as bat:
        for n in (1, 2, SPEC_K + 2):
            res = bat.submit(prompt, max_tokens=n).result(60)
            assert res["finish_reason"] == "length", (n, res)
            assert res["tokens"] == full[:n], (n, res["tokens"], full[:n])


def test_spec_config_validation(params):
    """JAX's ConfigErrors: a draft without speculate_k, speculate_k on
    the ladder, out of range, without a draft, a mismatched DraftTrunk;
    a draft deeper than the target."""
    with pytest.raises(ConfigError, match="draft trunk without"):
        _engine(params, speculate_k=0, draft=make_draft(params, layers=1))
    with pytest.raises(ConfigError, match="chunked"):
        _engine(params, prefill_chunk=0)
    with pytest.raises(ConfigError, match="must be in"):
        _engine(params, speculate_k=MAX_LEN)
    with pytest.raises(ConfigError, match="needs a draft"):
        _engine(params, draft=None)
    with pytest.raises(ConfigError, match="does not match"):
        mismatched = DraftTrunk(make_draft(params, layers=1),
                                k=SPEC_K + 1, num_slots=SLOTS,
                                max_len=MAX_LEN, chunk=SPEC_K + 3,
                                num_heads=HEADS, device="cpu")
        _engine(params, draft=mismatched)
    with pytest.raises(ConfigError, match="layers"):
        make_draft(params, layers=LAYERS + 1)
    # a DraftTrunk of the engine's shape is taken as it is
    ok = DraftTrunk(make_draft(params, layers=1), k=SPEC_K,
                    num_slots=SLOTS, max_len=MAX_LEN, chunk=SPEC_K + 2,
                    num_heads=HEADS, device="cpu")
    eng = _engine(params, draft=ok, warm=False)
    assert eng.draft is ok and eng.speculating and eng._kk == CHUNK


def test_metrics_counters_and_swap(params, spec_engine):
    """A swapped-in ServingMetrics inherits the speculate_k gauge; the
    counters grow on the new object only and render on /metrics."""
    old = spec_engine.metrics
    spec_engine.metrics = fresh = ServingMetrics()
    assert fresh.snapshot()["speculate_k"] == SPEC_K
    before = old.snapshot()["drafted_tokens_total"]
    rng = np.random.RandomState(6)
    prompt = _prompt(rng, 5)
    with GenerationBatcher(spec_engine) as bat:
        res = bat.submit(prompt, max_tokens=6).result(60)
    assert len(res["tokens"]) == 6
    snap = fresh.snapshot()
    assert snap["drafted_tokens_total"] > 0 and snap["spec_steps_total"] > 0
    assert snap["spec_slot_steps_total"] >= snap["spec_steps_total"]
    assert snap["accepted_tokens_total"] <= snap["drafted_tokens_total"]
    assert snap["spec_tokens_per_step"] == round(
        (snap["accepted_tokens_total"] + snap["spec_slot_steps_total"])
        / snap["spec_slot_steps_total"], 4)
    assert old.snapshot()["drafted_tokens_total"] == before
    text = fresh.render_prometheus()
    assert f"{fresh.name}_speculate_k {SPEC_K}" in text
    assert f"{fresh.name}_drafted_tokens_total " \
        f"{snap['drafted_tokens_total']}" in text
    assert "_spec_acceptance_rate " in text
    assert "_spec_tokens_per_step " in text
    assert ServingMetrics().snapshot()["spec_tokens_per_step"] == 0.0


def test_int8_kv_with_int8_draft_matches_twin(params):
    """An int8-KV paged speculating engine with an int8 draft emits its
    non-speculating int8-KV twin's streams (up to margin) and the int8
    lm_generate's; an int8 target (quantize_lm) serves too."""
    kw = dict(kv_layout="paged", kv_block_size=BS, kv_dtype="int8")
    spec = _engine(params, name="spec_q",
                   draft=make_draft(params, layers=1, quantize=True), **kw)
    twin = _engine(params, name="spec_q_twin", speculate_k=0, **kw)
    rng = np.random.RandomState(20)
    cases = [(_prompt(rng), 4 + (i % 6)) for i in range(6)]
    with GenerationBatcher(spec) as bat:
        got = _drive(bat, cases)
    with GenerationBatcher(twin) as bat:
        ref = _drive(bat, cases)
    checked, total = _compare(params, cases, got, ref, "int8")
    assert checked >= 0.9 * total
    oracle = [_oracle(params, p, n, "int8") for p, n in cases]
    checked, total = _compare(params, cases, got, oracle, "int8")
    assert checked >= 0.9 * total
    assert spec.metrics.snapshot()["drafted_tokens_total"] > 0
    spec._paged.check()
    # the full-quant engine: int8 trunk, its int8 draft, int8 KV
    qparams = qw.quantize_lm(params, min_size=64)
    full = _engine(qparams, name="spec_full_q",
                   draft=make_draft(qparams, layers=1), **kw)
    with GenerationBatcher(full) as bat:
        got = _drive(bat, cases[:3])
    checked, total = _compare(
        qparams, cases[:3], got,
        [_oracle(qparams, p, n, "int8") for p, n in cases[:3]], "int8")
    assert checked >= 0.9 * total


def _post(base, body, timeout=120):
    req = urllib.request.Request(f"{base}/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def test_http_generate_through_the_speculate_k_flag():
    """The server's --speculate-k / --draft-layers / --quant-weights
    flags build a speculating engine over the int8 trunk; /v1/generate
    streams from it equal the quantized lm_generate up to margin."""
    args = server.parse_args(["--device", "cpu", "--slots", str(SLOTS),
                              "--max-len", str(MAX_LEN), "--prefill-chunk",
                              str(CHUNK), "--speculate-k", "2",
                              "--draft-layers", "1", "--quant-weights", "1",
                              "--max-tokens", "6"])
    assert (args.speculate_k, args.draft_layers, args.quant_weights) \
        == (2, 1, 1)
    defaults = server.parse_args([])
    assert (defaults.speculate_k, defaults.draft_layers,
            defaults.quant_weights) == (0, 1, 0)
    gen = server.batcher_from_args(args, vocab=VOCAB, d_model=D_MODEL,
                                   num_heads=HEADS, dff=DFF, layers=LAYERS)
    eng = gen.engine
    assert eng.speculating and len(eng.draft.params["enc"]) == 1
    assert qw.is_quantized_leaf(eng.params["src_emb"])
    assert eng.draft.params["src_emb"]["q"] is eng.params["src_emb"]["q"]
    httpd = make_server(None, gen_batcher=gen)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.port}"
    rng = np.random.RandomState(8)
    cases = [(_prompt(rng, n), 6) for n in (3, 11, 7)]
    try:
        outs = []
        for i, (prompt, _n) in enumerate(cases):
            status, raw = _post(base, {"prompt": prompt.tolist(),
                                       "stream": i == 1})
            assert status == 200
            if i == 1:
                lines = [json.loads(ln) for ln in raw.decode().splitlines()]
                outs.append([ln["token"] for ln in lines if "token" in ln])
            else:
                outs.append(json.loads(raw)["tokens"])
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        gen.close()
    assert f"{gen.metrics.name}_speculate_k 2" in text
    checked, total = _compare(
        eng.params, cases, outs,
        [_oracle(eng.params, p, n) for p, n in cases])
    assert checked >= 0.9 * total
