"""The port's decoder-only LM trunk (paddle_tpu_torch.models.transformer)
against the JAX package's on the SAME weights (``params_from_numpy``),
on the CPU, where both sides take their plain attention paths.

Tolerances: float32 on both sides, sums in different orders through two
layers — hidden states, K/V and logits agree to ~3e-7 at these widths;
1e-4 absolute bounds them.  Greedy tokens are compared across frameworks
only while the JAX reference's top-1/top-2 logit margin exceeds MARGIN
(30x the logit difference), and the test asserts that most generated
tokens were compared.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.quant.weights import quantize_lm
from paddle_tpu_torch.models import transformer as torch_tf

VOCAB, D_MODEL, LAYERS, HEADS, DFF, MAX_LEN = 64, 32, 2, 2, 64, 48
TOL = 1e-4
MARGIN = 1e-5

CONFIGS = {
    "learned": dict(d_model=D_MODEL, num_heads=HEADS),
    "rope": dict(d_model=D_MODEL, num_heads=HEADS, pos_type="rope"),
    "gqa": dict(d_model=64, num_heads=4, num_kv_heads=2),
}


def _jax_params(name, seed=0):
    cfg = dict(CONFIGS[name])
    return cfg, jax_tf.init(jax.random.PRNGKey(seed), src_vocab=VOCAB,
                            trg_vocab=1, dff=DFF, enc_layers=LAYERS,
                            dec_layers=0, max_len=MAX_LEN, **cfg)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(num_heads, pos_type, JAX params, port params on the CPU)."""
    cfg, jp = _jax_params(request.param)
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    return cfg["num_heads"], cfg.get("pos_type", "learned"), jp, tp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _caches_close(got, want):
    for g, w in zip(got, want):
        _close(g["k"].numpy(), w["k"])
        _close(g["v"].numpy(), w["v"])


def test_params_from_numpy_round_trip_and_rejections():
    _cfg, jp = _jax_params("learned")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = torch_tf.params_from_numpy(tree, device="cpu")
    assert set(tp) == {"src_emb", "pos", "enc", "ln_f"}
    assert tp["src_emb"].dtype == torch.float32
    np.testing.assert_array_equal(tp["src_emb"].numpy(), tree["src_emb"])
    np.testing.assert_array_equal(tp["pos"].numpy(), tree["pos"])
    np.testing.assert_array_equal(tp["ln_f"]["g"].numpy(),
                                  tree["ln_f"]["g"])
    for got, want in zip(tp["enc"], tree["enc"]):
        for part in ("ln1", "attn", "ln2", "ffn"):
            assert set(got[part]) == set(want[part])
            for key in want[part]:
                np.testing.assert_array_equal(got[part][key].numpy(),
                                              want[part][key])
    with pytest.raises(ValueError, match="decoder"):
        torch_tf.params_from_numpy(dict(tree, dec=[tree["enc"][0]]),
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_tf.params_from_numpy(
            dict(tree, enc=[dict(tree["enc"][0], moe={})]), device="cpu")
    # an int8 tree round-trips: codes int8 and scales float32, bit for bit
    q = jax.tree_util.tree_map(np.asarray, quantize_lm(jp, min_size=64))
    tq = torch_tf.params_from_numpy(q, device="cpu")
    for got, want in ((tq["src_emb"], q["src_emb"]),
                      (tq["enc"][0]["attn"]["wq"], q["enc"][0]["attn"]["wq"]),
                      (tq["enc"][1]["ffn"]["w1"], q["enc"][1]["ffn"]["w1"])):
        assert set(got) == {"q", "s"}
        assert got["q"].dtype == torch.int8
        assert got["s"].dtype == torch.float32
        np.testing.assert_array_equal(got["q"].numpy(), want["q"])
        np.testing.assert_array_equal(got["s"].numpy(), want["s"])
    np.testing.assert_array_equal(tq["pos"].numpy(), q["pos"])


def test_prefill_then_decode_step_match_jax(pair, np_rng):
    heads, pos_type, jp, tp = pair
    prompt = np_rng.randint(1, VOCAB, (3, 9)).astype(np.int32)
    jh, jc = jax_tf.lm_prefill(jp, jnp.asarray(prompt), MAX_LEN, heads,
                               pos_type=pos_type)
    th, tc = torch_tf.lm_prefill(tp, prompt, MAX_LEN, heads,
                                 pos_type=pos_type)
    _close(th.numpy(), jh)
    _caches_close(tc, jc)
    nxt = np_rng.randint(1, VOCAB, 3).astype(np.int32)
    jl, jc = jax_tf.lm_decode_step(jp, jnp.asarray(nxt), 9, jc, heads,
                                   pos_type=pos_type)
    tl, tc = torch_tf.lm_decode_step(tp, nxt, 9, tc, heads,
                                     pos_type=pos_type)
    _close(tl.numpy(), jl)
    _caches_close(tc, jc)


@pytest.mark.parametrize("all_lanes", [False, True])
def test_chunk_step_matches_jax(pair, np_rng, all_lanes):
    """Two steps over a slab that mixes decode rows, full chunks and
    ragged chunk tails.  With all_lanes, only each row's fed lanes are
    compared: a decode row's dead lanes attend to the kernel contract's
    zeros in the port and to a repeat of lane 0 in JAX's masked path."""
    heads, pos_type, jp, tp = pair
    s, kk = 4, 4
    jc = jax_tf.init_lm_cache(jp, s, MAX_LEN)
    tc = torch_tf.init_lm_cache(tp, s, MAX_LEN)
    pos = np.asarray([0, 0, 5, 20], np.int32)
    for lens in ([4, 1, 3, 2], [1, 4, 2, 1]):
        lens = np.asarray(lens, np.int32)
        toks = np_rng.randint(1, VOCAB, (s, kk)).astype(np.int32)
        jl, jc = jax_tf.lm_decode_chunk_slots(
            jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(lens), jc,
            heads, pos_type=pos_type, all_lanes=all_lanes)
        tl, tc = torch_tf.lm_decode_chunk_slots(
            tp, toks, pos, lens, tc, heads, pos_type=pos_type,
            all_lanes=all_lanes)
        if all_lanes:
            fed = np.arange(kk)[None] < lens[:, None]
            _close(tl.numpy()[fed], np.asarray(jl)[fed])
        else:
            _close(tl.numpy(), jl)
        _caches_close(tc, jc)
        pos = pos + lens


def test_chunk_fed_cache_matches_own_prefill(pair, np_rng):
    """The port's two ingestion paths: a prompt fed through the chunk
    step K lanes at a time leaves the cache its own lm_prefill writes,
    and the last chunk's logits are the prefill's last position's."""
    heads, pos_type, _jp, tp = pair
    n, kk = 11, 4
    prompt = np_rng.randint(1, VOCAB, n).astype(np.int32)
    hidden, want = torch_tf.lm_prefill(tp, prompt[None], MAX_LEN, heads,
                                       pos_type=pos_type)
    cache = torch_tf.init_lm_cache(tp, 1, MAX_LEN)
    for start in range(0, n, kk):
        chunk = prompt[start:start + kk]
        toks = np.zeros((1, kk), np.int32)
        toks[0, :chunk.size] = chunk
        logits, cache = torch_tf.lm_decode_chunk_slots(
            tp, toks, [start], [chunk.size], cache, heads,
            pos_type=pos_type)
    for g, w in zip(cache, want):
        _close(g["k"][:, :n].numpy(), w["k"][:, :n].numpy())
        _close(g["v"][:, :n].numpy(), w["v"][:, :n].numpy())
    _close(logits.numpy(),
           torch_tf._lm_project(tp, hidden[:, -1]).numpy())


def _margins_jax(jp, ids, heads, pos_type):
    hidden, _ = jax_tf.lm_prefill(jp, jnp.asarray(ids), ids.shape[1], heads,
                                  pos_type=pos_type)
    top2 = np.sort(np.asarray(jax_tf._lm_project(jp, hidden)), axis=-1)
    return top2[..., -1] - top2[..., -2]


def test_generate_greedy_matches_jax_on_ragged_prompts(pair, np_rng):
    heads, pos_type, jp, tp = pair
    lengths = np.asarray([3, 9, 6], np.int32)
    prompt = np_rng.randint(1, VOCAB, (3, 9)).astype(np.int32)
    free = np.asarray(jax_tf.lm_generate(
        jp, prompt, 32, heads, prompt_lengths=lengths, pos_type=pos_type))
    eos = int(free[0, lengths[0] + 3])      # a token row 0 generates
    want = np.asarray(jax_tf.lm_generate(
        jp, prompt, 32, heads, prompt_lengths=lengths, eos_id=eos,
        pos_type=pos_type))
    got = torch_tf.lm_generate(tp, prompt, 32, heads,
                               prompt_lengths=lengths, eos_id=eos,
                               pos_type=pos_type).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 32)
    for r, n in enumerate(lengths):
        np.testing.assert_array_equal(got[r, :n], prompt[r, :n])
    assert (want[0, lengths[0] + 3:] == eos).all()      # pinned after eos
    marg = _margins_jax(jp, want, heads, pos_type)
    checked = 0
    for r, n in enumerate(lengths):
        for t in range(n, 32):
            if marg[r, t - 1] < MARGIN:
                break
            assert got[r, t] == want[r, t], (r, t)
            checked += 1
    assert checked >= (32 * 3 - lengths.sum()) // 2


def test_generate_sampling_contract():
    _cfg, jp = _jax_params("learned")
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    prompt = np.asarray([[5, 6, 7, 8]], np.int32)
    with pytest.raises(ValueError, match="generator"):
        torch_tf.lm_generate(tp, prompt, 12, HEADS, temperature=1.0)
    with pytest.raises(ValueError, match="top_k"):
        torch_tf.lm_generate(tp, prompt, 12, HEADS, temperature=1.0,
                             top_k=VOCAB + 1,
                             generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="exceeds the positional table"):
        torch_tf.lm_generate(tp, prompt, MAX_LEN + 1, HEADS)
    # top_k=1 leaves one candidate: sampling reproduces greedy exactly
    greedy = torch_tf.lm_generate(tp, prompt, 20, HEADS)
    top1 = torch_tf.lm_generate(tp, prompt, 20, HEADS, temperature=0.7,
                                top_k=1,
                                generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    # same generator seed, same draws
    a, b = (torch_tf.lm_generate(tp, prompt, 20, HEADS, temperature=1.0,
                                 top_k=8,
                                 generator=torch.Generator().manual_seed(s))
            .numpy() for s in (11, 11))
    np.testing.assert_array_equal(a, b)
    assert (a[:, :4] == prompt).all() and a.min() >= 0 and a.max() < VOCAB


def test_init_lm_shapes_and_no_silent_cpu_fallback():
    gen = torch.Generator().manual_seed(0)
    p = torch_tf.init_lm(gen, VOCAB, 64, 4, DFF, LAYERS, MAX_LEN,
                         num_kv_heads=2, device="cpu")
    assert p["src_emb"].shape == (VOCAB, 64) and p["pos"].shape == (48, 64)
    assert p["enc"][0]["attn"]["wk"].shape == (64, 32)
    cache = torch_tf.init_lm_cache(p, 3, MAX_LEN)
    assert cache[0]["k"].shape == (3, MAX_LEN, 32)
    rope = torch_tf.init_lm(gen, VOCAB, 32, 2, DFF, 1, 8, pos_type="rope",
                            device="cpu")
    assert "pos" not in rope
    with pytest.raises(ValueError, match="kv_dtype"):
        torch_tf.init_lm_cache(p, 1, 8, kv_dtype="bf16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_tf.init_lm(gen, VOCAB, 32, 2, DFF, 1, 8)
