"""The port's int8 trunk weights (``paddle_tpu_torch/quant/weights.py``)
against the JAX package's (``paddle_tpu/quant/weights.py``) on the same
numpy weights, and the port's ``lm_*`` entry points over JAX's quantized
tree (carried across by ``params_from_numpy``) against JAX's.

Tolerances: int8 codes within 1 and scales within 1e-5 relative, as
``test_torch_quant.py`` holds the KV quantizer (the two libraries may
round ``w / s`` an ulp apart at a .5 boundary; observed: equal).  The
identity-scale round trip and a zero channel are held bit for bit.  The
model outputs are held at ``test_torch_lm.py``'s 1e-4: both sides
dequantize the same codes and scales to the same float32 weights, then
sum in different orders.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import export as jax_export
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.quant import weights as jax_qw
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.quant import weights as qw

VOCAB, DFF, LAYERS, MAX_LEN, BS, K = 64, 64, 2, 48, 4, 4
TOL = 1e-4
CONFIGS = {
    "learned": dict(d_model=32, num_heads=2),
    "gqa_rope": dict(d_model=64, num_heads=4, num_kv_heads=2,
                     pos_type="rope"),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    """A numpy tree (quantized leaves included) as CPU tensors, dtypes
    kept."""
    return qw.map_leaves(
        lambda l: ({k: torch.tensor(np.asarray(v)) for k, v in l.items()}
                   if qw.is_quantized_leaf(l) else torch.tensor(l)), tree)


def _leaf_close(got, want):
    np.testing.assert_array_less(
        np.abs(got["q"].numpy().astype(np.int32)
               - np.asarray(want["q"]).astype(np.int32)), 2)
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]),
                               rtol=1e-5, atol=0)


def _tree_close(got, want):
    """Quantized leaves within the codes / scales tolerance, float leaves
    bit for bit (they pass through)."""
    if qw.is_quantized_leaf(got):
        assert jax_qw.is_quantized_leaf(want)
        _leaf_close(got, want)
    elif isinstance(got, dict):
        assert set(got) == set(want)
        for key in got:
            _tree_close(got[key], want[key])
    elif isinstance(got, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w)
    else:
        assert not jax_qw.is_quantized_leaf(want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def trunk(request):
    """(config, JAX float params, the same as numpy)."""
    cfg = CONFIGS[request.param]
    jp = jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                     dff=DFF, enc_layers=LAYERS, dec_layers=0,
                     max_len=MAX_LEN, **cfg)
    return cfg, jp, _np(jp)


# ------------------------------------------------------------ the scheme


@pytest.mark.parametrize("shape", [(32, 64), (64, 7), (3, 5, 16), (40,)])
def test_quantize_leaf_matches_jax(shape):
    rng = np.random.RandomState(len(shape) + shape[-1])
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3, shape[-1])
         ).astype(np.float32)
    got = qw.quantize_leaf(torch.tensor(w))
    want = jax_qw.quantize_leaf(jnp.asarray(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["s"].shape) == np.asarray(want["s"]).shape
    _leaf_close(got, want)
    np.testing.assert_allclose(qw.dequantize_leaf(got).numpy(),
                               np.asarray(jax_qw.dequantize_leaf(want)),
                               rtol=1e-5, atol=np.asarray(want["s"]).max())
    # an explicit axis (scales over axis 0 only) as JAX
    if len(shape) == 3:
        _leaf_close(qw.quantize_leaf(torch.tensor(w), axis=(0,)),
                    jax_qw.quantize_leaf(jnp.asarray(w), axis=(0,)))


def test_identity_scale_round_trip_and_zero_channel_bit_for_bit():
    """Integer values in [-127, 127] with every channel reaching 127:
    scale 1, codes the values, the round trip exact; a zero channel
    quantizes to zeros at scale 0 and dequantizes to exact zeros."""
    rng = np.random.RandomState(3)
    w = rng.randint(-127, 128, (24, 6)).astype(np.float32)
    w[0] = 127.0
    w[:, 4] = 0.0
    w[0, 4] = 0.0
    leaf = qw.quantize_leaf(torch.tensor(w))
    s = leaf["s"].numpy()[0]
    assert (s[np.arange(6) != 4] == 1.0).all() and s[4] == 0.0
    np.testing.assert_array_equal(leaf["q"].numpy(), w.astype(np.int8))
    np.testing.assert_array_equal(qw.dequantize_leaf(leaf).numpy(), w)
    want = jax_qw.quantize_leaf(jnp.asarray(w))
    np.testing.assert_array_equal(leaf["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(s, np.asarray(want["s"])[0])
    # half-to-even rounding at the .5 boundaries, as jnp.round
    half = np.asarray([[0.5, 1.5, -2.5, 127.0]], np.float32)
    np.testing.assert_array_equal(
        qw.quantize_leaf(torch.tensor(half))["q"].numpy(),
        np.asarray(jax_qw.quantize_leaf(jnp.asarray(half))["q"]))


@pytest.mark.parametrize("min_size", [64, 1024, 10 ** 6])
def test_quantize_lm_and_tree_match_jax(trunk, min_size):
    """Which leaves quantize (2-D float32 of >= min_size elements; the
    positional table never in quantize_lm, by size in quantize_tree),
    the codes and scales, and the shape / byte accounting."""
    _cfg, jp, tree = trunk
    for ours, theirs in ((qw.quantize_lm, jax_qw.quantize_lm),
                         (qw.quantize_tree, jax_qw.quantize_tree)):
        got = ours(_torch(tree), min_size=min_size)
        want = _np(theirs(jp, min_size=min_size))
        _tree_close(got, want)
        assert qw.quantized_weight_shapes(got) \
            == jax_qw.quantized_weight_shapes(want)
        assert qw.float_leaf_shapes(got) == jax_qw.float_leaf_shapes(want)
        assert qw.param_bytes(got) == jax_qw.param_bytes(want)
        assert qw.is_quantized_tree(got) == jax_qw.is_quantized_tree(want)
    if "pos" in tree:
        lm = qw.quantize_lm(_torch(tree), min_size=64)
        assert not qw.is_quantized_leaf(lm["pos"])
        np.testing.assert_array_equal(lm["pos"].numpy(), tree["pos"])
        assert qw.is_quantized_leaf(
            qw.quantize_tree(_torch(tree), min_size=64)["pos"])
    assert qw.TRAIN_LOSS_BUDGET == jax_qw.TRAIN_LOSS_BUDGET


def test_dequant_tree_and_maybe_dequant(trunk):
    _cfg, jp, tree = trunk
    q = qw.quantize_lm(_torch(tree), min_size=64)
    want = _np(jax_qw.dequant_tree(jax_qw.quantize_lm(jp, min_size=64)))
    got = qw.maybe_dequant(q)
    assert not qw.is_quantized_tree(got)
    for g, w in zip(jax.tree_util.tree_leaves(
            torch_tf.tree_map(lambda t: t.numpy(), got)),
            jax.tree_util.tree_leaves(want)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # a float tree passes through: the same tensors
    f = _torch(tree)
    assert qw.maybe_dequant(f) is f
    assert qw.dequant_tree(f)["src_emb"] is f["src_emb"]


def test_both_leaf_formats():
    """The JAX artifact format {"__int8__", "__scale__"} (export.
    quantize_params) reads everywhere the {"q", "s"} one does; a uint8
    payload is not a quantized leaf."""
    rng = np.random.RandomState(4)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    qtree, dequant = jax_export.quantize_params({"w": jnp.asarray(w)},
                                                min_size=16)
    leaf = _torch(_np(qtree))["w"]
    assert set(leaf) == {"__int8__", "__scale__"}
    assert qw.is_quantized_leaf(leaf) and qw.is_quantized_tree({"a": leaf})
    assert qw.weight_shape(leaf) == (40, 24)
    np.testing.assert_allclose(qw.dequantize_leaf(leaf).numpy(),
                               np.asarray(dequant(qtree)["w"]), rtol=1e-6)
    assert qw.param_bytes({"w": leaf}) == jax_qw.param_bytes(_np(qtree))
    assert not qw.is_quantized_leaf(
        {"q": torch.zeros(2, 2, dtype=torch.uint8), "s": torch.ones(1, 2)})


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def qpair(trunk):
    """(heads, pos_type, JAX quantized params, the port's from them)."""
    cfg, jp, _tree = trunk
    jq = jax_qw.quantize_lm(jp, min_size=64)
    tq = torch_tf.params_from_numpy(_np(jq), device="cpu")
    return cfg["num_heads"], cfg.get("pos_type", "learned"), jq, tq


def test_params_from_numpy_keeps_codes_and_scales(qpair):
    _heads, _pos, jq, tq = qpair
    want = _np(jq)
    for got, ref in ((tq["src_emb"], want["src_emb"]),
                     (tq["enc"][1]["ffn"]["w2"], want["enc"][1]["ffn"]["w2"])):
        assert got["q"].dtype == torch.int8
        assert got["s"].dtype == torch.float32 and got["s"].dim() == 2
        np.testing.assert_array_equal(got["q"].numpy(), ref["q"])
        np.testing.assert_array_equal(got["s"].numpy(), ref["s"])


def test_prefill_and_chunk_steps_over_the_quantized_tree_match_jax(
        qpair, np_rng):
    """lm_prefill, then two slab chunk steps (one all lanes) and two
    paged chunk steps over JAX's int8 tree, against JAX's."""
    heads, pos_type, jq, tq = qpair
    prompt = np_rng.randint(1, VOCAB, (3, 9)).astype(np.int32)
    jh, _ = jax_tf.lm_prefill(jq, jnp.asarray(prompt), MAX_LEN, heads,
                              pos_type=pos_type)
    th, _ = torch_tf.lm_prefill(tq, prompt, MAX_LEN, heads,
                                pos_type=pos_type)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        torch_tf._lm_project(tq, th).numpy(),
        np.asarray(jax_tf._lm_project(jq, jh)), atol=TOL, rtol=TOL)
    s = 4
    jc = jax_tf.init_lm_cache(jq, s, MAX_LEN)
    tc = torch_tf.init_lm_cache(tq, s, MAX_LEN)
    assert tc[0]["k"].dtype == torch.float32
    tables = np.zeros((s, MAX_LEN // BS), np.int32)
    tables[:, :5] = 1 + np.arange(s * 5).reshape(s, 5)
    jpc = jax_tf.init_lm_cache_paged(jq, 1 + s * 5, BS, max_len=MAX_LEN)
    tpc = torch_tf.init_lm_cache_paged(tq, 1 + s * 5, BS, max_len=MAX_LEN)
    pos = np.asarray([0, 3, 5, 9], np.int32)
    for lens, all_lanes in (([4, 1, 3, 2], False), ([1, 4, 2, 1], True)):
        lens = np.asarray(lens, np.int32)
        toks = np_rng.randint(1, VOCAB, (s, K)).astype(np.int32)
        fed = (np.arange(K)[None] < lens[:, None]) if all_lanes else ...
        args = tuple(map(jnp.asarray, (toks, pos, lens)))
        jl, jc = jax_tf.lm_decode_chunk_slots(
            jq, *args, jc, heads, pos_type=pos_type, all_lanes=all_lanes)
        tl, tc = torch_tf.lm_decode_chunk_slots(
            tq, toks, pos, lens, tc, heads, pos_type=pos_type,
            all_lanes=all_lanes)
        np.testing.assert_allclose(tl.numpy()[fed], np.asarray(jl)[fed],
                                   atol=TOL, rtol=TOL)
        jl, jpc = jax_tf.lm_decode_chunk_paged(
            jq, *args, jpc, jnp.asarray(tables), heads, pos_type=pos_type,
            all_lanes=all_lanes)
        tl, tpc = torch_tf.lm_decode_chunk_paged(
            tq, toks, pos, lens, tpc, tables, heads, pos_type=pos_type,
            all_lanes=all_lanes)
        np.testing.assert_allclose(tl.numpy()[fed], np.asarray(jl)[fed],
                                   atol=TOL, rtol=TOL)
        for g, w in zip(tpc, jpc):
            np.testing.assert_allclose(g["k"].numpy()[1:],
                                       np.asarray(w["k"])[1:], atol=TOL,
                                       rtol=TOL)
        pos = pos + lens


def test_generate_and_logits_over_the_quantized_tree_match_jax(qpair):
    """Greedy lm_generate (up to the first top-1/top-2 margin below
    1e-5, as test_torch_lm.py) and full-sequence lm_logits."""
    heads, pos_type, jq, tq = qpair
    prompt = np.asarray([[5, 9, 2, 7, 11, 3]], np.int32)
    want = np.asarray(jax_tf.lm_generate(jq, prompt, 24, heads,
                                         pos_type=pos_type))
    got = torch_tf.lm_generate(tq, prompt, 24, heads,
                               pos_type=pos_type).numpy()
    hidden, _ = jax_tf.lm_prefill(jq, jnp.asarray(want), 24, heads,
                                  pos_type=pos_type)
    top2 = np.sort(np.asarray(jax_tf._lm_project(jq, hidden)), -1)
    marg = top2[0, :, -1] - top2[0, :, -2]
    checked = 0
    for t in range(6, 24):
        if marg[t - 1] < 1e-5:
            break
        assert got[0, t] == want[0, t], t
        checked += 1
    assert checked >= 9
    from paddle_tpu.core.sequence import SequenceBatch as JSeq
    from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
    ids = np.asarray(want[:, :16])
    lens = np.asarray([16], np.int32)
    jlog = jax_tf.lm_logits(jq, JSeq(jnp.asarray(ids), jnp.asarray(lens)),
                            heads, pos_type=pos_type)
    tlog = torch_tf.lm_logits(tq, TSeq(torch.tensor(ids),
                                       torch.tensor(lens)), heads,
                              pos_type=pos_type)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)


# ------------------------------------------------ full width: the witness


def full_width_readings(seeds=(0,)):
    """chip_smoke.py's serve_w8 prefill on the CPU: its LM's weights
    (``init_lm`` from seed 0, drawn on the CPU) and ``w8_prompt(seed)``
    for each seed.  Per stream, the max |logit error| of the int8 tree's
    prefill against the float32 tree's, for the port and for the JAX
    package on the same numpy weights; and the two int8 trees."""
    import chip_smoke as cs
    params = torch_tf.init_lm(torch.Generator().manual_seed(0), cs.VOCAB,
                              cs.D_MODEL, cs.HEADS, cs.DFF, cs.LAYERS,
                              cs.SERVE_MAX_LEN, device="cpu")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    tq, jq = qw.quantize_lm(params), jax_qw.quantize_lm(jp)
    out = {}
    for seed in seeds:
        prompt = cs.w8_prompt(seed)
        errs = []
        for tf, p, p8, tensor in ((torch_tf, params, tq, torch.tensor),
                                  (jax_tf, jp, jq, jnp.asarray)):
            logits = [tf._lm_project(t, tf.lm_prefill(
                t, tensor(prompt), cs.GEN_PROMPT, cs.HEADS)[0])
                for t in (p, p8)]
            errs.append(np.abs(np.asarray(logits[0], np.float32)
                               - np.asarray(logits[1], np.float32)
                               ).max(axis=(-2, -1)))
        out[seed] = tuple(errs)
    return out, tq, jq


def test_full_width_prefill_logit_err_matches_jax():
    """At chip_smoke.py's full width (vocab 32000, D 512, 6 layers) the
    port's int8 trunk reads the JAX package's logit error per stream
    (within 1e-5) from codes and scales within the leaf tolerance: the
    CPU witness serve_w8 holds the card to."""
    readings, tq, jq = full_width_readings()
    _tree_close(tq, _np(jq))
    ours, theirs = readings[0]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    assert (ours > 0.01).all(), ours


if __name__ == "__main__":
    # The witness behind PERF.md's serve_w8 numbers and ROADMAP C6:
    # PYTHONPATH=. python tests/test_torch_quant_weights.py
    import json
    jax.config.update("jax_platforms", "cpu")
    readings, _, _ = full_width_readings(seeds=(0, 1, 2, 3))
    from paddle_tpu.quant import kv as jax_kvq
    print(json.dumps({"budget": jax_kvq.LOGIT_ERR_BUDGET, "streams": {
        seed: {"port": ours.tolist(), "jax": theirs.tolist()}
        for seed, (ours, theirs) in readings.items()}}))
