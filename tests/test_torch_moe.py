"""The port's mixture-of-experts slice (``ops/moe.py``, the MoE blocks of
``models/transformer.py``, ``layers/api.moe_layer``) against the JAX
package on the CPU, on the same weights (``params_from_numpy``) and
inputs from a seed.

Config: vocab 50, d_model 32, 2 heads, dff 64, 2 layers, 4 experts, top
2, T <= 24.  Tolerances: float32 on both sides, sums in other orders —
values at rtol 1e-5 (atol 1e-6 where a value may sit near 0), every
gradient leaf within 1e-5 of its largest magnitude (the experts' ReLU
and top-2 choices are decisions; at these seeds no pre-activation or
router probability lies within rounding of its kink, so both sides take
the same ones).  Gates and the tied-row choice are compared exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu.core.sequence import SequenceBatch as JaxBatch
from paddle_tpu.core.sequence import pack_sequences as jax_pack
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops import moe as jax_moe
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core.sequence import SequenceBatch, pack_sequences
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.ops import moe
from paddle_tpu_torch.serving import DecodeEngine, GenerationBatcher
from paddle_tpu_torch.utils.tree import tree_leaves

VOCAB, D_MODEL, HEADS, DFF, LAYERS, EXPERTS, TOP_K = 50, 32, 2, 64, 2, 4, 2
MAX_LEN = 32
RTOL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-5
MARGIN = 1e-5


@pytest.fixture(scope="module")
def moe_trunk():
    """(JAX MoE LM params, the numpy tree)."""
    jp = jax_tf.init(jax.random.PRNGKey(3), src_vocab=VOCAB, trg_vocab=1,
                     d_model=D_MODEL, num_heads=HEADS, dff=DFF,
                     enc_layers=LAYERS, dec_layers=0, max_len=MAX_LEN,
                     moe_experts=EXPERTS)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _port(tree, grad=False):
    tp = torch_tf.params_from_numpy(tree, device="cpu")
    if grad:
        for p in tree_leaves(tp):
            p.requires_grad_(True)
    return tp


def _close_grads(got_tree, want_tree):
    got = [p.grad.numpy() for p in tree_leaves(got_tree)]
    # the LM tree drops JAX's unused trg_emb / out leaves
    want = jax.tree_util.tree_leaves(
        {k: v for k, v in want_tree.items() if k in got_tree})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_REL * max(np.abs(w).max(), 1e-30)


def test_router_gates_and_aux_match_jax(np_rng):
    x = np_rng.randn(3, 7, D_MODEL).astype(np.float32)
    wg = (np_rng.randn(D_MODEL, EXPERTS) * 0.3).astype(np.float32)
    jprobs = jax_moe.router_probs(jnp.asarray(x), jnp.asarray(wg))
    probs = moe.router_probs(torch.tensor(x), torch.tensor(wg))
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=RTOL, atol=ATOL)
    # the gates of the same probs, exactly: the kept set is a decision
    jgates = jax_moe.moe_gates(jnp.asarray(probs.numpy()), TOP_K)
    gates = moe.moe_gates(probs, TOP_K)
    np.testing.assert_array_equal(gates.numpy() > 0, np.asarray(jgates) > 0)
    np.testing.assert_allclose(gates.numpy(), jgates, rtol=RTOL)
    assert ((gates > 0).sum(-1) == TOP_K).all()
    assert moe.moe_gates(probs, EXPERTS) is probs     # top_k >= E
    valid = np_rng.rand(3, 7) > 0.3
    for v in (None, valid):
        want = jax_moe.aux_load_balance_loss(
            jnp.asarray(probs.numpy()), jnp.asarray(gates.numpy()), TOP_K,
            None if v is None else jnp.asarray(v))
        got = moe.aux_load_balance_loss(
            probs, gates, TOP_K, None if v is None else torch.tensor(v))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_tied_router_rows_keep_the_lower_indices():
    """EXACTLY top_k experts on ties, the lower index first, as
    jax.lax.top_k keeps it."""
    rows = np.asarray([[0.25, 0.25, 0.25, 0.25],
                       [0.1, 0.3, 0.3, 0.3],
                       [0.2, 0.2, 0.4, 0.2],
                       [0.0, 0.5, 0.0, 0.5]], np.float32)
    want = np.asarray(jax_moe.moe_gates(jnp.asarray(rows), TOP_K))
    got = moe.moe_gates(torch.tensor(rows), TOP_K).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert (got > 0).tolist() == [[True, True, False, False],
                                  [False, True, True, False],
                                  [True, False, True, False],
                                  [False, True, False, True]]


def test_moe_ffn_forward_and_grads_match_jax(np_rng):
    """moe_ffn with its default activation (jax.nn.gelu, the tanh
    approximation) and the aux: values and gradients of a weighted sum
    with respect to x and every expert weight."""
    jparams = jax_moe.init_moe(jax.random.PRNGKey(1), D_MODEL, DFF, EXPERTS)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    x = np_rng.randn(2, 9, D_MODEL).astype(np.float32)
    cot = np_rng.randn(2, 9, D_MODEL).astype(np.float32)
    valid = np_rng.rand(2, 9) > 0.2

    def jloss(p, xx):
        out, aux = jax_moe.moe_ffn(xx, p, TOP_K, return_aux=True,
                                   valid=jnp.asarray(valid))
        return jnp.sum(out * cot) + aux, (out, aux)

    (jl, (jout, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_ffn(tx, tp, TOP_K, return_aux=True,
                           valid=torch.tensor(valid))
    loss = (out * torch.tensor(cot)).sum() + aux
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=RTOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    for key in ("wg", "w1", "w2"):
        w = np.asarray(jg[key])
        assert np.abs(tp[key].grad.numpy() - w).max() \
            <= GRAD_REL * np.abs(w).max(), key
    gx = np.asarray(jgx)
    assert np.abs(tx.grad.numpy() - gx).max() <= GRAD_REL * np.abs(gx).max()


def test_init_and_params_from_numpy_carry_moe_blocks(moe_trunk):
    _jp, tree = moe_trunk
    tp = _port(tree)
    for got, want in zip(tp["enc"], tree["enc"]):
        assert set(got) == {"ln1", "attn", "ln2", "moe"}
        assert set(got["moe"]) == {"wg", "w1", "w2"}
        assert got["moe"]["wg"].shape == (D_MODEL, EXPERTS)
        assert got["moe"]["w1"].shape == (EXPERTS, D_MODEL, DFF)
        assert got["moe"]["w2"].shape == (EXPERTS, DFF, D_MODEL)
        for key in ("wg", "w1", "w2"):
            np.testing.assert_array_equal(got["moe"][key].numpy(),
                                          want["moe"][key])
    own = torch_tf.init_lm(torch.Generator().manual_seed(0), VOCAB, D_MODEL,
                           HEADS, DFF, LAYERS, MAX_LEN, moe_experts=EXPERTS,
                           device="cpu")
    assert [set(b) for b in own["enc"]] == [{"ln1", "attn", "ln2", "moe"}] \
        * LAYERS
    assert [tuple(own["enc"][0]["moe"][k].shape) for k in ("wg", "w1", "w2")] \
        == [tuple(tree["enc"][0]["moe"][k].shape) for k in ("wg", "w1", "w2")]
    mt = torch_tf.init(torch.Generator().manual_seed(0), src_vocab=VOCAB,
                       trg_vocab=VOCAB, d_model=D_MODEL, num_heads=HEADS,
                       dff=DFF, enc_layers=1, dec_layers=1, max_len=MAX_LEN,
                       moe_experts=EXPERTS, device="cpu")
    assert "moe" in mt["enc"][0] and "ffn" in mt["dec"][0]
    with pytest.raises(ValueError, match="exactly one"):
        torch_tf.params_from_numpy(dict(tree, enc=[dict(
            tree["enc"][0], ffn={})]), device="cpu")


def _padded(np_rng):
    ids = np_rng.randint(3, VOCAB, (3, 20)).astype(np.int32)
    lengths = np.asarray([20, 13, 6], np.int32)
    return (JaxBatch(jnp.asarray(ids), jnp.asarray(lengths)),
            SequenceBatch(torch.tensor(ids), torch.tensor(lengths)))


def _packed(seed):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(3, VOCAB, n) for n in (9, 5, 14, 3, 7, 11, 4)]
    data, seg, pos = pack_sequences(seqs, 24)
    jdata, jseg, jpos = jax_pack(seqs, 24)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(seg, jseg)
    np.testing.assert_array_equal(pos, jpos)
    lengths = np.full((data.shape[0],), 24, np.int32)
    return ((JaxBatch(jnp.asarray(data), jnp.asarray(lengths)),
             jnp.asarray(seg), jnp.asarray(pos)),
            (SequenceBatch(torch.tensor(data), torch.tensor(lengths)),
             torch.tensor(seg), torch.tensor(pos)))


@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_moe_lm_loss_and_grads_match_jax(moe_trunk, np_rng, layout):
    """lm_loss of the MoE trunk with its aux (weight 0.01): padded rows
    (the aux over the key mask's tokens) and packed rows (over the
    segments' tokens); loss and every gradient leaf."""
    jp, tree = moe_trunk
    if layout == "padded":
        jtok, ttok = _padded(np_rng)
        jkw, tkw = {}, {}
    else:
        (jtok, jseg, jpos), (ttok, tseg, tpos) = _packed(5)
        jkw = dict(segment_ids=jseg, positions=jpos)
        tkw = dict(segment_ids=tseg, positions=tpos)
    # jitted: JAX's eager dispatch of the MoE trunk's backward is slow
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_tf.lm_loss(
        p, jtok, HEADS, moe_top_k=TOP_K, **jkw)))(jp)
    jaux = jax.jit(lambda p: jax_tf.lm_logits(
        p, jtok, HEADS, return_aux=True, moe_top_k=TOP_K, **jkw)[1])(jp)
    tp = _port(tree, grad=True)
    loss = torch_tf.lm_loss(tp, ttok, HEADS, moe_top_k=TOP_K, **tkw)
    loss.backward()
    _, aux = torch_tf.lm_logits(tp, ttok, HEADS, return_aux=True,
                                moe_top_k=TOP_K, **tkw)
    aux = float(aux.detach())
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    np.testing.assert_allclose(aux, float(jaux), rtol=RTOL)
    assert aux > 0
    _close_grads(tp, jg)


def test_moe_mt_loss_adds_the_encoders_aux(moe_trunk, np_rng):
    """The seq2seq loss over MoE encoder blocks: cross-entropy plus the
    weighted aux, as JAX's loss."""
    jp = jax_tf.init(jax.random.PRNGKey(4), src_vocab=VOCAB, trg_vocab=VOCAB,
                     d_model=D_MODEL, num_heads=HEADS, dff=DFF, enc_layers=1,
                     dec_layers=1, max_len=MAX_LEN, moe_experts=EXPERTS)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    jsrc, tsrc = _padded(np_rng)
    jtrg, ttrg = _padded(np_rng)
    want = jax_tf.loss(jp, jsrc, jtrg, jtrg, HEADS, moe_aux_weight=0.5)
    got = torch_tf.loss(_port(tree), tsrc, ttrg, ttrg, HEADS,
                        moe_aux_weight=0.5)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_moe_lm_prefill_logits_match_jax(moe_trunk, np_rng):
    jp, tree = moe_trunk
    prompt = np_rng.randint(3, VOCAB, (2, 11)).astype(np.int32)
    jh, _ = jax_tf.lm_prefill(jp, jnp.asarray(prompt), MAX_LEN, HEADS,
                              moe_top_k=TOP_K)
    want = np.asarray(jax_tf._lm_project(jp, jh))
    tp = _port(tree)
    h, _ = torch_tf.lm_prefill(tp, prompt, MAX_LEN, HEADS, moe_top_k=TOP_K)
    got = torch_tf._lm_project(tp, h).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # top_k = 1 routes differently: the argument reaches the blocks
    h1, _ = torch_tf.lm_prefill(tp, prompt, MAX_LEN, HEADS, moe_top_k=1)
    assert not torch.equal(h1, h)


def test_engine_streams_over_an_moe_trunk_match_lm_generate(moe_trunk):
    """DecodeEngine (chunked slab and paged int8) over the MoE trunk,
    requests behind a GenerationBatcher: every stream equals the port's
    lm_generate (over the same KV dtype) up to its first top-1/top-2
    margin below MARGIN (the chunked step and prefill + decode step
    round apart by ulps); lm_generate equals JAX's."""
    jp, tree = moe_trunk
    tp = _port(tree)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in (3, 9, 14, 6, 11)]
    n_tok = 8
    jref = jax_tf.lm_generate(jp, jnp.asarray([prompts[1]]),
                              len(prompts[1]) + n_tok, HEADS)
    ref1 = torch_tf.lm_generate(tp, np.asarray([prompts[1]]),
                                len(prompts[1]) + n_tok, HEADS)
    np.testing.assert_array_equal(ref1.numpy(), np.asarray(jref))
    for kw in (dict(), dict(kv_layout="paged", kv_block_size=4,
                            kv_dtype="int8")):
        eng = DecodeEngine(tp, num_heads=HEADS, num_slots=3,
                           max_len=MAX_LEN, prefill_chunk=4, device="cpu",
                           **kw)
        with GenerationBatcher(eng, default_max_tokens=n_tok) as bat:
            futs = [bat.submit(p, max_tokens=n_tok) for p in prompts]
            outs = [f.result(timeout=120) for f in futs]
        checked = 0
        for p, out in zip(prompts, outs):
            kv = kw.get("kv_dtype")
            ref = torch_tf.lm_generate(tp, np.asarray([p]), len(p) + n_tok,
                                       HEADS, kv_dtype=kv)
            hidden, _ = torch_tf.lm_prefill(tp, ref, ref.shape[1], HEADS,
                                            kv_dtype=kv)
            top2 = torch.topk(torch_tf._lm_project(tp, hidden), 2, dim=-1)
            margin = (top2.values[0, :, 0] - top2.values[0, :, 1]).numpy()
            for t, tok in enumerate(out["tokens"]):
                if margin[len(p) - 1 + t] < MARGIN:
                    break
                assert tok == int(ref[0, len(p) + t]), (kw, p, t)
                checked += 1
        assert checked >= 0.9 * n_tok * len(prompts), (kw, checked)


def _moe_net(M):
    if M is JL:
        jax_reset_names()
    else:
        L.reset_names()
    x = M.data_layer("x", 12)
    h = M.fc_layer(x, size=16, act="tanh")
    return M.moe_layer(h, n_experts=EXPERTS, expert_dim=24, top_k=TOP_K)


def test_moe_layer_in_a_dsl_config_matches_jax(np_rng):
    """moe_layer after an fc layer: the JAX Topology's init carried into
    the port's, the same dense [B, D] feed (flattened to one row for
    moe_ffn and restored)."""
    jout = _moe_net(JL)
    jtopo = JL.Topology(jout)
    jparams = jtopo.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    x = np_rng.randn(5, 12).astype(np.float32)
    want = np.asarray(jtopo.apply(jparams, {"x": jnp.asarray(x)}))
    tout = _moe_net(L)
    ttopo = L.Topology(tout)
    assert ttopo.param_shapes() == {k: {n: tuple(a.shape) for n, a in
                                        v.items()} for k, v in tree.items()}
    tp = L.params_from_numpy(ttopo, tree, device="cpu")
    got = ttopo.apply(tp, {"x": torch.tensor(x)}).numpy()
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    own = ttopo.init(torch.Generator().manual_seed(0), device="cpu")
    assert {n: tuple(a.shape) for n, a in own[tout.name].items()} == {
        "wg": (16, EXPERTS), "w1": (EXPERTS, 16, 24), "w2": (EXPERTS, 24, 16)}


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    from paddle_tpu_torch.scripts import bench
    for call in (
            lambda: moe.init_moe(torch.Generator().manual_seed(0), 8, 16, 4),
            lambda: torch_tf.init_lm(torch.Generator().manual_seed(0), 10, 8,
                                     2, 8, 1, 4, moe_experts=4),
            lambda: bench.bench_transformer_moe(
                batch=1, seq_len=4, vocab=10, d_model=8, dff=8, layers=1,
                heads=2, experts=4),
            lambda: bench.bench_transformer_packed(
                batch=1, max_len=16, vocab=10, d_model=8, dff=8, layers=1,
                heads=2),
            lambda: bench.bench_trainer_int8(batch=2, n_batches=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = moe.init_moe(torch.Generator().manual_seed(0), 8, 16, 4,
                          device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "wg": (8, 4), "w1": (4, 8, 16), "w2": (4, 16, 8)}
