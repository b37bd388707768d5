"""The port's attention NMT slice (ops/attention's additive attention,
ops/beam.greedy_search, models/seq2seq, scripts/bench.bench_seq2seq)
against the JAX package's on identical numpy inputs, on the CPU (where
the GRU kernels take their plain versions).

The model runs at a width where JAX's fused GRU route holds (vocab 64,
emb = h = att = 128, B 8, source 6 / target 5 steps, one ragged row and
one short target row), once with JAX's fused route forced (the Pallas
kernels in interpret mode) and once with its scan; each JAX reference is
computed once for the module.

Tolerances: float32 on both sides.  The additive attention agrees to an
ulp or two (1e-6 relative, 1e-6 absolute); results that pass through the
GRU recurrences, the decoder loop and the matrix products sum in
different orders and are held at rtol 2e-4, atol 2e-5 as
tests/test_pallas_gru.py:60 holds the JAX kernel to its scan; params and
momentum after three Momentum steps are held per leaf at 1e-4 of the
leaf's largest value.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.models import seq2seq as jax_seq2seq
from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.models import seq2seq
from paddle_tpu_torch.ops import attention
from paddle_tpu_torch.ops.kernels import gru as kgru
from paddle_tpu_torch.scripts import bench
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

RTOL, ATOL = 2e-4, 2e-5
EXACT = 1e-6
VOCAB, H, B, TS, TT = 64, 128, 8, 6, 5
SRC_LEN = np.asarray([6, 6, 3, 6, 1, 6, 5, 6], np.int32)
TRG_LEN = np.asarray([5, 5, 5, 2, 5, 5, 5, 4], np.int32)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _fused_route(fused):
    """JAX's GRU route: forced on (interpret mode) or off (the scan)."""
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always" if fused else "0"
    return prior


@functools.lru_cache(maxsize=None)
def _model():
    """JAX params (numpy) and a batch: ids from a seed, a ragged source
    row and short target rows."""
    tree = jax.tree_util.tree_map(np.asarray, jax_seq2seq.init(
        jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=VOCAB,
        emb_dim=H, hidden=H))
    rng = np.random.RandomState(7)
    src = rng.randint(3, VOCAB, (B, TS)).astype(np.int32)
    trg = rng.randint(3, VOCAB, (B, TT)).astype(np.int32)
    nxt = rng.randint(3, VOCAB, (B, TT)).astype(np.int32)
    return tree, src, trg, nxt


def _jax_batch():
    _, src, trg, nxt = _model()
    return (JaxSeq(jnp.asarray(src), jnp.asarray(SRC_LEN)),
            JaxSeq(jnp.asarray(trg), jnp.asarray(TRG_LEN)),
            JaxSeq(jnp.asarray(nxt), jnp.asarray(TRG_LEN)))


def _port_batch():
    _, src, trg, nxt = _model()
    return (SequenceBatch(torch.tensor(src), torch.tensor(SRC_LEN)),
            SequenceBatch(torch.tensor(trg), torch.tensor(TRG_LEN)),
            SequenceBatch(torch.tensor(nxt), torch.tensor(TRG_LEN)))


@functools.lru_cache(maxsize=None)
def _jax_reference(fused):
    """encode, forward logits, loss and gradients of the JAX model, once
    per route for the module (one jitted call: the route is read while
    it is traced)."""
    tree = _model()[0]
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    src, trg, nxt = _jax_batch()

    def loss_and_outputs(params):
        enc, proj, boot = jax_seq2seq.encode(params, src)
        logits = jax_seq2seq.forward(params, src, trg)
        return (jax_seq2seq.loss(params, src, trg, nxt),
                (enc.data, proj.data, boot, logits))

    prior = _fused_route(fused)
    try:
        (loss, outs), grads = jax.jit(jax.value_and_grad(
            loss_and_outputs, has_aux=True))(params)
    finally:
        jax_rnn.FUSED_LSTM = prior
    return {"enc": np.asarray(outs[0]), "proj": np.asarray(outs[1]),
            "boot": np.asarray(outs[2]), "logits": np.asarray(outs[3]),
            "loss": float(loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def test_additive_attention_matches_jax():
    rng = np.random.RandomState(1)
    b, t, a, d = 4, 7, 16, 24
    enc_proj = rng.randn(b, t, a).astype(np.float32)
    dec = rng.randn(b, a).astype(np.float32)
    v = rng.randn(a).astype(np.float32)
    values = rng.randn(b, t, d).astype(np.float32)
    lengths = np.asarray([7, 3, 1, 0], np.int32)     # masked tails, empty row
    jl = jnp.asarray(lengths)
    want_s = jax_attention.additive_attention_scores(
        JaxSeq(jnp.asarray(enc_proj), jl), jnp.asarray(dec), jnp.asarray(v))
    want_c = jax_attention.attention_context(want_s,
                                             JaxSeq(jnp.asarray(values), jl))
    tl = torch.tensor(lengths)
    got_s = attention.additive_attention_scores(
        SequenceBatch(torch.tensor(enc_proj), tl), torch.tensor(dec),
        torch.tensor(v))
    got_c = attention.attention_context(got_s, SequenceBatch(
        torch.tensor(values), tl))
    _close(got_s, want_s, "scores", rtol=EXACT, atol=EXACT)
    _close(got_c, want_c, "context", rtol=EXACT, atol=EXACT)
    assert (got_s[1, 3:] == -1e30).all() and not got_c[3].any()


def test_params_from_numpy_keys_and_layout():
    tree = _model()[0]
    params = seq2seq.params_from_numpy(tree, device="cpu")
    assert tree_map(lambda x: tuple(x.shape), params) \
        == tree_map(lambda x: tuple(x.shape), tree)
    assert [tuple(x.shape) for x in tree_leaves(params)] \
        == [x.shape for x in jax.tree_util.tree_leaves(tree)]
    np.testing.assert_array_equal(params["enc_bwd"]["w_gate"].numpy(),
                                  tree["enc_bwd"]["w_gate"])
    assert params["out2"]["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="seq2seq"):
        seq2seq.params_from_numpy(dict(tree, extra=tree["att_v"]),
                                  device="cpu")
    with pytest.raises(ValueError, match="seq2seq"):
        seq2seq.params_from_numpy(dict(tree, boot={"w": tree["boot"]["w"]}),
                                  device="cpu")
    init = seq2seq.init(torch.Generator().manual_seed(0), src_vocab=VOCAB,
                        trg_vocab=VOCAB, emb_dim=H, hidden=H, device="cpu")
    assert tree_map(lambda x: tuple(x.shape), init) \
        == tree_map(lambda x: tuple(x.shape), tree)


@pytest.mark.parametrize("fused", [True, False], ids=["jax_fused",
                                                      "jax_scan"])
def test_encode_forward_loss_and_grads_match_jax(fused):
    want = _jax_reference(fused)
    params = seq2seq.params_from_numpy(_model()[0], device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    src, trg, nxt = _port_batch()
    kgru.launches_fwd = kgru.launches_bwd = 0
    enc, proj, boot = seq2seq.encode(params, src)
    _close(enc.data.detach(), want["enc"], "enc")
    _close(proj.data.detach(), want["proj"], "proj")
    _close(boot.detach(), want["boot"], "boot")
    _close(seq2seq.forward(params, src, trg).detach(), want["logits"],
           "logits")
    loss = seq2seq.loss(params, src, trg, nxt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=1e-5)
    for (path, w), got in zip(
            jax.tree_util.tree_flatten_with_path(want["grads"])[0],
            tree_leaves(params)):
        _close(got.grad, w, jax.tree_util.keystr(path))
    assert (kgru.launches_fwd, kgru.launches_bwd) == (0, 0)


def test_greedy_generate_matches_jax():
    """Tokens and lengths equal JAX's on a fixture with clear argmax
    margins: the readout scaled up so that every step's top-1/top-2
    logit gap is above 1e-3 (checked below on JAX's teacher-forced
    logits), far beyond the ~1e-5 by which the two frameworks' logits
    differ, and the token row 0 emits at step 3 made the eos so that
    rows finish."""
    tree = jax.tree_util.tree_map(np.copy, _model()[0])
    tree["out2"]["w"] = tree["out2"]["w"] * 8.0
    max_len = 9
    port = seq2seq.params_from_numpy(tree, device="cpu")
    eos = int(seq2seq.greedy_generate(port, _port_batch()[0], max_len=4,
                                      eos_id=1)[0][0, 3])
    src = _jax_batch()[0]
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prior = _fused_route(True)
    try:
        want_tok, want_len = jax_seq2seq.greedy_generate(
            params, src, max_len=max_len, bos_id=0, eos_id=eos)
        prev = jnp.concatenate([jnp.zeros((B, 1), jnp.int32),
                                want_tok[:, :-1]], axis=1)
        logits = jax_seq2seq.forward(
            params, src, JaxSeq(prev, jnp.full((B,), max_len, jnp.int32)))
    finally:
        jax_rnn.FUSED_LSTM = prior
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    live = np.arange(max_len)[None, :] <= np.asarray(want_len)[:, None]
    assert (top2[..., 1] - top2[..., 0])[live].min() > 1e-3
    for p in tree_leaves(port):
        p.requires_grad_(True)
    kgru.launches_fwd = kgru.launches_bwd = 0
    tok, lengths = seq2seq.greedy_generate(port, _port_batch()[0],
                                           max_len=max_len, bos_id=0,
                                           eos_id=eos)
    assert tok.dtype == torch.int32 and not tok.requires_grad
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_len))
    assert (np.asarray(want_len) < max_len).any()      # some rows finish
    assert (kgru.launches_fwd, kgru.launches_bwd) == (0, 0)
    # beam generate (ported since it first refused here) at one lane is
    # this greedy decode
    beam = seq2seq.generate(port, _port_batch()[0], beam_size=1,
                            max_len=max_len, bos_id=0, eos_id=eos)
    np.testing.assert_array_equal(beam.tokens[:, 0].numpy(), tok.numpy())
    np.testing.assert_array_equal(beam.lengths[:, 0].numpy(),
                                  lengths.numpy())


def test_bench_step_matches_jax_bench_step_over_three_steps():
    """The port's bench_seq2seq train step (autograd + in-place Momentum)
    against bench.py:460-464's jitted, donating JAX step (its default
    route: the scan on the CPU), from the same initial params and batch,
    leaf by leaf."""
    port = bench.bench_seq2seq(batch=8, src_len=6, trg_len=5, vocab=VOCAB,
                               hidden=H, device="cpu")
    assert port.tokens_per_step == 8 * 5
    jp = tree_map(lambda x: jnp.asarray(x.detach().numpy().copy()),
                  port.params)
    opt = jax_optim.Momentum(learning_rate=0.01, momentum=0.9)
    js = opt.init(jp)
    src = JaxSeq(jnp.asarray(port.src.data.numpy()),
                 jnp.asarray(port.src.lengths.numpy()))
    trg = JaxSeq(jnp.asarray(port.trg.data.numpy()),
                 jnp.asarray(port.trg.lengths.numpy()))

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, src, trg):
        loss, grads = jax.value_and_grad(jax_seq2seq.loss)(params, src, trg,
                                                           trg)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss

    losses = []
    for _ in range(3):
        jp, js, jloss = step(jp, js, src, trg)
        loss = port.train_step()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for got, want in zip(tree_leaves(port.params)
                         + tree_leaves(port.opt_state["slots"]["mom"]),
                         jax.tree_util.tree_leaves(jp)
                         + jax.tree_util.tree_leaves(js["slots"]["mom"])):
        got, want = got.detach().numpy(), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_seq2seq_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seq2seq.init(torch.Generator().manual_seed(0), src_vocab=10,
                     trg_vocab=10, emb_dim=8, hidden=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seq2seq.params_from_numpy(_model()[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench_seq2seq(batch=8, src_len=3, trg_len=3, vocab=10,
                            hidden=128)
