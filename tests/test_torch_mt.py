"""The port's Transformer-base MT training path (``models/transformer``'s
seq2seq half and ``lm_logits``/``lm_loss``, ``ops/losses.masked_seq_mean``,
``optim.Adam``, ``scripts/bench.bench_transformer``) against the JAX
package on the SAME weights (``params_from_numpy``), on the CPU, where
the flash route runs ``FlashAttention``'s plain halves and the JAX side
its masked path.

Config: vocab 50, d_model 32, 2 heads, dff 64, 2+2 layers, B 2, T 128
(so ``full_seq=True`` opens the flash route), and T 12 for the padded,
key-masked path.  Tolerances: float32 on both sides, sums in different
orders — the loss at rtol 1e-5 and every gradient leaf within 1e-4 of
its largest magnitude; Adam alone, on identical gradients, at 1e-6; the
three-step bench comparison holds the loss at rtol 1e-4 and each param
within 1e-6 + 1e-4 lr (a few float32 spacings at |p| ~ 1, against an
Adam step of about lr), except an element whose JAX gradient has been
within 1e-3 of its leaf's largest magnitude at some step: a gradient
that is ~0 on one side can flip its sign, so such an element is held
within 2 lr per step.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxBatch
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops import losses as jax_losses
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.ops import losses
from paddle_tpu_torch.ops.kernels import flash_attention as fk
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.scripts import bench
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

VOCAB, D_MODEL, HEADS, DFF, LAYERS, B, T = 50, 32, 2, 64, 2, 2, 128
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
NEAR_ZERO_GRAD, PARAM_ATOL = 1e-3, 1e-6


@pytest.fixture(scope="module")
def mt_pair():
    """(JAX seq2seq params, the numpy tree)."""
    jp = jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB,
                     trg_vocab=VOCAB, d_model=D_MODEL, num_heads=HEADS,
                     dff=DFF, enc_layers=LAYERS, dec_layers=LAYERS,
                     max_len=T)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts FlashAttention.apply calls (the CPU counters cannot)."""
    calls = []
    real = fk.FlashAttention.apply

    def counted(*args):
        calls.append(args[4])
        return real(*args)
    monkeypatch.setattr(fk.FlashAttention, "apply", counted)
    return calls


def _batches(ids, lengths):
    return (JaxBatch(jnp.asarray(ids), jnp.asarray(lengths)),
            SequenceBatch(torch.tensor(ids), torch.tensor(lengths)))


def _port_params(tree):
    tp = torch_tf.params_from_numpy(tree, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    return tp


def _grads_close(want_grads, params):
    for (path, w), got in zip(
            jax.tree_util.tree_flatten_with_path(want_grads)[0],
            tree_leaves(params)):
        w = np.asarray(w)
        err = np.abs(got.grad.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), \
            (jax.tree_util.keystr(path), err, np.abs(w).max())


def test_masked_seq_mean_matches_jax(np_rng):
    x = np_rng.randn(4, 6).astype(np.float32)
    m = (np_rng.rand(4, 6) > 0.4).astype(np.float32)
    m[2] = 0.0                                     # an empty row: 0, not nan
    want = jax_losses.masked_seq_mean(jnp.asarray(x), jnp.asarray(m))
    got = losses.masked_seq_mean(torch.tensor(x), torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert got[2] == 0.0


@pytest.mark.parametrize("cfg", [dict(), dict(clip_norm=0.5, l2=1e-2)],
                         ids=["plain", "clipnorm_l2"])
def test_adam_matches_jax_over_three_updates(np_rng, cfg):
    params = {"w": np_rng.randn(4, 3).astype(np.float32),
              "l0": {"b": np_rng.randn(5).astype(np.float32)}}
    grads = [tree_map(lambda p: (np_rng.randn(*p.shape)
                                 * 10.0 ** np_rng.uniform(-6, 1, p.shape))
                      .astype(np.float32), params) for _ in range(3)]
    jopt = jax_optim.Adam(learning_rate=1e-2, **cfg)
    jp = tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    opt = Adam(learning_rate=1e-2, **cfg)
    tp = tree_map(torch.tensor, params)
    ts = opt.init(tp)
    for g in grads:
        jp, js = jopt.update(tree_map(jnp.asarray, g), js, jp)
        tp2, ts2 = opt.update(tree_map(torch.tensor, g), ts, tp)
        assert tp2 is tp and ts2 is ts           # updated in place
    assert ts["step"] == 3 and int(js["step"]) == 3
    for got, want in zip(
            tree_leaves(tp) + tree_leaves(ts["slots"]),
            jax.tree_util.tree_leaves(jp)
            + jax.tree_util.tree_leaves(js["slots"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_params_from_numpy_carries_the_seq2seq_tree(mt_pair):
    _jp, tree = mt_pair
    tp = torch_tf.params_from_numpy(tree, device="cpu")
    assert set(tp) == {"src_emb", "trg_emb", "pos", "enc", "dec", "ln_f",
                       "out"}
    assert tree_map(lambda x: tuple(x.shape), tp) \
        == tree_map(lambda x: tuple(x.shape), tree)
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got.numpy(), want)
    bad = dict(tree, dec=[dict(tree["dec"][0])])
    del bad["dec"][0]["xattn"]
    with pytest.raises(ValueError, match="decoder"):
        torch_tf.params_from_numpy(bad, device="cpu")


def test_init_draws_the_jax_tree_shapes(mt_pair):
    _jp, tree = mt_pair
    got = torch_tf.init(torch.Generator().manual_seed(0), src_vocab=VOCAB,
                        trg_vocab=VOCAB, d_model=D_MODEL, num_heads=HEADS,
                        dff=DFF, enc_layers=LAYERS, dec_layers=LAYERS,
                        max_len=T, device="cpu")
    assert tree_map(lambda x: tuple(x.shape), got) \
        == tree_map(lambda x: tuple(x.shape), tree)
    with pytest.raises(ValueError, match="does not divide"):
        torch_tf.init(torch.Generator().manual_seed(0), d_model=30,
                      num_heads=4, device="cpu")


def test_loss_and_grads_match_jax_on_the_flash_route(mt_pair, np_rng,
                                                     flash_calls):
    """full_seq=True at T 128: every attention (2 encoder, 2 decoder
    self- and 2 cross-attentions) takes the flash route, causal only in
    the decoder's self-attention; the launch counters stay 0."""
    jp, tree = mt_pair
    src = np_rng.randint(3, VOCAB, (B, T)).astype(np.int32)
    trg = np_rng.randint(3, VOCAB, (B, T)).astype(np.int32)
    lengths = np.full((B,), T, np.int32)
    (js, ts), (jt, tt) = _batches(src, lengths), _batches(trg, lengths)
    want, want_g = jax.value_and_grad(jax_tf.loss)(jp, js, jt, jt, HEADS,
                                                   full_seq=True)
    tp = _port_params(tree)
    before = (fk.launches, fk.launches_bwd_dkv, fk.launches_bwd_dq)
    loss = torch_tf.loss(tp, ts, tt, tt, HEADS, full_seq=True)
    loss.backward()
    assert (fk.launches, fk.launches_bwd_dkv, fk.launches_bwd_dq) == before
    assert sorted(flash_calls) == [False] * 4 + [True] * 2
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    _grads_close(want_g, tp)


def test_loss_and_grads_match_jax_on_padded_rows(mt_pair, np_rng,
                                                 flash_calls):
    """Without full_seq: key masks from the lengths (an empty-ish row
    included), the dense masked path, the per-row token mean."""
    jp, tree = mt_pair
    t = 12
    src = np_rng.randint(3, VOCAB, (3, t)).astype(np.int32)
    trg = np_rng.randint(3, VOCAB, (3, t)).astype(np.int32)
    (js, ts) = _batches(src, np.asarray([12, 5, 1], np.int32))
    (jt, tt) = _batches(trg, np.asarray([7, 12, 3], np.int32))
    want, want_g = jax.value_and_grad(jax_tf.loss)(jp, js, jt, jt, HEADS)
    tp = _port_params(tree)
    loss = torch_tf.loss(tp, ts, tt, tt, HEADS)
    loss.backward()
    assert not flash_calls
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    _grads_close(want_g, tp)


@pytest.fixture(scope="module")
def lm_pair():
    jp = jax_tf.init(jax.random.PRNGKey(1), src_vocab=VOCAB, trg_vocab=1,
                     d_model=D_MODEL, num_heads=HEADS, dff=DFF,
                     enc_layers=LAYERS, dec_layers=0, max_len=T)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def test_lm_logits_full_seq_matches_jax(lm_pair, np_rng, flash_calls):
    jp, tree = lm_pair
    ids = np_rng.randint(0, VOCAB, (B, T)).astype(np.int32)
    jb, tb = _batches(ids, np.full((B,), T, np.int32))
    want = jax_tf.lm_logits(jp, jb, HEADS, full_seq=True)
    got = torch_tf.lm_logits(torch_tf.params_from_numpy(tree, device="cpu"),
                             tb, HEADS, full_seq=True)
    assert flash_calls == [True] * LAYERS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_lm_loss_and_grads_match_jax(lm_pair, np_rng):
    jp, tree = lm_pair
    ids = np_rng.randint(0, VOCAB, (3, 16)).astype(np.int32)
    jb, tb = _batches(ids, np.asarray([16, 9, 1], np.int32))
    for smoothing in (0.0, 0.1):
        want, want_g = jax.value_and_grad(jax_tf.lm_loss)(
            jp, jb, HEADS, label_smoothing=smoothing)
        tp = _port_params(tree)
        loss = torch_tf.lm_loss(tp, tb, HEADS, label_smoothing=smoothing)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(want),
                                   rtol=LOSS_RTOL)
        # the JAX tree's trg_emb/out get zero gradients; the port drops
        # them from an LM tree
        want_g = {k: v for k, v in want_g.items()
                  if k not in ("trg_emb", "out", "dec")}
        _grads_close(want_g, tp)


def test_bench_step_matches_jax_bench_step_over_three_steps():
    """The port's bench_transformer step (autograd + in-place Adam)
    against bench.py:516-523's jitted, donating JAX step from the same
    initial params and batch."""
    lr = 1e-4
    port = bench.bench_transformer(batch=B, seq_len=T, vocab=VOCAB,
                                   d_model=D_MODEL, dff=DFF, layers=LAYERS,
                                   heads=HEADS, device="cpu")
    jp = tree_map(lambda x: jnp.asarray(x.detach().numpy().copy()),
                  port.params)
    opt = jax_optim.Adam(learning_rate=lr)
    js = opt.init(jp)
    src = JaxBatch(jnp.asarray(port.src.data.numpy()),
                   jnp.asarray(port.src.lengths.numpy()))
    trg = JaxBatch(jnp.asarray(port.trg.data.numpy()),
                   jnp.asarray(port.trg.lengths.numpy()))

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, src, trg):
        loss, grads = jax.value_and_grad(jax_tf.loss)(
            params, src, trg, trg, HEADS, full_seq=True)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss, grads

    near_zero = None
    for n in range(1, 4):
        jp, js, jloss, jgrads = step(jp, js, src, trg)
        loss = port.train_step()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        # an element whose JAX gradient has once been near 0 may have
        # stepped the other way on the port's side
        small = [np.abs(g) <= NEAR_ZERO_GRAD * np.abs(g).max()
                 for g in map(np.asarray, jax.tree_util.tree_leaves(jgrads))]
        near_zero = small if near_zero is None else [
            a | b for a, b in zip(near_zero, small)]
        for got, want, nz in zip(tree_leaves(port.params),
                                 jax.tree_util.tree_leaves(jp), near_zero):
            err = np.abs(got.detach().numpy() - np.asarray(want))
            assert err[~nz].max(initial=0.0) <= PARAM_ATOL + 1e-4 * lr
            assert err[nz].max(initial=0.0) <= 2 * lr * n
    assert port.opt_state["step"] == 3
    assert port.tokens_per_step == B * T


def test_full_seq_refuses_padded_rows_and_options_not_ported(mt_pair,
                                                             np_rng):
    _jp, tree = mt_pair
    tp = torch_tf.params_from_numpy(tree, device="cpu")
    ids = torch.tensor(np_rng.randint(3, VOCAB, (2, 8)).astype(np.int32))
    full = SequenceBatch(ids, torch.tensor([8, 8], dtype=torch.int32))
    padded = SequenceBatch(ids, torch.tensor([8, 5], dtype=torch.int32))
    with pytest.raises(ValueError, match="full_seq=True"):
        torch_tf.loss(tp, padded, full, full, HEADS, full_seq=True)
    with pytest.raises(ValueError, match="full_seq=True"):
        torch_tf.loss(tp, full, padded, padded, HEADS, full_seq=True)
    # remat runs now (tests/test_torch_packed.py holds it); the
    # sequence-parallel ring still raises
    for kw in (dict(mesh=object()), dict(zigzag=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            torch_tf.loss(tp, full, full, full, HEADS, **kw)
    # packed rows run now; a lone segment_ids or positions is the JAX
    # package's ValueError
    for kw in (dict(segment_ids=ids), dict(positions=ids)):
        with pytest.raises(ValueError, match="BOTH"):
            torch_tf.lm_loss(tp, full, HEADS, **kw)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_tf.init(torch.Generator().manual_seed(0), src_vocab=10,
                      trg_vocab=10, d_model=8, num_heads=2, dff=8,
                      enc_layers=1, dec_layers=1, max_len=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench_transformer(batch=1, seq_len=4, vocab=10, d_model=8,
                                dff=8, layers=1, heads=2)
