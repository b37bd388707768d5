"""The port's generation module (``layers/generation.py``: ``beam_search``
and ``greedy_generation`` over a DSL step) and ``models/seqtoseq_dsl``
against the JAX package on the CPU.

A small attention decoder (V 20, E 8, H 16, beam 3, max_length 8): a
memory booted from a layer, ``simple_attention`` over a sequence
``StaticInput`` (so both its data and its lengths are repeated
lane-major) and a dense static, the generated word's embedding from the
shared table.  Both packages decode from the same weights (JAX's init
perturbed by seeded noise); each row whose every step keeps its K-th
and (K+1)-th candidates at least MARGIN apart (the port's
``ops/beam.beam_search(trace=)``) must give JAX's tokens and lengths,
its scores within SCORE_TOL; near ties are rows where float32 may pick
either.  Then ``candidate_adjust`` and ``drop_callback`` passed through,
``greedy_generation`` as beam 1, the GeneratedInput's ids kept unless
overridden (``tests/test_dsl_surface.py``), the shared table's key, and
``models/seqtoseq_dsl`` at dim 16 against JAX's ``parse_config`` of
``demo/seqToseq/v1/train.conf``: layer names and parameter keys, the
training loss and every gradient from JAX's init, then the beams of the
generation graph from the same weights.

Tolerance: float32 on both sides in other summation orders; the loss
within TOL = 1e-5, gradients within GRAD_TOL = 1e-4 of each leaf's
largest entry.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers import generation
from paddle_tpu_torch.ops import beam as beam_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_TOL = 1e-4
SCORE_TOL = 1e-5
MARGIN = 2e-3
V, E, H, K, MAXLEN = 20, 8, 16, 3, 8
B = 4
ENC_LENGTHS = np.array([3, 5, 1, 4], np.int32)


def decoder(M, beam_size=K, greedy=False, **kw):
    enc = M.data_layer("enc", size=E, is_seq=True)
    ctx = M.data_layer("ctx", size=E)
    enc_proj = M.fc_layer(enc, size=H, act=None, bias_attr=False)
    boot = M.fc_layer(ctx, size=H, act="tanh")

    def step(word, enc_s, proj_s, ctx_s):
        mem = M.memory(name="dec", size=H, boot_layer=boot)
        att = M.simple_attention(enc_s, proj_s, mem)
        h = M.fc_layer([word, att, mem, ctx_s], size=H, act="tanh",
                       name="dec")
        return M.fc_layer(h, size=V, act="softmax", name="probs")

    ins = [M.GeneratedInput(size=V, embedding_name="trg_emb",
                            embedding_size=E),
           M.StaticInput(enc, is_seq=True), M.StaticInput(enc_proj,
                                                          is_seq=True),
           M.StaticInput(ctx)]
    if greedy:
        return M.greedy_generation(step, ins, max_length=MAXLEN)
    return M.beam_search(step, ins, beam_size=beam_size, max_length=MAXLEN,
                         **kw)


def _feeds(seed=0):
    rng = np.random.RandomState(seed)
    enc = rng.randn(B, int(ENC_LENGTHS.max()), E).astype(np.float32)
    enc[np.arange(enc.shape[1])[None] >= ENC_LENGTHS[:, None]] = 0.0
    ctx = rng.randn(B, E).astype(np.float32)
    return ({"enc": JaxSeq(jnp.asarray(enc), jnp.asarray(ENC_LENGTHS)),
             "ctx": jnp.asarray(ctx)},
            {"enc": SequenceBatch(torch.tensor(enc),
                                  torch.tensor(ENC_LENGTHS)),
             "ctx": torch.tensor(ctx)})


def _tree(topo, seed=0, scale=0.5):
    rng = np.random.RandomState(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*np.shape(a)).astype(
            np.float32), topo.init(jax.random.PRNGKey(seed)))


@pytest.fixture
def traced(monkeypatch):
    """The port's beam searches record their per-step trace here."""
    trace = []
    real = beam_ops.beam_search
    monkeypatch.setattr(beam_ops, "beam_search",
                        lambda *a, **kw: real(*a, trace=trace, **kw))
    return trace


def hold_beams(got, want, trace):
    """Rows without a near tie (every step's gap >= MARGIN, and the
    final beams' scores MARGIN apart) equal JAX's: tokens, lengths,
    scores within SCORE_TOL.  Returns the number of rows held."""
    gaps = torch.stack([s["gap"] for s in trace]).min(0).values.numpy()
    final = np.diff(-np.asarray(want.scores), axis=1)
    clear = (gaps >= MARGIN) & (final.min(1, initial=np.inf) >= MARGIN)
    for r in np.nonzero(clear)[0]:
        np.testing.assert_array_equal(got.tokens[r].numpy(),
                                      np.asarray(want.tokens[r]))
        np.testing.assert_array_equal(got.lengths[r].numpy(),
                                      np.asarray(want.lengths[r]))
        np.testing.assert_allclose(got.scores[r].numpy(),
                                   np.asarray(want.scores[r]),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
    return int(clear.sum())


def both(build, seed=0):
    """(port value, JAX value) of ``build`` from the same weights."""
    jax_reset_names()
    jtopo = JL.Topology(build(JL))
    tree = _tree(jtopo, seed)
    jf, tf = _feeds(seed)
    want = jtopo.apply(jax.tree_util.tree_map(jnp.asarray, tree), jf,
                       mode="test")
    L.reset_names()
    topo = L.Topology(build(L))
    assert topo.param_shapes() == {k: {n: np.shape(a) for n, a in v.items()}
                                   for k, v in tree.items()}
    got = topo.apply(L.params_from_numpy(topo, tree, device="cpu"), tf,
                     mode="test")
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_beam_search_matches_jax(traced, seed):
    got, want = both(decoder, seed)
    assert isinstance(got, beam_ops.BeamResult)
    assert got.tokens.shape == (B, K, MAXLEN)
    assert hold_beams(got, want, traced) >= B // 2


def test_greedy_generation_matches_jax_and_beam_one(traced):
    got, want = both(lambda M: decoder(M, greedy=True))
    assert isinstance(got, SequenceBatch) and got.data.shape == (B, MAXLEN)
    one, _ = both(lambda M: decoder(M, beam_size=1))
    np.testing.assert_array_equal(got.data.numpy(), one.tokens[:, 0].numpy())
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  one.lengths[:, 0].numpy())
    gaps = torch.stack([s["gap"] for s in traced[:MAXLEN]]).min(0).values
    clear = (gaps >= MARGIN).numpy()
    assert clear.sum() >= B // 2
    np.testing.assert_array_equal(got.data.numpy()[clear],
                                  np.asarray(want.data)[clear])


def _adjust(lib):
    """candidate_adjust: token 5 is never a candidate."""
    def adjust(lp):
        if lib is jnp:
            return lp.at[:, 5].set(-1e30)
        lp = lp.clone()
        lp[:, 5] = -1e30
        return lp
    return adjust


def _drop(lib):
    """drop_callback: a lane may not repeat its previous token."""
    def drop(tokens, t, cand):
        if isinstance(t, int) and t == 0:
            return cand
        prev = tokens[:, :, t - 1]
        hit = (lib.arange(cand.shape[-1])[None, None, :]
               == prev[..., None])
        if lib is jnp:
            return jnp.where(t > 0, jnp.where(hit, -1e30, cand), cand)
        return torch.where(hit, torch.tensor(-1e30), cand)
    return drop


def test_hooks_are_passed_through(traced):
    def build(M):
        lib = jnp if M is JL else torch
        return decoder(M, candidate_adjust=_adjust(lib),
                       drop_callback=_drop(lib))
    got, want = both(build, seed=2)
    toks = got.tokens.numpy()
    assert not (toks == 5).any()
    live = np.arange(MAXLEN)[None, None, 1:] < got.lengths.numpy()[..., None]
    assert not ((toks[..., 1:] == toks[..., :-1]) & live).any()
    assert hold_beams(got, want, traced) >= B // 2
    plain, _ = both(decoder, seed=2)
    assert (plain.tokens.numpy() == 5).any() or not np.array_equal(
        plain.tokens.numpy(), toks)


def test_generated_input_ids_not_clobbered():
    L.reset_names()
    enc = L.data_layer("enc2", size=4)

    def step(we, cs):
        mem = L.memory(name="st2", size=4)
        s = L.fc_layer([we, mem, cs], size=4, act="tanh", name="st2")
        return L.fc_layer(s, size=7, act="softmax")

    gi = L.GeneratedInput(size=7, embedding_name="e2", embedding_size=3,
                          bos_id=5, eos_id=6)
    L.beam_search(step, input=[gi, L.StaticInput(enc)], beam_size=2,
                  max_length=3)
    assert gi.bos_id == 5 and gi.eos_id == 6
    gi2 = L.GeneratedInput(size=7, embedding_name="e3", embedding_size=3,
                           bos_id=5, eos_id=6)
    L.beam_search(step, input=[gi2, L.StaticInput(enc)], bos_id=0, eos_id=1,
                  beam_size=2, max_length=3)
    assert gi2.bos_id == 0 and gi2.eos_id == 1
    assert generation.SubsequenceInput is L.SubsequenceInput


def test_shared_table_key_feeds_decoding():
    L.reset_names()
    train_emb = L.embedding_layer(L.data_layer("w", size=V, is_seq=True),
                                  size=E, param_attr={"name": "trg_emb"})
    train_keys = L.Topology(train_emb).param_shapes()
    gen_keys = L.Topology(decoder(L)).param_shapes()
    assert train_keys == {"trg_emb": {"w": (V, E)}}
    assert gen_keys["trg_emb"] == {"w": (V, E)}
    jax_reset_names()
    assert JL.Topology(decoder(JL)).init(
        jax.random.PRNGKey(0)).keys() == gen_keys.keys()


# ------------------------------------------------------- seqtoseq_dsl

S2S_DIM = 16


def _write(path, content):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(content)


@pytest.fixture
def s2s_data(tmp_path, monkeypatch):
    """tests/test_config_compat.py's pre-wmt14 fixture (7-word
    dictionaries, four pairs), the working directory its parent."""
    monkeypatch.chdir(tmp_path)
    d = tmp_path / "data" / "pre-wmt14"
    _write(d / "src.dict", "<s>\n<e>\n<unk>\nle\nchat\nnoir\nmange\n")
    _write(d / "trg.dict", "<s>\n<e>\n<unk>\nthe\ncat\nblack\neats\n")
    _write(d / "part-000",
           "le chat noir\tthe black cat\nle chat mange\tthe cat eats\n"
           "le noir chat\tthe cat black\nle chat\tthe cat\n")
    for name in ("train", "test", "gen"):
        _write(d / f"{name}.list", "data/pre-wmt14/part-000\n")
    return tmp_path


def test_seqtoseq_dsl_matches_jax_parse_of_train_conf(s2s_data, traced):
    from paddle_tpu.compat import config_to_runtime, parse_config
    from paddle_tpu.data import DataFeeder as JaxFeeder
    from paddle_tpu.layers.graph import value_data as jax_value
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.layers.graph import value_data
    from paddle_tpu_torch.models import seqtoseq_dsl
    conf = f"{REPO}/demo/seqToseq/v1/train.conf"
    parsed = parse_config(conf, f"dim={S2S_DIM},batch_size=4")
    jtopo = JL.Topology(parsed.outputs)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(0)))
    cfg = config_to_runtime(parsed)
    batch = next(iter(cfg["train_reader"]()))
    jfeed = JaxFeeder(cfg["feeding"])(batch)

    def jloss(p):
        return jnp.mean(jax_value(jtopo.apply(p, jfeed, mode="train")))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree))

    cost = seqtoseq_dsl.build(dim=S2S_DIM, src_dict_dim=7, trg_dict_dim=7)
    topo = L.Topology(cost)
    assert [n.name for n in topo.order] == [n.name for n in jtopo.order]
    params = L.params_from_numpy(topo, tree, device="cpu")
    for v in params.values():
        for t in v.values():
            t.requires_grad_(True)
    feed = DataFeeder(seqtoseq_dsl.feeding(7, 7), device="cpu")(batch)
    loss = torch.mean(value_data(topo.apply(params, feed, mode="train")))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= TOL * abs(float(jl))
    for k, v in tree.items():
        for n in v:
            g, w = params[k][n].grad.numpy(), np.asarray(jg[k][n])
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), (k, n)

    # the generation graph: the same keys, the trained weights drop in
    gen = parse_config(conf, f"is_generating=1,dim={S2S_DIM},batch_size=4,"
                             "max_length=6,beam_size=2")
    jgen = JL.Topology(gen.outputs)
    src = {"source_language_word": jfeed["source_language_word"]}
    want = jgen.apply(jax.tree_util.tree_map(jnp.asarray, tree), src,
                      mode="test")
    node = seqtoseq_dsl.build(True, dim=S2S_DIM, src_dict_dim=7,
                              trg_dict_dim=7, beam_size=2, max_length=6)
    gtopo = L.Topology(node)
    assert [n.name for n in gtopo.order] == [n.name for n in jgen.order]
    assert gtopo.param_shapes() == topo.param_shapes()
    got = gtopo.apply(L.params_from_numpy(gtopo, tree, device="cpu"),
                      {"source_language_word":
                       feed["source_language_word"]}, mode="test")
    assert got.tokens.shape == (4, 2, 6)
    assert hold_beams(got, want, traced) >= 2
