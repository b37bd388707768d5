"""The port's v1 config compiler (``paddle_tpu_torch/compat``: ``v1``,
``config_parser`` and the ``compat/shim`` modules that stand for
``paddle.*`` during a parse) against the JAX package's on the CPU.

``demo/seqToseq/v1/train.conf`` at dim 16, batch 4, on the fixture data
of tests/test_config_compat.py (7-word dictionaries, four pairs), and
its ``is_generating=1`` parse: layer names in topological order and
their widths, parameter keys and shapes, the batch size, the optimizer's
class and hyper-parameters, the feeding's types and the reader's batches
equal to JAX's; from JAX's weights (``params_from_numpy``) the loss and
every gradient of the first batch, the costs of two SGD steps, and the
beam decode's tokens up to each row's first top-K / top-(K+1) margin
below MARGIN.  Then configs the test writes: a list-style input_types
provider whose DFS order differs from its declaration order,
``inputs()`` winning, ``settings()`` with each optimizer, L1 / L2,
clipping and a decayed schedule, an evaluator, a stacked ``lstmemory``
classifier and a non-sequence group input promoted during the parse.
Then ``sys.modules``: a port parse leaves every ``paddle`` entry as it
found it, in either order with a JAX parse, and a process that parses
and steps ``train.conf`` through the port imports neither ``jax`` nor
``paddle_tpu``.

Tolerance: float32 on both sides in other summation orders; losses and
costs within TOL relative, each gradient leaf within GRAD_TOL of its
largest entry, optimizer trajectories within OPT_TOL.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
import paddle_tpu.optim as jax_optim
from paddle_tpu.compat import config_parser as jcp
from paddle_tpu.data.provider import integer_value_sequence as jax_int_seq
from paddle_tpu.data import DataFeeder as JaxFeeder
from paddle_tpu.layers.graph import value_data as jax_value
from paddle_tpu.trainer import SGD as JaxSGD
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.compat import config_parser as cp
from paddle_tpu_torch.data import DataFeeder
from paddle_tpu_torch.data.provider import integer_value_sequence
from paddle_tpu_torch.layers.graph import value_data
from paddle_tpu_torch.ops import beam as beam_ops
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.error import ConfigError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CONF = f"{REPO}/demo/seqToseq/v1/train.conf"
S2S_ARGS = "dim=16,batch_size=4"
GEN_ARGS = "is_generating=1,dim=16,batch_size=4,max_length=6,beam_size=2"
TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-5
MARGIN = 2e-3


def _write(path, content):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(content)


def _s2s_data(root):
    d = root / "data" / "pre-wmt14"
    _write(d / "src.dict", "<s>\n<e>\n<unk>\nle\nchat\nnoir\nmange\n")
    _write(d / "trg.dict", "<s>\n<e>\n<unk>\nthe\ncat\nblack\neats\n")
    _write(d / "part-000",
           "le chat noir\tthe black cat\nle chat mange\tthe cat eats\n"
           "le noir chat\tthe cat black\nle chat\tthe cat\n")
    for name in ("train", "test", "gen"):
        _write(d / f"{name}.list", "data/pre-wmt14/part-000\n")


@pytest.fixture(scope="module", autouse=True)
def s2s_dir(tmp_path_factory):
    """The fixture data, the working directory of the whole module (the
    config's paths and its lazy readers are relative to it)."""
    root = tmp_path_factory.mktemp("s2s")
    _s2s_data(root)
    with contextlib.chdir(root):
        yield root


@pytest.fixture(scope="module")
def jax_s2s(s2s_dir):
    """JAX's parses of train.conf (training and generation), its runtime
    dict, its init as numpy and its first batch; shared by the module."""
    with contextlib.chdir(s2s_dir):
        parsed = jcp.parse_config(TRAIN_CONF, S2S_ARGS)
        cfg = jcp.config_to_runtime(parsed)
        batches = list(cfg["train_reader"]())
        gen = jcp.parse_config(TRAIN_CONF, GEN_ARGS)
    topo = JL.Topology(parsed.outputs)
    tree = jax.tree_util.tree_map(np.asarray,
                                  topo.init(jax.random.PRNGKey(0)))
    return {"parsed": parsed, "cfg": cfg, "batches": batches, "gen": gen,
            "topo": topo, "tree": tree}


def _port_s2s(s2s_dir, args=S2S_ARGS):
    with contextlib.chdir(s2s_dir):
        parsed = cp.parse_config(TRAIN_CONF, args)
        cfg = cp.config_to_runtime(parsed) if parsed.data_sources.get(
            "train") else None
    return parsed, cfg


def _layers(topo):
    return [(n.name, n.layer_type, n.size, n.is_seq) for n in topo.order]


def _shapes(tree):
    return {k: {n: tuple(np.shape(a)) for n, a in v.items()}
            for k, v in tree.items()}


def _types(feeding):
    return {k: (t.dim, t.seq_type.value, t.kind) for k, t in feeding.items()}


def test_train_conf_parse_matches_jax(s2s_dir, jax_s2s):
    parsed, cfg = _port_s2s(s2s_dir)
    jparsed, jcfg = jax_s2s["parsed"], jax_s2s["cfg"]
    topo = L.Topology(parsed.outputs)
    assert _layers(topo) == _layers(jax_s2s["topo"])
    assert topo.param_shapes() == _shapes(jax_s2s["tree"])
    assert parsed.input_order == jparsed.input_order
    assert cfg["batch_size"] == jcfg["batch_size"] == 4
    assert parsed.settings["learning_rate"] == 5e-4
    assert type(parsed.settings["learning_method"]).__name__ \
        == type(jparsed.settings["learning_method"]).__name__ \
        == "AdamOptimizer"
    assert parsed.settings["learning_method"].kw \
        == jparsed.settings["learning_method"].kw
    assert _types(cfg["feeding"]) == _types(jcfg["feeding"])
    assert list(cfg["feeding"]) == list(jcfg["feeding"])
    assert list(cfg["train_reader"]()) == jax_s2s["batches"]
    assert list(cfg["test_reader"]()) == list(jcfg["test_reader"]())
    assert cfg["evaluators"] == jcfg["evaluators"] == []


def _loss_and_grads(jtopo, topo, tree, jfeed, feed):
    def jloss(p):
        return jnp.mean(jax_value(jtopo.apply(p, jfeed, mode="train")))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    params = L.params_from_numpy(topo, tree, device="cpu")
    for v in params.values():
        for t in v.values():
            t.requires_grad_(True)
    loss = torch.mean(value_data(topo.apply(params, feed, mode="train")))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= TOL * abs(float(jl))
    for k, v in tree.items():
        for n in v:
            g, w = params[k][n].grad.numpy(), np.asarray(jg[k][n])
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), (k, n)
    return float(loss.detach())


def test_train_conf_first_batch_loss_and_grads_match_jax(s2s_dir, jax_s2s):
    parsed, cfg = _port_s2s(s2s_dir)
    batch = jax_s2s["batches"][0]
    _loss_and_grads(jax_s2s["topo"], L.Topology(parsed.outputs),
                    jax_s2s["tree"],
                    JaxFeeder(jax_s2s["cfg"]["feeding"])(batch),
                    DataFeeder(cfg["feeding"], device="cpu")(batch))


def _sgd_costs(cfg, jcfg, tree, batches):
    """The costs of one SGD step a batch in each package, from ``tree``,
    with each config's own optimizer."""
    jt = JaxSGD(jcfg["cost"], parameters=jax.tree_util.tree_map(
        jnp.asarray, tree), update_equation=jcfg["optimizer"])
    tt = SGD(cfg["cost"], parameters=tree, update_equation=cfg["optimizer"],
             device="cpu")
    jf, tf = JaxFeeder(jcfg["feeding"]), DataFeeder(cfg["feeding"],
                                                    device="cpu")
    return ([float(tt.train_one_batch(b, feeder=tf)) for b in batches],
            [float(jt.train_one_batch(b, feeder=jf)) for b in batches])


def test_train_conf_two_sgd_steps_match_jax(s2s_dir, jax_s2s):
    _, cfg = _port_s2s(s2s_dir)
    batches = [jax_s2s["batches"][0]] * 2
    got, want = _sgd_costs(cfg, jax_s2s["cfg"], jax_s2s["tree"], batches)
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert got[1] < got[0]


def test_train_conf_generation_parse_decodes_as_jax(s2s_dir, jax_s2s,
                                                    monkeypatch):
    trace = []
    real = beam_ops.beam_search
    monkeypatch.setattr(beam_ops, "beam_search",
                        lambda *a, **kw: real(*a, trace=trace, **kw))
    gen, cfg = _port_s2s(s2s_dir, GEN_ARGS)
    assert cfg is None and gen.data_sources["test"]["args"]["is_generating"]
    gtopo, jgen = L.Topology(gen.outputs), JL.Topology(jax_s2s["gen"].outputs)
    assert _layers(gtopo) == _layers(jgen)
    tree = jax_s2s["tree"]
    assert set(gtopo.param_shapes()) <= set(tree)
    gtree = {k: tree[k] for k in gtopo.param_shapes()}
    batch = jax_s2s["batches"][0]
    rows = [{"source_language_word": s["source_language_word"]}
            for s in batch]
    jfeed = JaxFeeder({"source_language_word": jax_int_seq(7)})(rows)
    feed = DataFeeder({"source_language_word": integer_value_sequence(7)},
                      device="cpu")(rows)
    want = jgen.apply(jax.tree_util.tree_map(jnp.asarray, gtree), jfeed,
                      mode="test")
    got = gtopo.apply(L.params_from_numpy(gtopo, gtree, device="cpu"), feed,
                      mode="test")
    assert got.tokens.shape == (4, 2, 6)
    gaps = torch.stack([s["gap"] for s in trace]).min(0).values.numpy()
    final = np.diff(-np.asarray(want.scores), axis=1)
    clear = (gaps >= MARGIN) & (final.min(1, initial=np.inf) >= MARGIN)
    for r in np.nonzero(clear)[0]:
        np.testing.assert_array_equal(got.tokens[r].numpy(),
                                      np.asarray(want.tokens[r]))
        np.testing.assert_array_equal(got.lengths[r].numpy(),
                                      np.asarray(want.lengths[r]))
    assert clear.sum() >= 2


# ------------------------------------------------------- inline configs

LIST_PROVIDER = """
from paddle.trainer.PyDataProvider2 import *


@provider(input_types=[dense_vector(6), integer_value(2)])
def process(settings, file_name):
    with open(file_name) as f:
        for line in f:
            xs, lab = line.strip().split("\\t")
            yield [float(v) for v in xs.split()], int(lab)
"""

# declared label first; the graph reaches x first (DFS order x, lab)
LIST_CONF = """
from paddle.trainer_config_helpers import *
define_py_data_sources2(train_list="train.list", test_list=None,
                        module="list_provider", obj="process")
settings(batch_size=8, learning_rate=0.05,
         learning_method=MomentumOptimizer(0.9))
lab = data_layer(name="lab", size=2)
x = data_layer(name="x", size=6)
h = fc_layer(input=x, size=5, act=TanhActivation())
prob = fc_layer(input=h, size=2, act=SoftmaxActivation())
classification_error_evaluator(input=prob, label=lab)
outputs(classification_cost(input=prob, label=lab))
"""

# the provider yields (lab, x) and inputs() says so, against the DFS
INPUTS_PROVIDER = (LIST_PROVIDER
                   .replace("[dense_vector(6), integer_value(2)]",
                            "[integer_value(2), dense_vector(6)]")
                   .replace("yield [float(v) for v in xs.split()], int(lab)",
                            "yield int(lab), [float(v) for v in xs.split()]"))
INPUTS_CONF = (LIST_CONF.replace("outputs(", "inputs(lab, x)\noutputs(")
               .replace('"list_provider"', '"inputs_provider"'))

SEQ_PROVIDER = """
from paddle.trainer.PyDataProvider2 import *


def hook(settings, dict_size, **kwargs):
    settings.input_types = {"word": integer_value_sequence(dict_size),
                            "label": integer_value(3)}


@provider(init_hook=hook)
def process(settings, file_name):
    with open(file_name) as f:
        for line in f:
            lab, words = line.strip().split("\\t")
            yield {"word": [int(w) for w in words.split()],
                   "label": int(lab)}
"""

# a stacked lstmemory classifier (the sentiment demo's shape): seq-ness
# of "word" comes from the provider's dict-style input_types
LSTM_CONF = """
from paddle.trainer_config_helpers import *
define_py_data_sources2(train_list="seq.list", test_list=None,
                        module="seq_provider", obj="process",
                        args={"dict_size": 30})
settings(batch_size=6, learning_rate=0.01, learning_method=AdamOptimizer(),
         regularization=L2Regularization(1e-3),
         gradient_clipping_threshold=5.0)
word = data_layer(name="word", size=30)
emb = embedding_layer(input=word, size=8)
fc1 = fc_layer(input=emb, size=4 * 8)
lstm1 = lstmemory(input=fc1, act=TanhActivation())
fc2 = fc_layer(input=[fc1, lstm1], size=4 * 8)
lstm2 = lstmemory(input=fc2, reverse=True)
pool = pooling_layer(input=lstm2, pooling_type=MaxPooling())
prob = fc_layer(input=pool, size=3, act=SoftmaxActivation())
outputs(classification_cost(input=prob, label=data_layer(name="label",
                                                         size=3)))
"""

# no data source: "x" is a plain layer until the group promotes it
GROUP_CONF = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.01)
x = data_layer(name="x", size=5)
proj = fc_layer(input=x, size=6, act=TanhActivation())


def step(inp):
    mem = memory(name="h", size=6)
    return fc_layer(input=[inp, mem], size=6, act=TanhActivation(),
                    name="h")


outputs(last_seq(input=recurrent_group(step=step, input=proj)))
"""


@pytest.fixture(scope="module")
def inline_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1")
    rng = np.random.RandomState(7)
    rows = [" ".join(f"{v:.4f}" for v in rng.randn(6)) + f"\t{int(i % 2)}"
            for i in range(16)]
    _write(root / "list.txt", "\n".join(rows) + "\n")
    _write(root / "train.list", f"{root / 'list.txt'}\n")
    _write(root / "list_provider.py", LIST_PROVIDER)
    _write(root / "inputs_provider.py", INPUTS_PROVIDER)
    seqs = [f"{i % 3}\t" + " ".join(str(w) for w in rng.randint(
        0, 30, rng.randint(2, 9))) for i in range(12)]
    _write(root / "seq.txt", "\n".join(seqs) + "\n")
    _write(root / "seq.list", f"{root / 'seq.txt'}\n")
    _write(root / "seq_provider.py", SEQ_PROVIDER)
    for name, text in (("list_conf.py", LIST_CONF),
                       ("inputs_conf.py", INPUTS_CONF),
                       ("lstm_conf.py", LSTM_CONF),
                       ("group_conf.py", GROUP_CONF)):
        _write(root / name, text)
    return root


def _both(root, name, args=""):
    """(port, JAX) parses of ``name`` and their runtime dicts."""
    path = str(root / name)
    with contextlib.chdir(root):
        jparsed = jcp.parse_config(path, args)
        jcfg = jcp.config_to_runtime(jparsed)
        parsed = cp.parse_config(path, args)
        cfg = cp.config_to_runtime(parsed)
    return parsed, cfg, jparsed, jcfg


def _start(jparsed):
    return jax.tree_util.tree_map(np.asarray, JL.Topology(
        jparsed.outputs).init(jax.random.PRNGKey(3)))


@pytest.mark.parametrize("name, order", [("list_conf.py", ["x", "lab"]),
                                         ("inputs_conf.py", ["lab", "x"])])
def test_input_order_feeding_and_steps_match_jax(inline_dir, name, order):
    parsed, cfg, jparsed, jcfg = _both(inline_dir, name)
    assert parsed.input_order == jparsed.input_order == order
    assert _types(cfg["feeding"]) == _types(jcfg["feeding"])
    assert list(cfg["feeding"]) == order
    batches = list(cfg["train_reader"]())
    assert batches == list(jcfg["train_reader"]()) and len(batches) == 2
    tree = _start(jparsed)
    assert L.Topology(parsed.outputs).param_shapes() == _shapes(tree)
    got, want = _sgd_costs(cfg, jcfg, tree, batches)
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_evaluator_recorded_and_its_results_match_jax(inline_dir):
    parsed, cfg, jparsed, jcfg = _both(inline_dir, "list_conf.py")
    assert [s.name for s in cfg["evaluators"]] \
        == [s.name for s in jcfg["evaluators"]]
    assert len(cfg["evaluators"]) == 1
    assert cfg["evaluators"][0].input.name == jcfg["evaluators"][0].input.name
    tree = _start(jparsed)
    results = []
    for trainer, specs, feeding in (
            (SGD(cfg["cost"], parameters=tree,
                 update_equation=cfg["optimizer"],
                 evaluators=cfg["evaluators"], device="cpu"),
             cfg["evaluators"], cfg["feeding"]),
            (JaxSGD(jcfg["cost"], parameters=jax.tree_util.tree_map(
                jnp.asarray, tree), update_equation=jcfg["optimizer"],
                evaluators=jcfg["evaluators"]), jcfg["evaluators"],
             jcfg["feeding"])):
        seen = []
        # each evaluator's running result after every batch
        trainer.train(jcfg["train_reader"], num_passes=1, feeding=feeding,
                      log_period=0, event_handler=lambda e: seen.append(
                          [float(s.result()) for s in specs])
                      if type(e).__name__ == "EndIteration" else None)
        results.append(seen)
    assert len(results[0]) == 2
    np.testing.assert_allclose(results[0], results[1], rtol=TOL)


def test_stacked_lstmemory_classifier_matches_jax(inline_dir):
    parsed, cfg, jparsed, jcfg = _both(inline_dir, "lstm_conf.py")
    topo, jtopo = L.Topology(parsed.outputs), JL.Topology(jparsed.outputs)
    assert _layers(topo) == _layers(jtopo)
    assert [n.is_seq for n in topo.order if n.name == "word"] == [True]
    assert _types(cfg["feeding"]) == _types(jcfg["feeding"])
    batches = list(cfg["train_reader"]())
    assert batches == list(jcfg["train_reader"]()) and len(batches) == 2
    tree = _start(jparsed)
    _loss_and_grads(jtopo, topo, tree, JaxFeeder(jcfg["feeding"])(
        batches[0]), DataFeeder(cfg["feeding"], device="cpu")(batches[0]))
    got, want = _sgd_costs(cfg, jcfg, tree, batches)
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_non_sequence_group_input_promoted_during_the_parse(inline_dir):
    path = str(inline_dir / "group_conf.py")
    parsed, jparsed = cp.parse_config(path), jcp.parse_config(path)
    topo, jtopo = L.Topology(parsed.outputs), JL.Topology(jparsed.outputs)
    assert _layers(topo) == _layers(jtopo)
    assert [n.is_seq for n in topo.order[:2]] == [True, True]
    tree = _start(jparsed)
    lengths = np.asarray([3, 1, 4], np.int32)
    x = np.random.RandomState(5).randn(3, 4, 5).astype(np.float32)
    x[np.arange(4)[None] >= lengths[:, None]] = 0.0
    from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
    from paddle_tpu_torch.core.sequence import SequenceBatch
    want = jtopo.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                       {"x": JaxSeq(jnp.asarray(x), jnp.asarray(lengths))},
                       mode="test")
    got = topo.apply(L.params_from_numpy(topo, tree, device="cpu"),
                     {"x": SequenceBatch(torch.tensor(x),
                                         torch.tensor(lengths))},
                     mode="test")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # outside a parse the strict refusal stays, in both packages
    L.reset_names()
    with pytest.raises(ConfigError, match="is not a sequence; wrap"):
        L.recurrent_group(lambda s: s, L.data_layer("d", size=5))


# ------------------------------------------------------------- settings()

OPT_CASES = [
    ("MomentumOptimizer(momentum=0.9)", "L2Regularization(1e-2)", 0.5),
    ("AdamOptimizer(beta1=0.8)", "L1Regularization(1e-3)", None),
    ("AdamaxOptimizer()", None, 0.5),
    ("AdaGradOptimizer()", "L2Regularization(1e-3)", None),
    ("DecayedAdaGradOptimizer(rho=0.9)", None, 0.3),
    ("AdaDeltaOptimizer(rho=0.9, epsilon=1e-5)", "L1Regularization(1e-3)",
     None),
    ("RMSPropOptimizer(rho=0.9)", "L2Regularization(1e-2)", 0.4),
]


def _settings_conf(root, method, reg, clip, sched=""):
    text = ("from paddle.trainer_config_helpers import *\n"
            f"settings(batch_size=4, learning_rate=0.05, "
            f"learning_method={method}, regularization={reg}, "
            f"gradient_clipping_threshold={clip}{sched})\n"
            "x = data_layer(name='x', size=3)\n"
            "outputs(fc_layer(input=x, size=2))\n")
    path = root / "settings_conf.py"
    _write(path, text)
    return str(path)


def _trajectory(make_update, params, grads, steps=3):
    out = []
    for g in grads[:steps]:
        params = make_update(params, g)
        out.append(params)
    return out


def _run_port(opt, tree, grads):
    params = {k: {n: torch.tensor(a) for n, a in v.items()}
              for k, v in tree.items()}
    state = opt.init(params)
    out = []
    for g in grads:
        params, state = opt.update(
            {k: {n: torch.tensor(a) for n, a in v.items()}
             for k, v in g.items()}, state, params)
        out.append({k: {n: t.clone().numpy() for n, t in v.items()}
                    for k, v in params.items()})
    return out


def _run_jax(opt, tree, grads):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(params)
    out = []
    for g in grads:
        params, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, params)
        out.append(jax.tree_util.tree_map(np.asarray, params))
    return out


def _grads(rng, n=3):
    return [{"w": {"a": (rng.randn(3, 2) * 2).astype(np.float32),
                   "b": rng.randn(2).astype(np.float32)}} for _ in range(n)]


@pytest.mark.parametrize("method, reg, clip", OPT_CASES)
def test_settings_optimizers_match_jax(tmp_path, method, reg, clip):
    path = _settings_conf(tmp_path, method, reg, clip)
    parsed, jparsed = cp.parse_config(path), jcp.parse_config(path)
    assert type(parsed.settings["learning_method"]).__name__ \
        == type(jparsed.settings["learning_method"]).__name__
    assert parsed.settings["learning_method"].kw \
        == jparsed.settings["learning_method"].kw
    rng = np.random.RandomState(11)
    tree = {"w": {"a": rng.randn(3, 2).astype(np.float32),
                  "b": rng.randn(2).astype(np.float32)}}
    grads = _grads(rng)
    got = _run_port(cp._make_optimizer(parsed.settings), tree, grads)
    want = _run_jax(jcp._make_optimizer(jparsed.settings), tree, grads)
    for g, w in zip(got, want):
        for n in ("a", "b"):
            np.testing.assert_allclose(g["w"][n], w["w"][n], rtol=OPT_TOL,
                                       atol=OPT_TOL)


@pytest.mark.parametrize("sched, a, b", [("poly", 0.5, 0.75),
                                         ("exp", 0.5, 2.0),
                                         ("discexp", 0.5, 2.0),
                                         ("linear", 0.01, 0.02)])
def test_settings_decayed_schedule_follows_jax_schedules(tmp_path, sched,
                                                         a, b):
    """The port lowers a decayed schedule by name; held against JAX's own
    ``optim.schedules`` function driving JAX's optimizer (JAX's parser
    cannot build it: test_jax_parser_refuses_every_decayed_schedule)."""
    path = _settings_conf(
        tmp_path, "MomentumOptimizer(momentum=0.5)", None, None,
        f", learning_rate_schedule='{sched}', learning_rate_decay_a={a}, "
        f"learning_rate_decay_b={b}")
    parsed = cp.parse_config(path)
    rng = np.random.RandomState(12)
    tree = {"w": {"a": rng.randn(3, 2).astype(np.float32),
                  "b": rng.randn(2).astype(np.float32)}}
    grads = _grads(rng, 4)
    got = _run_port(cp._make_optimizer(parsed.settings), tree, grads)
    want = _run_jax(jax_optim.Momentum(
        learning_rate=getattr(jax_optim.schedules, sched)(0.05, a, b),
        momentum=0.5), tree, grads)
    for g, w in zip(got, want):
        for n in ("a", "b"):
            np.testing.assert_allclose(g["w"][n], w["w"][n], rtol=OPT_TOL,
                                       atol=OPT_TOL)


def test_settings_manual_schedule_follows_jax_schedules(tmp_path):
    """The reference's manual schedule (learning_rate_args
    "step:multiplier,..."), held against JAX's ``schedules.manual``
    driving JAX's optimizer (JAX's parser drops it for a constant)."""
    path = _settings_conf(
        tmp_path, "MomentumOptimizer(momentum=0.5)", None, None,
        ", learning_rate_schedule='manual', "
        "learning_rate_args='1:1.0,2:0.5,3:0.25'")
    parsed = cp.parse_config(path)
    rng = np.random.RandomState(13)
    tree = {"w": {"a": rng.randn(3, 2).astype(np.float32),
                  "b": rng.randn(2).astype(np.float32)}}
    grads = _grads(rng, 4)
    got = _run_port(cp._make_optimizer(parsed.settings), tree, grads)
    want = _run_jax(jax_optim.Momentum(
        learning_rate=jax_optim.schedules.manual(
            0.05, [(1, 1.0), (2, 0.5), (3, 0.25)]), momentum=0.5),
        tree, grads)
    for g, w in zip(got, want):
        for n in ("a", "b"):
            np.testing.assert_allclose(g["w"][n], w["w"][n], rtol=OPT_TOL,
                                       atol=OPT_TOL)


def test_jax_parser_refuses_every_decayed_schedule(tmp_path):
    """ROADMAP C22: JAX's ``_make_optimizer`` hands the optimizer the
    schedule function as ``learning_rate_schedule``, which
    ``schedules.get`` takes for a name, so any decayed schedule raises."""
    path = _settings_conf(
        tmp_path, "MomentumOptimizer(momentum=0.5)", None, None,
        ", learning_rate_schedule='poly', learning_rate_decay_a=0.5, "
        "learning_rate_decay_b=0.75")
    with pytest.raises(KeyError, match="unknown lr schedule"):
        jcp._make_optimizer(jcp.parse_config(path).settings)
    parsed = cp.parse_config(path)
    assert cp._make_optimizer(parsed.settings) is not None


def test_unlowered_schedule_is_refused(tmp_path):
    path = _settings_conf(
        tmp_path, "MomentumOptimizer()", None, None,
        ", learning_rate_schedule='pass_manual', learning_rate_decay_a=1.0")
    with pytest.raises(ConfigError, match="pass_manual"):
        cp._make_optimizer(cp.parse_config(path).settings)


def test_config_without_outputs_refused_as_jax(tmp_path):
    path = tmp_path / "none.py"
    _write(path, "from paddle.trainer_config_helpers import *\n"
                 "settings(batch_size=8)\n")
    with pytest.raises(JaxConfigError, match="declared no outputs"):
        jcp.parse_config(str(path))
    with pytest.raises(ConfigError, match="declared no outputs"):
        cp.parse_config(str(path))


# ------------------------------------------------------------ sys.modules

def _paddle_entries():
    return {k: v for k, v in sys.modules.items()
            if k == "paddle" or k.startswith("paddle.")}


def _summary(parsed):
    topo = L.Topology(parsed.outputs)
    return _layers(topo), parsed.input_order, topo.param_shapes()


def test_port_parse_leaves_paddle_modules_as_found(s2s_dir, jax_s2s):
    """Port, then JAX, then port: each port parse equals the one alone
    and leaves the JAX shim's ``paddle`` entries (the same objects) as
    it found them; a port parse that raises restores them too."""
    alone = _summary(_port_s2s(s2s_dir)[0])
    with contextlib.chdir(s2s_dir):
        jcp.parse_config(TRAIN_CONF, S2S_ARGS)     # imports the root shim
    before = _paddle_entries()
    assert "paddle.trainer_config_helpers" in before
    assert before["paddle"].__file__.startswith(os.path.join(REPO, "paddle"))
    again = _summary(_port_s2s(s2s_dir)[0])
    assert again == alone
    after = _paddle_entries()
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)
    bad = s2s_dir / "bad.conf"
    _write(bad, "from paddle.trainer_config_helpers import *\n"
                "import paddle\nassert paddle.__name__.startswith("
                "'paddle_tpu_torch')\nraise RuntimeError('config fails')\n")
    with pytest.raises(RuntimeError, match="config fails"):
        cp.parse_config(str(bad))
    after = _paddle_entries()
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)
    assert not any(k.startswith("seqtoseq_net") for k in sys.modules)
    # and JAX's parse after the port's equals JAX's alone
    with contextlib.chdir(s2s_dir):
        j2 = jcp.parse_config(TRAIN_CONF, S2S_ARGS)
    assert _layers(JL.Topology(j2.outputs)) == _layers(jax_s2s["topo"])
    assert j2.input_order == jax_s2s["parsed"].input_order


def test_port_and_jax_providers_do_not_share_a_module(s2s_dir, jax_s2s):
    _port_s2s(s2s_dir)
    port_keys = [k for k in sys.modules
                 if k.startswith("_ptpu_torch_provider_")]
    jax_keys = [k for k in sys.modules if k.startswith("_ptpu_provider_")]
    assert port_keys and jax_keys
    for k in port_keys:
        assert sys.modules[k].integer_value_sequence \
            is integer_value_sequence
    for k in jax_keys:
        assert "paddle_tpu_torch" not in sys.modules[
            k].integer_value_sequence.__module__


NO_JAX = """
import sys
from paddle_tpu_torch.compat import config_to_runtime, parse_config
from paddle_tpu_torch.data import DataFeeder
from paddle_tpu_torch.data.provider import integer_value_sequence
from paddle_tpu_torch.trainer import SGD
cfg = config_to_runtime(parse_config(sys.argv[1], "dim=16,batch_size=4"))
tr = SGD(cfg["cost"], update_equation=cfg["optimizer"], device="cpu")
feeder = DataFeeder(cfg["feeding"], device="cpu")
batch = next(cfg["train_reader"]())
costs = [float(tr.train_one_batch(batch, feeder=feeder)) for _ in range(2)]
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
assert not bad, bad
assert costs[1] < costs[0], costs
import json
from paddle_tpu_torch.layers import Topology
topo = Topology(cfg["cost"])
print(json.dumps([[[n.name, n.layer_type, n.size, n.is_seq]
                   for n in topo.order],
                  {k: {n: list(s) for n, s in v.items()}
                   for k, v in topo.param_shapes().items()}]))
"""


def test_a_port_parse_and_step_imports_no_jax(s2s_dir):
    """The port alone, in a fresh process: no jax, no paddle_tpu, and
    the same graph as the port's parse here, after JAX's."""
    out = subprocess.run([sys.executable, "-c", NO_JAX, TRAIN_CONF],
                         cwd=s2s_dir, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    layers, shapes = json.loads(out.stdout.strip().splitlines()[-1])
    topo = L.Topology(_port_s2s(s2s_dir)[0].outputs)
    assert [tuple(x) for x in layers] == _layers(topo)
    assert {k: {n: tuple(s) for n, s in v.items()}
            for k, v in shapes.items()} == topo.param_shapes()


def test_port_package_imports_no_jax_nor_root_paddle():
    """Every module of paddle_tpu_torch imports, in a fresh process,
    without loading jax, paddle_tpu or the root paddle package."""
    code = """
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    if m.name.endswith("__main__"):
        continue
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "paddle_tpu", "paddle"))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


# ------------------------------------------------------------------ CLI

def test_cli_trains_train_conf_with_jax_clis_pass_end_keys(s2s_dir):
    """``python -m paddle_tpu_torch train`` on the v1 config, on the CPU,
    writes the pass-end parameter keys JAX's CLI writes on it."""
    from paddle_tpu.trainer import cli as jax_cli
    args = ["train", "--config", TRAIN_CONF, "--config_args", S2S_ARGS,
            "--num_passes", "1"]
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", *args, "--device", "cpu",
         "--save_dir", str(s2s_dir / "port_out")], cwd=s2s_dir,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert jax_cli.main([*args, "--save_dir", str(s2s_dir / "jax_out")]) \
        in (0, None)
    got = np.load(s2s_dir / "port_out" / "pass-00000" / "params.npz")
    want = np.load(s2s_dir / "jax_out" / "pass-00000" / "params.npz")
    assert sorted(got.files) == sorted(want.files) and got.files
    for k in want.files:
        assert got[k].shape == want[k].shape, k


SIBLING_NAMED_V1 = """
from paddle.trainer_config_helpers import *
settings(batch_size=2)
outputs(fc_layer(input=data_layer(name="x", size=3), size=2))
"""


def test_a_config_named_like_a_package_module_parses(tmp_path):
    """JAX's sibling finder matches a dotted module by its last name, so a
    config file called v1.py stands in for ``paddle_tpu.compat.v1`` when
    the parse first imports it (ROADMAP C23; a fresh process, where the
    parse is that first import).  The port's finder takes top-level
    names only."""
    path = tmp_path / "v1.py"
    _write(path, SIBLING_NAMED_V1)
    code = ("import sys\nfrom paddle_tpu.compat import parse_config\n"
            "try:\n    parse_config(sys.argv[1])\n"
            "except NameError as e:\n    print('NameError', e)\n")
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.startswith("NameError"), (out.stdout, out.stderr[-2000:])
    code = code.replace("paddle_tpu.compat", "paddle_tpu_torch.compat") \
        + "else:\n    print('parsed')\n"
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "parsed", out.stderr[-2000:]


def test_cli_jobs_accept_a_v1_config(inline_dir, capsys):
    """train, test, time and checkgrad on a v1 config (the list-style
    provider's classifier), in process on the CPU."""
    from paddle_tpu_torch.trainer import cli
    conf = str(inline_dir / "list_conf.py")
    out = str(inline_dir / "cli_out")
    base = ["--config", conf, "--device", "cpu"]
    assert cli.main(["train", *base, "--save_dir", out]) == 0
    assert os.path.isdir(os.path.join(out, "pass-00000"))
    assert cli.main(["test", *base, "--model_dir", out]) == 0
    assert cli.main(["time", *base, "--num_batches", "1",
                     "--warmup", "1"]) == 0
    assert cli.main(["checkgrad", *base]) == 0
    text = capsys.readouterr().out
    assert "test cost:" in text and "time: 1 batches" in text
    assert "checkgrad PASSED" in text
