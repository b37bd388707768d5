"""The rest of ``optim`` (A9·f): every lr schedule, the optimizers' row
path with ``clip_scale``, and Polyak averaging, against the JAX
package's on the CPU.

Schedules are evaluated over steps 0-40 through ``schedules.get`` (JAX's
side vmapped under one ``jax.jit``), at and around every boundary, and
inside Momentum and Adam over three steps; each optimizer's
``row_update`` on a gathered row block and ``averaging`` over three
steps.  Schedules to 1e-6 relative (float32 on both sides); leaves
within 1e-5 of each one's largest entry.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.optim import averaging as jax_avg
from paddle_tpu.optim import schedules as jax_sched
from paddle_tpu_torch import optim
from paddle_tpu_torch.optim import averaging, schedules
from paddle_tpu_torch.utils.tree import tree_leaves

TOL = 1e-5
STEPS = np.arange(41)

# name -> get's keywords; boundaries inside 0..40 (discexp every 10,
# linear's floor at 26.7, manual at 10/20/30, pass_manual every 7 steps,
# warmup_cosine's end of warm-up at 5 and of the cosine at 35)
SCHEDULES = {
    "constant": {},
    "poly": {"decay_a": 0.3, "decay_b": 0.7},
    "exp": {"decay_a": 0.5, "decay_b": 7},
    "discexp": {"decay_a": 0.5, "decay_b": 10},
    "linear": {"decay_a": 0.003, "decay_b": 0.02},
    "manual": {"segments": [(10, 1.0), (20, 0.5), (30, 0.1)]},
    "pass_manual": {"segments": [(0, 1.0), (1, 0.5), (2, 0.1)],
                    "steps_per_pass": 7},
    "warmup_cosine": {"warmup_steps": 5, "total_steps": 35,
                      "min_ratio": 0.1},
}
# the same families, fast enough to move inside three optimizer steps
FAST = {
    "constant": {},
    "poly": {"decay_a": 0.5, "decay_b": 1.0},
    "exp": {"decay_a": 0.5, "decay_b": 2},
    "discexp": {"decay_a": 0.5, "decay_b": 1},
    "linear": {"decay_a": 0.03, "decay_b": 0.05},
    "manual": {"segments": [(0, 1.0), (1, 0.5), (2, 0.25)]},
    "pass_manual": {"segments": [(0, 1.0), (1, 0.5)], "steps_per_pass": 2},
    "warmup_cosine": {"warmup_steps": 1, "total_steps": 3,
                      "min_ratio": 0.2},
}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_over_steps(name):
    kw = SCHEDULES[name]
    want = np.asarray(jax.jit(jax.vmap(jax_sched.get(name, 0.1, **kw)))(
        jnp.asarray(STEPS)))
    sched = schedules.get(name, 0.1, **kw)
    got = np.asarray([sched(int(t)) for t in STEPS])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if name in ("discexp", "manual"):
        # a step equal to a boundary keeps that segment, the next moves on
        assert got[10] == got[9] * (0.5 if name == "discexp" else 1.0)
        assert got[11] == got[10] * (1.0 if name == "discexp" else 0.5)


def test_schedule_refusals_match_jax():
    for mod in (jax_sched, schedules):
        with pytest.raises(ValueError, match="steps_per_pass"):
            mod.get("pass_manual", 1.0, segments=[(0, 1.0)])
        with pytest.raises(KeyError, match="bogus"):
            mod.get("bogus", 0.1)


def _tree(rng):
    return {"fc": {"w": rng.randn(4, 3).astype(np.float32),
                   "b": rng.randn(3).astype(np.float32)}}


def _torch_tree(tree):
    return {k: {n: torch.tensor(a) for n, a in v.items()}
            for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(FAST))
def test_schedules_inside_momentum_and_adam(name):
    """Three updates of Momentum and of Adam under the schedule (its
    keywords through ``sched_kw``): parameters and slots."""
    rng = np.random.RandomState(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]

    def make(mod, kind):
        kw = {"learning_rate": 0.1, "learning_rate_schedule": name,
              "sched_kw": FAST[name]}
        return (mod.Momentum(momentum=0.9, **kw) if kind == "momentum"
                else mod.Adam(**kw))

    def jrun(p, gs):
        out = {}
        for kind in ("momentum", "adam"):
            opt = make(jax_optim, kind)
            q, st = p, opt.init(p)
            for g in gs:
                q, st = opt.update(g, st, q)
            out[kind] = (q, st["slots"])
        return out
    want = jax.jit(jrun)(params, grads)
    for kind in ("momentum", "adam"):
        opt = make(optim, kind)
        p = _torch_tree(params)
        st = opt.init(p)
        for g in grads:
            opt.update(_torch_tree(g), st, p)
        assert st["step"] == 3
        for got, ref in zip(tree_leaves([p, st["slots"]]),
                            jax.tree_util.tree_leaves(want[kind])):
            _close(got.numpy(), ref, f"{name} {kind}")


@pytest.mark.parametrize("kind", ["momentum", "adagrad", "adadelta",
                                  "rmsprop", "decayed_adagrad", "adam",
                                  "adamax"])
def test_row_update_with_clip_scale_matches_jax(kind):
    """Each optimizer's row path on a gathered block of 5 rows at step 2,
    with a caller's clip_scale and the elementwise clip before it, and
    L2: rows and slot rows."""
    rng = np.random.RandomState(1)
    rows = {"w": rng.randn(5, 4).astype(np.float32)}
    grads = {"w": rng.randn(5, 4).astype(np.float32)}
    cfg = {"learning_rate": 0.05, "clip_threshold": 1.0, "clip_norm": 2.0,
           "l2": 1e-2}
    jopt, topt = jax_optim.get(kind, **cfg), optim.get(kind, **cfg)
    slot0 = jax.tree_util.tree_map(
        lambda a: jnp.abs(jnp.asarray(a)) * 0.1, jopt.row_init(rows))

    def jrow(r, g, s):
        return jopt.row_update(g, s, r, jnp.asarray(2, jnp.int32),
                               clip_scale=jnp.asarray(0.3, jnp.float32))
    want = jax.jit(jrow)(rows, grads, slot0)
    slots = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                   slot0)
    trows = {"w": torch.tensor(rows["w"])}
    got = topt.row_update({"w": torch.tensor(grads["w"])}, slots, trows, 2,
                          clip_scale=torch.tensor(0.3))
    assert topt.clip_norm == 2.0 and topt.clip_threshold == 1.0
    assert set(topt.row_init(trows)) == set(jopt.row_init(rows))
    for g, w in zip(tree_leaves(list(got)),
                    jax.tree_util.tree_leaves(want)):
        _close(g.numpy(), w, kind)


@pytest.mark.parametrize("decay", [None, 0.9], ids=["plain", "decay"])
def test_averaging_matches_jax(decay):
    rng = np.random.RandomState(2)
    params = _tree(rng)
    steps = [_tree(rng) for _ in range(3)]
    jst = jax_avg.init(params)
    tst = averaging.init(_torch_tree(params))
    # apply before any accumulate: the live parameters
    for got, want in zip(tree_leaves(averaging.apply(
            tst, _torch_tree(params))), jax.tree_util.tree_leaves(
                jax_avg.apply(jst, params))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for p in steps:
        jst = jax_avg.accumulate(jst, p, decay=decay)
        tst = averaging.accumulate(tst, _torch_tree(p), decay=decay)
    assert float(tst.count) == float(jst.count)
    _close_tree = zip(tree_leaves(averaging.apply(tst, _torch_tree(params))),
                      jax.tree_util.tree_leaves(jax_avg.apply(jst, params)))
    for got, want in _close_tree:
        _close(got.numpy(), want, f"averaging decay={decay}")
    for got, want in zip(tree_leaves(tst.sum_),
                         jax.tree_util.tree_leaves(jst.sum_)):
        _close(got.numpy(), want, "sum")
    tst = averaging.reset(tst, _torch_tree(params))
    assert float(tst.count) == 0 and not any(
        t.any() for t in tree_leaves(tst.sum_))
