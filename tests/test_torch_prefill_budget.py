"""The server CLI's ``--prefill-chunk-budget`` (ROADMAP C21) in the port
and in the JAX package on the CPU: both parsers take it with the FLAGS
default, ``batcher_from_args`` hands it to the engine, and the
budgeted batchers of both CLIs, on JAX's demo weights, stream the
tokens of JAX's ``lm_generate``.

Token comparisons: a token is compared while the reference's top-1 /
top-2 logit margin exceeds MARGIN (tests/test_torch_engine.py's rule),
and most tokens must be compared.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.serving import server as jax_server
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.serving import server
from paddle_tpu_torch.utils.flags import FLAGS

MARGIN = 1e-5
SMALL = ["--slots", "4", "--max-len", "64"]
JAX_SMALL = ["--gen-slots", "4", "--gen-max-len", "64"]
HEADS = 2


class _Parsed(Exception):
    pass


def _jax_args(monkeypatch, argv):
    """The args JAX's server main parses from ``argv``, caught where it
    would build its demo batcher."""
    seen = {}

    def capture(args, tiny=False, metrics=None):
        seen["args"] = args
        raise _Parsed

    monkeypatch.setattr(jax_server, "_demo_gen_batcher", capture)
    with pytest.raises(_Parsed):
        jax_server.main(["--demo-generate", *argv])
    monkeypatch.undo()
    return seen["args"]


def test_both_clis_parse_the_budget_with_the_flags_default(monkeypatch):
    assert server.parse_args([]).prefill_chunk_budget \
        == FLAGS.serving_prefill_chunk_budget == 0
    assert server.parse_args(["--prefill-chunk-budget", "4"]) \
        .prefill_chunk_budget == 4
    assert _jax_args(monkeypatch, []).prefill_chunk_budget == 0
    assert _jax_args(monkeypatch, ["--prefill-chunk-budget", "4"]) \
        .prefill_chunk_budget == 4


def _check(tokens, ref_ids, n_prompt, margins):
    n = 0
    for t, tok in enumerate(tokens):
        if margins[n_prompt - 1 + t] < MARGIN:
            break
        assert tok == int(ref_ids[n_prompt + t]), (t, tokens, ref_ids)
        n += 1
    return n


def test_budgeted_batchers_stream_jax_lm_generate(monkeypatch):
    jargs = _jax_args(monkeypatch, ["--prefill-chunk-budget", "4",
                                    *JAX_SMALL])
    jgen = jax_server._demo_gen_batcher(jargs)
    jp = jgen.engine.params
    assert jgen.engine.prefill_chunk_budget == 4
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    # the port's demo trunk on JAX's demo weights
    monkeypatch.setattr(torch_tf, "init_lm", lambda *a, **kw: tp)
    gen = server.batcher_from_args(server.parse_args(
        ["--demo-generate", "--prefill-chunk-budget", "4", "--device", "cpu",
         *SMALL]))
    eng = gen.engine
    assert eng.prefill_chunk_budget == 4 and eng.prefill_chunk == 8
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, n) for n in (9, 17, 5, 23)]
    n_tok = 8
    try:
        futs = [gen.submit(p.tolist(), max_tokens=n_tok) for p in prompts]
        outs = [f.result(timeout=120)["tokens"] for f in futs]
        jfuts = [jgen.submit(p.tolist(), max_tokens=n_tok) for p in prompts]
        jouts = [f.result(timeout=300)["tokens"] for f in jfuts]
        snap = eng.metrics.snapshot()
    finally:
        gen.close()
        jgen.close()
    # the budget held: at most 4 teacher-forced lanes a step
    assert 0 < eng.metrics.prefill_lane_steps_total \
        <= 4 * snap["decode_steps_total"]
    lengths = np.asarray([p.size for p in prompts])
    padded = np.zeros((len(prompts), lengths.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :p.size] = p
    ids = np.asarray(jax_tf.lm_generate(jp, padded, lengths.max() + n_tok,
                                        HEADS, prompt_lengths=lengths))
    hidden, _ = jax_tf.lm_prefill(jp, jnp.asarray(ids), ids.shape[1], HEADS)
    top2 = np.sort(np.asarray(jax_tf._lm_project(jp, hidden)), -1)
    margins = top2[..., -1] - top2[..., -2]
    for streams in (outs, jouts):
        checked = sum(_check(toks, ids[i], lengths[i], margins[i])
                      for i, toks in enumerate(streams))
        assert checked >= 0.9 * n_tok * len(prompts)
