"""Attention NMT encoder-decoder (``paddle_tpu/models/seq2seq.py``; the
reference's demo/seqToseq: bi-GRU encoder, Bahdanau attention, GRU
decoder, generation).

Parameters are a nested dict with the JAX tree's keys:

    {"src_emb": [Vs, E], "trg_emb": [Vt, E],
     "enc_fwd" / "enc_bwd": {"w_in": [E, 3H], "w_gate": [H, 2H],
                             "w_state": [H, H], "b": [3H]},
     "att_enc": [2H, A], "att_dec": [H, A], "att_v": [A],
     "boot": {"w": [H, H], "b": [H]},
     "dec_in": [E + 2H, 3H], "dec_b": [3H], "dec_gate": [H, 2H],
     "dec_state": [H, H],
     "out1": {"w": [3H + E, H], "b": [H]}, "out2": {"w": [H, Vt], "b": [Vt]}}

The encoder's two GRUs are ``ops/rnn.gru`` (the GRU kernels on the card
where ``gru.supported`` holds).  The teacher-forced decoder is a Python
loop over the target steps of ``gru_cell`` steps: in JAX it is a
``lax.scan`` that reaches no kernel, so it is plain PyTorch here.
Beam-search ``generate`` waits for ``ops/beam.beam_search`` (ROADMAP
A10).
"""

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops import beam as beam_ops
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.ops import initializers, linear, losses, rnn
from paddle_tpu_torch.utils.tree import tree_map

_GRU_KEYS = {"w_in", "w_gate", "w_state", "b"}
_TOP_KEYS = {"src_emb", "trg_emb", "enc_fwd", "enc_bwd", "att_enc",
             "att_dec", "att_v", "boot", "dec_in", "dec_b", "dec_gate",
             "dec_state", "out1", "out2"}


def init(generator, src_vocab=30000, trg_vocab=30000, emb_dim=512,
         hidden=512, att_dim=None, device=None):
    """Random parameters drawn from ``generator`` (the port's own init,
    not JAX's random bits) with the JAX ``init``'s rules
    (``seq2seq.py:21-56``): embeddings U(-0.1, 0.1), weights normal with
    std 1/sqrt(fan_in), biases 0.  Placed on ``device`` (the card unless
    "cpu")."""
    dev = _device.resolve(device)
    att_dim = att_dim or hidden
    gen, h, e = generator, hidden, emb_dim
    ninit, zeros = initializers.normal(), initializers.constant(0.0)
    uinit = initializers.uniform(0.1)

    def gru_params():
        return {"w_in": ninit(gen, (e, 3 * h)),
                "w_gate": ninit(gen, (h, 2 * h)),
                "w_state": ninit(gen, (h, h)),
                "b": zeros(gen, (3 * h,))}

    params = {"src_emb": uinit(gen, (src_vocab, e)),
              "trg_emb": uinit(gen, (trg_vocab, e)),
              "enc_fwd": gru_params(), "enc_bwd": gru_params(),
              "att_enc": ninit(gen, (2 * h, att_dim)),
              "att_dec": ninit(gen, (h, att_dim)),
              "att_v": ninit(gen, (att_dim,)),
              "boot": {"w": ninit(gen, (h, h)), "b": zeros(gen, (h,))},
              "dec_in": ninit(gen, (e + 2 * h, 3 * h)),
              "dec_b": zeros(gen, (3 * h,)),
              "dec_gate": ninit(gen, (h, 2 * h)),
              "dec_state": ninit(gen, (h, h)),
              "out1": {"w": ninit(gen, (h + 2 * h + e, h)),
                       "b": zeros(gen, (h,))},
              "out2": {"w": ninit(gen, (h, trg_vocab)),
                       "b": zeros(gen, (trg_vocab,))}}
    return tree_map(lambda t: t.to(dev), params)


def params_from_numpy(tree, device=None):
    """The JAX tree as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    params)``) -> the port's dict, same keys, float32 on ``device``."""
    dev = _device.resolve(device)
    if set(tree) != _TOP_KEYS or any(
            set(tree[k]) != _GRU_KEYS for k in ("enc_fwd", "enc_bwd")) \
            or any(set(tree[k]) != {"w", "b"}
                   for k in ("boot", "out1", "out2")):
        raise ValueError(f"not a seq2seq tree: keys {sorted(tree)}")
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=dev), tree)


def encode(params, src: SequenceBatch):
    """-> (enc_states SequenceBatch [B, T, 2H], enc_proj SequenceBatch
    [B, T, A], boot decoder state [B, H])."""
    x = emb_ops.embedding_lookup(params["src_emb"], src.data)
    pf, pb = params["enc_fwd"], params["enc_bwd"]
    fwd, _ = rnn.gru(SequenceBatch(linear.matmul(x, pf["w_in"]),
                                   src.lengths),
                     pf["w_gate"], pf["w_state"], bias=pf["b"])
    bwd, _ = rnn.gru(SequenceBatch(linear.matmul(x, pb["w_in"]),
                                   src.lengths),
                     pb["w_gate"], pb["w_state"], bias=pb["b"], reverse=True)
    enc = rnn.bidirectional(fwd, bwd)
    proj = SequenceBatch(linear.matmul(enc.data, params["att_enc"]),
                         enc.lengths)
    # reference decoder_boot: fc(tanh) of the backward encoder's first step
    boot = torch.tanh(linear.matmul(bwd.data[:, 0], params["boot"]["w"])
                      + params["boot"]["b"])
    return enc, proj, boot


def _dec_step(params, enc, enc_proj, state, emb_t):
    """One decoder step: attention + GRU + readout.  state [B, H] ->
    (new state, logits [B, V])."""
    dec_proj = linear.matmul(state, params["att_dec"])
    scores = attn_ops.additive_attention_scores(enc_proj, dec_proj,
                                                params["att_v"])
    context = attn_ops.attention_context(scores, enc)          # [B, 2H]
    x = torch.cat([emb_t, context], dim=-1)
    x3 = linear.matmul(x, params["dec_in"]) + params["dec_b"]
    new_state = rnn.gru_cell(x3, state, params["dec_gate"],
                             params["dec_state"])
    readout = torch.tanh(linear.matmul(
        torch.cat([new_state, context, emb_t], dim=-1),
        params["out1"]["w"]) + params["out1"]["b"])
    logits = linear.matmul(readout, params["out2"]["w"]) + params["out2"]["b"]
    return new_state, logits


def forward(params, src: SequenceBatch, trg_in: SequenceBatch):
    """Teacher-forced decode -> logits [B, T_trg, V].  A row past its
    length keeps its state (the masked merge of ``seq2seq.py:100-104``)."""
    enc, enc_proj, boot = encode(params, src)
    emb = emb_ops.embedding_lookup(params["trg_emb"], trg_in.data)
    live = trg_in.mask(emb.dtype)[..., None] > 0              # [B, T, 1]
    state, logits = boot, []
    for t in range(emb.shape[1]):
        new_state, lg = _dec_step(params, enc, enc_proj, state, emb[:, t])
        state = torch.where(live[:, t], new_state, state)
        logits.append(lg)
    return torch.stack(logits, dim=1)


def loss(params, src: SequenceBatch, trg_in: SequenceBatch,
         trg_next: SequenceBatch):
    logits = forward(params, src, trg_in)
    labels = trg_next.data
    if labels.dim() == 3:
        labels = labels[..., 0]
    per_tok = losses.classification_cost(logits, labels)
    per_seq = losses.masked_seq_mean(per_tok, trg_in.mask(per_tok.dtype))
    return torch.mean(per_seq)


def generate(params, src: SequenceBatch, beam_size=5, max_len=50, bos_id=0,
             eos_id=1, length_penalty=0.0):
    """Beam-search translation: not yet ported (``ops/beam.beam_search``,
    ROADMAP A10)."""
    raise NotImplementedError("seq2seq.generate needs ops/beam.beam_search, "
                              "not yet ported to paddle_tpu_torch "
                              "(ROADMAP A10); greedy_generate is")


def greedy_generate(params, src: SequenceBatch, max_len=50, bos_id=0,
                    eos_id=1):
    """Argmax translation (``seq2seq.py:142-151``) -> (tokens [B,
    max_len] int32, lengths [B]).  Runs without autograd, so that the
    encoder takes the lean GRU forward even on parameters that require
    gradients."""
    with torch.no_grad():
        b = src.data.shape[0]
        enc, enc_proj, boot = encode(params, src)

        def step_fn(state, prev_ids):
            emb_t = emb_ops.embedding_lookup(params["trg_emb"], prev_ids)
            new_state, logits = _dec_step(params, enc, enc_proj, state,
                                          emb_t)
            return torch.log_softmax(logits, dim=-1), new_state

        return beam_ops.greedy_search(step_fn, boot, b, max_len, bos_id,
                                      eos_id)
