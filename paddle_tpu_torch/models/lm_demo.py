"""demo/lm (``demo/lm/train_and_sample.py``): a decoder-only char LM
over ``models/transformer``, trained padding-free on packed rows, then
sampled through the KV-cached generator.

The grammar is the demo's: "<subject> <verb> <object>." over three
subjects, two verbs and three objects, one token per character, BOS 1,
pad 0 (vocab 20).  ``reader.packed`` first-fit packs 512 sentences of
``RandomState(0)`` into full rows of ``max_len`` 24 (``buffer_size``
64), batched 16 with the tail dropped; each row carries its
``segment_ids`` and ``positions``, so the attention is block-diagonal
per segment: JAX's route at T 24 with segments is the dense masked
path, and so is the port's (no flash kernel; the segments need it).
The trunk is ``transformer.init(d_model 48, dff 96, 2 encoder layers,
dec_layers 0, max_len 24)`` at 4 heads, trained by ``lm_loss`` under
``Adam(3e-3)``.  Sampling is ``lm_generate`` from the prompts "cat " and
"bird ": greedy, and at temperature 0.7 over the top 8.  On the card its
prompt's prefill runs the flash forward kernel; its per-token steps
(``lm_decode_step``) attend by the masked plain path, as JAX's do.

``python -m paddle_tpu_torch.models.lm_demo [--epochs N] [--device
cpu]`` trains and prints the samples.
"""

import argparse

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.utils.tree import value_and_grad

# the grammar: subject verb object ".", tokenized per char
WORDS = {
    "sub": ["cat", "dog", "bird"],
    "verb": ["sees", "likes"],
    "obj": ["fish", "seed", "bone"],
}
CHARS = sorted({c for ws in WORDS.values() for w in ws for c in w}
               | {" ", "."})
PAD, BOS = 0, 1
VOCAB = len(CHARS) + 2
ENC = {c: i + 2 for i, c in enumerate(CHARS)}
DEC = {i: c for c, i in ENC.items()}

MAX_LEN = 24
BATCH = 16
D_MODEL, DFF, LAYERS, HEADS = 48, 96, 2, 4
LR = 3e-3
N_SENTENCES = 512
PROMPTS = ("cat ", "bird ")
TEMPERATURE, TOP_K = 0.7, 8


def sentences(n, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        s = " ".join([rng.choice(WORDS["sub"]), rng.choice(WORDS["verb"]),
                      rng.choice(WORDS["obj"])]) + "."
        yield np.asarray([BOS] + [ENC[c] for c in s], np.int32)


def packed_batches(max_len=MAX_LEN, batch=BATCH, n=N_SENTENCES):
    """The demo's reader: batches of packed rows, each row (tokens,
    segment_ids, positions) of ``max_len``."""
    return reader_mod.batch(
        reader_mod.packed(lambda: sentences(n), max_len, buffer_size=64),
        batch, drop_last=True)


def stack(rows):
    """A batch of packed rows as three [B, T] int32 arrays."""
    return tuple(np.stack([r[k] for r in rows]) for k in range(3))


def init(seed=0, device=None, max_len=MAX_LEN):
    """The demo's trunk from the port's own init (a CPU generator seeded
    ``seed``; JAX's PRNGKey draws differ)."""
    return transformer.init(torch.Generator().manual_seed(seed),
                            src_vocab=VOCAB, trg_vocab=1, d_model=D_MODEL,
                            dff=DFF, enc_layers=LAYERS, dec_layers=0,
                            max_len=max_len, device=device)


def loss(params, data, seg, pos):
    """``lm_loss`` of one packed batch (tensors on the params' device)."""
    toks = SequenceBatch(data, torch.full((data.shape[0],), data.shape[1],
                                          dtype=torch.int32,
                                          device=data.device))
    return transformer.lm_loss(params, toks, HEADS, segment_ids=seg,
                               positions=pos)


class Trainer:
    """The demo's jitted step as a function of the parameter tree:
    ``lm_loss`` and its gradient, then ``Adam(3e-3).update``."""

    def __init__(self, params):
        self.params = params
        self.opt = Adam(learning_rate=LR)
        self.state = self.opt.init(params)
        self.device = params["src_emb"].device

    def step(self, rows):
        data, seg, pos = (torch.as_tensor(a, device=self.device)
                          for a in stack(rows))
        value, g = value_and_grad(lambda p: loss(p, data, seg, pos),
                                  self.params)
        self.params, self.state = self.opt.update(g, self.state,
                                                  self.params)
        return value


def encode_prompt(text):
    return np.asarray([[BOS] + [ENC[c] for c in text]], np.int32)


def decode(ids):
    return "".join(DEC.get(int(i), "") for i in ids[1:])


def generate(params, prompt_txt, generator=None, max_len=MAX_LEN):
    """The demo's samples: greedy with no generator, else temperature
    0.7 over the top 8 drawn from ``generator`` (a ``torch.Generator``
    on the params' device).  Returns the ids [max_len]."""
    kw = ({} if generator is None else
          dict(temperature=TEMPERATURE, top_k=TOP_K, generator=generator))
    with torch.no_grad():
        return transformer.lm_generate(params, encode_prompt(prompt_txt),
                                       max_len=max_len, num_heads=HEADS,
                                       **kw)[0].cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.models."
                                      "lm_demo")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    tr = Trainer(init(device=dev))
    batches = packed_batches()
    value = None
    for epoch in range(args.epochs):
        for rows in batches():
            value = tr.step(rows)
        print(f"epoch {epoch}: loss {float(value):.4f}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    for prompt_txt in PROMPTS:
        print(f"greedy   {prompt_txt!r} -> "
              f"{decode(generate(tr.params, prompt_txt))!r}", flush=True)
        print(f"sampled  {prompt_txt!r} -> "
              f"{decode(generate(tr.params, prompt_txt, gen))!r}",
              flush=True)
    return float(value)


if __name__ == "__main__":
    main()
