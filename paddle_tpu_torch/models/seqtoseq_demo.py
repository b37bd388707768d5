"""demo/seqToseq's training script (``demo/seqToseq/train.py``; the
reference's demo/seqToseq seqToseq_net.py): the attention NMT of
``models/seq2seq`` trained on the ``wmt14`` loader and decoded by beam
search.

At the demo's widths (hidden 256, emb 256, batch 32, source and target
vocab 3000, ragged sources of 3-29 tokens) the encoder's two GRUs pass
the fused route's rule (B % 8 == 0, D % 128 == 0), so on the card each
runs the GRU kernels (``ops/rnn.gru``: forward and BPTT + dW a step, the
reverse one over the time-flipped ragged rows), and ``generate`` the
lean forward once a direction.  Adam lr 5e-4 with clip_norm 5.0.

    python -m paddle_tpu_torch.models.seqtoseq_demo [--num_passes N]
        [--model_dir DIR] [--generate] [--device cpu|cuda]
"""

import argparse
import itertools

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import pad_sequences
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.datasets import wmt14
from paddle_tpu_torch.models import seq2seq
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.trainer.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from paddle_tpu_torch.utils.logging import logger
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

BATCH = 32


def make_batches(batch_size=BATCH):
    """The demo's reader: the wmt14 train triples shuffled in a buffer of
    1024 (seed 0), in batches of ``batch_size``."""
    return reader_mod.batch(
        reader_mod.shuffle(wmt14.train(), 1024, seed=0), batch_size)


def feed_batch(batch, device=None):
    """(src, trg_in, trg_next) padded SequenceBatches on ``device`` (the
    card unless "cpu")."""
    return tuple(pad_sequences([np.asarray(b[i], np.int32) for b in batch],
                               device=device) for i in range(3))


def setup(hidden=256, emb=256, device=None, params=None):
    """The demo's parameters on ``device`` (drawn from a generator seeded
    0: the port's bits, with the JAX init's rules; or ``params``, a numpy
    tree such as JAX's init), its optimizer state, and ``step(src,
    trg_in, trg_next)``: one Adam step of ``seq2seq.loss`` in place,
    returning the loss."""
    dev = _device.resolve(device)
    if params is None:
        params = seq2seq.init(torch.Generator().manual_seed(0),
                              src_vocab=wmt14.SRC_DICT_SIZE,
                              trg_vocab=wmt14.TRG_DICT_SIZE, emb_dim=emb,
                              hidden=hidden, device=dev)
    else:
        params = seq2seq.params_from_numpy(params, dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = Adam(learning_rate=5e-4, clip_norm=5.0)
    opt_state = opt.init(params)

    def step(src, trg_in, trg_next):
        for p in leaves:
            p.grad = None
        loss = seq2seq.loss(params, src, trg_in, trg_next)
        loss.backward()
        opt.update(tree_map(lambda p: p.grad, params), opt_state, params)
        return loss.detach()

    return params, opt_state, step


def train(num_passes=2, save_dir="output", hidden=256, emb=256,
          device=None):
    """``num_passes`` passes over the demo's reader, logging the mean loss
    of every 10 batches and saving the parameters after each pass;
    returns them."""
    dev = _device.resolve(device)
    params, _, step = setup(hidden, emb, dev)
    for pass_id in range(num_passes):
        losses = []
        for i, batch in enumerate(make_batches()()):
            losses.append(float(step(*feed_batch(batch, dev))))
            if (i + 1) % 10 == 0:
                logger.info("pass %d batch %d loss %.4f", pass_id, i + 1,
                            np.mean(losses[-10:]))
        save_checkpoint(save_dir, pass_id, params)
    return params


def generate(model_dir, beam_size=5, max_len=40, device=None):
    """Beam-search the first 8 wmt14 test sources with the newest
    parameters in ``model_dir``, print each best hypothesis and return
    the ``BeamResult``."""
    dev = _device.resolve(device)
    tree, _, _, _ = load_checkpoint(model_dir)
    params = seq2seq.params_from_numpy(tree, dev)
    batch = list(itertools.islice(wmt14.test()(), 8))
    src, _, _ = feed_batch(batch, dev)
    res = seq2seq.generate(params, src, beam_size=beam_size,
                           max_len=max_len, bos_id=wmt14.START,
                           eos_id=wmt14.END)
    tokens, lengths = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
    src_ids, src_len = src.data.cpu().numpy(), src.lengths.cpu().numpy()
    for i in range(src_ids.shape[0]):
        hyp = [int(t) for t in tokens[i, 0, :int(lengths[i, 0])]]
        print(f"src={[int(t) for t in src_ids[i, :int(src_len[i])]]}")
        print(f"  -> {hyp} (score {float(res.scores[i, 0]):.3f})")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--generate", action="store_true")
    ap.add_argument("--model_dir", default="output")
    ap.add_argument("--num_passes", type=int, default=2)
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    if args.generate:
        generate(args.model_dir, device=args.device)
    else:
        train(args.num_passes, args.model_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
