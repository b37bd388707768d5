"""The training driver: v2-style ``SGD.train(reader, event_handler)``
(``paddle_tpu/trainer/trainer.py``; reference python/paddle/v2/
trainer.py:30-175, trainer/Trainer.cpp:261-492, TrainerInternal.cpp:
66-170).

One device, dense parameters.  Where the JAX trainer jits one step
function, a step here runs the graph eagerly (``Topology.apply``), takes
the mean of each cost, calls ``backward()`` and applies the port's
optimizer in place (``_forward`` / ``_backward`` / ``_update``, which
``scripts/bench.step_split`` times one by one).  Parameters live on the
trainer's device (the card unless "cpu"), drawn from a CPU generator
seeded with ``seed`` so that a CPU and a CUDA trainer start from the
same weights.  Checkpoints use the JAX trainer's format
(``trainer/checkpoint.py``), so either package reads the other's.

The layers' mutable state (batch norm's moving stats: ``(mean, var)``
per layer, from ``Topology.init_state``) threads through the steps as
``model_state``: each train step's forward reads it and keeps what the
layers put, ``test`` reads it in test mode, and checkpoints carry it
both ways across the packages.

``quant_weights=True`` trains with int8 weight streaming, as the JAX
trainer does: every 2-D float32 weight of at least ``quant_min_size``
elements keeps an int8 twin (``quant/weights.quantize_tree``'s codes and
per-column scales); the step's forward and backward read the dequantized
twin, the gradients update the float32 masters, and the masters are
requantized (deterministically) before the step returns.  Checkpoints
carry the ``{"master", "q"}`` bundle, and either kind of checkpoint loads
into either kind of trainer.  The combinations the JAX trainer refuses
(with sparse-update embeddings, a mesh, ``grad_accum_steps > 1`` or
``compute_dtype``) raise its ``ConfigError``.

``compute_dtype=torch.bfloat16`` is the JAX trainer's mixed precision:
the step's forward (and ``test``) reads the parameters and the feed
cast to bf16 (``core/dtypes.cast_tree``), each cost's batch mean is
taken in float32, and autograd returns float32 gradients to the float32
masters through the cast, so the optimizer, its state and the
checkpoints stay float32 and unchanged.  The products of
``ops/linear.matmul`` follow the process-wide policy
(``core/dtypes.set_policy``), which the CLI's ``--dtype`` sets beside
it, as the JAX CLI does.

``evaluators=`` (``evaluators.dsl`` specs) fetch their bound layers as
extra outputs; the specs update every batch from tensors on the device
(no host sync), reset at each pass, and their ``result()`` rides on the
log line every ``log_period`` and at pass end.  ``grad_accum_steps=N``
wraps the optimizer state as JAX's does, ``{"inner", "gsum", "tick"}``:
the gradients sum over N micro-batches and the optimizer applies their
mean on every Nth, so checkpoints written mid-accumulation by either
package resume in the other.  Pruning ``update_hooks`` (``hooks.py``)
mask the parameter values at init and after ``load``, and every step's
gradients before the optimizer (and before the accumulation).

``train(save_on_signal=True)`` (with ``save_dir``, on the main thread)
turns SIGTERM into a graceful stop: the current batch finishes, a
blocking checkpoint with ``preempted`` and ``batches_done`` in its meta
is written, and ``train`` returns; ``train(resume=True)`` re-enters that
pass skipping exactly the trained batches (no step, no dropout draw).
Pass-end saves run on the background writer
(``checkpoint.save_checkpoint(block=False)``), landed before ``train``
returns.  The port's dropout generator is not in the checkpoint (the
meta's ``rng`` is JAX's PRNG key; the port writes null, which JAX
skips), so a config with dropout resumes from its seed's stream.

``Inferencer`` / ``infer`` run a topology in test mode, optionally in
bf16 (``compute_dtype``; outputs returned float32) or over int8 weights
(``quantize="int8"``, a copy of JAX's ``export.quantize_params``).
``Trainer`` is ``SGD``.

``sparse_update`` embeddings train by their touched rows, as JAX's
sparse step does: each step gathers the rows its id feeds touch
(``ops/sparse.unique_touched``, one host sync), rewrites the id feeds to
positions in that row block, differentiates the block in place of the
[V, D] table (which never requires grad), takes ONE global norm over the
dense and row gradients for ``clip_norm``, applies ``update`` and
``row_update`` (at the dense state's step, before its increment) and
writes the valid rows and their optimizer slot rows back.  The
optimizer state is JAX's ``{"dense": ..., "sparse": {key: slots}}``, so
sparse checkpoints carry across the packages both ways.  JAX's
refusals come with it: ids not straight from a data layer, an id feed
with another consumer, a table shared with a non-sparse layer, a
pruning hook on a sparse table, ``grad_accum_steps > 1`` and
``quant_weights``; and a nested id feed, which JAX's step cannot read
either, raises at the first step that meets it.  Pruning masks apply to
the dense gradients on this path too (JAX's sparse step skips them:
ROADMAP C16).

``train(prefetch=N)`` runs the feeder conversion and the host-to-device
copy on a background thread N batches ahead (``data/prefetch``); each
step's wait for its feed adds to ``utils/stats.global_stats``'
``h2d_wait``, with or without it.

``mesh`` / ``sharding_rules`` raise ``ConfigError`` naming ROADMAP A12.
"""

import signal
import time

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.dtypes import cast_tree
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.layers.graph import Topology, params_from_numpy, \
    value_data
from paddle_tpu_torch.ops import sparse as sparse_ops
from paddle_tpu_torch.quant import weights as qw
from paddle_tpu_torch.trainer import events
from paddle_tpu_torch.trainer import hooks as param_hooks
from paddle_tpu_torch.trainer.checkpoint import load_checkpoint, \
    save_checkpoint, wait_pending
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.logging import logger
from paddle_tpu_torch.utils.stats import global_stats
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map


def _refuse(what, item):
    raise ConfigError(f"SGD: {what} is not ported yet (ROADMAP {item})")


def _keystr(path):
    """A tree path as ``jax.tree_util.keystr`` writes it ("['fc_0']['w0']"):
    the keys of the int8 twin, so that the two packages' checkpoints
    carry the same bundle."""
    return "".join(f"[{k!r}]" for k in path)


def _state_on(tree, device):
    """A checkpoint's model state (numpy leaves) as tensors on
    ``device``, keeping its tuples (batch norm's (mean, var)) tuples."""
    if isinstance(tree, dict):
        return {k: _state_on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_state_on(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def _detach(v):
    if isinstance(v, (SequenceBatch, NestedSequenceBatch)):
        return v._replace(data=v.data.detach())
    return v.detach()


class SGD:
    """paddle.v2.trainer.SGD on one device.

    cost: LayerOutput (or list) whose value is a per-sample loss [B].
    update_equation: an ``optim`` optimizer (Momentum, Adam).
    extra_layers: more LayerOutputs to evaluate each batch; their values
    ride on the EndIteration events.  evaluators: ``evaluators.dsl``
    specs.  device: the card unless "cpu".
    """

    def __init__(self, cost, parameters=None, update_equation=None,
                 extra_layers=None, is_local=True, mesh=None,
                 sharding_rules=None, seed=1, donate=True, evaluators=None,
                 compute_dtype=None, grad_accum_steps=1,
                 quant_weights=False, quant_min_size=1024, device=None):
        self._quant = bool(quant_weights)
        self._quant_min_size = int(quant_min_size)
        self.grad_accum_steps = int(grad_accum_steps)
        if self.grad_accum_steps < 1:
            raise ConfigError("grad_accum_steps must be >= 1")
        if self._quant:
            # the JAX trainer's refusals of the int8 mode, before the
            # port's own of the unported settings
            if mesh is not None:
                raise ConfigError(
                    "quant_weights=True is single-chip for now (sharding "
                    "the int8+scale pair tree is the named residual)")
            if self.grad_accum_steps > 1:
                raise ConfigError(
                    "quant_weights=True with grad_accum_steps > 1 is "
                    "unsupported (the held-grads window would read stale "
                    "quantized weights)")
            if compute_dtype is not None:
                raise ConfigError(
                    "quant_weights=True already streams int8 weights; "
                    "combining it with compute_dtype is unsupported")
        if mesh is not None or sharding_rules is not None:
            _refuse("a mesh (sharded training)", "A12")
        if update_equation is None:
            raise ValueError("SGD needs update_equation=, e.g. "
                             "optim.Momentum(learning_rate=0.01)")
        # the step's compute dtype (JAX's SGD(compute_dtype=)): None keeps
        # the float32 masters in the forward
        self.compute_dtype = compute_dtype
        self.device = _device.resolve(device)
        self.costs = cost if isinstance(cost, (list, tuple)) else [cost]
        self.extra_layers = list(extra_layers or [])
        # evaluator specs: their bound layers are fetched as extra
        # outputs; labels and weights come straight from the feed
        self.evaluators = list(evaluators or [])
        self._eval_slots = []
        # per spec: {kw: ('feed', name) | ('extra', i)}
        self._eval_extra_slots = []

        def slot_for(layer):
            if layer.layer_type == "data":
                return ("feed", layer.name)
            if layer in self.extra_layers:
                return ("extra", self.extra_layers.index(layer))
            self.extra_layers.append(layer)
            return ("extra", len(self.extra_layers) - 1)

        for spec in self.evaluators:
            self._eval_slots.append(slot_for(spec.input))
            self._eval_extra_slots.append(
                {kw: slot_for(l) for kw, l in spec.extra_inputs.items()})
        self.topology = Topology(list(self.costs) + self.extra_layers)
        self._sparse_specs = self._find_sparse_specs()
        self._touched = {}      # the step's {key: (uids, valid count)}
        self.optimizer = update_equation
        if parameters is None:
            self.parameters = self.topology.init(
                torch.Generator().manual_seed(seed), device=self.device)
        else:
            # a copy, float32 on the device: tensors or numpy (a JAX tree)
            self.parameters = tree_map(
                lambda a: a.detach().to(self.device, torch.float32).clone()
                if isinstance(a, torch.Tensor) else torch.tensor(
                    np.asarray(a, np.float32), device=self.device),
                parameters)
        # static pruning hooks (reference ParameterUpdaterHook.cpp:36):
        # the values masked once here, the gradients every step
        self._prune_masks = param_hooks.build_masks(self.topology,
                                                    self.parameters)
        for k in self._prune_masks:
            if k in self._sparse_specs:
                raise ConfigError(
                    f"pruning hook on {k!r}: sparse_update tables can't be "
                    "statically pruned (the row path rewrites the table)")
        if self.grad_accum_steps > 1 and self._sparse_specs:
            raise ConfigError(
                "grad_accum_steps > 1 is unsupported with sparse_update "
                "embeddings (touched-row sets differ per micro-batch)")
        if self._quant and self._sparse_specs:
            raise ConfigError(
                "quant_weights=True is unsupported with sparse_update "
                "embeddings (row-sliced tables have no per-out-channel "
                "scale home)")
        self._mask_values()
        self._track()
        # the int8 twin of the masters: only the quantized leaves, keyed
        # by path; rebuilt from the masters after every update
        self._qtree = self._requant(self.parameters) if self._quant \
            else None
        self._view = None       # the step's tree, between its forward and
                                # its update
        self.opt_state = self.optimizer.init(self._dense(self.parameters))
        if self._sparse_specs:
            # whole-table slots for the sparse tables; a step gathers,
            # updates and scatters back only the touched rows of them
            self.opt_state = {
                "dense": self.opt_state,
                "sparse": {k: self.optimizer.row_init(self.parameters[k])
                           for k in self._sparse_specs}}
        if self.grad_accum_steps > 1:
            # JAX's accumulation wrapper: the gradient sum and the count
            # of micro-batches in it (a host int, as the inner "step")
            self.opt_state = {"inner": self.opt_state,
                              "gsum": self._zeros_like_params(),
                              "tick": 0}
        # batch norm's moving stats, threaded through train and test
        self.model_state = self.topology.init_state(self.device)
        # draws of the layers that need them (dropout)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self._stop_signal = None

    def _track(self):
        self._leaves = tree_leaves(self.parameters)
        for key, tree in self.parameters.items():
            # in int8 mode the step differentiates its own view, and a
            # sparse table's step its gathered row block
            for p in tree_leaves(tree):
                p.requires_grad_(not self._quant
                                 and key not in self._sparse_specs)

    def _dense(self, tree):
        """``tree`` without the sparse tables' keys."""
        return {k: v for k, v in tree.items() if k not in self._sparse_specs}

    def _find_sparse_specs(self):
        """The embeddings flagged sparse_update whose ids come straight
        from a data layer (the reference's sparse-remote-update
        constraint), as JAX finds them: {param_key: {"feeds": [...],
        "vocab": V, "budget": K or None}}."""
        specs = {}
        nodes = {}
        order = self.topology.order
        for node in order:
            if node.layer_type != "embedding" \
                    or not node.cfg.get("sparse_update"):
                continue
            src = node.inputs[0]
            if src.layer_type != "data":
                raise ConfigError(
                    f"sparse_update embedding {node.name!r} needs a data "
                    "layer input (ids straight from the feed)")
            consumers = [n for n in order if src in n.inputs and n is not node]
            if consumers:
                raise ConfigError(
                    f"sparse_update embedding {node.name!r}: its id input "
                    f"{src.name!r} also feeds {consumers[0].name!r}; the "
                    "sparse path rewrites that feed and would corrupt it")
            key = self.topology._param_key(node)
            spec = specs.setdefault(key, {"feeds": [],
                                          "vocab": node.cfg["vocab"],
                                          "budget": node.cfg.get(
                                              "sparse_budget")})
            spec["feeds"].append(src.name)
            nodes.setdefault(key, set()).add(id(node))
        # the step puts the gathered row block under the table's key, so
        # no other kind of layer may read that key
        for node in order:
            key = self.topology._param_key(node)
            if key in specs and id(node) not in nodes[key] \
                    and node.layer_type != "data":
                raise ConfigError(
                    f"sparse_update table {key!r} is shared with layer "
                    f"{node.name!r} ({node.layer_type}), which would read "
                    "the gathered row block instead of the full table; "
                    "share only among sparse_update embeddings")
        return specs

    def _sparse_feed(self, feed):
        """The feed with each sparse table's id feeds rewritten to
        positions in its row block, the touched rows kept for the step
        (``self._touched``).  An id outside [0, vocab) touches no row and
        becomes position -1, which the block lookup reads as a zero row,
        as the dense lookup reads the id itself (``unique_touched``)."""
        feed = dict(feed)
        self._touched = {}
        for key, spec in self._sparse_specs.items():
            flats, places = [], []
            for f in spec["feeds"]:
                v = feed[f]
                if isinstance(v, NestedSequenceBatch):
                    raise ConfigError(
                        f"sparse_update table {key!r}: its id feed {f!r} is "
                        "a nested sequence; the sparse step reads plain or "
                        "sequence id feeds only (JAX's sparse step cannot "
                        "read a nested one either)")
                d = v.data if isinstance(v, SequenceBatch) else v
                flats.append(d.reshape(-1))
                places.append((f, v, d.shape))
            ids = torch.cat(flats) if len(flats) > 1 else flats[0]
            budget = spec["budget"] or sparse_ops.default_row_budget(
                ids.numel())
            uids, inv, count = sparse_ops.unique_touched(
                ids, budget, spec["vocab"], with_count=True)
            off = 0
            for f, v, shape in places:
                n = int(np.prod(shape))
                iv = inv[off:off + n].reshape(shape)
                off += n
                feed[f] = SequenceBatch(iv, v.lengths) \
                    if isinstance(v, SequenceBatch) else iv
            self._touched[key] = (uids, count)
        return feed

    def _zeros_like_params(self):
        return tree_map(lambda p: torch.zeros_like(p.detach()),
                        self.parameters)

    def _mask_values(self):
        """The pruning masks on the parameter values, in place."""
        if not self._prune_masks:
            return
        with torch.no_grad():
            for key, mask in self._prune_masks.items():
                for p, m in zip(tree_leaves(self.parameters[key]),
                                tree_leaves(mask)):
                    p.mul_(m)

    def _requant(self, params):
        """The masters' int8 twin: ``{tree path: {"q", "s"}}`` for every
        leaf ``quantize_tree`` quantizes (2-D float32, at least
        ``quant_min_size`` elements), and only those.  Deterministic,
        so rebuilding it from the same masters gives the same codes."""
        out = {}

        def visit(tree, path):
            if isinstance(tree, dict):
                for key in sorted(tree):
                    visit(tree[key], path + (key,))
                return
            q = qw.quantize_tree(tree.detach(), min_size=self._quant_min_size)
            if qw.is_quantized_leaf(q):
                out[_keystr(path)] = q

        visit(params, ())
        return out

    def _step_view(self):
        """The tree the step differentiates: in int8 mode each quantized
        leaf's dequantized twin and the masters' other leaves, as fresh
        leaf tensors (the masters stay out of the graph); with sparse
        tables each table's gathered row block, a fresh leaf, in its
        place; else the masters themselves."""
        if self._sparse_specs:
            view = dict(self.parameters)
            for key, (uids, _) in self._touched.items():
                view[key] = tree_map(
                    lambda t, u=uids: sparse_ops.gather_rows(t, u)
                    .requires_grad_(True), self.parameters[key])
            return view
        if not self._quant:
            return self.parameters

        def view(tree, path):
            if isinstance(tree, dict):
                return {k: view(v, path + (k,)) for k, v in tree.items()}
            q = self._qtree.get(_keystr(path))
            leaf = qw.dequantize_leaf(q) if q is not None else tree.detach()
            return leaf.requires_grad_(True)

        return view(self.parameters, ())

    # ------------------------------------------------------------ step

    def _feed(self, batch, feeder):
        if feeder is None:
            return batch
        if not isinstance(feeder, DataFeeder):
            feeder = DataFeeder(feeder, device=self.device)
        return feeder(batch)

    def _cast_compute(self, tree):
        """float32 leaves -> compute_dtype (ids, masks, lengths
        untouched); the identity without a compute_dtype."""
        if self.compute_dtype is None:
            return tree
        return cast_tree(tree, self.compute_dtype)

    def _forward(self, feed):
        """(total cost, extras): the graph in train mode over the step's
        view of the params (``_step_view``), cast with the feed to the
        compute dtype, the sum over costs of each cost's batch mean,
        float32."""
        if self._sparse_specs:
            feed = self._sparse_feed(feed)
        self._view = self._step_view()
        out, new_state = self.topology.apply(
            self._cast_compute(self._view), self._cast_compute(feed),
            mode="train", generator=self.generator,
            state=self.model_state, return_state=True)
        outs = out if isinstance(out, tuple) else (out,)
        n_cost = len(self.costs)
        total = sum(torch.mean(value_data(c).float()) for c in outs[:n_cost])
        self.model_state = {**self.model_state, **new_state}
        return total, [_detach(e) for e in outs[n_cost:]]

    def _backward(self, total):
        for p in self._leaves:
            p.grad = None
        total.backward()

    def _update(self):
        """The optimizer on the masters with the view's gradients, in
        place, after the pruning masks; under gradient accumulation the
        gradients join the sum and every Nth micro-batch applies its
        mean; in int8 mode then the masters' requantization.  The view
        (and with it every dequantized weight) is dropped."""
        view = self._view
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), view)
        self._view = None
        grads = param_hooks.apply_masks(grads, self._prune_masks)
        if self._sparse_specs:
            self._sparse_update(grads, view)
            return
        if self.grad_accum_steps > 1:
            st = self.opt_state
            with torch.no_grad():
                torch._foreach_add_(tree_leaves(st["gsum"]),
                                    tree_leaves(grads))
            st["tick"] += 1
            if st["tick"] < self.grad_accum_steps:
                return
            with torch.no_grad():
                mean = tree_map(lambda s: s / self.grad_accum_steps,
                                st["gsum"])
            self.optimizer.update(mean, st["inner"], self.parameters)
            torch._foreach_zero_(tree_leaves(st["gsum"]))
            st["tick"] = 0
            return
        self.optimizer.update(grads, self.opt_state, self.parameters)
        if self._quant:
            self._qtree = self._requant(self.parameters)

    def _sparse_update(self, grads, view):
        """The sparse step's update: one global-norm scale over the dense
        and row gradients (after clip_threshold, as ``update`` measures
        it), ``update`` on the dense parameters, ``row_update`` on each
        table's row block at the dense state's step before its
        increment, then the valid rows and slot rows written back."""
        opt, specs = self.optimizer, self._sparse_specs
        dense_grads = self._dense(grads)
        row_grads = {k: grads[k] for k in specs}
        clip_scale = None
        if opt.clip_norm:
            with torch.no_grad():
                leaves = tree_leaves([dense_grads, row_grads])
                if opt.clip_threshold:
                    ct = opt.clip_threshold
                    leaves = [torch.clamp(g, -ct, ct) for g in leaves]
                gn = torch.sqrt(sum(torch.sum(torch.square(g))
                                    for g in leaves) + 1e-12)
                clip_scale = torch.clamp(opt.clip_norm / gn, max=1.0)
        dstate = self.opt_state["dense"]
        step = dstate["step"]
        opt.update(dense_grads, dstate, self._dense(self.parameters),
                   clip_scale=clip_scale)
        for key in specs:
            uids, count = self._touched[key]
            slots = self.opt_state["sparse"][key]
            slot_rows = tree_map(lambda t: sparse_ops.gather_rows(t, uids),
                                 slots)
            rows, slot_rows = opt.row_update(row_grads[key], slot_rows,
                                             view[key], step,
                                             clip_scale=clip_scale)
            for tree, new in ((self.parameters[key], rows),
                              (slots, slot_rows)):
                for t, r in zip(tree_leaves(tree), tree_leaves(new)):
                    sparse_ops.scatter_rows(t, uids, r, count)
        self._touched = {}

    def _step(self, feed):
        total, extras = self._forward(feed)
        self._backward(total)
        self._update()
        return total.detach(), extras

    def train_one_batch(self, batch, feeder=None):
        """One train step on one host batch; returns the cost, a 0-d
        tensor on the device (reference TrainerInternal::trainOneBatch)."""
        return self._step(self._feed(batch, feeder))[0]

    def log_parameter_stats(self):
        """Per-parameter value abs-max/avg dump (the reference's
        --show_parameter_stats_period)."""
        for key in sorted(self.parameters):
            for name in sorted(self.parameters[key]):
                a = self.parameters[key][name].detach().abs()
                logger.info("  param ['%s']['%s'] shape=%s absmax=%.5g "
                            "absavg=%.5g", key, name, tuple(a.shape),
                            float(a.max()), float(a.mean()))

    def train(self, reader, num_passes=1, event_handler=None, feeding=None,
              save_dir=None, saving_period=1, save_only_one=False,
              test_reader=None, test_period=0, log_period=100,
              buffered_batches=4, show_parameter_stats_period=0,
              save_on_signal=True, prefetch=0, resume=False):
        """reader: callable -> iterator of batches (lists of samples).
        feeding: {data_layer_name: InputType} or a DataFeeder.  A
        checkpoint is written every ``saving_period`` passes to
        ``save_dir`` (in the background; landed before ``train``
        returns); ``test_reader`` runs every ``test_period`` passes
        (every pass at 0).

        resume: continue from the latest pass dir in ``save_dir`` (a
        fresh run when there is none): after it, or — for a preemption
        checkpoint — inside its pass, skipping exactly the
        ``batches_done`` batches it trained (no step, no draw), which is
        bit-identical to an uninterrupted run when the reader replays
        the same batches per pass.

        save_on_signal: with ``save_dir`` and on the main thread, SIGTERM
        requests a graceful stop: the current batch finishes, a blocking
        checkpoint with ``preempted: true``, the signal and
        ``batches_done`` is written, and ``train`` returns.  The previous
        handler is put back on the way out.

        prefetch: with N > 0 a background thread runs the reader, the
        feeder conversion and the host-to-device copy N batches ahead
        (``data/prefetch.ShardedPrefetcher``; ``buffered_batches`` is then
        ignored); each step's wait for its feed is ``h2d_wait`` in
        ``utils/stats.global_stats`` either way."""
        event_handler = event_handler or (lambda e: None)
        if feeding is not None and not isinstance(feeding, DataFeeder):
            feeding = DataFeeder(feeding, device=self.device)

        first_pass, resume_skip = 0, 0
        if resume:
            if not save_dir:
                raise ConfigError("train(resume=True) needs save_dir=")
            try:
                meta = self.load(save_dir)
            except FileNotFoundError:
                meta = None     # nothing saved yet: a fresh run
            if meta is not None:
                if meta.get("preempted") \
                        and meta.get("batches_done") is not None:
                    # MID-pass: re-enter that pass, skipping the trained
                    # prefix, so the remainder replays bit-identically
                    first_pass = int(meta["pass_id"])
                    resume_skip = int(meta["batches_done"])
                else:
                    first_pass = int(meta["pass_id"]) + 1
                logger.info("resume: loaded pass %d from %s%s; continuing "
                            "at pass %d%s", meta["pass_id"], save_dir,
                            " (preemption checkpoint)"
                            if meta.get("preempted") else "", first_pass,
                            f" batch {resume_skip}" if resume_skip else "")

        self._stop_signal = None
        prev_handler, handler_armed = None, False
        if save_on_signal and save_dir:
            def request_stop(signum, frame):
                self._stop_signal = signum
                logger.info("SIGTERM: finishing current batch, then "
                            "checkpointing to %s", save_dir)
            try:
                prev_handler = signal.signal(signal.SIGTERM, request_stop)
                handler_armed = True
            except ValueError:      # not the main thread: feature off
                prev_handler = None

        def resolve(slot, extras, feed):
            kind, key = slot
            return feed.get(key) if kind == "feed" else extras[key]

        def update_evaluators(extras, feed):
            for spec, slot, eslots in zip(self.evaluators, self._eval_slots,
                                          self._eval_extra_slots):
                lab = feed.get(spec.label.name) \
                    if spec.label is not None else None
                wgt = feed.get(spec.weight.name) \
                    if spec.weight is not None else None
                extra = {kw: resolve(s, extras, feed)
                         for kw, s in eslots.items()}
                spec.update(resolve(slot, extras, feed), lab, wgt,
                            extra=extra)

        def eval_log_suffix():
            parts = []
            for spec in self.evaluators:
                r = spec.result()
                if r is not None:
                    parts.append(f"{spec.name}={r:.5f}"
                                 if isinstance(r, float)
                                 else f"{spec.name}={r}")
            return (" Eval: " + " ".join(parts)) if parts else ""

        try:
            for pass_id in range(first_pass, num_passes):
                event_handler(events.BeginPass(pass_id))
                for spec in self.evaluators:
                    spec.reset()
                batch_reader = reader
                if buffered_batches and not prefetch:
                    # host-only double buffering; with prefetch the
                    # pipeline's own thread covers it
                    batch_reader = reader_mod.buffered(reader,
                                                       buffered_batches)
                prefetcher = None
                if prefetch:
                    # the same conversion as the synchronous path, on the
                    # producer thread
                    from paddle_tpu_torch.data.prefetch import (
                        ShardedPrefetcher, device_placer)
                    prefetcher = ShardedPrefetcher(
                        batch_reader, depth=prefetch,
                        convert=lambda b: self._feed(b, feeding),
                        place=device_placer(device=self.device))
                cost_sum = torch.zeros((), device=self.device)
                n_batches, window = 0, []
                # a preemption resume's first pass skips the batches the
                # checkpoint already trained
                skip_left, resume_skip = resume_skip, 0
                pass_skip = skip_left
                t0 = time.time()
                batch_id = -1
                feed_iter = iter(prefetcher) if prefetcher is not None \
                    else iter(batch_reader())
                h2d_wait = global_stats.get("h2d_wait")
                try:
                    while True:
                        # h2d_wait: the time blocked on the next device-
                        # ready feed (the queue's wait with prefetch, the
                        # reader and the conversion inline without)
                        t_in = time.perf_counter()
                        try:
                            item = next(feed_iter)
                        except StopIteration:
                            break
                        batch_id += 1
                        if skip_left > 0:
                            skip_left -= 1
                            continue
                        feed = item if prefetcher is not None \
                            else self._feed(item, feeding)
                        h2d_wait.add(time.perf_counter() - t_in)
                        event_handler(events.BeginIteration(pass_id,
                                                            batch_id))
                        cost, extras = self._step(feed)
                        cost_sum = cost_sum + cost
                        n_batches += 1
                        if log_period:
                            window.append(cost)
                        if self.evaluators:
                            update_evaluators(extras, feed)
                        if log_period and (batch_id + 1) % log_period == 0:
                            c = float(torch.stack(window).mean())
                            window = []
                            logger.info(
                                "Pass %d Batch %d Cost %.5f (%.1f "
                                "ms/batch)%s", pass_id, batch_id + 1, c,
                                (time.time() - t0) / log_period * 1e3,
                                eval_log_suffix())
                            t0 = time.time()
                        if (show_parameter_stats_period and (batch_id + 1)
                                % show_parameter_stats_period == 0):
                            self.log_parameter_stats()
                        event_handler(events.EndIteration(
                            pass_id, batch_id, cost=cost,
                            evaluator_results={
                                f"extra_{i}": e
                                for i, e in enumerate(extras)}))
                        if self._stop_signal is not None:
                            break
                finally:
                    if prefetcher is not None:
                        prefetcher.close()
                pass_cost = float(cost_sum) / n_batches if n_batches \
                    else float("nan")
                logger.info("Pass %d done, mean cost %.5f%s", pass_id,
                            pass_cost, eval_log_suffix())
                if test_reader is not None and self._stop_signal is None \
                        and (not test_period
                             or (pass_id + 1) % test_period == 0):
                    event_handler(events.EndTesting(
                        pass_id, self.test(test_reader, feeding=feeding)))
                if save_dir and self._stop_signal is not None:
                    # the preemption checkpoint: blocking (the process is
                    # about to be reaped), and batches_done lets
                    # train(resume=True) re-enter this pass
                    path = self.save(save_dir, pass_id,
                                     save_only_one=save_only_one, block=True,
                                     extra={"preempted": True,
                                            "signal": int(self._stop_signal),
                                            "batches_done":
                                            pass_skip + n_batches})
                    logger.info("preemption checkpoint %s; stopping after "
                                "pass %d", path, pass_id)
                elif save_dir and (pass_id + 1) % saving_period == 0:
                    # the snapshot is taken now; the disk write overlaps
                    # the next pass
                    logger.info("saving checkpoint %s (async)", self.save(
                        save_dir, pass_id, save_only_one=save_only_one,
                        block=False))
                event_handler(events.EndPass(pass_id))
                if self._stop_signal is not None:
                    break
        finally:
            # land the pending saves and put the handler back, also when
            # an exception unwinds out of the loop (a leaked handler would
            # make the process unkillable by SIGTERM)
            try:
                if save_dir:
                    wait_pending(save_dir)
            finally:
                if handler_armed:
                    signal.signal(signal.SIGTERM,
                                  prev_handler if prev_handler is not None
                                  else signal.SIG_DFL)

    # ------------------------------------------------------------ test

    def test(self, reader, feeding=None):
        """The mean over ``reader``'s batches of the summed cost means,
        in test mode, without gradients."""
        total, n = 0.0, 0
        with torch.no_grad():
            for batch in reader():
                out = self.topology.apply(
                    self._cast_compute(self.parameters),
                    self._cast_compute(self._feed(batch, feeding)),
                    mode="test", state=self.model_state)
                outs = out if isinstance(out, tuple) else (out,)
                total += float(sum(torch.mean(value_data(c).float())
                                   for c in outs[:len(self.costs)]))
                n += 1
        mean = total / max(n, 1)
        logger.info("Test cost %.5f over %d batches", mean, n)
        return mean

    # ------------------------------------------------------------ io

    def save(self, save_dir, pass_id=0, save_only_one=False, block=True,
             extra=None):
        """Write ``save_dir/pass-%05d`` (params, optimizer and model
        state, meta) in the JAX trainer's format and return its path;
        ``block=False`` returns once the host snapshot is taken and
        writes in the background (``checkpoint.wait_pending``)."""
        extra = dict(extra or {})
        extra.setdefault("grad_accum_steps", self.grad_accum_steps)
        # JAX's PRNG key: the port's draws come from a torch generator
        extra.setdefault("rng", None)
        params = self.parameters
        if self._quant and self._qtree:
            # both trees: a resumed step reads the same int8 bytes
            params = {"master": self.parameters, "q": self._qtree}
        opt_state = self.opt_state
        if self.grad_accum_steps > 1:
            opt_state = {**opt_state,
                         "tick": np.asarray(opt_state["tick"], np.int32)}
        return save_checkpoint(save_dir, pass_id, params, opt_state,
                               self.model_state, extra=extra,
                               save_only_one=save_only_one, block=block)

    def load(self, save_dir, pass_id=None):
        """Load a pass dir (the latest if pass_id is None) written by this
        trainer or by the JAX package's; returns its meta."""
        params, opt_state, model_state, meta = load_checkpoint(save_dir,
                                                               pass_id)
        bundled = set(params) == {"master", "q"}
        masters = params["master"] if bundled else params
        self.parameters = params_from_numpy(self.topology, masters,
                                            self.device)
        self._track()
        if self._quant:
            # a bundle's int8 twin as saved; a plain checkpoint's masters
            # requantized (deterministic: the same codes either way)
            self._qtree = ({key: {k: torch.tensor(np.asarray(a),
                                                  device=self.device)
                                  for k, a in leaf.items()}
                            for key, leaf in params["q"].items()}
                           if bundled else self._requant(self.parameters))
        if opt_state is not None:
            self.opt_state = self._opt_on(
                self._adapt_accum_state(opt_state, meta))
        if model_state:
            self.model_state = _state_on(model_state, self.device)
        self._refresh_prune_masks()
        return meta

    def _on_device(self, tree):
        return tree_map(lambda a: a if isinstance(a, torch.Tensor)
                        else torch.tensor(np.asarray(a, np.float32),
                                          device=self.device), tree)

    def _opt_on(self, opt_state):
        """A checkpoint's optimizer state on the device: host ints for
        the step (and the accumulation tick), float32 tensors for the
        slots (the sparse tables' too, and the gradient sum)."""
        if "inner" in opt_state:
            return {"inner": self._opt_on(opt_state["inner"]),
                    "gsum": self._on_device(opt_state["gsum"]),
                    "tick": int(opt_state["tick"])}
        if "sparse" in opt_state:
            # the sparse layout: the dense state and the tables' slots
            return {"dense": self._opt_on(opt_state["dense"]),
                    "sparse": self._on_device(opt_state["sparse"])}
        return {"step": int(opt_state["step"]),
                "slots": self._on_device(opt_state["slots"])}

    def _adapt_accum_state(self, opt_state, meta):
        """Reconcile a checkpoint's grad-accumulation wrapper with this
        trainer's grad_accum_steps, as JAX's does.  Clean boundaries
        (tick 0) convert freely in both directions; only a checkpoint
        holding mid-accumulation grads under a DIFFERENT accum value is
        an error (replaying those grads at another denominator would
        mis-scale the next step)."""
        wrapped = isinstance(opt_state, dict) and "gsum" in opt_state
        want = self.grad_accum_steps > 1
        tick = int(opt_state["tick"]) if wrapped else 0
        stored = meta.get("grad_accum_steps")
        if wrapped and not want:
            if tick:
                logger.warning(
                    "checkpoint holds %d accumulated micro-batch grads "
                    "(grad_accum_steps=%s) — discarded, this trainer "
                    "doesn't accumulate", tick, stored or ">1")
            return opt_state["inner"]
        if want and not wrapped:
            return {"inner": opt_state, "gsum": self._zeros_like_params(),
                    "tick": 0}
        if wrapped and want and stored and stored != self.grad_accum_steps:
            if tick:
                raise ConfigError(
                    f"checkpoint is mid-accumulation (tick={tick}) under "
                    f"grad_accum_steps={stored}; this trainer has "
                    f"{self.grad_accum_steps} — resume with the matching "
                    "setting (or from a pass boundary)")
            # clean boundary: gsum is zeros, the wrapper carries over
        return opt_state

    def _refresh_prune_masks(self):
        """Re-derive the pruning masks after the parameters were replaced
        (checkpoint load): a sparsity_ratio mask must reflect the LOADED
        weights, not the discarded random init, and the value mask is
        re-applied."""
        if not self._prune_masks:
            return
        self._prune_masks = param_hooks.build_masks(self.topology,
                                                    self.parameters)
        self._mask_values()


def _quantize_params(params, min_size=1024):
    """A copy of JAX's ``export.quantize_params``: weight-only symmetric
    int8 with per-output-channel scales (last axis) — float32 leaves of
    at least ``min_size`` elements become ``{"__int8__", "__scale__"}``
    pairs, the scale the max |w| over every other axis / 127 (at least
    1e-12), the codes ``clip(round(w / s), -127, 127)``; small leaves
    stay float32.  Returns (qtree, dequant)."""
    def q(x):
        if x.dtype != torch.float32 or x.numel() < min_size:
            return x
        axes = tuple(range(x.ndim - 1)) if x.ndim > 1 else (0,)
        # a divisor tensor, not a Python scalar: CUDA turns a division by
        # a scalar into a product with its reciprocal (ulps off JAX's)
        s = torch.amax(torch.abs(x), dim=axes, keepdim=True) \
            / torch.tensor(127.0, device=x.device)
        s = torch.clamp(s, min=1e-12)
        return {"__int8__": torch.clamp(torch.round(x / s), -127, 127)
                .to(torch.int8), "__scale__": s}

    def is_q(leaf):
        return isinstance(leaf, dict) and "__int8__" in leaf

    def walk(tree, fn):
        if is_q(tree) or not isinstance(tree, dict):
            return fn(tree)
        return {k: walk(v, fn) for k, v in tree.items()}

    def dequant(tree):
        return walk(tree, lambda l: l["__int8__"].to(torch.float32)
                    * l["__scale__"] if is_q(l) else l)

    return walk(params, q), dequant


def _to_float32(out, dtype):
    """Outputs of ``dtype`` back to float32 (tuples and sequences kept)."""
    if isinstance(out, (SequenceBatch, NestedSequenceBatch)):
        return out._replace(data=_to_float32(out.data, dtype))
    if isinstance(out, tuple):
        return tuple(_to_float32(o, dtype) for o in out)
    return out.float() if out.dtype == dtype else out


class Inferencer:
    """paddle.v2.inference: run a topology in test mode on the device
    (the card unless "cpu").

    compute_dtype=torch.bfloat16 runs the forward on the parameters and
    feed cast to bf16 and returns float32 outputs; quantize="int8" keeps
    the weights as int8 codes with per-channel scales (``_quantize_params``)
    and dequantizes them at each call.  ``.parameters`` stays the
    caller's float tree."""

    def __init__(self, output_layer, parameters, model_state=None,
                 compute_dtype=None, quantize=None, device=None):
        outs = output_layer if isinstance(output_layer, (list, tuple)) \
            else [output_layer]
        self.device = _device.resolve(device)
        self.topology = Topology(list(outs))
        self.parameters = parameters
        self.compute_dtype = compute_dtype
        self._exec_params = tree_map(
            lambda a: a.detach().to(self.device)
            if isinstance(a, torch.Tensor)
            else torch.tensor(np.asarray(a), device=self.device), parameters)
        self._dequant = None
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(
                    f"quantize={quantize!r} (supported: None, 'int8')")
            self._exec_params, self._dequant = _quantize_params(
                self._exec_params)
        self.model_state = _state_on(model_state, self.device) \
            if model_state else {}

    def _fwd(self, p, s, feed):
        if self._dequant is not None:
            p = self._dequant(p)
        if self.compute_dtype is not None:
            p = cast_tree(p, self.compute_dtype)
            feed = cast_tree(feed, self.compute_dtype)
        out = self.topology.apply(p, feed, mode="test", state=s)
        if self.compute_dtype is not None:
            out = _to_float32(out, self.compute_dtype)
        return out

    def infer(self, feed_or_batch, feeding=None):
        """The outputs on one batch: a feed dict, or host samples with
        ``feeding`` ({data_layer_name: InputType} or a DataFeeder)."""
        if feeding is not None and not isinstance(feed_or_batch, dict):
            feeder = feeding if isinstance(feeding, DataFeeder) \
                else DataFeeder(feeding, device=self.device)
            feed = feeder(feed_or_batch)
        else:
            feed = {k: v if isinstance(v, (SequenceBatch, NestedSequenceBatch,
                                           torch.Tensor))
                    else torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in feed_or_batch.items()}
        with torch.no_grad():
            return self._fwd(self._exec_params, self.model_state, feed)


def infer(output_layer, parameters, input, feeding=None, device=None):
    return Inferencer(output_layer, parameters, device=device).infer(
        input, feeding=feeding)


# the modern name for the training driver (SGD is the v2-compat spelling)
Trainer = SGD
