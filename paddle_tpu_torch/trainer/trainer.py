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

Settings whose machinery is not ported raise ``ConfigError`` naming
their ROADMAP item: ``mesh`` / ``sharding_rules`` (A12), ``evaluators``
(A9·c), ``grad_accum_steps > 1`` and pruning hooks (A9·c),
sparse-update embeddings and ``prefetch > 0`` (A9·f), ``save_on_signal``
and resuming from a preemption checkpoint (A9·c).
"""

import time

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.dtypes import cast_tree
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data import reader as reader_mod
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.layers.graph import Topology, params_from_numpy, \
    value_data
from paddle_tpu_torch.quant import weights as qw
from paddle_tpu_torch.trainer import events
from paddle_tpu_torch.trainer.checkpoint import save_checkpoint, \
    load_checkpoint
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.logging import logger
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map


def _refuse(what, item):
    raise ConfigError(f"SGD: {what} is not ported yet (ROADMAP {item})")


def _keystr(path):
    """A tree path as ``jax.tree_util.keystr`` writes it ("['fc_0']['w0']"):
    the keys of the int8 twin, so that the two packages' checkpoints
    carry the same bundle."""
    return "".join(f"[{k!r}]" for k in path)


def _detach(v):
    if isinstance(v, SequenceBatch):
        return SequenceBatch(v.data.detach(), v.lengths)
    return v.detach()


class SGD:
    """paddle.v2.trainer.SGD on one device.

    cost: LayerOutput (or list) whose value is a per-sample loss [B].
    update_equation: an ``optim`` optimizer (Momentum, Adam).
    extra_layers: more LayerOutputs to evaluate each batch; their values
    ride on the EndIteration events.  device: the card unless "cpu".
    """

    def __init__(self, cost, parameters=None, update_equation=None,
                 extra_layers=None, is_local=True, mesh=None,
                 sharding_rules=None, seed=1, donate=True, evaluators=None,
                 compute_dtype=None, grad_accum_steps=1,
                 quant_weights=False, quant_min_size=1024, device=None):
        self._quant = bool(quant_weights)
        self._quant_min_size = int(quant_min_size)
        if self._quant:
            # the JAX trainer's refusals of the int8 mode, before the
            # port's own of the unported settings
            if mesh is not None:
                raise ConfigError(
                    "quant_weights=True is single-chip for now (sharding "
                    "the int8+scale pair tree is the named residual)")
            if int(grad_accum_steps) > 1:
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
        if evaluators:
            _refuse("evaluators", "A9·c")
        if int(grad_accum_steps) != 1:
            _refuse("grad_accum_steps > 1", "A9·c")
        if update_equation is None:
            raise ValueError("SGD needs update_equation=, e.g. "
                             "optim.Momentum(learning_rate=0.01)")
        # the step's compute dtype (JAX's SGD(compute_dtype=)): None keeps
        # the float32 masters in the forward
        self.compute_dtype = compute_dtype
        self.device = _device.resolve(device)
        self.costs = cost if isinstance(cost, (list, tuple)) else [cost]
        self.extra_layers = list(extra_layers or [])
        self.topology = Topology(list(self.costs) + self.extra_layers)
        for node in self.topology.order:
            if node.layer_type == "embedding" \
                    and node.cfg.get("sparse_update"):
                if self._quant:
                    raise ConfigError(
                        "quant_weights=True is unsupported with "
                        "sparse_update embeddings (row-sliced tables have "
                        "no per-out-channel scale home)")
                _refuse(f"sparse_update embedding {node.name!r}", "A9·f")
            pas = node.cfg.get("param_attr")
            pas = pas if isinstance(pas, (list, tuple)) else [pas]
            if any(isinstance(p, dict) and p.get("update_hooks")
                   for p in pas):
                _refuse(f"update_hooks (pruning) on {node.name!r}", "A9·c")
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
        self._track()
        # the int8 twin of the masters: only the quantized leaves, keyed
        # by path; rebuilt from the masters after every update
        self._qtree = self._requant(self.parameters) if self._quant \
            else None
        self._view = None       # the step's tree, between its forward and
                                # its update
        self.opt_state = self.optimizer.init(self.parameters)
        self.model_state = self.topology.init_state()
        # draws of the layers that need them (dropout)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)

    def _track(self):
        self._leaves = tree_leaves(self.parameters)
        for p in self._leaves:
            # in int8 mode the step differentiates its own view
            p.requires_grad_(not self._quant)

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
        leaf tensors (the masters stay out of the graph); else the
        masters themselves."""
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
        place; in int8 mode then the masters' requantization.  The view
        (and with it every dequantized weight) is dropped."""
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), self._view)
        self._view = None
        self.optimizer.update(grads, self.opt_state, self.parameters)
        if self._quant:
            self._qtree = self._requant(self.parameters)

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
              save_on_signal=False, prefetch=0, resume=False):
        """reader: callable -> iterator of batches (lists of samples).
        feeding: {data_layer_name: InputType} or a DataFeeder.  A
        checkpoint is written every ``saving_period`` passes to
        ``save_dir``; ``test_reader`` runs every ``test_period`` passes
        (every pass at 0).  ``resume``: continue after the latest pass
        dir in ``save_dir`` (a fresh run when there is none)."""
        if prefetch:
            _refuse("prefetch > 0 (the device-side input pipeline)",
                    "A9·f")
        if save_on_signal:
            _refuse("save_on_signal (SIGTERM preemption checkpoints)",
                    "A9·c")
        event_handler = event_handler or (lambda e: None)
        if feeding is not None and not isinstance(feeding, DataFeeder):
            feeding = DataFeeder(feeding, device=self.device)

        first_pass = 0
        if resume:
            if not save_dir:
                raise ConfigError("train(resume=True) needs save_dir=")
            try:
                meta = self.load(save_dir)
            except FileNotFoundError:
                meta = None     # nothing saved yet: a fresh run
            if meta is not None:
                first_pass = int(meta["pass_id"]) + 1
                logger.info("resume: loaded pass %d from %s; continuing at "
                            "pass %d", meta["pass_id"], save_dir, first_pass)

        for pass_id in range(first_pass, num_passes):
            event_handler(events.BeginPass(pass_id))
            batch_reader = reader_mod.buffered(reader, buffered_batches) \
                if buffered_batches else reader
            cost_sum = torch.zeros((), device=self.device)
            n_batches, window = 0, []
            t0 = time.time()
            for batch_id, batch in enumerate(batch_reader()):
                event_handler(events.BeginIteration(pass_id, batch_id))
                cost, extras = self._step(self._feed(batch, feeding))
                cost_sum = cost_sum + cost
                n_batches += 1
                if log_period:
                    window.append(cost)
                if log_period and (batch_id + 1) % log_period == 0:
                    c = float(torch.stack(window).mean())
                    window = []
                    logger.info("Pass %d Batch %d Cost %.5f (%.1f ms/batch)",
                                pass_id, batch_id + 1, c,
                                (time.time() - t0) / log_period * 1e3)
                    t0 = time.time()
                if (show_parameter_stats_period and (batch_id + 1)
                        % show_parameter_stats_period == 0):
                    self.log_parameter_stats()
                event_handler(events.EndIteration(
                    pass_id, batch_id, cost=cost,
                    evaluator_results={f"extra_{i}": e
                                       for i, e in enumerate(extras)}))
            pass_cost = float(cost_sum) / n_batches if n_batches \
                else float("nan")
            logger.info("Pass %d done, mean cost %.5f", pass_id, pass_cost)
            if test_reader is not None and (
                    not test_period or (pass_id + 1) % test_period == 0):
                event_handler(events.EndTesting(
                    pass_id, self.test(test_reader, feeding=feeding)))
            if save_dir and (pass_id + 1) % saving_period == 0:
                logger.info("saved checkpoint %s", self.save(
                    save_dir, pass_id, save_only_one=save_only_one))
            event_handler(events.EndPass(pass_id))

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
        state, meta) in the JAX trainer's format and return its path.
        The write is synchronous, so ``block`` is met either way."""
        extra = dict(extra or {})
        extra.setdefault("grad_accum_steps", 1)
        params = self.parameters
        if self._quant and self._qtree:
            # both trees: a resumed step reads the same int8 bytes
            params = {"master": self.parameters, "q": self._qtree}
        return save_checkpoint(save_dir, pass_id, params,
                               self.opt_state, self.model_state,
                               extra=extra, save_only_one=save_only_one)

    def load(self, save_dir, pass_id=None):
        """Load a pass dir (the latest if pass_id is None) written by this
        trainer or by the JAX package's; returns its meta."""
        params, opt_state, model_state, meta = load_checkpoint(save_dir,
                                                               pass_id)
        if meta.get("preempted"):
            _refuse("resuming a preemption checkpoint", "A9·c")
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
            if "inner" in opt_state:    # a grad-accumulation wrapper
                if int(opt_state["tick"]):
                    _refuse("resuming mid gradient accumulation", "A9·c")
                opt_state = opt_state["inner"]
            self.opt_state = {
                "step": int(opt_state["step"]),
                "slots": tree_map(lambda a: torch.tensor(
                    np.asarray(a, np.float32), device=self.device),
                    opt_state["slots"])}
        if model_state:
            self.model_state = tree_map(
                lambda a: torch.tensor(a, device=self.device), model_state)
        return meta
