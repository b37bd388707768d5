"""Execute reference-style v1 trainer config scripts
(``paddle_tpu/compat/config_parser.py``).

Reference: python/paddle/trainer/config_parser.py:3558 ``parse_config(
config_file, config_arg_str)`` executes the user's config script against
the trainer_config_helpers DSL and returns the assembled proto; the C++
trainer then builds data providers from the recorded PyDataProvider2
sources (TrainerConfigHelper.cpp:33-54).

Here the script executes against the port's layer DSL (the layer ctors
build ``LayerOutput`` graphs directly), so parsing a config yields a
ready topology, optimizer and reader spec with no proto in between.
``parse_config`` returns a ``ParsedConfig``; ``config_to_runtime``
lowers it to the {cost, optimizer, train_reader, feeding, ...} dict the
CLI trainer consumes.

The scripts import ``paddle.trainer_config_helpers`` and their providers
``paddle.trainer.PyDataProvider2``.  While a script or a provider runs,
``paddle_names`` places the port's own modules under those names in
``sys.modules`` (``compat/shim``: ``paddle``,
``paddle.trainer_config_helpers`` and its eight submodules,
``paddle.trainer``, ``paddle.trainer.PyDataProvider2`` and
``paddle.trainer.config_parser``), and afterwards puts back exactly the
``paddle`` entries that stood there before, whatever they were.
"""

import builtins
import contextlib
import importlib
import importlib.machinery
import importlib.util
import os
import sys

from paddle_tpu_torch.utils.error import ConfigError

# The reference config scripts and providers are python-2 era; give them
# the py2 builtins they expect (only where py3 lacks them, so a second
# copy of this setup elsewhere in the process changes nothing).
for _name, _val in (("xrange", range), ("unicode", str),
                    ("basestring", (str, bytes))):
    if not hasattr(builtins, _name):
        setattr(builtins, _name, _val)

# the py2 module name some providers import
import pickle as _pickle  # noqa: E402

sys.modules.setdefault("cPickle", _pickle)


def _py2_map(*a):
    return list(map(*a))


def _py2_filter(*a):
    return list(filter(*a))


# Module-global shadows for the py2 list-returning builtins, seeded into
# the executing namespace (globals win over builtins) rather than written
# into the source, so line numbers and the module docstring stay.
_PY2_GLOBALS = {"map": _py2_map, "filter": _py2_filter}


def _py2_rewrite(src: str) -> str:
    """Textual py2 idioms the reference demo helpers use (dict.iteritems,
    f.next(), sys.maxint); the py3 spellings drop in.  Each replace keeps
    the line, so tracebacks still point at the file on disk."""
    return (src.replace(".iteritems()", ".items()")
               .replace(".itervalues()", ".values()")
               .replace(".iterkeys()", ".keys()")
               .replace(".next()", ".__next__()")
               .replace("sys.maxint", "sys.maxsize"))


class _Py2SourceLoader(importlib.machinery.SourceFileLoader):
    def get_data(self, path):
        if str(path).endswith(".py"):
            with open(path, "r") as f:
                return _py2_rewrite(f.read()).encode()
        return super().get_data(path)

    def get_code(self, fullname):
        # bypass the bytecode cache (it would hold the un-rewritten code)
        source = self.get_data(self.get_filename(fullname))
        return compile(source, self.get_filename(fullname), "exec")

    def exec_module(self, module):
        module.__dict__.update(_PY2_GLOBALS)
        super().exec_module(module)


class _Py2ConfigDirFinder:
    """While a v1 config parses, sibling imports from its directory
    (``from seqtoseq_net import *``) load through the py2 rewrite.  Only
    top-level names are siblings (JAX's finder matches a dotted name by
    its last part too).  The loaded names are recorded so
    ``parse_config`` evicts them afterwards: two demos that both import a
    sibling of one name must not share a cached module."""

    def __init__(self, config_dir):
        self.config_dir = config_dir
        self.loaded = []

    def find_spec(self, name, path=None, target=None):
        if path is not None:
            # a submodule (``paddle_tpu_torch.compat.v1``) is never a
            # sibling, whatever its last name: a config called v1.py must
            # not stand in for it
            return None
        # the config dir first, then its parent (the reference demos do
        # sys.path.append('..') to share helpers)
        base = name + ".py"
        for d in (self.config_dir, os.path.dirname(self.config_dir)):
            cand = os.path.join(d, base)
            if os.path.exists(cand):
                self.loaded.append(name)
                return importlib.util.spec_from_file_location(
                    name, cand, loader=_Py2SourceLoader(name, cand))
        return None


_SHIM = "paddle_tpu_torch.compat.shim"
_TCH_SUBMODULES = ("activations", "attrs", "data_sources", "evaluators",
                   "layers", "networks", "optimizers", "poolings")
# the reference import paths a config or a provider uses -> the port's
# modules that stand for them during a parse
PADDLE_NAMES = {
    "paddle": _SHIM,
    "paddle.trainer_config_helpers": f"{_SHIM}.trainer_config_helpers",
    **{f"paddle.trainer_config_helpers.{m}":
       f"{_SHIM}.trainer_config_helpers.{m}" for m in _TCH_SUBMODULES},
    "paddle.trainer": f"{_SHIM}.trainer",
    "paddle.trainer.PyDataProvider2": f"{_SHIM}.trainer.PyDataProvider2",
    "paddle.trainer.config_parser": f"{_SHIM}.trainer.config_parser",
}


def _is_paddle_key(name):
    return name == "paddle" or name.startswith("paddle.")


@contextlib.contextmanager
def paddle_names():
    """The port's shim modules under the reference's ``paddle.*`` names
    in ``sys.modules`` for the block, and no other ``paddle`` entry (the
    repository's root ``paddle`` package, where a caller imported it, is
    out of sight); on the way out, also when the block raises, every
    ``paddle`` entry is put back as it stood before: the ones there
    restored, the ones the block added removed.  Nests."""
    before = {k: v for k, v in sys.modules.items() if _is_paddle_key(k)}
    try:
        for k in before:        # only the port's names during the block
            del sys.modules[k]
        for name, target in PADDLE_NAMES.items():
            sys.modules[name] = importlib.import_module(target)
        yield
    finally:
        for k in [k for k in sys.modules if _is_paddle_key(k)]:
            if k not in before:
                del sys.modules[k]
        sys.modules.update(before)


class ParseContext:
    def __init__(self, config_args=None, config_dir="."):
        self.config_args = dict(config_args or {})
        self.config_dir = config_dir
        self.settings = {"batch_size": 256, "learning_rate": 1e-3}
        self.data_sources = {}
        self.outputs = []
        self.input_order = []       # data layers in declaration order
        self.explicit_inputs = False    # inputs(...) was called
        self.evaluators = []


_ACTIVE = []


def active_context() -> ParseContext:
    if not _ACTIVE:
        raise ConfigError(
            "no active config parse (settings()/define_py_data_sources2 must "
            "run inside parse_config, i.e. from a --config script)")
    return _ACTIVE[-1]


def in_parse():
    return bool(_ACTIVE)


def _dfs_input_order(outputs):
    """Data layers in DFS order over the output graph, the reference's
    ``outputs()`` input-order rule (trainer_config_helpers/networks.py:
    1410-1490): provider slots pair with data layers as reached from the
    outputs, not as declared.  The two differ when a config declares its
    label layer first (benchmark/paddle/image/googlenet.py:146)."""
    from paddle_tpu_torch.layers.graph import Topology
    order = []
    for node in Topology._topo_sort(outputs):
        if getattr(node, "layer_type", None) == "data" \
                and node.name not in order:
            order.append(node.name)
    return order


class ParsedConfig:
    def __init__(self, ctx: ParseContext, namespace):
        self.settings = ctx.settings
        self.data_sources = ctx.data_sources
        self.outputs = ctx.outputs
        if getattr(ctx, "explicit_inputs", False):
            # reference: an explicit inputs() wins outright
            # (HasInputsSet() early-return, networks.py:1449)
            self.input_order = list(ctx.input_order)
        else:
            # the input order derives from the outputs' graph; declaration
            # order only covers data layers the outputs never reach (kept
            # as a tail so nothing is dropped)
            dfs = _dfs_input_order(ctx.outputs)
            order = dfs + [n for n in ctx.input_order if n not in dfs]
            self._check_seqness_stable(ctx, order)
            self.input_order = order
        self.evaluators = ctx.evaluators
        self.config_dir = ctx.config_dir
        self.namespace = namespace   # the script's globals (for tooling)

    @staticmethod
    def _check_seqness_stable(ctx, final_order):
        """data_layer resolved each layer's seq-ness at its declaration
        index into list-style input_types; feeding pairs types by the
        final order.  Where the two orders differ that is only sound if
        every layer's seq-ness is the same under both pairings; otherwise
        fail loud instead of scrambling sequence flags."""
        types = getattr(ctx, "_resolved_types", None)
        if not isinstance(types, (list, tuple)) \
                or final_order == ctx.input_order:
            return
        decl_idx = {n: i for i, n in enumerate(ctx.input_order)}

        def seqness(i):
            if i is None or i >= len(types):
                return None
            return getattr(types[i], "seq_type", 0)

        for fi, name in enumerate(final_order):
            if seqness(fi) != seqness(decl_idx.get(name)):
                raise ConfigError(
                    f"data layer {name!r}: declaration order and the "
                    "outputs-derived input order assign different "
                    "sequence types from the provider's list-style "
                    "input_types; declare data layers in input order, "
                    "call inputs(...) explicitly, or use dict-style "
                    "input_types")


def _import_provider(module, config_dir):
    """Import a data-provider module from the config's directory, under
    the ``paddle`` names (``paddle_names``).  A provider file is loaded
    under a key of its directory, so same-named providers of different
    demos (every demo calls its module 'dataprovider') don't collide in
    ``sys.modules``; the key's prefix is the port's own, so a provider
    the JAX package loaded (bound to its ``PyDataProvider2`` types) is
    never reused here.  The config dir is on ``sys.path`` during the exec
    so sibling imports resolve."""
    rel = module.replace(".", os.sep) + ".py"
    # the config dir, then its parent (demos share providers one level up)
    path = next((p for p in (os.path.join(config_dir, rel),
                             os.path.join(os.path.dirname(config_dir), rel))
                 if os.path.exists(p)), None)
    added = False
    if config_dir not in sys.path:
        sys.path.insert(0, config_dir)
        added = True
    try:
        with paddle_names():
            if path is None:
                return importlib.import_module(module)
            key = (f"_ptpu_torch_provider_{abs(hash(os.path.dirname(path)))}"
                   f"_{module}")
            if key in sys.modules:
                return sys.modules[key]
            # providers are py2-era too: load through the rewrite
            spec = importlib.util.spec_from_file_location(
                key, path, loader=_Py2SourceLoader(key, path))
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            try:
                spec.loader.exec_module(mod)
            except BaseException:
                del sys.modules[key]    # no half-run module stays cached
                raise
            return mod
    finally:
        if added:
            sys.path.remove(config_dir)


def resolve_input_types(ctx: ParseContext):
    """Input types from the recorded data sources, resolved at parse time
    so data_layer can infer seq-ness (the reference carries it in the
    provider's input_types, not the layer config).  Builds the provider
    with an empty file list: generators are lazy, only init_hook runs.
    A provider that cannot build so (it needs real files) is skipped, as
    JAX's parser skips it."""
    if hasattr(ctx, "_resolved_types"):
        return ctx._resolved_types
    types = None
    for key in ("train", "test"):
        src = ctx.data_sources.get(key)
        if not src:
            continue
        try:
            mod = _import_provider(src["module"], ctx.config_dir)
            factory = getattr(mod, src["obj"]) if isinstance(src["obj"], str) \
                else src["obj"]
            reader = factory([], **(src.get("args") or {}))
            types = getattr(reader, "input_types", None)
            if types:
                break
        except Exception:   # noqa: BLE001 — provider may need real files
            continue
    ctx._resolved_types = types
    return types


def _parse_config_arg_str(s):
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        if not kv.strip():
            continue
        k, _, v = kv.partition("=")
        out[k.strip()] = v.strip()
    return out


def parse_config(config_file, config_arg_str="") -> ParsedConfig:
    """Execute a v1 config script (the reference's parse_config
    signature).  config_arg_str: "k=v,k2=v2" (or an already parsed
    dict)."""
    args = (config_arg_str if isinstance(config_arg_str, dict)
            else _parse_config_arg_str(config_arg_str))
    config_dir = os.path.dirname(os.path.abspath(config_file))
    ctx = ParseContext(args, config_dir)
    from paddle_tpu_torch.layers.graph import reset_names
    reset_names()
    _ACTIVE.append(ctx)
    added_path = False
    finder = _Py2ConfigDirFinder(config_dir)
    try:
        # the provider module named by define_py_data_sources2 lives next
        # to the config script (the reference trainer's behavior)
        if config_dir not in sys.path:
            sys.path.insert(0, config_dir)
            added_path = True
        with open(config_file) as f:
            src = _py2_rewrite(f.read())
        ns = {"__file__": os.path.abspath(config_file),
              "__name__": "__paddle_tpu_torch_config__", **_PY2_GLOBALS}
        code = compile(src, config_file, "exec")
        with paddle_names():
            sys.meta_path.insert(0, finder)
            exec(code, ns)
    finally:
        if finder in sys.meta_path:
            sys.meta_path.remove(finder)
        for name in finder.loaded:
            sys.modules.pop(name, None)
        _ACTIVE.pop()
        if added_path:
            sys.path.remove(config_dir)
    if not ctx.outputs:
        raise ConfigError(f"{config_file} declared no outputs(); nothing to "
                          "train or infer")
    return ParsedConfig(ctx, ns)


# ------------------------------------------------------------ lowering

# the reference's LearningRateScheduler names with decay_a / decay_b
_DECAY_SCHEDULES = ("poly", "exp", "discexp", "linear")


def _manual_segments(args):
    """learning_rate_args "b0:m0,b1:m1,..." (the reference's manual
    schedule) -> [(b0, m0), ...]."""
    segs = []
    for part in str(args or "").split(","):
        if part.strip():
            b, _, m = part.partition(":")
            segs.append((float(b), float(m)))
    if not segs:
        raise ConfigError("learning_rate_schedule='manual' needs "
                          "learning_rate_args='step:multiplier,...'")
    return segs


def _make_optimizer(settings):
    """The ``settings()`` record -> an ``optim`` optimizer.  A schedule
    is named to the optimizer with its decay terms, so
    ``optim.schedules.get`` builds it (JAX's parser hands the optimizer a
    schedule function where it expects a name, and raises KeyError for
    every decayed schedule; ROADMAP C22)."""
    from paddle_tpu_torch import optim
    from paddle_tpu_torch.compat import v1

    method = settings.get("learning_method") or v1.MomentumOptimizer(0.0)
    lr = settings.get("learning_rate", 1e-3)
    kw = dict(method.kw)

    reg = settings.get("regularization")
    if reg is not None:
        if getattr(reg, "l2", 0.0):
            kw["l2"] = reg.l2
        if getattr(reg, "l1", 0.0):
            kw["l1"] = reg.l1
    clip = settings.get("gradient_clipping_threshold")
    if clip:
        clip = clip.threshold if hasattr(clip, "threshold") else clip
        kw["clip_threshold"] = clip

    # the reference LearningRateScheduler: 'poly' with decay_a = decay_b
    # = 0 is constant
    sched_name = settings.get("learning_rate_schedule", "poly")
    da = settings.get("learning_rate_decay_a", 0.0)
    db = settings.get("learning_rate_decay_b", 0.0)
    if sched_name in _DECAY_SCHEDULES and (da or db):
        kw["learning_rate_schedule"] = sched_name
        kw["sched_kw"] = {"decay_a": da, "decay_b": db}
    elif sched_name == "manual":
        kw["learning_rate_schedule"] = "manual"
        kw["sched_kw"] = {"segments": _manual_segments(
            settings.get("learning_rate_args"))}
    elif sched_name not in (None, "constant") + _DECAY_SCHEDULES:
        # JAX's parser drops such a schedule for a constant rate
        raise ConfigError(f"learning_rate_schedule={sched_name!r} is not "
                          "one the config parser lowers (poly, exp, "
                          "discexp, linear, manual, constant); "
                          "pass_manual needs the batches a pass")

    names = {"momentum": optim.Momentum, "adam": optim.Adam,
             "adamax": optim.AdaMax, "adagrad": optim.AdaGrad,
             "decayed_adagrad": optim.DecayedAdaGrad,
             "adadelta": optim.AdaDelta, "rmsprop": optim.RMSProp}
    return names[method.optim_name](learning_rate=lr, **kw)


def _expand_file_list(file_list, config_dir):
    """A train/test list is a text file of data-file paths (one a line,
    the reference convention), resolved against the cwd, then the config
    dir; a list or tuple of paths passes through."""
    if isinstance(file_list, (list, tuple)):
        return list(file_list)
    path = file_list
    if not os.path.exists(path):
        alt = os.path.join(config_dir, file_list)
        if os.path.exists(alt):
            path = alt
        else:
            raise ConfigError(f"data source list file not found: {file_list}")
    base = os.path.dirname(os.path.abspath(path))
    files = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if not os.path.exists(line):
                alt = os.path.join(base, line)
                line = alt if os.path.exists(alt) else line
            files.append(line)
    return files


def _make_reader(src, config_dir, batch_size):
    """A batched reader and the input types of a recorded data source."""
    mod = _import_provider(src["module"], config_dir)
    factory = getattr(mod, src["obj"]) if isinstance(src["obj"], str) \
        else src["obj"]
    files = _expand_file_list(src["file_list"], config_dir)
    sample_reader = factory(files, **(src.get("args") or {}))
    input_types = getattr(sample_reader, "input_types", None)

    def batched():
        batch = []
        for sample in sample_reader():
            batch.append(sample)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    return batched, input_types


def _feeding_dict(input_types, input_order):
    """{name: InputType} in the input order (list-style input_types pair
    positionally with it, the reference's inputs() ordering)."""
    if input_types is None:
        return None
    if isinstance(input_types, dict):
        if input_order:
            ordered = {n: input_types[n] for n in input_order
                       if n in input_types}
            if len(ordered) == len(input_types):
                return ordered
        return dict(input_types)
    return dict(zip(input_order, list(input_types)))


def config_to_runtime(parsed: ParsedConfig, for_test=False):
    """Lower a ParsedConfig to the CLI trainer's config dict."""
    batch_size = parsed.settings.get("batch_size", 256)
    cfg = {
        "cost": (parsed.outputs[0] if len(parsed.outputs) == 1
                 else list(parsed.outputs)),
        "optimizer": _make_optimizer(parsed.settings),
        "batch_size": batch_size,
        "evaluators": list(parsed.evaluators),
    }
    feeding = None
    if "train" in parsed.data_sources:
        reader, input_types = _make_reader(parsed.data_sources["train"],
                                           parsed.config_dir, batch_size)
        cfg["train_reader"] = reader
        feeding = _feeding_dict(input_types, parsed.input_order)
    if "test" in parsed.data_sources:
        reader, input_types = _make_reader(parsed.data_sources["test"],
                                           parsed.config_dir, batch_size)
        cfg["test_reader"] = reader
        if feeding is None:
            feeding = _feeding_dict(input_types, parsed.input_order)
    if feeding:
        cfg["feeding"] = feeding
    return cfg
