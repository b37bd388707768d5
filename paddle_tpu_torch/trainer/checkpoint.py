"""Checkpoint save/load in the JAX trainer's on-disk format
(``paddle_tpu/trainer/checkpoint.py:72-247``).

Layout: ``save_dir/pass-%05d/`` holding ``params.npz``,
``opt_state.npz`` and ``model_state.npz`` (each a tree flattened to
"a/b/c" keys by ``_flatten``, with ``__len__`` / ``__none__`` markers
for lists, tuples and None) and ``meta.json`` (``pass_id``,
``format_version`` and the caller's extras).  A pass dir written by
``paddle_tpu``'s trainer loads here, and the reverse, with numpy alone.

Writes are crash-atomic: everything lands in a hidden ``.tmp-`` dir
first and is renamed into place, so a crash mid-save never leaves a
partial pass dir for the latest-pass pick to trip on.  Each write is the
span ``trainer.checkpoint.write`` (``obs/trace.py``), and the fault
point ``trainer.checkpoint.write`` (``resilience/faults.py``) fires
mid-write, after the parameters land in the ``.tmp-`` dir: an injected
error leaves no pass dir and no ``.tmp-`` dir behind.

``save_checkpoint(block=False)`` is JAX's background writer: the
snapshot to host memory is taken before the call returns (a copy of
every leaf, so the trainer's next in-place update cannot reach it), the
disk write runs on a thread, one write in flight per directory, and a
failed write re-raises at that directory's next save or
``wait_pending``.  ``merge_model`` / ``load_merged`` write and read the
JAX package's single deployable ``.npz``.
"""

import atexit
import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from paddle_tpu_torch.obs import trace as obstrace
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.utils.logging import logger

# single-flight async writer PER SAVE DIR: at most one background save in
# flight per directory; a failure surfaces on that directory's next
# save/wait instead of dying silently, and trainers saving to different
# dirs never serialize on (or crash from) each other
_pending = {}        # realpath(save_dir) -> Thread
_pending_exc = {}    # realpath(save_dir) -> BaseException
_pending_lock = threading.Lock()


def wait_pending(save_dir=None):
    """Block until in-flight async saves have landed — for one directory,
    or all of them when save_dir is None — and re-raise their failure
    here (the caller's next sync point) if they had one."""
    with _pending_lock:
        if save_dir is None:
            keys = list(_pending) + [k for k in _pending_exc
                                     if k not in _pending]
        else:
            keys = [os.path.realpath(save_dir)]
        threads = [(_pending.get(k), k) for k in keys]
    first_exc = None
    for t, k in threads:
        if t is not None:
            t.join()
        with _pending_lock:
            exc = _pending_exc.pop(k, None)
            _pending.pop(k, None)
        if exc is not None:
            if first_exc is None:
                first_exc = exc
            else:
                # the first is re-raised, the others leave a trace
                logger.error("async checkpoint save to %s also failed: %r",
                             k, exc)
    if first_exc is not None:
        raise first_exc


# interpreter shutdown kills daemon threads AFTER atexit callbacks run, so
# this makes every scheduled async save land (or report its failure) even
# when an exception unwinds straight out of the train loop
atexit.register(wait_pending)


def _host(tree):
    """Tensors -> numpy arrays, leaf by leaf (other leaves unchanged).
    Always a copy: ``.cpu()`` of a CPU tensor is the same storage, which
    the optimizers update in place."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.cpu().numpy() if t.device.type != "cpu" \
            else t.numpy().copy()
    return tree


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        out[f"{prefix}__len__"] = np.asarray(
            [len(tree), 1 if isinstance(tree, tuple) else 0])
    elif tree is None:
        out[f"{prefix}__none__"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat):
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val

    def rebuild(node):
        if isinstance(node, dict):
            if "__none__" in node and len(node) == 1:
                return None
            if "__len__" in node:
                n, is_tuple = (int(x) for x in node["__len__"])
                items = [rebuild(node[str(i)]) for i in range(n)]
                return tuple(items) if is_tuple else items
            return {k: rebuild(v) for k, v in node.items()}
        return node
    return rebuild(root)


def save_checkpoint(save_dir, pass_id, params, opt_state=None,
                    model_state=None, extra=None, save_only_one=False,
                    block=True):
    """Write ``save_dir/pass-%05d/{params,opt_state,model_state}.npz`` +
    ``meta.json`` (trees of tensors or numpy arrays); returns the pass
    dir.  ``save_only_one`` removes the other pass dirs after.

    block=False: the host snapshot still happens NOW (the values written
    are this exact call's), but the disk write runs on a background
    thread.  Single flight — a new save first joins the previous one of
    its directory; call ``wait_pending()`` before reading the checkpoint
    back."""
    final = os.path.join(save_dir, f"pass-{pass_id:05d}")
    host_params = _host(params)
    host_opt = _host(opt_state) if opt_state is not None else None
    host_mstate = _host(model_state) if model_state is not None else None
    meta = {"pass_id": pass_id, "format_version": 1}
    meta.update(extra or {})

    def write():
        span = obstrace.start_span("trainer.checkpoint.write", root=False,
                                   pass_id=pass_id)
        try:
            os.makedirs(save_dir, exist_ok=True)
            tmp = tempfile.mkdtemp(prefix=f".tmp-pass-{pass_id:05d}-",
                                   dir=save_dir)
            # mkdtemp makes 0700; inherit the parent's perms
            os.chmod(tmp, os.stat(save_dir).st_mode & 0o777)
        except BaseException as e:   # the span must not stay active
            span.end(error=f"{type(e).__name__}: {e}")
            raise
        try:
            np.savez(os.path.join(tmp, "params.npz"),
                     **_flatten(host_params))
            # mid-write: the arrays are on disk under the hidden .tmp-
            # name, which is never renamed into a pass dir on failure
            faults.hit("trainer.checkpoint.write")
            if host_opt is not None:
                np.savez(os.path.join(tmp, "opt_state.npz"),
                         **_flatten(host_opt))
            if host_mstate is not None:
                np.savez(os.path.join(tmp, "model_state.npz"),
                         **_flatten(host_mstate))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            old = None
            if os.path.isdir(final):
                # rename the predecessor aside instead of removing it
                # first: the only window with no pass dir is between the
                # two renames, and load_checkpoint falls back to .old-
                # dirs for it
                old = tempfile.mkdtemp(prefix=f".old-pass-{pass_id:05d}-",
                                       dir=save_dir)
                os.rmdir(old)
                os.rename(final, old)
            os.rename(tmp, final)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        except BaseException as e:
            shutil.rmtree(tmp, ignore_errors=True)
            span.end(error=f"{type(e).__name__}: {e}")
            raise
        span.end(path=final)
        if save_only_one:
            for name in os.listdir(save_dir):
                if name.startswith("pass-") \
                        and name != f"pass-{pass_id:05d}":
                    shutil.rmtree(os.path.join(save_dir, name),
                                  ignore_errors=True)

    wait_pending(save_dir)   # don't interleave with an async predecessor
    if block:
        write()
        return final
    key = os.path.realpath(save_dir)

    def run():
        try:
            write()
        except BaseException as e:   # surfaces at the next wait_pending
            with _pending_lock:
                _pending_exc[key] = e

    t = threading.Thread(target=run, daemon=True,
                         name=f"ckpt-save-{pass_id}")
    with _pending_lock:
        _pending[key] = t
    t.start()
    return final


def _load_npz(path):
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


def load_checkpoint(save_dir, pass_id=None):
    """Load a pass dir (the latest if pass_id is None).  Returns
    (params, opt_state, model_state, meta), the trees as numpy arrays."""
    if pass_id is None:
        passes = sorted(n for n in os.listdir(save_dir)
                        if n.startswith("pass-"))
        if not passes:
            # the crash window of an overwrite-save: the predecessor was
            # renamed aside but the replacement didn't land
            passes = sorted(n for n in os.listdir(save_dir)
                            if n.startswith(".old-pass-")
                            and os.path.exists(
                                os.path.join(save_dir, n, "meta.json")))
        if not passes:
            raise FileNotFoundError(f"no pass-* checkpoints in {save_dir}")
        path = os.path.join(save_dir, passes[-1])
    else:
        path = os.path.join(save_dir, f"pass-{pass_id:05d}")
    params = _load_npz(os.path.join(path, "params.npz"))
    opt_state = _load_npz(os.path.join(path, "opt_state.npz"))
    model_state = _load_npz(os.path.join(path, "model_state.npz"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, model_state, meta


def merge_model(save_dir, out_path, pass_id=None):
    """paddle_merge_model equivalent: one deployable ``.npz`` (params +
    model_state + meta) for inference, the JAX package's format."""
    params, _, model_state, meta = load_checkpoint(save_dir, pass_id)
    blob = _flatten({"params": params, "model_state": model_state or {}})
    np.savez_compressed(out_path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), np.uint8), **blob)
    return out_path


def load_merged(path):
    """(params, model_state, meta) of a ``merge_model`` file, numpy
    leaves."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    tree = _unflatten(flat)
    return tree["params"], tree.get("model_state"), meta
