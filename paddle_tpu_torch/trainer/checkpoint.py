"""Checkpoint save/load in the JAX trainer's on-disk format
(``paddle_tpu/trainer/checkpoint.py:72-247``).

Layout: ``save_dir/pass-%05d/`` holding ``params.npz``,
``opt_state.npz`` and ``model_state.npz`` (each a tree flattened to
"a/b/c" keys by ``_flatten``, with ``__len__`` / ``__none__`` markers
for lists, tuples and None) and ``meta.json`` (``pass_id``,
``format_version`` and the caller's extras).  A pass dir written by
``paddle_tpu``'s trainer loads here, and the reverse, with numpy alone.

Writes are synchronous and crash-atomic: everything lands in a hidden
``.tmp-`` dir first and is renamed into place, so a crash mid-save
never leaves a partial pass dir for the latest-pass pick to trip on.
The JAX trainer's background writer waits for ROADMAP A9·c.
"""

import json
import os
import shutil
import tempfile

import numpy as np
import torch


def _host(tree):
    """Tensors -> numpy arrays, leaf by leaf (other leaves unchanged)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
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
                    model_state=None, extra=None, save_only_one=False):
    """Write ``save_dir/pass-%05d/{params,opt_state,model_state}.npz`` +
    ``meta.json`` (trees of tensors or numpy arrays); returns the pass
    dir.  ``save_only_one`` removes the other pass dirs after."""
    final = os.path.join(save_dir, f"pass-{pass_id:05d}")
    meta = {"pass_id": pass_id, "format_version": 1}
    meta.update(extra or {})
    os.makedirs(save_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-pass-{pass_id:05d}-", dir=save_dir)
    # mkdtemp makes 0700; inherit the parent's perms
    os.chmod(tmp, os.stat(save_dir).st_mode & 0o777)
    try:
        np.savez(os.path.join(tmp, "params.npz"), **_flatten(_host(params)))
        if opt_state is not None:
            np.savez(os.path.join(tmp, "opt_state.npz"),
                     **_flatten(_host(opt_state)))
        if model_state is not None:
            np.savez(os.path.join(tmp, "model_state.npz"),
                     **_flatten(_host(model_state)))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        old = None
        if os.path.isdir(final):
            # rename the predecessor aside instead of removing it first:
            # the only window with no pass dir is between the two renames,
            # and load_checkpoint falls back to .old- dirs for it
            old = tempfile.mkdtemp(prefix=f".old-pass-{pass_id:05d}-",
                                   dir=save_dir)
            os.rmdir(old)
            os.rename(final, old)
        os.rename(tmp, final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if save_only_one:
        for name in os.listdir(save_dir):
            if name.startswith("pass-") and name != f"pass-{pass_id:05d}":
                shutil.rmtree(os.path.join(save_dir, name),
                              ignore_errors=True)
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
