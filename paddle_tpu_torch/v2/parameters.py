"""paddle.v2.parameters (``paddle_tpu/v2/parameters.py``; reference
v2/parameters.py): a numpy view of the parameter tree by flat dotted
names, with ``create(cost)`` and the tar serialization.

The names are JAX's: the tree's keys joined by ".", dict keys in sorted
order and list entries by index (``jax.tree_util``'s flattening), so
``'__fc_0__.w0'`` names the same leaf in both packages.  The tar layout
is JAX's byte for byte: one member a leaf, its raw C-order bytes, in
that order, then ``__meta__.json`` with each leaf's shape and dtype;
either package reads the other's file.
"""

import io
import json
import tarfile

import numpy as np
import torch

from paddle_tpu_torch.layers.graph import Topology
from paddle_tpu_torch.utils.tree import tree_map


def _flatten(tree, prefix=()):
    """[(path, leaf)] in ``jax.tree_util`` order: dict keys sorted, list
    and tuple entries by index."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, prefix + (k,)))
    return out


class Parameters:
    """Dict-like over the flattened 'layer.param' names (the reference
    exposed flat parameter names like '___fc_layer_0__.w0').  ``tree`` is
    the trainer's {key: {name: tensor}}; ``__getitem__`` returns numpy."""

    def __init__(self, tree):
        self.tree = tree

    # -------------------------------------------------- dict-like access
    def _flat(self):
        return {".".join(str(p) for p in path): leaf
                for path, leaf in _flatten(self.tree)}

    def names(self):
        return list(self._flat())

    def keys(self):
        return self.names()

    def __contains__(self, name):
        return name in self._flat()

    def __getitem__(self, name):
        return self._flat()[name].detach().cpu().numpy()

    def __setitem__(self, name, value):
        """The leaf ``name`` replaced by ``value`` (numpy or a tensor),
        on the leaf's device and in its dtype."""
        parts = name.split(".")
        node = self.tree
        for key in parts[:-1]:
            node = node[int(key) if isinstance(node, list) else key]
        last = int(parts[-1]) if isinstance(node, list) else parts[-1]
        old = node[last]
        new = value.detach().clone() if isinstance(value, torch.Tensor) \
            else torch.tensor(np.asarray(value))
        node[last] = new.to(device=old.device, dtype=old.dtype)

    def get_shape(self, name):
        return tuple(self._flat()[name].shape)

    # -------------------------------------------------- serialization
    def to_tar(self, f):
        """Reference v2/parameters.py to_tar: a tar of the raw arrays and
        their meta."""
        with tarfile.open(fileobj=f, mode="w") as tar:
            meta = {}
            for name, leaf in self._flat().items():
                a = np.ascontiguousarray(leaf.detach().cpu().numpy())
                meta[name] = {"shape": list(a.shape), "dtype": str(a.dtype)}
                data = a.tobytes()
                info = tarfile.TarInfo(name=name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
            mb = json.dumps(meta).encode()
            info = tarfile.TarInfo(name="__meta__.json")
            info.size = len(mb)
            tar.addfile(info, io.BytesIO(mb))

    @classmethod
    def from_tar(cls, f, like=None):
        """A flat {name: np.ndarray}; with ``like`` (a Parameters or a
        tree) the arrays written into a copy of that tree instead."""
        with tarfile.open(fileobj=f, mode="r") as tar:
            meta = json.loads(tar.extractfile("__meta__.json").read())
            flat = {}
            for name, m in meta.items():
                raw = tar.extractfile(name).read()
                flat[name] = np.frombuffer(raw, m["dtype"]).reshape(
                    m["shape"])
        if like is None:
            return flat
        tree = like.tree if isinstance(like, Parameters) else like
        params = cls(tree_map(lambda t: t.detach().clone(), tree))
        for name, arr in flat.items():
            params[name] = arr
        return params


def create(cost, seed=1, device=None):
    """paddle.v2.parameters.create(cost) -> Parameters, drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (the card
    unless "cpu" or ``init(use_gpu=False)``)."""
    outs = cost if isinstance(cost, (list, tuple)) else [cost]
    topo = Topology(list(outs))
    return Parameters(topo.init(torch.Generator().manual_seed(seed),
                                device=device))
