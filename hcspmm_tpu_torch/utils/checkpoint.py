"""Checkpoint / resume; port of hcspmm_tpu/utils/checkpoint.py in the same
file format, so that a checkpoint written by either package loads in the
other.

The format is one ``.npz``: the leaves as ``leaf_0, leaf_1, ...`` in JAX's
flatten order (lists and tuples in order, dict keys sorted, None holding
no leaf), ``__treedef__`` the JSON of the tree with every leaf replaced by
``"__array__"`` (the text ``json.dumps`` gives JAX's ``tree.map`` of it),
and ``__meta__`` a JSON object.  A leaf is anything else: a tensor (saved
as its NumPy array on the host), an array or a scalar.  Loading gives
NumPy leaves, tuples coming back as lists as in the JAX package;
``models.net.params_from_jax`` turns a parameter list into tensors.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch

_PLACEHOLDER = "__array__"


def _flatten(tree, leaves: List) -> Any:
    """The skeleton of ``tree`` (leaves replaced by the placeholder), its
    leaves appended to ``leaves`` in JAX's order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    leaves.append(np.asarray(tree))
    return _PLACEHOLDER


def _unflatten(skeleton, leaves) -> Any:
    if skeleton is None:
        return None
    if isinstance(skeleton, dict):
        return {k: _unflatten(skeleton[k], leaves) for k in sorted(skeleton)}
    if isinstance(skeleton, list):
        return [_unflatten(v, leaves) for v in skeleton]
    if skeleton != _PLACEHOLDER:
        raise ValueError(f"__treedef__ holds {skeleton!r} where a leaf or a container belongs")
    leaf = next(leaves, None)
    if leaf is None:
        raise ValueError("__treedef__ places more leaves than the file holds")
    return leaf


def save_pytree(path: str, tree, metadata: dict | None = None) -> None:
    """Atomic save: a crash mid-write (the failure the elastic supervisor
    recovers from, train.elastic) must never corrupt the last good
    checkpoint, so the file is written to a temp name and os.replace()d
    into place."""
    leaves: List = []
    skeleton = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + f".tmp.{os.getpid()}.npz"
    np.savez(tmp, __treedef__=json.dumps(skeleton), __meta__=json.dumps(metadata or {}),
             **arrays)
    os.replace(tmp, final)


def load_pytree(path: str) -> Tuple[Any, dict]:
    """(tree with NumPy leaves, metadata) of a checkpoint; ``path`` may
    omit the ``.npz`` that ``save_pytree`` appends."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        skeleton = json.loads(str(data["__treedef__"]))
        meta = json.loads(str(data["__meta__"]))
        n = len([k for k in data.files if k.startswith("leaf_")])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    it = iter(leaves)
    tree = _unflatten(skeleton, it)
    if next(it, None) is not None:
        raise ValueError("the file holds more leaves than __treedef__ places")
    return tree, meta
