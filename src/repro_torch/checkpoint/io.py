"""Atomic sharded checkpoints, in the JAX package's on-disk format
(``repro.checkpoint.io``).

Layout:  <dir>/step_<N>/
            meta.json            — step, leaf index, shapes/dtypes, hash
            arrays_<k>.npz       — leaf shards (at most 512 MiB each)
            _COMMITTED           — written last; a checkpoint without the
                                   marker is ignored (crash-safe)

Writes go to a ``step_<N>.tmp.*`` directory, then ``os.rename``.  Leaves
are named by their key path as ``jax.tree_util.keystr`` writes it
(:func:`keypath_items`: ``['params']['embed']``, and a NamedTuple's
fields as attributes, ``['opt'].mu['embed']``), so a checkpoint of either
package loads in the other.  A bf16 tensor is written as the reference
writes a bf16 array (NumPy has no bf16: two raw bytes, ``|V2``) and read
back as bf16 by :func:`tree_to_torch`.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MAX_SHARD_BYTES = 512 << 20


def keypath_items(tree) -> List[Tuple[str, Any]]:
    """(key path, leaf) of every leaf, in ``jax.tree_util``'s flattening
    order: dict keys sorted, NamedTuple fields and sequence items in
    order; ``None`` holds no leaf."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), f"{path}.{f}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif node is not None:
            out.append((path, node))

    walk(tree, "")
    return out


def fill_template(template, leaves: Dict[str, Any], path: str = ""):
    """``template``'s structure (dicts, NamedTuples, sequences) with each
    leaf replaced by ``leaves[its key path]``."""
    if isinstance(template, dict):
        return {k: fill_template(template[k], leaves, f"{path}[{k!r}]")
                for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(fill_template(getattr(template, f),
                                              leaves, f"{path}.{f}")
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(fill_template(v, leaves, f"{path}[{i}]")
                              for i, v in enumerate(template))
    if template is None:
        return None
    if path not in leaves:
        raise KeyError(f"checkpoint missing leaf {path}")
    return leaves[path]


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the NumPy array the reference would write (bf16 as its
    two raw bytes); a tensor is copied, so that a save in flight holds a
    snapshot while the step updates the tensor in place.  A ``DTensor``
    is gathered whole first: a collective, so every rank of its mesh
    calls this for it."""
    if isinstance(leaf, torch.Tensor):
        from repro_torch.parallel.sharding import is_dtensor

        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree,
                    extra_meta: Optional[Dict] = None) -> str:
    """Blocking save; returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp.", dir=directory)
    items = keypath_items(tree)
    shards: List[Dict[str, np.ndarray]] = [{}]
    sizes = [0]
    index: Dict[str, int] = {}
    leaves_meta: Dict[str, Dict] = {}
    for name, leaf in items:
        arr = to_numpy(leaf)
        if sizes[-1] + arr.nbytes > MAX_SHARD_BYTES and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = arr
        sizes[-1] += arr.nbytes
        index[name] = len(shards) - 1
        leaves_meta[name] = {"shape": list(arr.shape),
                             "dtype": _dtype_name(leaf, arr)}
    digest = hashlib.sha256()
    for i, shard in enumerate(shards):
        path = os.path.join(tmp, f"arrays_{i}.npz")
        np.savez(path, **shard)
        with open(path, "rb") as f:
            digest.update(f.read())
    meta = {
        "step": step,
        "index": index,
        "n_shards": len(shards),
        "leaves": leaves_meta,
        "sha256": digest.hexdigest(),
        "extra": extra_meta or {},
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def checkpoint_steps(directory: str) -> List[int]:
    """Committed checkpoints, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp." not in name:
            if os.path.exists(os.path.join(directory, name, "_COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def load_checkpoint(directory: str, step: Optional[int] = None,
                    template=None, verify: bool = True):
    """Returns (tree, meta): the flat ``{key path: array}`` without
    ``template``, else the template's structure filled with the arrays
    (NumPy; :func:`tree_to_torch` makes tensors of them)."""
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if verify:
        digest = hashlib.sha256()
        for i in range(meta["n_shards"]):
            with open(os.path.join(path, f"arrays_{i}.npz"), "rb") as f:
                digest.update(f.read())
        if digest.hexdigest() != meta["sha256"]:
            raise IOError(f"checkpoint {path} failed hash verification")
    arrays: Dict[str, np.ndarray] = {}
    for i in range(meta["n_shards"]):
        with np.load(os.path.join(path, f"arrays_{i}.npz")) as z:
            for k in z.files:
                arrays[k] = z[k]
    if template is None:
        return arrays, meta
    return fill_template(template, arrays), meta


def tree_to_torch(tree, device="cpu"):
    """A tree of NumPy arrays (as :func:`load_checkpoint` returns it) as
    tensors on ``device``; two-byte raw arrays (the reference's bf16)
    become bf16."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(conv(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        arr = np.asarray(node)
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(device)

    return conv(tree)
