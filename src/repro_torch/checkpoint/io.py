"""Checkpoint I/O: one .npy file per leaf and a JSON manifest.

The counterpart of ``repro.checkpoint.io``, in its on-disk format, so that
a checkpoint written by either package restores in the other, leaf for
leaf:

  * ``manifest.json`` holds the step, the save time, the caller's
    metadata, a string naming the tree's structure (``treedef``; the
    reference writes JAX's, the port its own), and one entry a leaf: its
    key path, index, global shape, dtype and shards (file name and global
    offset).  The port writes every leaf as one shard at offset 0, and
    reads shards at any offsets.
  * Key paths follow JAX's: a dict's keys in sorted order, a sequence's
    indices, a NamedTuple's field names, and a dataclass's fields by their
    index in field order (as the reference's registered pytree node classes
    flatten them), joined by '/'.
  * bfloat16 leaves are saved as float32 (lossless: numpy has no bf16) and
    restored as bfloat16, from the manifest's dtype.
  * Writes are atomic: a temporary directory beside the target, then
    ``os.replace``.

``restore_checkpoint`` takes a template tree and matches each of its leaves
to the manifest's entry by key path; shapes must match.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in JAX's flattening order, or
    None for a leaf.  None is an empty node, as in JAX."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(str(i), getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix) or "<root>", tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in kids:
        out.extend(_flatten(child, prefix + (key,)))
    return out


def _structure(node) -> str:
    """The port's ``treedef``: the tree's nesting with '*' for each leaf."""
    kids = _children(node)
    if kids is None:
        return "*"
    if node is None:
        return "None"
    inner = ", ".join(
        (f"{k!r}: " if isinstance(node, dict) else "") + _structure(c)
        for k, c in kids)
    if isinstance(node, dict):
        return "{" + inner + "}"
    if isinstance(node, list):
        return "[" + inner + "]"
    if type(node) is tuple:
        return "(" + inner + ")"
    return f"{type(node).__name__}({inner})"


def _unflatten(template, leaves: List[Any]):
    """Rebuild ``template``'s structure with ``leaves`` in flattening
    order (consumed from the front)."""
    kids = _children(template)
    if kids is None:
        return leaves.pop(0)
    if template is None:
        return None
    new = [_unflatten(c, leaves) for _, c in kids]
    if isinstance(template, dict):
        return {k: v for (k, _), v in zip(kids, new)}
    if _is_namedtuple(template):
        return type(template)(*new)
    if isinstance(template, (list, tuple)):
        return type(template)(new)
    return dataclasses.replace(template, **{
        f.name: v for f, v in zip(dataclasses.fields(template), new)})


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)   # npy-portable, lossless
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(
    directory: str | os.PathLike,
    tree: Any,
    step: int,
    metadata: Optional[Dict] = None,
) -> pathlib.Path:
    """Atomically save a tree of tensors (and numpy arrays or scalars)."""
    directory = pathlib.Path(directory)
    directory.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=".ckpt_tmp_",
                                        dir=directory.parent))
    manifest: Dict[str, Any] = {
        "step": int(step),
        "time": time.time(),
        "metadata": metadata or {},
        "treedef": _structure(tree),
        "leaves": [],
    }
    try:
        for i, (key, leaf) in enumerate(_flatten(tree)):
            arr = _to_numpy(leaf)
            fname = f"leaf{i:05d}_shard00000.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append({
                "key": key,
                "index": i,
                "shape": list(arr.shape),
                "dtype": _dtype_name(leaf),
                "shards": [{"file": fname, "offset": [0] * arr.ndim}],
            })
        (tmp / "manifest.json").write_text(json.dumps(manifest))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if directory.exists():
        shutil.rmtree(directory)
    os.replace(tmp, directory)
    return directory


def load_manifest(directory: str | os.PathLike) -> Dict:
    return json.loads((pathlib.Path(directory) / "manifest.json").read_text())


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown checkpoint dtype {name!r}")
    return dt


def _read_leaf(directory: pathlib.Path, entry: Dict) -> np.ndarray:
    """A leaf's global array from its shards."""
    shape = tuple(entry["shape"])
    bf16 = entry["dtype"] == "bfloat16"
    full = np.zeros(shape, np.float32 if bf16 else np.dtype(entry["dtype"]))
    for sh in entry["shards"]:
        data = np.load(directory / sh["file"]).astype(full.dtype)
        idx = tuple(slice(off, off + dim)
                    for off, dim in zip(sh["offset"], data.shape))
        full[idx] = data
    return full


def restore_checkpoint(
    directory: str | os.PathLike,
    target_tree: Any,
    device=None,
) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``target_tree``, matching leaves by
    key path (shapes must match), as tensors of the manifest's dtypes on
    ``device`` (default: the CUDA device; pass ``device='cpu'`` for the
    CPU).  Returns (tree, step, metadata)."""
    dev = resolve_device(device, "restore_checkpoint")
    directory = pathlib.Path(directory)
    manifest = load_manifest(directory)
    entries = {e["key"]: e for e in manifest["leaves"]}
    targets = _flatten(target_tree)
    if len(targets) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"target expects {len(targets)}")
    out: List[Any] = []
    for key, target in targets:
        entry = entries.get(key)
        if entry is None:
            raise ValueError(f"checkpoint has no leaf {key!r}")
        shape = tuple(entry["shape"])
        if tuple(np.shape(target)) != shape:
            raise ValueError(
                f"leaf {key}: checkpoint shape {shape} != target "
                f"{tuple(np.shape(target))}")
        arr = torch.from_numpy(_read_leaf(directory, entry))
        out.append(arr.to(dev, _torch_dtype(entry["dtype"])))
    tree = _unflatten(target_tree, out)
    return tree, int(manifest["step"]), manifest.get("metadata", {})
