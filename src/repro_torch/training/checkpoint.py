"""Checkpointing: atomic, numpy-backed, in the reference's format.

Counterpart of ``repro/training/checkpoint.py``, with the same layout:
    <root>/step_<N>/manifest.json     shapes, dtypes, step
    <root>/step_<N>/arr_<k>.npy       one file per leaf
    <root>/LATEST                     name of the newest complete step dir

Writes go to ``step_<N>.tmp`` and are renamed only after the manifest is
fsync'd, so a killed writer never corrupts the latest checkpoint.  Leaves
are numbered in JAX's flattening order (``training.tree``: sorted dict
keys, sequences in order) and bf16 is stored as a ``uint16`` view with its
true dtype in the manifest, as the reference stores ml_dtypes' bfloat16:
a checkpoint written by either package restores into the other's tree.
The manifest's ``treedef`` (JAX's serialized tree structure) is null, as
the reference writes it when JAX cannot serialize one; neither package's
``restore`` reads it.  ``restore`` places each leaf on its target tensor's
device and dtype, or, given ``shardings`` (a tree of
``sharding.NamedSharding``: a mesh and placements), distributes it onto
that mesh (``distribute_tensor``) -- restoring onto a *different* mesh
(elastic rescale) is the same code path.  A tree of DTensors is saved
whole: every rank gathers each leaf, rank 0 writes, and the ranks meet at
a barrier before ``save`` returns.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.training.tree import leaves as _leaves
from repro_torch.training.tree import unflatten

MANIFEST = "manifest.json"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array to store, its true dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":  # ml_dtypes (bfloat16, fp8, ...)
        true = str(arr.dtype)
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), true
    return arr, str(arr.dtype)


def save(root: str | pathlib.Path, step: int, tree, *, keep_last: int = 3) -> str:
    leaves = _leaves(tree)
    if any(isinstance(t, DTensor) for t in leaves):
        # every rank gathers (a collective); rank 0 writes
        whole = [t.full_tensor() if isinstance(t, DTensor) else t
                 for t in leaves]
        path = (_write(root, step, whole, keep_last)
                if dist.get_rank() == 0 else
                str(pathlib.Path(root) / f"step_{step:08d}"))
        dist.barrier()
        return path
    return _write(root, step, leaves, keep_last)


def _write(root, step: int, leaves: list, keep_last: int) -> str:
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    meta = {"step": step, "treedef": None, "num_leaves": len(leaves),
            "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, true_dtype = _to_numpy(leaf)
        np.save(tmp / f"arr_{i}.npy", arr, allow_pickle=False)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": true_dtype,
                               "stored": str(arr.dtype)})

    with open(tmp / MANIFEST, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)

    latest = root / "LATEST"
    latest_tmp = root / "LATEST.tmp"
    latest_tmp.write_text(final.name)
    latest_tmp.rename(latest)

    _gc(root, keep_last)
    return str(final)


def _gc(root: pathlib.Path, keep_last: int) -> None:
    steps = sorted(p for p in root.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root: str | pathlib.Path) -> int | None:
    root = pathlib.Path(root)
    latest = root / "LATEST"
    if not latest.exists():
        return None
    name = latest.read_text().strip()
    if not (root / name / MANIFEST).exists():
        return None
    return int(name.split("_")[1])


def _to_tensor(arr: np.ndarray, true_dtype: str) -> torch.Tensor:
    if true_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != true_dtype:
        raise ValueError(f"no torch dtype for a stored {true_dtype}")
    return torch.from_numpy(arr)


def restore(root: str | pathlib.Path, tree_like, *, step: int | None = None,
            shardings=None):
    """Restore into the structure of ``tree_like``: each leaf takes its
    target tensor's dtype and device, or with ``shardings`` (a tree of the
    same structure whose leaves have ``mesh`` and ``placements``, as
    ``sharding.named`` gives them) becomes a DTensor on that mesh.
    Returns (tree, step)."""
    root = pathlib.Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    meta = json.loads((d / MANIFEST).read_text())

    leaves_like = _leaves(tree_like)
    if meta["num_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves, target {len(leaves_like)}")
    shard_leaves = (_sharding_leaves(shardings) if shardings is not None
                    else [None] * len(leaves_like))

    out = []
    for i, (like, shard) in enumerate(zip(leaves_like, shard_leaves)):
        arr = np.load(d / f"arr_{i}.npy", allow_pickle=False)
        want_shape = tuple(like.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs target {want_shape}")
        t = _to_tensor(arr, meta["leaves"][i]["dtype"])
        if shard is not None:
            t = t.to(device=shard.mesh.device_type, dtype=like.dtype)
            out.append(distribute_tensor(t, shard.mesh, shard.placements))
        else:
            out.append(t.to(device=like.device, dtype=like.dtype))
    return unflatten(tree_like, out), step


def _sharding_leaves(tree) -> list:
    """The shardings of ``tree`` in leaf order (a sharding is a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _sharding_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _sharding_leaves(v)]
    return [tree]
