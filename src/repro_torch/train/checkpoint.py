"""Checkpoint save / restore (counterpart of ``repro/train/checkpoint.py``).

Layout, the reference's: ``<dir>/step_<n>/`` holding one ``.npy`` per leaf
(``leaf_<i>.npy``) and ``manifest.json`` (step, each leaf's path, file,
shape and dtype, the caller's metadata).  Leaves are ordered and named as
``jax.tree_util`` flattens the same tree (dict keys sorted, list and tuple
entries by index, ``None`` holding none), so
either package restores the other's checkpoint of the same tree; write a
model's parameters in the reference's stacked layout
(:func:`repro_torch.models.model.stacked_tree`).  bf16 leaves are stored
as their 16-bit patterns (int16 ``.npy``) with ``"bfloat16"`` in the
manifest, since numpy has no bf16; only the port reads those back.

Fault-tolerance contract:
  * atomic publish — write to ``tmp_step_<n>``, then rename;
  * ``latest_step`` scans for the newest complete manifest, so a job killed
    mid-write restarts from the previous step;
  * the data pipeline seeks to ``step·global_batch`` on restart.

``restore(..., shardings=)`` takes a tree of the port's
:class:`~repro_torch.distributed.sharding.NamedSharding` shaped like
``like_tree`` and places each leaf on its mesh's device, as the reference
re-shards onto the current mesh.  One card holds a leaf whole: a spec that
splits a leaf over an axis of size > 1, or a spec-only mesh (the
production meshes, which hold no device), raises.  Without ``shardings``
a restored leaf goes to the device of the leaf it replaces.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """``[(path, leaf)]`` in ``jax.tree_util``'s order, paths joined by
    ``/`` as the reference's ``_key_str`` joins them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in _flatten(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_flatten` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        got = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    return next(leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree, *, metadata: dict | None = None):
    """Atomic checkpoint publish."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f"tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index = []
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        index.append({"path": name, "file": fname, "shape": list(arr.shape),
                      "dtype": dtype})
    manifest = {"step": step, "leaves": index, "metadata": metadata or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    """Newest step with a complete manifest (crash-consistent)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
            os.path.join(directory, name, _MANIFEST)
        ):
            steps.append(int(name[len("step_"):]))
    return max(steps) if steps else None


def _device_of(sharding, path: str) -> torch.device:
    """The one device a leaf restored under ``sharding`` goes to."""
    if sharding.mesh.devices is None:
        raise ValueError(f"leaf {path}: a spec-only mesh "
                         f"{dict(sharding.mesh.shape)} holds no device")
    if sharding.shard_factor() > 1:
        raise ValueError(f"leaf {path}: {sharding.spec} splits it over "
                         f"{sharding.shard_factor()} devices; one card "
                         "holds a leaf whole")
    return sharding.mesh.devices[0]


def _restored(arr: np.ndarray, meta: dict, like, sharding) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if meta["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    if sharding is not None:
        return t.to(_device_of(sharding, meta["path"]))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def restore(directory: str, step: int, like_tree, *, shardings=None):
    """Restore into the structure of ``like_tree``: tensors, each on the
    device of the leaf it replaces (the CPU for a non-tensor leaf), or on
    its sharding's device when ``shardings`` (a tree of NamedSharding
    shaped like ``like_tree``) is given, in the dtype it was saved in.  A
    leaf count or shape that differs raises."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]
    flat = [leaf for _, leaf in _flatten(like_tree)]
    if len(flat) != len(leaves_meta):
        raise ValueError(
            f"checkpoint has {len(leaves_meta)} leaves, tree expects "
            f"{len(flat)}"
        )
    sh_flat = ([sh for _, sh in _flatten(shardings)]
               if shardings is not None else [None] * len(flat))
    if len(sh_flat) != len(flat):
        raise ValueError(f"{len(sh_flat)} shardings for {len(flat)} leaves")
    out = []
    for meta, like, sh in zip(leaves_meta, flat, sh_flat):
        arr = np.load(os.path.join(d, meta["file"]))
        want = tuple(like.shape if hasattr(like, "shape")
                     else np.shape(like))
        if tuple(arr.shape) != want:
            raise ValueError(
                f"leaf {meta['path']}: checkpoint shape {arr.shape} != "
                f"expected {want}"
            )
        out.append(_restored(arr, meta, like, sh))
    return _unflatten(like_tree, iter(out)), manifest


def restore_latest(directory: str, like_tree, *, shardings=None):
    step = latest_step(directory)
    if step is None:
        return None
    tree, manifest = restore(directory, step, like_tree, shardings=shardings)
    return step, tree, manifest
