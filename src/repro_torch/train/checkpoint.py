"""Checkpoints in the reference's on-disk format (port of
``repro.train.checkpoint``): atomic manifests, async save, restore by key.

Layout (one directory per step):

    <dir>/step_000123/
        arrays.npz          the flattened tree ("/"-joined key paths)
        MANIFEST.json       step, tree digest, status=complete

A tree is what ``jax.tree_util`` would flatten: dicts (keys sorted),
named tuples (a field is the path part ``.name``, as JAX prints its
``GetAttrKey``), lists and tuples (the index), and leaves that are tensors
or numpy arrays. The parameters go in as ``models.model.stack(params.
named_parameters())`` and the optimizer state as
``train.optimizer.opt_state_to_host(state)``, the reference's params pytree
and ``AdamWState``; so a checkpoint written by either package restores
into the other. A dtype ``np.savez`` cannot round-trip (bf16) is stored as
the unsigned integer view of its width, and ``restore`` views it back
using the target tree's dtypes.

Writes go to ``step_xxx.tmp`` then ``os.replace``: a crashed writer never
leaves a manifest behind, so ``latest_step`` only ever resumes from a
complete checkpoint. ``AsyncCheckpointer`` snapshots to host and writes on
a worker thread, so the train loop does not block on disk.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

_WIDTH_VIEW = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# the integer views torch reads a stored view back through, by width
_TORCH_VIEW = {1: (np.uint8, torch.uint8), 2: (np.int16, torch.int16),
               4: (np.int32, torch.int32), 8: (np.int64, torch.int64)}
_SAVEZ_SAFE = {"bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
               "uint32", "uint64", "float16", "float32", "float64",
               "complex64", "complex128"}


def _leaves(tree: Any, path: tuple = ()):
    """(key path, leaf) pairs in ``jax.tree_util``'s order and naming."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, val in zip(tree._fields, tree):
            yield from _leaves(val, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _leaves(val, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        out = {key: None for key in tree}
        for key in sorted(tree):
            out[key] = _rebuild(tree[key], leaves)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _shape(leaf) -> tuple:
    return tuple(int(n) for n in (leaf.shape if isinstance(
        leaf, torch.Tensor) else np.shape(leaf)))


def _host(leaf) -> np.ndarray:
    """The leaf's bits as a numpy array ``np.savez`` round-trips."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if _dtype_name(t) not in _SAVEZ_SAFE:
            width = t.element_size()
            return t.view(_TORCH_VIEW[width][1]).numpy().view(
                _WIDTH_VIEW[width])
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name not in _SAVEZ_SAFE:
        arr = arr.view(_WIDTH_VIEW[arr.dtype.itemsize])
    return arr


def tree_digest(tree: Any) -> str:
    keys = sorted(f"{key}:{_shape(leaf)}:{_dtype_name(leaf)}"
                  for key, leaf in _leaves(tree))
    return hashlib.sha256("|".join(keys).encode()).hexdigest()[:16]


def save(dir_: str, step: int, tree: Any, extra: dict | None = None) -> str:
    os.makedirs(dir_, exist_ok=True)
    final = os.path.join(dir_, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = {key: _host(leaf) for key, leaf in _leaves(tree)}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = dict(step=step, digest=tree_digest(tree),
                    num_arrays=len(flat), status="complete",
                    **(extra or {}))
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(dir_: str) -> int | None:
    if not os.path.isdir(dir_):
        return None
    steps = []
    for name in os.listdir(dir_):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(dir_, name, "MANIFEST.json")):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore(dir_: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (shapes and dtypes must
    match): tensor leaves come back as tensors of their dtype (on
    ``device``, the CPU unless given), numpy leaves as numpy arrays."""
    path = os.path.join(dir_, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["status"] == "complete"
    want = tree_digest(like)
    if manifest["digest"] != want:
        raise ValueError(
            f"checkpoint tree digest {manifest['digest']} != expected {want}")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for key, leaf in _leaves(like):
            arr = arrays[key]
            if isinstance(leaf, torch.Tensor):
                if _dtype_name(leaf) in _SAVEZ_SAFE:
                    t = torch.from_numpy(np.array(arr))
                else:                       # a uint view (bf16, ...)
                    view = _TORCH_VIEW[leaf.element_size()][0]
                    t = torch.from_numpy(np.array(arr).view(view)).view(
                        leaf.dtype)
                out.append(t.to(device or "cpu"))
            else:
                want_dt = np.asarray(leaf).dtype
                if arr.dtype != want_dt and want_dt.name not in _SAVEZ_SAFE:
                    arr = arr.view(want_dt)
                out.append(np.asarray(arr, dtype=want_dt))
    return _rebuild(like, iter(out))


def snapshot(tree: Any) -> Any:
    """A host copy of every leaf (tensors stay tensors, on the CPU)."""
    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True)
        return np.array(leaf)
    return _rebuild(tree, iter([copy(leaf) for _, leaf in _leaves(tree)]))


class AsyncCheckpointer:
    """Snapshot to host immediately; persist on a background thread."""

    def __init__(self, dir_: str):
        self.dir = dir_
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None):
        host_tree = snapshot(tree)       # blocks on the device-to-host copy
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree, extra), daemon=True)
        self._thread.start()

    def _write(self, step, tree, extra):
        self.last_path = save(self.dir, step, tree, extra)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
