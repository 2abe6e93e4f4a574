"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpoint``):
atomic, manifest-driven, restorable into another layout.

* **atomic** -- write into ``step_<n>.tmp``, fsync, rename; a crash
  mid-save never corrupts the latest checkpoint;
* **manifest** -- ``manifest.json`` lists every leaf (its ``"/"``-joined
  key path, shape and dtype), so restore validates the structure before
  touching arrays; ``arrays.npz`` holds the leaves as ``leaf_<i>``.  The
  format is the reference's, so each package restores the other's files;
* **async** -- :class:`AsyncCheckpointer` snapshots to host memory
  synchronously and writes on a worker thread;
* **retention** -- keep the last ``keep`` checkpoints.

bf16 leaves: numpy has no bf16 without ``ml_dtypes`` (which the GPU
machine lacks), so a bf16 leaf is stored as its raw 2-byte words, an
``|V2`` array with manifest dtype ``bfloat16`` -- byte for byte what the
reference writes for a bf16 leaf.  The port restores such leaves from
either package bit for bit.  The reference cannot restore a bf16 leaf at
all, its own included (numpy has no cast from ``|V2`` to ``bfloat16``);
both packages restore every fp32 and integer leaf of the other's.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_paths, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")
BF16_STORAGE = "|V2"


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a tensor leaf (bf16 as its raw ``|V2`` words)."""
    if isinstance(leaf, np.ndarray):
        return leaf
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_STORAGE)
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype(BF16_STORAGE) else \
        str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(directory: str, step: int, state, keep: int = 3) -> str:
    """Atomically save ``state`` (a tree of tensors or numpy arrays) at
    ``step``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": int(step), "leaves": []}
    arrays = {}
    for i, (path, leaf) in enumerate(tree_paths(state)):
        arr = _to_numpy(leaf)
        name = f"leaf_{i}"
        arrays[name] = arr
        manifest["leaves"].append(
            {"key": "/".join(map(str, path)), "name": name,
             "shape": list(arr.shape), "dtype": _dtype_name(arr)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _steps(directory: str) -> list[int]:
    return [int(m.group(1)) for m in
            (_STEP_RE.match(d) for d in os.listdir(directory)) if m]


def _gc(directory: str, keep: int):
    for s in sorted(_steps(directory))[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target):
    """Restore into ``target``'s structure: every leaf's key must be in the
    checkpoint with the target leaf's shape; each comes back on the target
    leaf's device in its dtype.  (The reference's ``shardings`` argument
    has no counterpart: the port trains on one device.)"""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key_path, leaf in tree_paths(target):
            key = "/".join(map(str, key_path))
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            e = by_key[key]
            arr = data[e["name"]]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs {want}")
            leaves.append(_to_tensor(arr, e["dtype"]).to(
                device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(target, leaves)


class AsyncCheckpointer:
    """Snapshot synchronously, persist on a background thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state):
        self.wait()
        # synchronous host snapshot, decoupled from the live tensors (a
        # CPU tensor's numpy view would share its memory: copied)
        snapshot = tree_unflatten(state, [
            _to_numpy(x.detach().clone() if x.device.type == "cpu" else x)
            for x in tree_leaves(state)])

        def work():
            try:
                save_checkpoint(self.directory, step, snapshot, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
