"""Checkpointing: async, atomic, keep-N, resume.

Port of the reference's ``checkpoint/ckpt.py``, in its on-disk format, so
each package restores the other's checkpoints: one ``.npz`` per (step,
host) named ``ckpt_<step:08d>_h<host>.npz``, keyed by each leaf's tree
path (dict keys, sorted, and sequence indices joined by ``/``, as
``jax.tree_util`` flattens a tree), beside ``manifest_h<host>.json``,
which records the latest durable step.  A bfloat16 leaf, which numpy has
no type for, is stored as raw 2-byte void (``|V2``), as the reference's
numpy bf16 arrays are; any void leaf is read back as the template leaf's
type, bit for bit.

Writes go to a temp name and then rename (atomic on POSIX), so a
half-written checkpoint is never visible.  ``save_async`` copies every
leaf from the device to host memory before it returns and writes on a
background thread, so the train loop never blocks on disk; this is the
restart story of the fault-tolerance manager (``runtime.fault``).

A tree's leaves are tensors (restored as tensors of the template leaf's
dtype on its device), numpy arrays or scalars (restored as numpy arrays,
as the reference restores every leaf).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

import numpy as np
import torch

from repro_torch import tree as tree_lib

_V2 = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference writes: a host copy of a
    tensor (bf16 as raw 2-byte void), or a copy of the array."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_V2)
        return t.numpy()
    return np.array(leaf)


def _flatten(tree) -> dict:
    return {tree_lib.path_key(path): _to_numpy(leaf)
            for path, leaf in tree_lib.leaves_with_path(tree)}


def _restore_leaf(arr: np.ndarray, leaf):
    if torch.is_tensor(leaf):
        if arr.dtype.kind == "V":          # bf16 stored raw
            assert leaf.element_size() == arr.dtype.itemsize, \
                (arr.dtype, leaf.dtype)
            raw = torch.from_numpy(arr.view(np.int16).copy())
            t = raw.view(leaf.dtype)
        else:
            t = torch.from_numpy(arr.copy()).to(leaf.dtype)
        return t.to(leaf.device)
    if arr.dtype.kind == "V":
        arr = arr.view(np.dtype(leaf.dtype))
    return arr.astype(np.asarray(leaf).dtype)


def save_pytree(tree, path: str):
    arrays = _flatten(tree)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_pytree(template, path: str):
    """Restore arrays into the structure of ``template``."""
    with np.load(path) as data:
        def restore(path_, leaf):
            key = tree_lib.path_key(path_)
            arr = data[key]
            shape = (tuple(leaf.shape) if torch.is_tensor(leaf)
                     else np.shape(leaf))
            assert tuple(arr.shape) == shape, (key, arr.shape, shape)
            return _restore_leaf(arr, leaf)

        return tree_lib.map_with_path(restore, template)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, host_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.host = host_index
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -------------------------------------------------- paths & manifest
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}_h{self.host}.npz")

    def _manifest(self) -> str:
        return os.path.join(self.dir, f"manifest_h{self.host}.json")

    def latest_step(self):
        try:
            with open(self._manifest()) as f:
                return json.load(f)["step"]
        except Exception:
            steps = self.all_steps()
            return steps[-1] if steps else None

    def all_steps(self):
        pat = re.compile(rf"ckpt_(\d+)_h{self.host}\.npz$")
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := pat.match(f)))

    # -------------------------------------------------- save / restore
    def _write(self, step: int, arrays: dict):
        tmp = self._path(step) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._path(step))
        with open(self._manifest() + ".tmp", "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(self._manifest() + ".tmp", self._manifest())
        self._gc()

    def save(self, step: int, tree):
        self._write(step, _flatten(tree))

    def save_async(self, step: int, tree):
        """Snapshot to host memory now; write in the background."""
        self.wait()
        snapshot = _flatten(tree)         # device->host copy happens here
        self._thread = threading.Thread(target=self._write,
                                        args=(step, snapshot), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template, step=None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_pytree(template, self._path(step)), step

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            try:
                os.remove(self._path(s))
            except OSError:
                pass
