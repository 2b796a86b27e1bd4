"""Fault-tolerant checkpointing: atomic, async, keep-policy (the port of
``repro.checkpoint``, with its on-disk contract).

  * a checkpoint is a directory ``step_<n>/`` (``step_%08d``) holding
    ``arrays.npz`` and a ``meta.json`` (``meta``, the sorted ``keys``,
    ``time``);
  * writes go to ``step_<n>.tmp`` and are renamed atomically — a crash
    mid-write never corrupts the latest checkpoint, and ``restore_latest``
    never picks up a torn ``.tmp`` directory;
  * ``CheckpointManager`` keeps the most recent ``keep`` checkpoints and
    can write on a background thread; the state is copied to host memory
    before the thread starts, so a training step that updates the
    parameters in place cannot tear the snapshot.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or Python numbers; an ``nn.Module`` stands for its
named parameters.  A leaf's key is its path joined with ``/`` (``0/embed``,
``1/mu/embed``, ``2`` for the state ``(model, OptState, step)``).  bf16
tensors are stored as f32 (numpy has no bf16) and restored to the dtype of
the tree they are loaded into.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else aliases."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(leaf)


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> None:
    """Leaves of ``tree`` by key, in the tree's order."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = tree


def to_host(tree: Any) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` copied to host memory, by key."""
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    return {k: _host(v) for k, v in flat.items()}


def save_pytree(path: str, tree: Any, *, meta: Optional[dict] = None) -> None:
    """Atomic save of a tree to ``path`` (a directory)."""
    _write(path, to_host(tree), meta)


def _write(path: str, arrs: Dict[str, np.ndarray], meta: Optional[dict]) -> None:
    """Host arrays to ``path.tmp``, then renamed to ``path``."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrs)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"meta": meta or {}, "keys": sorted(arrs.keys()),
                   "time": time.time()}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _fill(like, data, prefix: str):
    """``like`` with every leaf read from ``data``: tensors (module
    parameters included) are overwritten in place, in their own dtype and
    device; containers are rebuilt; numbers take the stored value."""
    if isinstance(like, nn.Module):
        _fill(dict(like.named_parameters()), data, prefix)
        return like
    if isinstance(like, dict):
        return {k: _fill(v, data, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_fill(v, data, f"{prefix}{i}/") for i, v in enumerate(like)]
        if hasattr(like, "_fields"):  # NamedTuple
            return type(like)(*vals)
        return type(like)(vals)
    arr = data[prefix[:-1]]
    if isinstance(like, torch.Tensor):
        with torch.no_grad():
            like.copy_(torch.from_numpy(arr).to(like.dtype))
        return like
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def load_pytree(path: str, like: Any) -> Any:
    """Load ``path`` into the structure of ``like`` (see ``_fill``)."""
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _fill(like, data, "")


class CheckpointManager:
    """Keep-policy + optional async writer."""

    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self):
        """Steps of the complete checkpoints, ascending."""
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def wait(self):
        """Join the writer thread, if one runs."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, *, meta: Optional[dict] = None):
        """Write ``tree`` as step ``step``: copied to host now, written now
        or on a background thread."""
        host = to_host(tree)

        def write():
            _write(self._step_dir(step), host, meta)
            self._gc()

        self.wait()
        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, step: int, like: Any):
        """Checkpoint ``step`` loaded into ``like``."""
        return load_pytree(self._step_dir(step), like)

    def latest_step(self) -> Optional[int]:
        """The newest complete step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None


def restore_latest(directory: str, like: Any):
    """Returns (tree, step) from the newest complete checkpoint, or
    (None, None)."""
    mgr = CheckpointManager(directory, async_write=False)
    step = mgr.latest_step()
    if step is None:
        return None, None
    return mgr.restore(step, like), step
