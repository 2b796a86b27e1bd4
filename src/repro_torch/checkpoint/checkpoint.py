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

A state sharded on a grid (a model from ``runtime.sharding.shard_model``
or ``launch.train.make_state(mesh=)``, with its moments) is written as its
*logical* arrays, as JAX's checkpoints are: every rank gathers each leaf
(a collective) and rank 0 alone copies it to host memory and writes.
Loading into a sharded ``like`` keeps each rank's block of the logical
arrays by the like's own specs (or by ``shardings=``, a
``runtime.sharding.ModelSharding``), so a checkpoint of one grid restores
onto another: JAX's elastic restore.
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


def tree_shardings(tree: Any):
    """The placement of a tree holding a sharded model (the model itself,
    or a state whose first element it is): its ``ModelSharding``, else
    None.  A leaf takes the spec of its last key component, the parameter
    name (``0/embed`` and ``1/mu/embed`` both take ``embed``'s); other
    leaves are whole."""
    model = tree[0] if isinstance(tree, (list, tuple)) and tree else tree
    return getattr(model, "sharding", None)


def _spec(key: str, shardings) -> tuple:
    if shardings is None:
        return ()
    return shardings.specs.get(key.rsplit("/", 1)[-1], ())


def to_host(tree: Any, shardings=None
            ) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` copied to host memory, by key; sharded
    leaves are gathered to their logical arrays first (a collective, which
    every rank joins; only the writer keeps the copies, so a grid's other
    ranks return an empty dict instead of holding the whole state too)."""
    from ..runtime.sharding import gather_tensor

    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    keep = _writer(shardings)
    out = {}
    for k, v in flat.items():
        spec = _spec(k, shardings)
        if spec and isinstance(v, torch.Tensor):
            v = gather_tensor(v.detach(), spec, shardings.grid)
        if keep:
            out[k] = _host(v)
    return out


def _writer(shardings) -> bool:
    """Whether this rank writes (rank 0 of a sharded tree's grid)."""
    return shardings is None or shardings.grid.rank == 0


def save_pytree(path: str, tree: Any, *, meta: Optional[dict] = None,
                shardings=None) -> None:
    """Atomic save of a tree to ``path`` (a directory): a sharded tree's
    logical arrays, written by rank 0 (every rank calls it)."""
    shardings = shardings or tree_shardings(tree)
    host = to_host(tree, shardings)
    if _writer(shardings):
        _write(path, host, meta)


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


def _fill(like, data, prefix: str, shardings=None):
    """``like`` with every leaf read from ``data``: tensors (module
    parameters included) are overwritten in place, in their own dtype and
    device, with the rank's block of a sharded leaf; containers are
    rebuilt; numbers take the stored value."""
    if isinstance(like, nn.Module):
        _fill(dict(like.named_parameters()), data, prefix, shardings)
        return like
    if isinstance(like, dict):
        return {k: _fill(v, data, f"{prefix}{k}/", shardings)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_fill(v, data, f"{prefix}{i}/", shardings)
                for i, v in enumerate(like)]
        if hasattr(like, "_fields"):  # NamedTuple
            return type(like)(*vals)
        return type(like)(vals)
    arr = data[prefix[:-1]]
    if isinstance(like, torch.Tensor):
        src = torch.from_numpy(arr)
        spec = _spec(prefix[:-1], shardings)
        if spec:
            from ..runtime.sharding import shard_tensor

            src = shard_tensor(src, spec, shardings.grid)
        with torch.no_grad():
            like.copy_(src.to(like.dtype))
        return like
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def load_pytree(path: str, like: Any, *,
                shardings=None) -> Any:
    """Load ``path`` into the structure of ``like`` (see ``_fill``): a
    sharded ``like`` (or ``shardings``) keeps each rank's block of the
    stored logical arrays."""
    shardings = shardings or tree_shardings(like)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _fill(like, data, "", shardings)


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

    def save(self, step: int, tree: Any, *, meta: Optional[dict] = None,
             shardings=None):
        """Write ``tree`` as step ``step``: copied to host now (a sharded
        tree gathered to its logical arrays: every rank calls it), written
        by rank 0 now or on a background thread."""
        shardings = shardings or tree_shardings(tree)
        host = to_host(tree, shardings)
        if not _writer(shardings):
            return

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

    def restore(self, step: int, like: Any, *,
                shardings=None):
        """Checkpoint ``step`` loaded into ``like``."""
        return load_pytree(self._step_dir(step), like, shardings=shardings)

    def latest_step(self) -> Optional[int]:
        """The newest complete step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None


def restore_latest(directory: str, like: Any, *,
                   shardings=None):
    """Returns (tree, step) from the newest complete checkpoint, or
    (None, None)."""
    mgr = CheckpointManager(directory, async_write=False)
    step = mgr.latest_step()
    if step is None:
        return None, None
    return mgr.restore(step, like, shardings=shardings), step
