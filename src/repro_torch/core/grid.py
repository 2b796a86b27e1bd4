"""The process grid of the port's explicit-exchange stages.

The JAX package runs one SPMD program over a ``Mesh`` of devices in one
process; its ``shard_map`` bodies talk through ``ppermute``, ``psum``,
``pmax`` and ``all_gather`` over named mesh axes.  The port runs one
process per rank instead (``torch.distributed``), every rank calling the
same entry point on the same replicated inputs.  :class:`ProcessGrid` is
the counterpart of a 2D ``("data", "model")`` mesh over the default process
group, and its methods are the counterparts of those collectives:

* rank ``r`` sits at grid position ``(i, j) = divmod(r, pc)``; axis
  ``"data"`` indexes the grid rows (``i``, size ``pr``) and axis ``"model"``
  the grid columns (``j``, size ``pc``).  A collective over ``"data"`` runs
  among the ranks of one grid column (same ``j``), one over ``"model"``
  among the ranks of one grid row (same ``i``), as in ``shard_map``;
* :meth:`ppermute` takes JAX's ``(source, destination)`` pairs of axis
  indices: ``[((t + 1) % n, t)]`` means index ``t + 1`` sends to ``t``.
  Send and receive are posted together (``batch_isend_irecv``); a rank that
  receives nothing gets zeros, as under ``lax.ppermute``;
* :meth:`psum` / :meth:`pmax` are ``all_reduce`` SUM / MAX over the axis
  subgroups (bool is reduced as int32: gloo reduces no bool);
* :meth:`all_gather` is the tiled all-gather (list-form ``all_gather`` and
  ``torch.cat``).

Without an initialised process group the grid is 1×1 over the calling
process — JAX's one-device mesh: every axis has size 1, ``ppermute`` and
``all_gather`` return their input and every reduction is the identity.
Axes of size 1 never issue a collective, on any grid.

Multi-row-axis grids (JAX's ``("pod", "data", "model")`` meshes) are not
ported: asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
_POD_TODO = ("multi-row-axis ('pod', 'data') grids are not ported yet "
             "(ROADMAP.md queue 1, item 11b)")


def _world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default group; ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def square_shape(p: int) -> Tuple[int, int]:
    """``(pr, pc)`` with ``pr`` the largest divisor of ``p`` that is
    ``≤ √p`` (4 → 2×2, 8 → 2×4, 9 → 3×3, 2 → 1×2) — the shape of JAX's
    ``default_summa_mesh``."""
    pr = max(1, math.isqrt(p))
    while p % pr:
        pr -= 1
    return pr, p // pr


class ProcessGrid:
    """A ``(pr, pc)`` grid over the default process group (see the module
    docstring).  ``pr · pc`` must equal the world size.  The row and column
    subgroups are built once, here, in the same order on every rank, so
    every rank must construct the same grids in the same order."""

    def __init__(self, pr: int, pc: int,
                 axis_names: Sequence[str] = AXES):
        if tuple(axis_names) != AXES:
            raise NotImplementedError(
                f"grid axes {tuple(axis_names)}: only {AXES} grids are "
                f"ported; {_POD_TODO}")
        rank, world = _world()
        if pr < 1 or pc < 1 or pr * pc != world:
            raise ValueError(f"a {pr}x{pc} grid needs {pr * pc} ranks; the "
                             f"process group has {world}")
        self.pr, self.pc = int(pr), int(pc)
        self.rank = rank
        self.i, self.j = divmod(rank, self.pc)
        # the global ranks of each axis group this rank belongs to, and the
        # subgroup handles (None = the default group)
        self._members: Dict[str, List[int]] = {
            "data": [t * self.pc + self.j for t in range(self.pr)],
            "model": [self.i * self.pc + t for t in range(self.pc)],
        }
        self._groups: Dict[str, object] = {}
        for axis, size, other in (("data", self.pr, self.pc),
                                  ("model", self.pc, self.pr)):
            if size == 1 or other == 1:
                continue  # size 1: no collective; other == 1: the world
            for g in range(other):
                ranks = ([t * self.pc + g for t in range(self.pr)]
                         if axis == "data"
                         else [g * self.pc + t for t in range(self.pc)])
                handle = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[axis] = handle

    # --- constructors -----------------------------------------------------

    @classmethod
    def square(cls) -> "ProcessGrid":
        """The 2D grid over every rank, ``pr`` the largest divisor of P that
        is ``≤ √P`` — the counterpart of JAX's ``default_summa_mesh``.
        Square whenever P is a perfect square (the ring SUMMA's shape);
        otherwise the ring routes to the recorded all-gather fallback."""
        return _cached(*square_shape(_world()[1]))

    @classmethod
    def rows(cls) -> "ProcessGrid":
        """The P×1 grid (every rank a grid row) — the counterpart of JAX's
        ``default_row_mesh``."""
        return _cached(_world()[1], 1)

    # --- mesh view ----------------------------------------------------------

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {"data": self.pr, "model": self.pc}

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return {"data": self.i, "model": self.j}[_check_axis(axis)]

    def __repr__(self) -> str:
        return (f"ProcessGrid({self.pr}x{self.pc}, rank {self.rank} at "
                f"({self.i}, {self.j}))")

    # --- collectives ------------------------------------------------------

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            _check_axis(a)
        return tuple(a for a in axes if self.shape[a] > 1)

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute`` over ``axis``: ``perm`` holds ``(source,
        destination)`` pairs of axis indices.  Returns what this rank
        receives (zeros if it receives nothing)."""
        if self.shape[_check_axis(axis)] == 1:
            return x
        me = self.axis_index(axis)
        members = self._members[axis]
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        x = x.contiguous()
        out = torch.zeros_like(x)
        if dst and dst[0] == me and src and src[0] == me:
            return x.clone()
        wire = _wire(x)
        recv = _wire(out)
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, wire, members[dst[0]]))
        if src:
            ops.append(dist.P2POp(dist.irecv, recv, members[src[0]]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return _unwire(recv, x.dtype) if src else out

    def _all_reduce(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        axes = self._axes(axes)
        if not axes:
            return x
        dtype = x.dtype
        buf = (x.to(torch.int32) if dtype == torch.bool else x).clone()
        if len(axes) == 2:
            dist.all_reduce(buf, op=op)
        else:
            dist.all_reduce(buf, op=op, group=self._groups.get(axes[0]))
        return buf.to(dtype) if dtype == torch.bool else buf

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``lax.psum`` over one axis or a tuple of axes."""
        return self._all_reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``lax.pmax`` over one axis or a tuple of axes."""
        return self._all_reduce(x, axes, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """Tiled ``lax.all_gather`` over ``axis``: the axis' shards of ``x``
        concatenated along ``dim`` in axis-index order."""
        n = self.shape[_check_axis(axis)]
        if n == 1:
            return x
        x = x.contiguous()
        wire = _wire(x)
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=self._groups.get(axis))
        return torch.cat([_unwire(p, x.dtype) for p in parts], dim=dim)


def _check_axis(axis: str) -> str:
    if axis not in AXES:
        raise NotImplementedError(f"grid axis {axis!r}: {_POD_TODO}")
    return axis


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a dtype every backend sends (bool travels as uint8)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x


# one grid per (pr, pc) and default group: building a grid creates process
# subgroups, a collective call that every rank makes in the same order
_CACHE: Dict[Tuple[int, int], Tuple[object, ProcessGrid]] = {}


def _cached(pr: int, pc: int) -> ProcessGrid:
    world = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             else None)
    hit = _CACHE.get((pr, pc))
    if hit is not None and hit[0] is world:
        return hit[1]
    grid = ProcessGrid(pr, pc)
    _CACHE[(pr, pc)] = (world, grid)
    return grid


def resolve_grid(mesh: Optional[ProcessGrid], default: str) -> ProcessGrid:
    """``mesh`` if given (it must be a :class:`ProcessGrid`), else the
    ``default`` grid (``"square"`` or ``"rows"``)."""
    if mesh is None:
        return ProcessGrid.square() if default == "square" else ProcessGrid.rows()
    if not isinstance(mesh, ProcessGrid):
        raise NotImplementedError(
            f"mesh must be a repro_torch.core.grid.ProcessGrid, got "
            f"{type(mesh).__name__}; device meshes and {_POD_TODO}")
    return mesh
