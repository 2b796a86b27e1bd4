"""The process grid of the port's explicit-exchange stages.

The JAX package runs one SPMD program over a ``Mesh`` of devices in one
process; its ``shard_map`` bodies talk through ``ppermute``, ``psum``,
``pmax`` and ``all_gather`` over named mesh axes.  The port runs one
process per rank instead (``torch.distributed``), every rank calling the
same entry point on the same replicated inputs.  :class:`ProcessGrid` is
the counterpart of a ``("data", "model")`` or ``("pod", "data", "model")``
mesh over the default process group, and its methods are the counterparts
of those collectives:

* rank ``r`` sits at the coordinates that unravel ``r`` over the axis
  sizes, major to minor: ``(i, j) = divmod(r, pc)`` on a 2D grid,
  ``(p, d, j)`` on a 3D one.  ``"model"`` is always the column axis (index
  ``j``, size ``pc``); the other axes carry the grid rows.  A collective
  over an axis runs among the ranks that differ only on that axis, as in
  ``shard_map``;
* every collective takes one axis name or a tuple of names, as
  ``lax.psum(x, ("pod", "data"))`` does.  Over a tuple the axis index is
  the linear index over those axes in the order given, major to minor:
  ``p · n_data + d`` on ``("pod", "data")``, JAX's order for a tuple axis;
* :meth:`ppermute` takes JAX's ``(source, destination)`` pairs of axis
  indices: ``[((t + 1) % n, t)]`` means index ``t + 1`` sends to ``t``.
  Send and receive are posted together (``batch_isend_irecv``); a rank that
  receives nothing gets zeros, as under ``lax.ppermute``;
* :meth:`psum` / :meth:`pmax` are ``all_reduce`` SUM / MAX over the axis
  subgroup (bool is reduced as int32: gloo reduces no bool);
* :meth:`all_gather` is the tiled all-gather (list-form ``all_gather`` and
  ``torch.cat``, the parts in axis-index order).

The subgroup of an axis set is built the first time a collective over that
set is issued: every rank issues the same collectives in the same order, so
every rank builds the same subgroups in the same order.  Axes of size 1
never issue a collective, on any grid.  Without an initialised process
group the grid is 1×1 over the calling process — JAX's one-device mesh.

Each grid counts the bytes of the collectives it issues, by op
(:attr:`ProcessGrid.collective_bytes`): the gathered buffer of an
``all_gather``, the reduced buffer of an ``all_reduce`` and the sent buffer
of a ``permute`` — the conventions of JAX's ``launch/hlo_analysis.py``.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
#: the axis names a grid may have; "model" is the column axis of both
GRID_AXES = (AXES, POD_AXES)
#: the collectives a grid counts bytes for
COLLECTIVE_OPS = ("all_gather", "all_reduce", "permute")

Axes = Union[str, Sequence[str]]


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
    """A grid over the default process group (see the module docstring):
    ``ProcessGrid(pr, pc)`` on ``("data", "model")``, or
    ``ProcessGrid(n_pod, n_data, pc, axis_names=POD_AXES)``.  The product
    of the sizes must equal the world size.  :attr:`row_axes` are the axes
    before ``"model"``; :attr:`pr` / :attr:`i` are the grid rows over all
    of them (JAX's ``infer_row_axes``), :attr:`pc` / :attr:`j` the grid
    columns."""

    def __init__(self, *sizes: int, axis_names: Sequence[str] = AXES):
        axes = tuple(axis_names)
        self.axis_names, self.sizes = axes, tuple(int(s) for s in sizes)
        if axes not in GRID_AXES:
            raise ValueError(f"grid axes {axes}: a grid has the axes "
                             f"{AXES} or {POD_AXES}")
        if len(sizes) != len(axes):
            raise ValueError(f"{len(sizes)} sizes for the axes {axes}")
        rank, world = _world()
        total = math.prod(int(s) for s in sizes)
        if min(sizes) < 1 or total != world:
            shape = "x".join(str(s) for s in sizes)
            raise ValueError(f"a {shape} grid needs {total} ranks; the "
                             f"process group has {world}")
        self.rank = rank
        self.coords = _unravel(rank, self.sizes)
        self.row_axes = axes[:-1]
        self.pr, self.pc = self.size(self.row_axes), self.sizes[-1]
        self.i, self.j = self.axis_index(self.row_axes), self.coords[-1]
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.collective_bytes: Dict[str, int] = dict.fromkeys(COLLECTIVE_OPS, 0)

    # --- constructors -----------------------------------------------------

    @classmethod
    def square(cls) -> "ProcessGrid":
        """The 2D grid over every rank, ``pr`` the largest divisor of P that
        is ``≤ √P`` — the counterpart of JAX's ``default_summa_mesh``.
        Square whenever P is a perfect square (the ring SUMMA's shape);
        otherwise the ring routes to the recorded all-gather fallback."""
        return _cached(square_shape(_world()[1]), AXES)

    @classmethod
    def rows(cls) -> "ProcessGrid":
        """The P×1 grid (every rank a grid row) — the counterpart of JAX's
        ``default_row_mesh``."""
        return _cached((_world()[1], 1), AXES)

    @classmethod
    def of_shape(cls, shape: Sequence[int],
                 axes: Sequence[str] = AXES) -> "ProcessGrid":
        """The grid of ``shape`` on ``axes``, one per (shape, axes) and
        process group (building a grid is cheap; its subgroups are not)."""
        return _cached(tuple(int(s) for s in shape), tuple(axes))

    # --- mesh view ----------------------------------------------------------

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"grid axis {a!r} is not one of "
                                 f"{self.axis_names}")
        return axes

    def size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (a product over a tuple)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (``lax.axis_index``; over a
        tuple, the linear index major to minor)."""
        idx = 0
        for a in self._axes(axes):
            k = self.axis_names.index(a)
            idx = idx * self.sizes[k] + self.coords[k]
        return idx

    def members(self, axes: Axes) -> List[int]:
        """The global ranks of this rank's group along ``axes``, by axis
        index: rank ``members(axes)[t]`` has index ``t``."""
        return self._members_at(self.coords, self._axes(axes))

    def _members_at(self, coords: Sequence[int], axes: Sequence[str]
                    ) -> List[int]:
        """The global ranks through ``coords`` along ``axes``, by axis
        index."""
        ks = [self.axis_names.index(a) for a in axes]
        out = []
        for idx in itertools.product(*(range(self.sizes[k]) for k in ks)):
            c = list(coords)
            for k, v in zip(ks, idx):
                c[k] = v
            out.append(_ravel(c, self.sizes))
        return out

    def __repr__(self) -> str:
        shape = "x".join(str(s) for s in self.sizes)
        return (f"ProcessGrid({shape} on {self.axis_names}, rank {self.rank} "
                f"at {self.coords})")

    # --- collectives ------------------------------------------------------

    def _group(self, axes: Tuple[str, ...]):
        """The subgroup handle of ``axes`` (``None`` = the default group),
        built for every group of the set the first time it is asked for."""
        live = tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)
        if live == tuple(a for a in self.axis_names if self.shape[a] > 1):
            return None
        if live not in self._groups:
            others = [k for k, a in enumerate(self.axis_names)
                      if a not in live]
            for fixed in itertools.product(*(range(self.sizes[k])
                                             for k in others)):
                coords = [0] * len(self.sizes)
                for k, c in zip(others, fixed):
                    coords[k] = c
                ranks = self._members_at(coords, live)
                handle = dist.new_group(sorted(ranks))
                if self.rank in ranks:
                    self._groups[live] = handle
        return self._groups[live]

    def reset_collective_bytes(self) -> Dict[str, int]:
        """The byte counts so far, and set them to 0."""
        out = dict(self.collective_bytes)
        self.collective_bytes = dict.fromkeys(COLLECTIVE_OPS, 0)
        return out

    def ppermute(self, x: torch.Tensor, axes: Axes,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute`` over ``axes``: ``perm`` holds ``(source,
        destination)`` pairs of axis indices.  Returns what this rank
        receives (zeros if it receives nothing)."""
        axes = self._axes(axes)
        if self.size(axes) == 1:
            return x
        me = self.axis_index(axes)
        members = self.members(axes)
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
            self.collective_bytes["permute"] += _nbytes(wire)
        if src:
            ops.append(dist.P2POp(dist.irecv, recv, members[src[0]]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return _unwire(recv, x.dtype) if src else out

    def _all_reduce(self, x: torch.Tensor, axes: Axes, op) -> torch.Tensor:
        axes = self._axes(axes)
        if self.size(axes) == 1:
            return x
        dtype = x.dtype
        buf = (x.to(torch.int32) if dtype == torch.bool else x).clone()
        dist.all_reduce(buf, op=op, group=self._group(axes))
        self.collective_bytes["all_reduce"] += _nbytes(buf)
        return buf.to(dtype) if dtype == torch.bool else buf

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``lax.psum`` over one axis or a tuple of axes."""
        return self._all_reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``lax.pmax`` over one axis or a tuple of axes."""
        return self._all_reduce(x, axes, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = 0
                   ) -> torch.Tensor:
        """Tiled ``lax.all_gather`` over ``axes``: the shards of ``x``
        concatenated along ``dim`` in axis-index order."""
        axes = self._axes(axes)
        n = self.size(axes)
        if n == 1:
            return x
        x = x.contiguous()
        wire = _wire(x)
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=self._group(axes))
        self.collective_bytes["all_gather"] += n * _nbytes(wire)
        # the group's parts come in global-rank order; put them in axis order
        by_rank = sorted(self.members(axes))
        where = {r: q for q, r in enumerate(by_rank)}
        return torch.cat([_unwire(parts[where[r]], x.dtype)
                          for r in self.members(axes)], dim=dim)


def _unravel(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for s in reversed(sizes):
        rank, c = divmod(rank, s)
        coords.append(c)
    return tuple(reversed(coords))


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a dtype every backend sends (bool travels as uint8)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x


# one grid per (shape, axes) and default group: building a grid's subgroups
# is a collective call that every rank makes in the same order
_CACHE: Dict[Tuple[Tuple[int, ...], Tuple[str, ...]],
             Tuple[object, ProcessGrid]] = {}


def _cached(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> ProcessGrid:
    world = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             else None)
    hit = _CACHE.get((shape, axes))
    if hit is not None and hit[0] is world:
        return hit[1]
    grid = ProcessGrid(*shape, axis_names=axes)
    _CACHE[(shape, axes)] = (world, grid)
    return grid


def resolve_grid(mesh: Optional[ProcessGrid], default: str) -> ProcessGrid:
    """``mesh`` if given (it must be a :class:`ProcessGrid`), else the
    ``default`` grid (``"square"`` or ``"rows"``)."""
    if mesh is None:
        return ProcessGrid.square() if default == "square" else ProcessGrid.rows()
    if not isinstance(mesh, ProcessGrid):
        raise NotImplementedError(
            f"mesh must be a repro_torch.core.grid.ProcessGrid, got "
            f"{type(mesh).__name__}: a ProcessGrid over torch.distributed "
            f"ranks is the port's counterpart of a JAX device mesh "
            f"(ROADMAP.md queue 1, item 11)")
    return mesh


def resolve_row_axes(grid: ProcessGrid,
                     row_axes: Optional[Sequence[str]]) -> Tuple[str, ...]:
    """``row_axes`` checked against ``grid`` (axes before ``"model"``, in
    grid order), or, when ``None``, all of the grid's ``("pod", "data")``
    axes (JAX's ``infer_row_axes``).  Row axes left out are replica axes:
    their ranks hold the same blocks and do the same work."""
    if row_axes is None:
        return grid.row_axes
    row_axes = tuple(row_axes)
    if (not row_axes or any(a not in grid.row_axes for a in row_axes)
            or list(row_axes) != [a for a in grid.row_axes if a in row_axes]):
        raise ValueError(f"row_axes {row_axes}: grid rows take axes of "
                         f"{grid.row_axes}, in that order")
    return row_axes
