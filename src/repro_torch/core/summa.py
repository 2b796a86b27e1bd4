"""Distributed 2D sparse SUMMA over semirings (paper §IV-D, §V-B) on a
``torch.distributed`` process grid.

The PyTorch counterpart of ``repro.core.summa``.  JAX shards a global ELL
over a ``("data", "model")`` mesh; here each rank of a
:class:`~.grid.ProcessGrid` holds its own block:

* A distributed matrix (:class:`DistEll`) is CombBLAS's 2D block layout.
  Its grid rows lie on the grid axes ``row_axes`` (``("data",)``, or
  ``("pod", "data")`` with row index ``p · n_data + d``) and its grid
  columns on ``"model"``; a grid axis left out of ``row_axes`` is a replica
  axis, whose ranks hold the same blocks and do the same work.  Row block
  ``i`` of the ``n`` rows lives on grid row ``i``; the capacity axis is
  split into ``pc`` column blocks, and rank ``(i, j)`` holds block
  ``A_ij``: the entries of its rows whose global column id falls in grid
  column ``j``'s range, in ``block_capacity`` slots.  :func:`block_layout`
  is that layout as one global matrix ``(n, pc · block_capacity)``, the
  array JAX shards; :func:`collect` gathers it back on every rank.
* :func:`summa_ring` is the explicit-exchange Cannon ring for square grids:
  a Cannon skew of the blocks (:func:`_skew_a` / :func:`_skew_b` are its
  global view), then ``pc`` stages in batches of ``stages_per_call``, each
  batch one ``spgemm_ring_stages`` op (the CUDA kernel on the card), with a
  ``ppermute`` rotation of both panels between stages.  The stage buffers
  are reordered into canonical k-block order before one final merge, so
  the product equals the local ``spgemm`` bit for bit even under the
  order-dependent overlap ⊕.  Every rotation is counted where it is
  issued: ``exchange_words_summa`` / ``exchange_rounds_summa`` equal
  JAX's trace-time counts and ``bench_comm_model.words_summa``.
  Non-square grids and grid rows on two axes route to
  :func:`summa_allgather`, recorded in stats.
* :func:`dist_transitive_reduction_ring` and
  :func:`dist_transitive_reduction` are Algorithm 2 on the grid, with the
  square N = R² on the ring or on all-gathered panels, the row max reduced
  over the grid row and the prune local (§V-D).
* :func:`overlap_spgemm_shard_map` is the overlap stage's
  ``distribution="shard_map"`` entry point.

Every rank must call these functions in the same order with the same
shapes: each issues the same collectives, whatever its data holds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from .backend import dispatch, resolve_backend
from .grid import ProcessGrid, resolve_grid, resolve_row_axes
from .semiring import INF, MP, Semiring, minplus_orient_semiring as MPSR
from .spgemm import spgemm, spgemm_masked
from .spmat import EllMatrix, NO_COL, from_coo, merge_sorted_rows, prune
from ..obs import schema, span, validated

_I32 = torch.int32
#: ring stages per ``spgemm_ring_stages`` launch (JAX's
#: ``PipelineConfig.summa_stages_per_call`` default)
STAGES_PER_CALL = 4


@dataclasses.dataclass
class DistEll:
    """This rank's block of a 2D-block-distributed ELL matrix (module
    docstring): ``mat`` has the ``n / pr`` rows of grid row ``i`` and the
    ``block_capacity`` slots of grid column ``j``, with global column ids;
    the grid rows lie on the grid axes ``row_axes``."""

    mat: EllMatrix
    grid: ProcessGrid
    row_axes: Tuple[str, ...] = ("data",)

    @property
    def pr(self) -> int:
        """Grid rows: the product of the ``row_axes`` sizes."""
        return self.grid.size(self.row_axes)

    @property
    def pc(self) -> int:
        """Grid columns: the ``"model"`` size."""
        return self.grid.pc

    @property
    def i(self) -> int:
        """This rank's grid row."""
        return self.grid.axis_index(self.row_axes)

    @property
    def block_capacity(self) -> int:
        """Slots per (row, column block)."""
        return self.mat.capacity


def _tree(vals, fn):
    return {k: fn(v) for k, v in vals.items()}


def local_block(mat: EllMatrix, pr: int, pc: int, i: int, j: int
                ) -> EllMatrix:
    """Block ``(i, j)`` of a global block-layout matrix ``(n, pc · bc)``."""
    nb = mat.cols.shape[0] // pr
    bc = mat.cols.shape[1] // pc
    rows, slots = slice(i * nb, (i + 1) * nb), slice(j * bc, (j + 1) * bc)
    return EllMatrix(cols=mat.cols[rows, slots].contiguous(),
                     vals=_tree(mat.vals, lambda v: v[rows, slots].contiguous()),
                     n_cols=mat.n_cols)


def block_layout(mat: EllMatrix, *, pc: int, block_capacity: int,
                 semiring: Semiring) -> Tuple[EllMatrix, torch.Tensor]:
    """The global 2D block layout ``(n, pc · block_capacity)`` of a
    row-sorted host ELL matrix, without re-merging its entries: entry →
    block ``col // ceil(n_cols / pc)``, rank = its same-block predecessors
    in the row, slot ``block · block_capacity + rank``.  ``semiring``
    supplies the zero of empty slots.  Returns ``(matrix, overflow)``, the
    entries beyond ``block_capacity`` in some (row, block).  The rank comes
    from a stable sort by block (JAX counts predecessors pairwise, in
    O(K²) per row): the same slots."""
    n, k = mat.cols.shape
    dev = mat.cols.device
    cb = -(-mat.n_cols // pc)
    valid = mat.cols >= 0
    blk = torch.where(valid, torch.div(mat.cols, cb, rounding_mode="floor"),
                      pc).to(torch.int64)
    order = torch.sort(blk, dim=1, stable=True).indices
    sblk = torch.gather(blk, 1, order).contiguous()
    first = torch.searchsorted(sblk, sblk, side="left")
    ranks_sorted = torch.arange(k, device=dev)[None, :] - first
    rank = torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)
    in_cap = valid & (rank < block_capacity)
    overflow = torch.sum(valid & (rank >= block_capacity)).to(_I32)
    rows = torch.arange(n, device=dev)[:, None].expand(n, k)[in_cap]
    slot = (blk * block_capacity + rank)[in_cap]
    width = pc * block_capacity
    cols = torch.full((n, width), NO_COL, dtype=_I32, device=dev)
    cols[rows, slot] = mat.cols[in_cap]
    vals = semiring.zero((n, width), dev)
    for key, v in mat.vals.items():
        vals[key][rows, slot] = v[in_cap]
    return EllMatrix(cols=cols, vals=vals, n_cols=mat.n_cols), overflow


def _dist(g: EllMatrix, grid: ProcessGrid, row_axes) -> DistEll:
    """This rank's block of the global block layout ``g``."""
    pr, i = grid.size(row_axes), grid.axis_index(row_axes)
    return DistEll(mat=local_block(g, pr, grid.pc, i, grid.j), grid=grid,
                   row_axes=row_axes)


def distribute_ell_blocks(mat: EllMatrix, *, block_capacity: int,
                          semiring: Semiring,
                          mesh: Optional[ProcessGrid] = None,
                          row_axes: Sequence[str] = ("data",)):
    """This rank's :class:`DistEll` block of an already-built (row-sorted)
    ELL matrix that every rank holds (:func:`block_layout`), with its grid
    rows on ``row_axes``.  Returns ``(DistEll, overflow)``; the rows must
    divide by the grid rows."""
    grid = resolve_grid(mesh, "square")
    row_axes = resolve_row_axes(grid, row_axes)
    n, pr = mat.cols.shape[0], grid.size(row_axes)
    if n % pr:
        raise ValueError(f"distribute_ell_blocks: {n} rows not divisible by "
                         f"grid rows {pr}")
    g, overflow = block_layout(mat, pc=grid.pc, block_capacity=block_capacity,
                               semiring=semiring)
    return _dist(g, grid, row_axes), overflow


def distribute_ell(rows, cols, vals, valid, *, n_rows: int, n_cols: int,
                   block_capacity: int, semiring: Semiring,
                   mesh: Optional[ProcessGrid] = None,
                   row_axes: Sequence[str] = ("data",)):
    """This rank's :class:`DistEll` block of a matrix given as COO triplets
    (every rank holds them all), with its grid rows on ``row_axes``;
    duplicates merge with ⊕ in input order.  Returns ``(DistEll,
    overflow)``."""
    grid = resolve_grid(mesh, "square")
    row_axes = resolve_row_axes(grid, row_axes)
    pc = grid.pc
    cb = -(-n_cols // pc)
    blk = torch.where(valid, torch.div(cols, cb, rounding_mode="floor"), 0)
    m2, overflow = from_coo(rows * pc + blk, cols, vals, valid,
                            n_rows=n_rows * pc, n_cols=n_cols,
                            capacity=block_capacity, semiring=semiring)
    width = pc * block_capacity
    g = EllMatrix(cols=m2.cols.reshape(n_rows, width),
                  vals=_tree(m2.vals, lambda v: v.reshape(
                      (n_rows, width) + v.shape[2:])),
                  n_cols=n_cols)
    return _dist(g, grid, row_axes), overflow


def collect(d: DistEll) -> EllMatrix:
    """The global block layout ``(n, pc · block_capacity)`` of ``d``,
    gathered on every rank."""
    grid = d.grid

    def gather(x):
        return grid.all_gather(grid.all_gather(x, "model", dim=1),
                               d.row_axes, dim=0)

    return EllMatrix(cols=gather(d.mat.cols), vals=_tree(d.mat.vals, gather),
                     n_cols=d.mat.n_cols)


# ---------------------------------------------------------------------------
# Cannon skew: the global view and the exchange.
# ---------------------------------------------------------------------------


def _skew_a(mat: EllMatrix, pr: int, pc: int) -> EllMatrix:
    """Cannon pre-skew of A, global view: block ``(i, j)`` ← block
    ``(i, (i + j) mod pc)`` — a per-block-row roll of the slot blocks."""
    n, ktot = mat.cols.shape
    kb, nb = ktot // pc, n // pr
    dev = mat.cols.device
    i_of_row = torch.arange(n, device=dev) // nb
    slot = torch.arange(ktot, device=dev)
    src_j = (i_of_row[:, None] + (slot // kb)[None, :]) % pc
    idx = src_j * kb + (slot % kb)[None, :]

    def take(x):
        ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
            idx.shape + x.shape[2:])
        return torch.gather(x, 1, ix)

    return EllMatrix(cols=take(mat.cols), vals=_tree(mat.vals, take),
                     n_cols=mat.n_cols)


def _skew_b(mat: EllMatrix, pr: int, pc: int) -> EllMatrix:
    """Cannon pre-skew of B, global view: block ``(i, j)`` ← block
    ``((i + j) mod pr, j)`` — a per-block-column roll of the row blocks."""
    n, ktot = mat.cols.shape
    kb, nb = ktot // pc, n // pr
    dev = mat.cols.device
    row = torch.arange(n, device=dev)
    slot = torch.arange(ktot, device=dev)
    src_i = ((row // nb)[:, None] + (slot // kb)[None, :]) % pr
    src_row = src_i * nb + (row % nb)[:, None]

    def take(x):
        return x[src_row, slot[None, :]]

    return EllMatrix(cols=take(mat.cols), vals=_tree(mat.vals, take),
                     n_cols=mat.n_cols)


def _shift(grid: ProcessGrid, x: torch.Tensor, axis: str, by: int):
    """Rank at axis index ``t`` receives the block of index ``(t + by)``."""
    n = grid.shape[axis]
    if by % n == 0:
        return x
    return grid.ppermute(x, axis, [((t + by) % n, t) for t in range(n)])


def _skew_local(a: EllMatrix, b: EllMatrix, grid: ProcessGrid,
                row_axis: str = "data"):
    """The Cannon skew by exchange: rank ``(i, j)`` (``i`` along
    ``row_axis``) receives A block ``(i, (i + j) mod pc)`` along its grid
    row and B block ``((i + j) mod pr, j)`` along its grid column — the
    blocks of :func:`_skew_a` / :func:`_skew_b`."""
    i, j = grid.axis_index(row_axis), grid.j
    ac = _shift(grid, a.cols, "model", i)
    av = _tree(a.vals, lambda v: _shift(grid, v, "model", i))
    bc = _shift(grid, b.cols, row_axis, j)
    bv = _tree(b.vals, lambda v: _shift(grid, v, row_axis, j))
    return ac, av, bc, bv


def _slot_words(vals) -> int:
    """4-byte words per ELL slot: the int32 column id plus every value-leaf
    element behind it (the analytic twin is ``words_summa``'s
    ``*_words_per_slot``)."""
    words = 1
    for leaf in vals.values():
        t = 1
        for d in leaf.shape[2:]:
            t *= d
        words += t
    return words


def _stack(xs):
    return xs[0].unsqueeze(0) if len(xs) == 1 else torch.stack(xs)


# ---------------------------------------------------------------------------
# SUMMA.
# ---------------------------------------------------------------------------


def summa_allgather(a: DistEll, b: DistEll, *, semiring: Semiring,
                    out_block_capacity: int, row_chunk: Optional[int] = None,
                    build_only: bool = False):
    """C = A ⊗ B by the broadcast-all SUMMA: all-gather A along the grid
    row (the rank's full block row) and B along the grid column, over every
    row axis (its full block column), then one local multiply, bounded by
    ``row_chunk`` row blocks (the result does not depend on it).  Returns
    ``(DistEll C, overflow)``.

    ``build_only=True`` returns the rank's program instead, the counterpart
    of JAX's jitted one: ``fn(a_cols, a_vals, b_cols, b_vals)`` on the
    rank's local blocks gives ``(c_cols, c_vals, overflow)``."""
    grid, row_axes = a.grid, a.row_axes
    n_cols_out = b.mat.n_cols

    def fn(a_cols, a_vals, b_cols, b_vals):
        ac = grid.all_gather(a_cols, "model", dim=1)
        av = _tree(a_vals, lambda v: grid.all_gather(v, "model", dim=1))
        bc = grid.all_gather(b_cols, row_axes, dim=0)
        bv = _tree(b_vals, lambda v: grid.all_gather(v, row_axes, dim=0))
        am = EllMatrix(cols=ac, vals=av, n_cols=bc.shape[0])
        bm = EllMatrix(cols=bc, vals=bv, n_cols=n_cols_out)
        c, ovf = spgemm(am, bm, semiring=semiring,
                        capacity=out_block_capacity, row_chunk=row_chunk)
        ovf = grid.psum(ovf.reshape(1), (*row_axes, "model"))[0]
        return c.cols, c.vals, ovf

    if build_only:
        return fn
    cc, cv, ovf = fn(a.mat.cols, a.mat.vals, b.mat.cols, b.mat.vals)
    c = EllMatrix(cols=cc, vals=cv, n_cols=n_cols_out)
    return DistEll(mat=c, grid=grid, row_axes=row_axes), ovf


def summa_ring(a: DistEll, b: DistEll, *, semiring: Semiring,
               out_block_capacity: int, backend: str = "auto",
               stages_per_call: int = STAGES_PER_CALL):
    """Explicit-exchange Cannon ring SUMMA.  Returns ``(DistEll C,
    overflow, stats)``.

    Square grids run the ring: the Cannon skew (:func:`_skew_local`), then
    ``pc`` stages in batches of ``stages_per_call``.  Each batch is one call
    of the dispatched ``spgemm_ring_stages`` op; the rotation feeding the
    next batch is issued before the batch's multiply.  Stage ``s`` on rank
    ``(i, j)`` multiplies k-block ``(i + j + s) mod pc``, an order under
    which the overlap ⊕ (first position pairs kept) is not invariant, so
    the stage buffers are reordered into ascending k-block order and merged
    once: the candidate sequence of the local ``spgemm``.

    Stats: ``exchange_words_summa`` / ``exchange_rounds_summa`` count each
    rotation as it is issued (words per rank, JAX's trace-time accounting;
    the one-time skew is not counted, as in JAX, where it is a reshard of
    the global array).  ``summa_backend`` and ``spgemm_hbm_round_trips``
    name what ran: ``"cuda"`` on CUDA tensors launches the kernel once per
    batch, ``ceil(pc / stages_per_call)``; the plain version (the
    ``reference`` backend, or any backend on CPU tensors) pays one per
    stage.

    Non-square grids and grid rows on two axes cannot form the ring: they
    run :func:`summa_allgather`, recording ``summa_algorithm=
    "allgather_fallback"`` and the reason, with the exchange stats present
    and zero."""
    grid, row_axes = a.grid, a.row_axes
    pr, pc = a.pr, a.pc
    reason = None
    if len(row_axes) != 1:
        reason = f"multi-axis grid rows {row_axes}"
    elif pr != pc:
        reason = f"non-square grid {pr}x{pc}"
    if reason is not None:
        out, ovf = summa_allgather(a, b, semiring=semiring,
                                   out_block_capacity=out_block_capacity)
        return out, ovf, validated({
            "summa_algorithm": "allgather_fallback",
            "summa_fallback_reason": reason,
            **schema.zero_defaults("summa_exchange"),
        }, context="summa_allgather_fallback",
            require_groups=("summa_exchange",))

    dev = a.mat.cols.device
    n_cols_out = b.mat.n_cols
    n_loc, ka = a.mat.cols.shape
    nb_b, kb = b.mat.cols.shape  # B block rows == A panel's rebased id range
    wa_rot = n_loc * ka * _slot_words(a.mat.vals)
    wb_rot = nb_b * kb * _slot_words(b.mat.vals)
    resolved = resolve_backend(backend, dev)
    op = dispatch("spgemm_ring_stages", resolved, dev)
    g = max(1, min(stages_per_call, pc))
    (row_axis,) = row_axes
    i, j = a.i, grid.j
    left = [((t + 1) % pc, t) for t in range(pc)]  # rotate left / up
    acct = {"words": 0, "rounds": 0}

    def rotate(ac, av, bc, bv):
        acct["words"] += wa_rot + wb_rot
        acct["rounds"] += 1
        return (grid.ppermute(ac, "model", left),
                _tree(av, lambda v: grid.ppermute(v, "model", left)),
                grid.ppermute(bc, row_axis, left),
                _tree(bv, lambda v: grid.ppermute(v, row_axis, left)))

    with span("SpGEMM", kind="phase", phase="skew"):
        cur = _skew_local(a.mat, b.mat, grid, row_axis)
    with span("SpGEMM", kind="phase", phase="ring", pc=pc,
              stages_per_call=g) as sp:
        chunks_cols, chunks_vals = [], []
        ovf = torch.zeros((), dtype=_I32, device=dev)
        s = 0
        while s < pc:
            sc = min(g, pc - s)
            with span("SpGEMM", kind="phase", phase="ring_stage", s=s,
                      stages=sc):
                panels = [cur]
                for _ in range(sc - 1):
                    cur = rotate(*cur)
                    panels.append(cur)
                st_a_cols = _stack([p[0] for p in panels])
                st_a_vals = {k: _stack([p[1][k] for p in panels])
                             for k in cur[1]}
                st_b_cols = _stack([p[2] for p in panels])
                st_b_vals = {k: _stack([p[3][k] for p in panels])
                             for k in cur[3]}
                offsets = (((i + j + s + torch.arange(sc, device=dev)) % pc)
                           * nb_b).to(_I32)
                if s + sc < pc:
                    cur = rotate(*cur)  # feeds the next batch
                cc, cv, so = op(offsets, st_a_cols, st_a_vals, st_b_cols,
                                st_b_vals, semiring=semiring,
                                capacity=out_block_capacity,
                                n_cols_out=n_cols_out)
            chunks_cols.append(cc)
            chunks_vals.append(cv)
            ovf = ovf + so
            s += sc
        st_cols = torch.cat(chunks_cols, dim=0)  # (pc, n_loc, cap)
        st_vals = {k: torch.cat([c[k] for c in chunks_vals], dim=0)
                   for k in chunks_vals[0]}
        # canonical reorder: buffer q ← the stage that produced k-block q
        order = (torch.arange(pc, device=dev) - (i + j)) % pc
        width = pc * out_block_capacity
        merged_cols = st_cols[order].transpose(0, 1).reshape(n_loc, width)
        merged_vals = _tree(st_vals, lambda v: v[order].transpose(0, 1)
                            .reshape((n_loc, width) + v.shape[3:]))
        with span("SpGEMM", kind="phase", phase="stage_merge"):
            mc, mv, mo = merge_sorted_rows(merged_cols, merged_vals,
                                           capacity=out_block_capacity,
                                           semiring=semiring)
        ovf = grid.psum((ovf + mo).reshape(1), (row_axis, "model"))[0]
        sp.set_output((mc, ovf))
    fused = resolved == "cuda" and dev.type == "cuda"  # the kernel ran
    stats = validated({
        "summa_algorithm": "ring",
        "summa_stages": pc,
        "summa_backend": "cuda" if fused else "reference",
        "exchange_words_summa": acct["words"],
        "exchange_rounds_summa": acct["rounds"],
        "spgemm_hbm_round_trips": -(-pc // g) if fused else pc,
        "spgemm_hbm_round_trips_reference": pc,
    }, context="summa_ring", require_groups=("summa_exchange",))
    c = EllMatrix(cols=mc, vals=mv, n_cols=n_cols_out)
    return DistEll(mat=c, grid=grid, row_axes=row_axes), ovf, stats


def _pad_rows(mat: EllMatrix, mult: int, semiring: Semiring) -> EllMatrix:
    """``mat`` with empty rows appended up to a multiple of ``mult``."""
    n, k = mat.cols.shape
    pad = -(-n // mult) * mult - n
    if pad == 0:
        return mat
    dev = mat.cols.device
    zero = semiring.zero((pad, k), dev)
    return EllMatrix(
        cols=torch.cat([mat.cols, torch.full((pad, k), NO_COL, dtype=_I32,
                                             device=dev)]),
        vals={key: torch.cat([v, zero[key]]) for key, v in mat.vals.items()},
        n_cols=mat.n_cols)


def overlap_spgemm_shard_map(a: EllMatrix, b: EllMatrix, *,
                             semiring: Semiring, operand_semiring: Semiring,
                             capacity: int,
                             mesh: Optional[ProcessGrid] = None,
                             row_axes: Optional[Sequence[str]] = None,
                             backend: str = "auto",
                             stages_per_call: int = STAGES_PER_CALL):
    """Distributed C = A ⊗ B for operands every rank holds — the overlap
    stage's ``distribution="shard_map"`` path.  The grid rows lie on
    ``row_axes`` (default: the grid's ``("pod", "data")`` axes, JAX's
    ``infer_row_axes``; on two axes the ring takes the recorded
    fallback).

    Pads both operands' rows to a multiple of the grid rows, distributes
    them at their full source capacities (so distribution never
    overflows), runs :func:`summa_ring`, then collects and re-merges the
    blocks into ``capacity`` slots per row.  Equal to ``spgemm(a, b,
    capacity=capacity)``, values and overflow, whenever no single column
    block contributes more than ``capacity`` entries to one output row.
    ``operand_semiring`` supplies the operands' empty-slot zero.  Returns
    ``(EllMatrix, overflow, stats)`` on every rank."""
    grid = resolve_grid(mesh, "square")
    row_axes = resolve_row_axes(grid, row_axes)
    pr = grid.size(row_axes)
    n_rows = a.cols.shape[0]
    a_pad = _pad_rows(a, pr, operand_semiring)
    b_pad = _pad_rows(b, pr, operand_semiring)
    with span("SpGEMM", kind="phase", phase="distribute") as sp:
        da, ovf_da = distribute_ell_blocks(
            a_pad, block_capacity=a.capacity, semiring=operand_semiring,
            mesh=grid, row_axes=row_axes)
        db, ovf_db = distribute_ell_blocks(
            b_pad, block_capacity=b.capacity, semiring=operand_semiring,
            mesh=grid, row_axes=row_axes)
        sp.set_output((da.mat.cols, db.mat.cols))
    cd, ovf_ring, stats = summa_ring(da, db, semiring=semiring,
                                     out_block_capacity=capacity,
                                     backend=backend,
                                     stages_per_call=stages_per_call)
    with span("SpGEMM", kind="phase", phase="collect_merge"):
        g = collect(cd)
        mc, mv, mo = merge_sorted_rows(g.cols, g.vals, capacity=capacity,
                                       semiring=semiring)
    out = EllMatrix(cols=mc[:n_rows], vals=_tree(mv, lambda v: v[:n_rows]),
                    n_cols=b.n_cols)
    return out, ovf_da + ovf_db + ovf_ring + mo, stats


# ---------------------------------------------------------------------------
# Distributed transitive reduction (Algorithm 2 on the grid).
# ---------------------------------------------------------------------------


def _nnz(d: DistEll, cols: torch.Tensor) -> int:
    """The global nnz of the blocks ``cols`` laid out as ``d``'s."""
    local = torch.sum(cols >= 0).to(_I32).reshape(1)
    return int(d.grid.psum(local, (*d.row_axes, "model"))[0])


def _prune_step(grid: ProcessGrid, r: EllMatrix, got: torch.Tensor,
                found: torch.Tensor, fuzz: torch.Tensor) -> EllMatrix:
    """Lines 5–9 of Algorithm 2 on the rank's block, local per §V-D: the
    fuzzed row max (a ``pmax`` over the grid row), the transitive combos
    ``N ≤ max`` and the prune of R ∘ ¬I."""
    v = r.vals[MP]
    vals_m = torch.where(torch.isfinite(v), v, -INF)
    vals_m = torch.where((r.cols >= 0)[:, :, None], vals_m, -INF)
    row_max = grid.pmax(torch.amax(vals_m, dim=(1, 2)), "model") + fuzz
    trans = ((got <= row_max[:, None, None]) & torch.isfinite(got)
             & found[:, :, None] & torch.isfinite(v))
    new_vals = torch.where(trans, INF, v)
    dead = ~torch.any(torch.isfinite(new_vals), dim=-1) & (r.cols >= 0)
    return prune(EllMatrix(cols=r.cols, vals={MP: new_vals}, n_cols=r.n_cols),
                 dead, MPSR)


def dist_transitive_reduction_ring(r: DistEll, fuzz: float = 200.0, *,
                                   n_block_capacity: Optional[int] = None,
                                   max_iters: int = 10,
                                   backend: str = "auto"):
    """Distributed Algorithm 2 with the N = R² square on the explicit
    exchange ring.  Returns ``(DistEll, iters, nnz, stats)``.

    Each pass is one :func:`summa_ring` (min-plus orientation semiring,
    ``n_block_capacity`` slots per N block, default ``min(K², 4K)``)
    followed by the local prune step; the loop ends when the global nnz
    stops changing.  Stats accumulate the rings' exchange words and
    rounds."""
    grid = r.grid
    kb = r.block_capacity
    if n_block_capacity is None:
        n_block_capacity = min(kb * kb, 4 * kb)
    fuzz_t = torch.tensor(fuzz, dtype=torch.float32, device=r.mat.cols.device)
    cur = r
    nnz_cur = _nnz(r, r.mat.cols)
    prev, it = -1, 0
    stats: Dict = {**schema.zero_defaults("summa_exchange"),
                   "summa_algorithm": None}
    while nnz_cur != prev and it < max_iters:
        n_sq, _, st = summa_ring(cur, cur, semiring=MPSR,
                                 out_block_capacity=n_block_capacity,
                                 backend=backend)
        got, found = n_sq.mat.lookup(MPSR, cur.mat.cols)
        pruned = _prune_step(grid, cur.mat, got[MP], found, fuzz_t)
        cur = DistEll(mat=pruned, grid=grid, row_axes=r.row_axes)
        stats["exchange_words_summa"] += st["exchange_words_summa"]
        stats["exchange_rounds_summa"] += st["exchange_rounds_summa"]
        stats["summa_algorithm"] = st["summa_algorithm"]
        prev, nnz_cur, it = nnz_cur, _nnz(r, pruned.cols), it + 1
    return cur, it, nnz_cur, stats


def dist_transitive_reduction(r: DistEll, fuzz: float = 200.0, *,
                              n_block_capacity: Optional[int] = None,
                              max_iters: int = 10, fused: bool = False,
                              row_chunk: Optional[int] = None,
                              build_only: bool = False,
                              summa: str = "allgather"):
    """Distributed Algorithm 2.  Returns ``(DistEll, iters, nnz)``.

    ``summa="allgather"`` squares on all-gathered panels each pass (the
    rank's full block row of R times its full block column, over every row
    axis); ``fused=True`` takes the sampled square N ∘ pattern(R)
    (``spgemm_masked``: no pattern growth, no stage sort).  ``row_chunk``
    bounds the local multiply by row blocks; the result does not depend on
    it.  ``build_only=True`` returns the rank's program instead, the
    counterpart of JAX's jitted one: ``fn(r_cols, r_vals)`` on the rank's
    block (``r_vals`` the ``(rows, slots, 4)`` min-plus values) gives
    ``(s_cols, s_vals, iters, nnz)``.  ``summa="ring"`` runs
    :func:`dist_transitive_reduction_ring` and takes none of ``fused``,
    ``row_chunk`` and ``build_only``."""
    if summa not in ("allgather", "ring"):
        raise ValueError(f"unknown summa variant {summa!r}")
    if summa == "ring":
        if fused or build_only or row_chunk is not None:
            raise ValueError("summa='ring' supports neither fused nor "
                             "row_chunk nor build_only")
        out, iters, nnz, _ = dist_transitive_reduction_ring(
            r, fuzz, n_block_capacity=n_block_capacity, max_iters=max_iters)
        return out, iters, nnz
    grid, row_axes = r.grid, r.row_axes
    kb = r.block_capacity
    if n_block_capacity is None:
        n_block_capacity = min(kb * kb, 4 * kb)
    n_total = r.mat.n_cols

    def fn(r_cols, r_vals):
        fuzz_t = torch.tensor(fuzz, dtype=torch.float32, device=r_cols.device)
        cur = EllMatrix(cols=r_cols, vals={MP: r_vals}, n_cols=n_total)
        nnz_cur = _nnz(r, cur.cols)
        prev, it = -1, 0
        while nnz_cur != prev and it < max_iters:
            ac = grid.all_gather(cur.cols, "model", dim=1)
            av = grid.all_gather(cur.vals[MP], "model", dim=1)
            bc = grid.all_gather(cur.cols, row_axes, dim=0)
            bv = grid.all_gather(cur.vals[MP], row_axes, dim=0)
            a_loc = EllMatrix(cols=ac, vals={MP: av}, n_cols=n_total)
            b_loc = EllMatrix(cols=bc, vals={MP: bv}, n_cols=n_total)
            if fused:
                got = spgemm_masked(a_loc, b_loc, cur, semiring=MPSR,
                                    row_chunk=row_chunk).vals
                found = cur.mask
            else:
                n_loc, _ = spgemm(a_loc, b_loc, semiring=MPSR,
                                  capacity=n_block_capacity,
                                  row_chunk=row_chunk)
                got, found = n_loc.lookup(MPSR, cur.cols)
            cur = _prune_step(grid, cur, got[MP], found, fuzz_t)
            prev, nnz_cur, it = nnz_cur, _nnz(r, cur.cols), it + 1
        return cur.cols, cur.vals[MP], it, nnz_cur

    if build_only:
        return fn
    cols, vals, it, nnz = fn(r.mat.cols, r.mat.vals[MP])
    out = EllMatrix(cols=cols, vals={MP: vals}, n_cols=n_total)
    return DistEll(mat=out, grid=grid, row_axes=row_axes), it, nnz
