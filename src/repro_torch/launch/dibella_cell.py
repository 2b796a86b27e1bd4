"""The paper's own cell (``--arch dibella``): the two distributed matrix
stages of Algorithms 1 and 2 at H. sapiens scale (the paper's Table IV).

  * overlap SpGEMM  C = A·Aᵀ  (position-pair semiring, all-gather SUMMA)
  * transitive reduction of R (min-plus semiring, sampled or full square)

The port's counterpart of ``repro.launch.dibella_cell``.  :func:`build_cells`
returns each stage's program on the rank's local blocks (the
``build_only`` callables of ``core/summa.py``, the counterpart of JAX's
jitted programs) beside its argument specs: ``device="meta"`` tensors of
the rank's block shapes and dtypes, the counterpart of
``jax.ShapeDtypeStruct``.  Torch cannot lower such a program ahead of time,
so the port runs it: :func:`make_inputs` draws the cell's matrices from a
seed on the device, and the dry run (``launch/dryrun.py``) times the
stages.

The inputs, in the global block layout of ``core/summa.py``:

* k-mer incidences: k-mer ``u`` of ``m`` occurs in ``c_u`` reads,
  ``c_u`` uniform in ``[2, kmer_capacity]`` (the reliable-frequency
  window), the consecutive reads ``s_u, s_u + 1, …`` (mod ``n``) from a
  uniform ``s_u`` — reads sorted by genome position share k-mers with their
  neighbours — each at a position uniform in a read of
  :data:`READ_LEN` bp and a uniform strand (value ``2 · pos + strand``);
* A (reads × k-mers) holds them, capped at ``read_capacity`` per (read,
  column block); Aᵀ is the exact transpose of what A kept (at most
  ``kmer_capacity`` a row);
* R (reads × reads) has ``r_block_capacity`` neighbours a row at distinct
  offsets ``±1 … ±r_block_capacity`` drawn at random, forward edges in
  orientation 0 and backward edges in orientation 3, with the min-plus
  suffix ``100 · |offset| + U[0, 50)``, integer-valued f32, capped at
  ``r_block_capacity`` per (row, column block).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.grid import AXES, ProcessGrid
from ..core.semiring import MP, minplus_orient_semiring as MPSR, overlap_semiring
from ..core.spmat import EllMatrix, NO_COL
from ..core.summa import (
    DistEll,
    block_layout,
    dist_transitive_reduction,
    local_block,
    summa_allgather,
)

_I32 = torch.int32
#: read length (bp) the k-mer positions are drawn in
READ_LEN = 1400


def cell_row_axes(axes: Sequence[str]) -> Tuple[str, ...]:
    """The grid-row axes of the cell on a grid with ``axes``: ``("pod",
    "data")`` where both exist, as JAX's cell takes them."""
    return tuple(a for a in ("pod", "data") if a in axes)


def cell_specs(cfg, shape: Sequence[int], axes: Sequence[str] = AXES
               ) -> Dict[str, tuple]:
    """Each stage's argument specs for one rank of a grid of ``shape`` on
    ``axes``: ``device="meta"`` tensors of JAX's global shapes divided by
    the grid (``ka = pc · read_capacity`` slots, ``ku = pc ·
    kmer_capacity``, ``kr = pc · r_block_capacity``, rows over the grid
    rows)."""
    size = dict(zip(axes, shape))
    pr = 1
    for a in cell_row_axes(axes):
        pr *= size[a]
    n, m = cfg.n_reads, cfg.m_kmers
    if n % pr or m % pr:
        raise ValueError(f"{n} reads and {m} k-mers do not divide by "
                         f"{pr} grid rows")

    def meta(*shape, dtype=_I32):
        return torch.empty(shape, dtype=dtype, device="meta")

    ka, ku, kr = cfg.read_capacity, cfg.kmer_capacity, cfg.r_block_capacity
    return {
        "overlap": (meta(n // pr, ka), {"pos": meta(n // pr, ka)},
                    meta(m // pr, ku), {"pos": meta(m // pr, ku)}),
        "tr": (meta(n // pr, kr), meta(n // pr, kr, 4, dtype=torch.float32)),
    }


def tree_bytes(x) -> int:
    """The bytes of the tensors in ``x`` (nested dicts, lists and tuples;
    other leaves count 0): for a stage's specs, JAX's
    ``argument_size_in_bytes``."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(tree_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(tree_bytes(v) for v in x)
    return 0


def build_cells(cfg, grid: ProcessGrid, *, fused_tr: bool = True,
                row_chunk: Optional[int] = 4096):
    """``{"overlap": (fn, specs), "tr": (fn, specs)}`` for this rank of
    ``grid``: ``fn(a_cols, a_vals, at_cols, at_vals)`` gives the rank's
    ``(c_cols, c_vals, overflow)``, ``fn(r_cols, r_vals)`` its ``(s_cols,
    s_vals, iters, nnz)``; every rank calls them together."""
    row_axes = cell_row_axes(grid.axis_names)
    specs = cell_specs(cfg, grid.sizes, grid.axis_names)
    a_cols, a_vals, at_cols, at_vals = specs["overlap"]
    a_d = DistEll(mat=EllMatrix(cols=a_cols, vals=a_vals, n_cols=cfg.m_kmers),
                  grid=grid, row_axes=row_axes)
    at_d = DistEll(mat=EllMatrix(cols=at_cols, vals=at_vals,
                                 n_cols=cfg.n_reads),
                   grid=grid, row_axes=row_axes)
    overlap_fn = summa_allgather(
        a_d, at_d, semiring=overlap_semiring,
        out_block_capacity=cfg.overlap_block_capacity,
        row_chunk=row_chunk, build_only=True)
    r_cols, r_vals = specs["tr"]
    r_d = DistEll(mat=EllMatrix(cols=r_cols, vals={MP: r_vals},
                                n_cols=cfg.n_reads),
                  grid=grid, row_axes=row_axes)
    tr_fn = dist_transitive_reduction(r_d, cfg.tr_fuzz, fused=fused_tr,
                                      row_chunk=row_chunk, build_only=True)
    return {"overlap": (overlap_fn, specs["overlap"]),
            "tr": (tr_fn, specs["tr"])}


def _place(rows, key_cols, blk, cap, n_rows, pc, *fills):
    """ELL arrays ``(n_rows, pc · cap)`` of entries sorted by (row, column):
    entry ``e`` goes to slot ``blk[e] · cap + rank`` of row ``rows[e]``,
    ``rank`` its place among the entries of its (row, block); entries past
    ``cap`` are dropped.  ``fills`` are ``(values, fill value)`` pairs.
    Returns the column array, the value arrays and the kept-entry mask."""
    dev = rows.device
    grp = rows.to(torch.int64) * pc + blk
    first = torch.searchsorted(grp, grp, side="left")
    rank = torch.arange(grp.shape[0], device=dev) - first
    keep = rank < cap
    r, slot = rows[keep].to(torch.int64), (blk * cap + rank)[keep]
    cols = torch.full((n_rows, pc * cap), NO_COL, dtype=_I32, device=dev)
    cols[r, slot] = key_cols[keep].to(_I32)
    outs = []
    for vals, fill in fills:
        out = torch.full((n_rows, pc * cap), fill, dtype=vals.dtype,
                         device=dev)
        out[r, slot] = vals[keep]
        outs.append(out)
    return cols, outs, keep


def make_global_inputs(cfg, pc: int, *, seed: int = 0, device="cuda"):
    """The cell's matrices in the global block layout of a grid with ``pc``
    columns (module docstring), drawn from ``seed`` on ``device``:
    ``{"A": (cols, {"pos"}), "At": (cols, {"pos"}), "R": (cols, vals)}``
    and ``"overflow"``, the R entries past a block's capacity."""
    n, m = cfg.n_reads, cfg.m_kmers
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randint(lo, hi, size):
        return torch.randint(lo, hi, size, generator=gen, device=dev)

    # k-mer incidences: k-mer u in reads s_u .. s_u + c_u - 1 (mod n)
    cnt = randint(2, cfg.kmer_capacity + 1, (m,))
    start = randint(0, n, (m,))
    total = int(cnt.sum())
    kmer = torch.repeat_interleave(torch.arange(m, device=dev), cnt,
                                   output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(total, device=dev) - torch.repeat_interleave(
        first, cnt, output_size=total)
    read = (start[kmer] + off) % n
    pos = (2 * randint(0, READ_LEN, (total,)) + randint(0, 2, (total,))
           ).to(_I32)
    del cnt, start, first, off

    # A: sorted by (read, k-mer), capped per (read, column block)
    order = torch.argsort(read * m + kmer)
    read, kmer, pos = read[order], kmer[order], pos[order]
    a_cols, (a_pos,), keep = _place(read, kmer, kmer // -(-m // pc),
                                    cfg.read_capacity, n, pc, (pos, -1))
    read, kmer, pos = read[keep], kmer[keep], pos[keep]
    # At: the exact transpose of what A kept
    order = torch.argsort(kmer * n + read)
    read, kmer, pos = read[order], kmer[order], pos[order]
    at_cols, (at_pos,), _ = _place(kmer, read, read // -(-n // pc),
                                   cfg.kmer_capacity, m, pc, (pos, -1))
    del read, kmer, pos, order, keep

    # R: r_block_capacity neighbours a row at random offsets ±1..±K
    k = cfg.r_block_capacity
    offsets = torch.cat([torch.arange(-k, 0, device=dev),
                         torch.arange(1, k + 1, device=dev)])
    pick = torch.argsort(torch.rand((n, 2 * k), generator=gen, device=dev),
                         dim=1)[:, :k]
    off = offsets[pick]
    cols = (torch.arange(n, device=dev)[:, None] + off) % n
    cols, idx = torch.sort(cols, dim=1)
    off = torch.gather(off, 1, idx)
    suffix = (100 * off.abs() + randint(0, 50, (n, k))).to(torch.float32)
    vals = torch.full((n, k, 4), float("inf"), device=dev)
    combo = torch.where(off > 0, 0, 3)
    vals.scatter_(2, combo[:, :, None], suffix[:, :, None])
    r, ovf = block_layout(EllMatrix(cols=cols.to(_I32), vals={MP: vals},
                                    n_cols=n),
                          pc=pc, block_capacity=k, semiring=MPSR)
    return {"A": (a_cols, {"pos": a_pos}), "At": (at_cols, {"pos": at_pos}),
            "R": (r.cols, r.vals[MP]), "overflow": int(ovf)}


def local_inputs(glob: dict, grid: ProcessGrid) -> Dict[str, tuple]:
    """This rank's blocks of :func:`make_global_inputs`' matrices, in the
    argument order of :func:`build_cells`' programs."""
    row_axes = cell_row_axes(grid.axis_names)
    pr, i = grid.size(row_axes), grid.axis_index(row_axes)

    def block(cols, vals):
        vals_d = vals if isinstance(vals, dict) else {MP: vals}
        b = local_block(EllMatrix(cols=cols, vals=vals_d, n_cols=0),
                        pr, grid.pc, i, grid.j)
        return b.cols, (b.vals if isinstance(vals, dict) else b.vals[MP])

    return {"overlap": block(*glob["A"]) + block(*glob["At"]),
            "tr": block(*glob["R"])}


def make_inputs(cfg, grid: ProcessGrid, *, seed: int = 0, device="cuda"):
    """This rank's cell inputs on ``grid`` (every rank draws the same
    global matrices from ``seed`` and keeps its blocks)."""
    return local_inputs(make_global_inputs(cfg, grid.pc, seed=seed,
                                           device=device), grid)


def model_ops(cfg, pc: int) -> int:
    """The cell's semiring operations, JAX's dry-run count: one ⊗ per
    candidate k-mer pair of the overlap, and 8 add/min per candidate of
    each of 3 sampled-square passes."""
    return (cfg.n_reads * (pc * cfg.read_capacity) * cfg.kmer_capacity
            + 3 * cfg.n_reads * (pc * cfg.r_block_capacity) ** 2 * 8)
