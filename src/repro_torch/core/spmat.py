"""Static-capacity sparse matrices in ELL layout, on torch tensors.

The PyTorch counterpart of ``repro.core.spmat``.  A sparse
``n_rows × n_cols`` matrix is

  * ``cols``: ``(n_rows, capacity)`` int32, column per slot, ``-1`` empty,
    sorted ascending within each row (empty slots at the end);
  * ``vals``: a dict of tensors with leading shape ``(n_rows, capacity)``.

Every sort is stable (``torch.sort(..., stable=True)``), as ``jnp.argsort``
and ``jnp.lexsort`` are, because the overlap ⊕ keeps the first position
pairs and so depends on merge order.  Scatters write only live entries
(selected by a mask), so no index is written twice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from .semiring import Semiring, tree_take, tree_where

NO_COL = -1
_BIG = 2**30


def next_pow2(x: int) -> int:
    """Smallest power of two ≥ max(x, 1) — the shared bucket-padding policy."""
    return 1 << max(0, int(x) - 1).bit_length()


def _argsort_stable(key: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sort(key, dim=dim, stable=True).indices


def _take_rows(vals: Dict[str, torch.Tensor], order: torch.Tensor):
    """Gather each leaf along axis 1 with an ``(n, q)`` index."""
    out = {}
    for key, v in vals.items():
        idx = order.reshape(order.shape + (1,) * (v.dim() - 2))
        out[key] = torch.gather(v, 1, idx.expand(order.shape + v.shape[2:]))
    return out


@dataclasses.dataclass
class EllMatrix:
    """ELL sparse matrix: see module docstring."""

    cols: torch.Tensor  # (n_rows, capacity) int32; -1 = empty; row-sorted
    vals: Dict[str, torch.Tensor]  # leaves (n_rows, capacity, ...)
    n_cols: int

    @property
    def n_rows(self) -> int:
        """Number of rows."""
        return self.cols.shape[0]

    @property
    def capacity(self) -> int:
        """Slots per row."""
        return self.cols.shape[1]

    @property
    def mask(self) -> torch.Tensor:
        """``(n_rows, capacity)`` bool, True on live slots."""
        return self.cols >= 0

    def nnz(self) -> torch.Tensor:
        """Live entries (0-d int64 tensor)."""
        return torch.sum(self.mask)

    def row_nnz(self) -> torch.Tensor:
        """Live entries per row."""
        return torch.sum(self.mask, dim=1)

    def to_dense(self, semiring: Semiring) -> Dict[str, torch.Tensor]:
        """Dense values (absent -> semiring zero), leaves
        ``(n_rows, n_cols, ...)``."""
        n, k = self.cols.shape
        dense = semiring.zero((n, self.n_cols), self.cols.device)
        m = self.mask
        rows = torch.arange(n, device=self.cols.device)[:, None].expand(n, k)
        r, c = rows[m], self.cols[m].to(torch.int64)
        for key, v in self.vals.items():
            dense[key][r, c] = v[m]
        return dense

    def lookup(self, semiring: Semiring, query_cols: torch.Tensor):
        """Row-wise sorted lookup: the value at ``self[i, query_cols[i, q]]``
        (semiring zero where absent) and the found mask."""
        n, k = self.cols.shape
        big = torch.where(self.mask, self.cols, _BIG).contiguous()
        q = query_cols
        pos = torch.searchsorted(big, torch.where(q >= 0, q, 0).contiguous())
        pos = torch.clamp(pos, 0, k - 1)
        hit_col = torch.gather(big, 1, pos)
        found = (hit_col == q) & (q >= 0)
        got = _take_rows(self.vals, pos)
        return tree_where(found, got, semiring.zero(q.shape, q.device)), found


def map_row_blocks(fn: Callable, inputs: Any, *, n_rows: int, row_chunk: int,
                   fills: Any = None):
    """Map ``fn`` over ``row_chunk``-row blocks of ``inputs`` (a dict or a
    tuple of tensors / dicts with leading dim ``n_rows``).

    The last block is padded with ``fills`` (default 0).  ``fn(block)``
    returns ``(row_out, aux)``: ``row_out`` a tuple or dict of tensors with
    leading dim ``row_chunk``, reassembled to ``n_rows`` rows; ``aux`` is
    collected per block in a list."""
    nb = -(-n_rows // row_chunk)
    pad = nb * row_chunk - n_rows

    def leaves(x, f):
        if isinstance(x, dict):
            return {k: leaves(v, f[k] if isinstance(f, dict) else f)
                    for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(leaves(v, f[i] if isinstance(f, tuple) else f)
                         for i, v in enumerate(x))
        return _pad_rows(x, pad, f)

    def block(x, b):
        if isinstance(x, dict):
            return {k: block(v, b) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(block(v, b) for v in x)
        return x[b * row_chunk:(b + 1) * row_chunk]

    padded = leaves(inputs, 0 if fills is None else fills)
    outs, aux = [], []
    for b in range(nb):
        row_out, a = fn(block(padded, b))
        outs.append(row_out)
        aux.append(a)
    return _concat_rows(outs, n_rows), aux


def fill_pad_rows(x: torch.Tensor, n_live: int, n_rows: int) -> torch.Tensor:
    """``x``'s first ``n_live`` rows followed by ``n_rows − n_live`` copies
    of row 0: the results of a bucket whose pad rows repeat row 0's inputs
    (``n_live ≥ 1``)."""
    x = x[:n_live]
    if n_rows == n_live:
        return x
    return torch.cat([x, x[:1].expand((n_rows - n_live,) + tuple(x.shape[1:]))])


def _pad_rows(x: torch.Tensor, pad: int, fill) -> torch.Tensor:
    if pad == 0:
        return x
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail], dim=0)


def _concat_rows(outs, n_rows):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat_rows([o[k] for o in outs], n_rows) for k in first}
    if isinstance(first, tuple):
        return tuple(_concat_rows([o[i] for o in outs], n_rows)
                     for i in range(len(first)))
    return torch.cat(outs, dim=0)[:n_rows]


def _run_totals(new_run: torch.Tensor, vals, semiring: Semiring):
    """⊕-total of each run of a flat stream (``new_run`` starts a run),
    broadcast back onto every element of its run."""
    run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
    run_start = torch.nonzero(new_run).reshape(-1)
    totals = semiring.reduce_runs(vals, run_id, run_start)
    return tree_take(totals, run_id)


def _rank_in_row_sorted(rows_sorted: torch.Tensor, kept: torch.Tensor):
    """Given row ids sorted ascending and a kept mask, rank of each kept entry
    among kept entries of the same row (0-based)."""
    k = kept.to(torch.int64)
    c = torch.cumsum(k, 0)
    base_idx = torch.searchsorted(rows_sorted, rows_sorted, side="left")
    return c - c[base_idx] + k[base_idx] - 1


def from_coo(rows, cols, vals, valid, *, n_rows: int, n_cols: int,
             capacity: int, semiring: Semiring):
    """EllMatrix from COO triplets, merging duplicate (row, col) entries
    with ``semiring.add`` in input order.  Returns (EllMatrix, overflow)."""
    dev = rows.device
    rkey = torch.where(valid, rows.to(torch.int64), n_rows)
    ckey = torch.where(valid, cols.to(torch.int64), n_cols)
    order = _argsort_stable(rkey * (n_cols + 1) + ckey)
    rs, cs = rkey[order], ckey[order]
    vs = tree_take(vals, order)
    valid_s = valid[order]

    e = rs.numel()
    new_run = torch.ones(e, dtype=torch.bool, device=dev)
    if e > 1:
        new_run[1:] = (rs[1:] != rs[:-1]) | (cs[1:] != cs[:-1])
    scanned = _run_totals(new_run, vs, semiring)
    next_new = torch.ones(e, dtype=torch.bool, device=dev)
    next_new[:-1] = new_run[1:]
    kept = next_new & valid_s  # last element of each (row, col) run

    rank = _rank_in_row_sorted(rs, kept)
    in_cap = kept & (rank < capacity)
    overflow = torch.sum(kept & (rank >= capacity)).to(torch.int32)

    r_live, k_live = rs[in_cap], rank[in_cap]
    out_cols = torch.full((n_rows, capacity), NO_COL, dtype=torch.int32,
                          device=dev)
    out_cols[r_live, k_live] = cs[in_cap].to(torch.int32)
    out_vals = semiring.zero((n_rows, capacity), dev)
    for key, v in scanned.items():
        out_vals[key][r_live, k_live] = v[in_cap]
    return EllMatrix(cols=out_cols, vals=out_vals, n_cols=n_cols), overflow


def merge_sorted_rows(cand_cols, cand_vals, *, capacity: int,
                      semiring: Semiring):
    """Per-row candidate merge: sort each row of ``(n, Q)`` candidates by
    column (−1 = invalid), ⊕-combine duplicates and compact into
    ``capacity`` ELL slots.  Returns (cols, vals, overflow)."""
    n, q = cand_cols.shape
    dev = cand_cols.device
    key = torch.where(cand_cols >= 0, cand_cols.to(torch.int64), _BIG)
    order = _argsort_stable(key, dim=1)
    cs = torch.gather(key, 1, order)
    vs = _take_rows(cand_vals, order)
    valid = cs < _BIG
    new_run = torch.ones((n, q), dtype=torch.bool, device=dev)
    if q > 1:
        new_run[:, 1:] = cs[:, 1:] != cs[:, :-1]
    flat = {k: v.reshape((n * q,) + v.shape[2:]) for k, v in vs.items()}
    scanned = _run_totals(new_run.reshape(-1), flat, semiring)
    scanned = {k: v.reshape((n, q) + v.shape[1:]) for k, v in scanned.items()}
    next_new = torch.ones((n, q), dtype=torch.bool, device=dev)
    next_new[:, :-1] = new_run[:, 1:]
    kept = next_new & valid & ~semiring.is_zero(scanned)

    # compact: a stable sort moves kept entries (already col-ascending) first
    ckey = torch.where(kept, cs, _BIG)
    order2 = _argsort_stable(ckey, dim=1)[:, :capacity]
    raw = torch.gather(ckey, 1, order2)
    out_cols = torch.where(raw < _BIG, raw, NO_COL).to(torch.int32)
    out_vals = _take_rows(scanned, order2)
    out_vals = tree_where(out_cols >= 0, out_vals,
                          semiring.zero(out_cols.shape, dev))
    overflow = torch.sum(
        torch.clamp(torch.sum(kept, dim=1) - capacity, min=0)
    ).to(torch.int32)
    return out_cols, out_vals, overflow


def ell_equal(a: EllMatrix, b: EllMatrix) -> bool:
    """Structural + value equality (host-side, for tests)."""
    if a.n_cols != b.n_cols or a.n_rows != b.n_rows:
        return False
    if sorted(a.vals) != sorted(b.vals):
        return False
    if not np.array_equal(a.cols.cpu().numpy(), b.cols.cpu().numpy()):
        return False
    return all(
        np.allclose(a.vals[k].cpu().numpy(), b.vals[k].cpu().numpy(),
                    equal_nan=True)
        for k in a.vals
    )


def prune(mat: EllMatrix, drop: torch.Tensor, semiring: Semiring) -> EllMatrix:
    """Remove entries where ``drop`` (n, capacity) is True, recompacting rows
    so they stay sorted by column (the paper's R ∘ ¬I, §IV-E)."""
    n, k = mat.cols.shape
    keep = mat.mask & ~drop
    key = torch.where(keep, mat.cols.to(torch.int64), _BIG)
    order = _argsort_stable(key, dim=1)
    new_raw = torch.gather(key, 1, order)
    new_cols = torch.where(new_raw < _BIG, new_raw, NO_COL).to(torch.int32)
    new_vals = _take_rows(mat.vals, order)
    new_vals = tree_where(new_cols >= 0, new_vals,
                          semiring.zero((n, k), mat.cols.device))
    return EllMatrix(cols=new_cols, vals=new_vals, n_cols=mat.n_cols)
