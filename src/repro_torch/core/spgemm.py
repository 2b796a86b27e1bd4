"""Local semiring SpGEMM over static-capacity ELL matrices, in torch.

The PyTorch counterpart of ``repro.core.spgemm``: for each row i of A,
gather the B rows indexed by A's column slots, apply ⊗ to the (K_A × K_B)
candidate grid, then merge candidates sharing an output column with ⊕
(``merge_sorted_rows``).  Also ``spgemm_masked``, the sampled product
``(A ⊗ B) ∘ pattern(M)`` the fused transitive reduction uses, and
``transpose``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .semiring import Semiring, reduce_rows, tree_map, tree_where
from .spmat import EllMatrix, NO_COL, from_coo, map_row_blocks, merge_sorted_rows


def _candidates(a: EllMatrix, b: EllMatrix, semiring: Semiring):
    """(n, KA·KB) candidate columns (−1 invalid) and ⊗ values."""
    n, ka = a.cols.shape
    kb = b.cols.shape[1]
    a_valid = a.mask
    safe = torch.where(a_valid, a.cols, 0).to(torch.int64)
    b_cols_g = b.cols[safe]  # (n, KA, KB)
    b_vals_g = tree_map(lambda v: v[safe], b.vals)
    a_vals_e = tree_map(lambda v: v[:, :, None], a.vals)
    cand_vals = semiring.mul(a_vals_e, b_vals_g)
    cand_valid = (
        a_valid[:, :, None] & (b_cols_g >= 0) & ~semiring.is_zero(cand_vals)
    )
    cand_cols = torch.where(cand_valid, b_cols_g, NO_COL).reshape(n, ka * kb)
    cand_vals = tree_map(lambda v: v.reshape((n, ka * kb) + v.shape[3:]),
                         cand_vals)
    return cand_cols, cand_vals


def spgemm(a: EllMatrix, b: EllMatrix, *, semiring: Semiring, capacity: int,
           row_chunk: Optional[int] = None):
    """C = A ⊗ B over ``semiring``; returns (EllMatrix C, overflow count).
    ``row_chunk`` bounds the candidate buffer by mapping over row blocks."""
    if row_chunk is not None and a.cols.shape[0] > row_chunk:
        return _spgemm_chunked(a, b, semiring=semiring, capacity=capacity,
                               row_chunk=row_chunk)
    cand_cols, cand_vals = _candidates(a, b, semiring)
    out_cols, out_vals, overflow = merge_sorted_rows(
        cand_cols, cand_vals, capacity=capacity, semiring=semiring
    )
    return EllMatrix(cols=out_cols, vals=out_vals, n_cols=b.n_cols), overflow


def _spgemm_chunked(a, b, *, semiring, capacity, row_chunk):
    n = a.cols.shape[0]

    def one(chunk):
        cc, cv = chunk
        am = EllMatrix(cols=cc, vals=cv, n_cols=a.n_cols)
        c, ovf = spgemm(am, b, semiring=semiring, capacity=capacity)
        return (c.cols, c.vals), ovf

    (oc, ov), ovfs = map_row_blocks(
        one, (a.cols, a.vals), n_rows=n, row_chunk=row_chunk,
        fills=(-1, {k: 0 for k in a.vals}),
    )
    return EllMatrix(cols=oc, vals=ov, n_cols=b.n_cols), torch.stack(ovfs).sum()


def spgemm_masked(a: EllMatrix, b: EllMatrix, mask: EllMatrix, *,
                  semiring: Semiring, row_chunk: Optional[int] = None):
    """Sampled product N = (A ⊗ B) restricted to pattern(mask); the result
    shares ``mask.cols``."""
    if row_chunk is not None and a.cols.shape[0] > row_chunk:
        return _spgemm_masked_chunked(a, b, mask, semiring=semiring,
                                      row_chunk=row_chunk)
    return _spgemm_masked_impl(a, b, mask, semiring=semiring)


def _spgemm_masked_chunked(a, b, mask, *, semiring, row_chunk):
    n = a.cols.shape[0]

    def one(chunk):
        cc, cv, kc, kv = chunk
        am = EllMatrix(cols=cc, vals=cv, n_cols=a.n_cols)
        mm = EllMatrix(cols=kc, vals=kv, n_cols=mask.n_cols)
        return _spgemm_masked_impl(am, b, mm, semiring=semiring).vals, None

    vals, _ = map_row_blocks(
        one, (a.cols, a.vals, mask.cols, mask.vals), n_rows=n,
        row_chunk=row_chunk,
        fills=(-1, {k: 0 for k in a.vals}, -1, {k: 0 for k in mask.vals}),
    )
    return EllMatrix(cols=mask.cols, vals=vals, n_cols=mask.n_cols)


def _spgemm_masked_impl(a: EllMatrix, b: EllMatrix, mask: EllMatrix, *,
                        semiring: Semiring) -> EllMatrix:
    """``⊕_k A[i,k] ⊗ B[k, mask.cols[i,q]]`` for every mask slot: no sort,
    no pattern growth; one ⊕-reduction of the candidates per mask slot."""
    n = a.cols.shape[0]
    km = mask.cols.shape[1]
    dev = a.cols.device
    cand_cols, cand_vals = _candidates(a, b, semiring)
    q = cand_cols.shape[1]
    zero = semiring.zero((n, q), dev)
    slots = []
    for s in range(km):
        slot_cols = mask.cols[:, s]
        hits = (cand_cols == slot_cols[:, None]) & (slot_cols[:, None] >= 0)
        slots.append(reduce_rows(semiring, tree_where(hits, cand_vals, zero)))
    out_vals = {k: torch.stack([s[k] for s in slots], dim=1) for k in slots[0]}
    out_vals = tree_where(mask.cols >= 0, out_vals, semiring.zero((n, km), dev))
    return EllMatrix(cols=mask.cols, vals=out_vals, n_cols=mask.n_cols)


def transpose(a: EllMatrix, *, capacity: int, semiring: Semiring):
    """Explicit ELL transpose (paper Alg. 1 line 5).  Returns (Aᵀ, overflow)."""
    n, k = a.cols.shape
    rows = torch.arange(n, dtype=torch.int32, device=a.cols.device)
    rows = rows[:, None].expand(n, k).reshape(-1)
    cols = a.cols.reshape(-1)
    valid = cols >= 0
    vals = tree_map(lambda v: v.reshape((n * k,) + v.shape[2:]), a.vals)
    return from_coo(cols, rows, vals, valid, n_rows=a.n_cols, n_cols=n,
                    capacity=capacity, semiring=semiring)
