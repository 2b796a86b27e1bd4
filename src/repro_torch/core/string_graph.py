"""Bidirected string-graph construction from alignment results, in torch.

The PyTorch counterpart of ``repro.core.string_graph`` (paper §II, §IV-E):
overlaps are classified from alignment coordinates (contained, dovetail
i→j, dovetail j→i, internal), and every proper dovetail becomes two
directed entries of the overlap matrix R — ``i→j`` with strands (a, b) and
its complement ``j→i`` with strands (1−b, 1−a) — each a MinPlus 4-vector
value (suffix length at combo 2·s_i + s_j, +inf elsewhere).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .semiring import INF, MP, minplus_orient_semiring
from .spmat import EllMatrix, from_coo, prune


class OverlapClass(NamedTuple):
    """Per-pair classification flags + directed-edge payloads (see
    ``repro.core.string_graph.OverlapClass``)."""

    contained_i: torch.Tensor
    contained_j: torch.Tensor
    fwd_ij: torch.Tensor
    fwd_ji: torch.Tensor
    suf_ij: torch.Tensor
    suf_ij_comp: torch.Tensor
    suf_ji: torch.Tensor
    suf_ji_comp: torch.Tensor
    strands_ij: torch.Tensor  # (E, 2) int32
    strands_ji: torch.Tensor


def classify_overlaps(bi, ei, li, bj, ej, lj, strand_j, *,
                      end_fuzz: int = 25) -> OverlapClass:
    """Vectorized overlap classification; all args (E,) int32, coordinates
    of j in its oriented frame."""
    bi, ei, li, bj, ej, lj, s = (
        torch.as_tensor(x).to(torch.int32)
        for x in (bi, ei, li, bj, ej, lj, strand_j)
    )
    left_i = bi
    right_i = li - ei
    left_j = bj
    right_j = lj - ej

    cont_i = (left_i <= end_fuzz) & (right_i <= end_fuzz)
    cont_j = (left_j <= end_fuzz) & (right_j <= end_fuzz)
    # both contained (equal spans): the shorter is contained, ties → i
    both = cont_i & cont_j
    cont_i = cont_i & (~both | (li <= lj))
    cont_j = cont_j & (~both | (lj < li))

    proper_ij = (right_i <= end_fuzz) & (left_j <= end_fuzz)
    proper_ji = (left_i <= end_fuzz) & (right_j <= end_fuzz)
    anycont = cont_i | cont_j
    zeros = torch.zeros_like(s)
    return OverlapClass(
        contained_i=cont_i,
        contained_j=cont_j,
        fwd_ij=proper_ij & ~anycont,
        fwd_ji=proper_ji & ~anycont,
        suf_ij=right_j,
        suf_ij_comp=left_i,
        suf_ji=right_i,
        suf_ji_comp=left_j,
        strands_ij=torch.stack([zeros, s], dim=-1),
        strands_ji=torch.stack([s, zeros], dim=-1),
    )


def _mp_entry(suffix, strands):
    """(E,) suffix + (E,2) strands -> (E,4) MinPlus value."""
    combo = 2 * strands[:, 0] + strands[:, 1]
    lanes = torch.arange(4, device=strands.device)
    return torch.where(lanes[None, :] == combo[:, None],
                       suffix.to(torch.float32)[:, None],
                       torch.tensor(INF, device=strands.device))


def build_overlap_graph(read_i, read_j, cls: OverlapClass, valid, *,
                        n_reads: int, capacity: int):
    """The overlap matrix R from classified pairs.  Returns (R, contained
    (n,) bool, overflow)."""
    sr = minplus_orient_semiring
    e_ij = _mp_entry(cls.suf_ij, cls.strands_ij)
    comp_ij = torch.stack([1 - cls.strands_ij[:, 1], 1 - cls.strands_ij[:, 0]], -1)
    e_ij_c = _mp_entry(cls.suf_ij_comp, comp_ij)
    e_ji = _mp_entry(cls.suf_ji, cls.strands_ji)
    comp_ji = torch.stack([1 - cls.strands_ji[:, 1], 1 - cls.strands_ji[:, 0]], -1)
    e_ji_c = _mp_entry(cls.suf_ji_comp, comp_ji)

    rows = torch.cat([read_i, read_j, read_j, read_i])
    cols = torch.cat([read_j, read_i, read_i, read_j])
    vals = {MP: torch.cat([e_ij, e_ij_c, e_ji, e_ji_c])}
    ok = torch.cat([valid & cls.fwd_ij, valid & cls.fwd_ij,
                    valid & cls.fwd_ji, valid & cls.fwd_ji])
    mat, overflow = from_coo(rows, cols, vals, ok, n_rows=n_reads,
                             n_cols=n_reads, capacity=capacity, semiring=sr)
    contained = torch.zeros(n_reads, dtype=torch.bool, device=read_i.device)
    contained[read_i[valid & cls.contained_i].to(torch.int64)] = True
    contained[read_j[valid & cls.contained_j].to(torch.int64)] = True
    return mat, contained, overflow


def drop_contained(mat: EllMatrix, contained: torch.Tensor) -> EllMatrix:
    """Remove all edges incident to contained reads (paper §IV-D)."""
    safe = torch.where(mat.mask, mat.cols, 0).to(torch.int64)
    drop = contained[:, None] | (contained[safe] & mat.mask)
    return prune(mat, drop & mat.mask, minplus_orient_semiring)


def edge_list(mat: EllMatrix):
    """Host-side edge list [(i, j, combo, suffix)] for tests/inspection."""
    cols = mat.cols.cpu().numpy()
    vals = mat.vals[MP].cpu().numpy()
    out = []
    for i in range(cols.shape[0]):
        for q in range(cols.shape[1]):
            j = cols[i, q]
            if j < 0:
                continue
            for c in range(4):
                v = vals[i, q, c]
                if v != INF:
                    out.append((i, int(j), c, float(v)))
    return out
