"""Consensus stage: pileup polishing of the contig tensor (DESIGN.md §2.8),
in torch.

The PyTorch counterpart of ``repro.assembly.consensus``.  Every chain read
is mapped back onto its contig through the Contigs-stage layout
(``ContigSet.offsets/widths``), then

1. junction refinement re-estimates each piece's placement against its
   predecessor by banded cross-correlation over the junction end of the
   overlap (shift search in ``[−junction_radius, junction_radius]``);
2. the refined layout re-materializes the draft;
3. the ``consensus`` op (``kernels/pileup``) accumulates the per-column
   pileup of every read at its refined placement and re-calls each column
   by strict-majority vote.

Vote agreement and depth give a per-contig identity/QV estimate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

from ..core.backend import dispatch
from .contigs import Contig, materialize_rows

JUNCTION_WIN = 64
_I32 = torch.int32
# the piece slots the gathers below take at once: the (C, M) slots are
# padded to the longest chain's, so only the live ones (reads; junctions)
# are worked on, this many (~2.5 kB of bases each) a block
PIECE_BLOCK = 1 << 14


def _live_blocks(live: torch.Tensor):
    """The flat ids of ``live``'s True entries, in blocks of
    ``PIECE_BLOCK``."""
    ids = torch.nonzero(live.reshape(-1)).reshape(-1)
    return [ids[i:i + PIECE_BLOCK] for i in range(0, ids.numel(), PIECE_BLOCK)]


@dataclasses.dataclass
class ConsensusResult:
    """Polished contig tensors + per-column/per-contig quality evidence
    (rows beyond ``n_contigs`` are padding)."""

    codes: Any  # (C, L) uint8, polished bases
    lengths: Any  # (C,) int32, refined contig lengths
    states: Any  # (C, M) int32, -1 padded
    depth: Any  # (C, L) int32
    agree: Any  # (C, L) int32
    depth_mean: Any  # (C,) f32
    identity: Any  # (C,) f32
    qv: Any  # (C,) f32
    n_contigs: int
    stats: Dict[str, float]

    def to_contigs(self) -> List[Contig]:
        """The polished contigs as host ``Contig`` records."""
        return materialize_rows(self.codes, self.lengths, self.states,
                                self.n_contigs)


def _gather_pieces(states, offsets, widths, codes, lengths):
    """Every chain read in contig orientation and its nominal placement:
    ``(pieces (C, M, LR) uint8, start (C, M) int32, plen (C, M) int32)``;
    empty slots hold no bases."""
    lr = codes.shape[1]
    valid = states >= 0
    r = torch.where(valid, states >> 1, 0).to(torch.int64)
    ln = torch.where(valid, lengths[r], 0)
    start = torch.where(valid, offsets + widths - ln, 0)
    pieces = torch.zeros(tuple(states.shape) + (lr,), dtype=torch.uint8,
                         device=codes.device)
    flat = pieces.view(-1, lr)
    b = torch.arange(lr, dtype=_I32, device=codes.device)[None, :]
    for ids in _live_blocks(valid):
        rc = ((states.reshape(-1)[ids] & 1) == 1)[:, None]
        n = ln.reshape(-1)[ids][:, None]
        idx = torch.where(rc, n - 1 - b, b)
        base = torch.gather(codes[r.reshape(-1)[ids]], 1,
                            torch.clamp(idx, 0, lr - 1).to(torch.int64))
        base = torch.where(rc, 3 - base, base)
        flat[ids] = torch.where(b < n, base, 0).to(torch.uint8)
    return pieces, start.to(_I32), ln.to(_I32)


def _junction_scores(pieces, plen, pair, delta0, ov, shifts):
    """``(C, M, S)`` banded-correlation scores of each junction (a piece
    and its predecessor) at each shift; 0 off the junctions, so only
    theirs are computed."""
    c, m, lr = pieces.shape
    dev = pieces.device
    flat = pieces.reshape(-1, lr)
    sc = torch.zeros((c * m, len(shifts)), dtype=_I32, device=dev)
    b = torch.arange(lr, dtype=_I32, device=dev)[None, :]
    for ids in _live_blocks(pair):  # t >= 1: id - 1 is the predecessor
        cur = flat[ids].to(_I32)
        prev = flat[ids - 1].to(_I32)
        prev_len = plen.reshape(-1)[ids - 1][:, None]
        d0 = delta0.reshape(-1)[ids][:, None]
        near = ((b < plen.reshape(-1)[ids][:, None])
                & (b >= (ov.reshape(-1)[ids] - JUNCTION_WIN)[:, None]))
        cols = []
        for d in shifts:
            idx = b + d0 + d
            ok = near & (idx >= 0) & (idx < prev_len)
            pv = torch.gather(prev, 1,
                              torch.clamp(idx, 0, lr - 1).to(torch.int64))
            cols.append(torch.sum(ok & (pv == cur), dim=1, dtype=_I32))
        sc[ids] = torch.stack(cols, dim=-1)
    return sc.view(c, m, len(shifts))


def _refine_layout(pieces, start, plen, *, radius: int):
    """Re-estimate each junction's relative offset by banded correlation
    (see ``repro.assembly.consensus._refine_layout``).  Returns
    ``(start', offset', width', lengths', n_shifted)``."""
    c, m, lr = pieces.shape
    dev = pieces.device
    valid = plen > 0
    prev_len = torch.roll(plen, 1, dims=1)
    prev_start = torch.roll(start, 1, dims=1)
    t_pos = torch.arange(m, dtype=_I32, device=dev)[None, :]
    pair = valid & (t_pos >= 1) & (prev_len > 0)
    delta0 = torch.where(pair, start - prev_start, 0)
    ov = torch.where(pair, prev_start + prev_len - start, 0)

    # δ = 0 first so ties keep the nominal layout; then outward by |δ|
    shifts = [0]
    for d in range(1, radius + 1):
        shifts.extend((-d, d))
    sc = _junction_scores(pieces, plen, pair, delta0, ov, shifts)
    pick = torch.argmax(sc, dim=-1)
    dbest = torch.tensor(shifts, dtype=_I32, device=dev)[pick]
    best = torch.amax(sc, dim=-1)
    sc0 = sc[..., 0]
    decisive = best > sc0 + torch.clamp(torch.div(sc0, 2, rounding_mode="floor"),
                                        min=8)
    strong = 5 * best >= 4 * torch.clamp(ov, max=JUNCTION_WIN)
    dbest = torch.where(pair & decisive & strong, dbest, 0)

    step = torch.where(pair, delta0 + dbest, 0)
    new_start = torch.cumsum(step, dim=1, dtype=_I32)
    ends = torch.where(valid, new_start + plen, 0)
    run_end = torch.cummax(ends, dim=1).values
    prev_end = torch.cat(
        [torch.zeros((c, 1), dtype=run_end.dtype, device=dev), run_end[:, :-1]],
        dim=1)
    new_width = torch.where(valid, torch.clamp(run_end - prev_end, min=0), 0)
    new_off = torch.where(valid, prev_end, 0)
    new_len = torch.amax(run_end, dim=1).to(_I32)
    n_shifted = torch.sum(dbest != 0)
    return (new_start.to(_I32), new_off.to(_I32), new_width.to(_I32), new_len,
            n_shifted)


def _rescatter_draft(pieces, offs, widths, plen, *, l: int):
    """Re-materialize the draft under a (refined) layout: piece t writes its
    last ``width`` bases at columns ``[offset, offset + width)``."""
    c, m, lr = pieces.shape
    dev = pieces.device
    flat = pieces.reshape(-1, lr)
    b = torch.arange(lr, dtype=_I32, device=dev)[None, :]
    out = torch.zeros((c, l), dtype=torch.uint8, device=dev)
    for ids in _live_blocks(plen > 0):
        n = plen.reshape(-1)[ids][:, None]
        skip = n - widths.reshape(-1)[ids][:, None]
        cols = offs.reshape(-1)[ids][:, None] + b - skip
        on = (b >= skip) & (b < n) & (cols >= 0) & (cols < l)
        rows = torch.div(ids, m, rounding_mode="floor")[:, None].expand(
            on.shape)
        # pieces of one contig never overlap in the refined layout, so each
        # (row, column) is written at most once
        out[rows[on], cols[on].to(torch.int64)] = flat[ids][on]
    return out


def _quality(draft, polished, depth, agree, lengths):
    """Backend-independent reductions over the op outputs."""
    l = draft.shape[1]
    dev = draft.device
    colmask = torch.arange(l, device=dev)[None, :] < lengths[:, None]
    covered = colmask & (depth > 0)
    num = torch.sum(torch.where(covered, agree, 0), dim=1, dtype=_I32)
    den = torch.sum(torch.where(covered, depth, 0), dim=1, dtype=_I32)
    ident = num.to(torch.float32) / torch.clamp(den, min=1).to(torch.float32)
    ident = torch.where(den > 0, ident, 1.0)
    qv = -10.0 * torch.log10(torch.clamp(1.0 - ident, min=1e-6))
    dsum = torch.sum(torch.where(colmask, depth, 0), dim=1, dtype=_I32)
    depth_c = dsum.to(torch.float32) / torch.clamp(
        torch.sum(colmask, dim=1, dtype=_I32), min=1).to(torch.float32)
    n_cols = torch.clamp(torch.sum(colmask, dtype=_I32), min=1)
    depth_mean = torch.sum(dsum, dtype=_I32).to(torch.float32) / n_cols.to(
        torch.float32)
    overall = torch.sum(num, dtype=_I32).to(torch.float32) / torch.clamp(
        torch.sum(den, dtype=_I32), min=1).to(torch.float32)
    n_changed = torch.sum((polished != draft) & colmask)
    return ident, qv, depth_c, depth_mean, overall, n_changed


def polish_contig_set(cset, codes, lengths, *, backend: str = "auto",
                      min_depth: int = 2,
                      junction_radius: int = 12) -> ConsensusResult:
    """Polish a ``ContigSet`` against its own reads via the ``consensus``
    op; the result's column capacity is the maximum refined contig length
    (data-dependent, so both contig backends give the same tensors)."""
    dev = codes.device
    states = cset.states.to(_I32)
    pieces, start, plen = _gather_pieces(
        states, cset.offsets.to(_I32), cset.widths.to(_I32),
        codes.to(torch.uint8), lengths.to(_I32),
    )
    if junction_radius > 0:
        start, offs, widths, lens, n_shifted = _refine_layout(
            pieces, start, plen, radius=junction_radius)
        l_op = max(int(torch.amax(lens)), 1)
        draft = _rescatter_draft(pieces, offs, widths, plen, l=l_op)
    else:
        lens = cset.lengths.to(_I32)
        n_shifted = torch.zeros((), dtype=_I32, device=dev)
        l_op = max(int(torch.amax(lens)), 1)
        d0 = cset.codes.to(torch.uint8)
        draft = (d0[:, :l_op] if d0.shape[1] >= l_op
                 else torch.nn.functional.pad(d0, (0, l_op - d0.shape[1])))
    draft = draft.contiguous()
    polished, depth, agree = dispatch("consensus", backend, dev)(
        draft, pieces, start, plen, min_depth=min_depth)
    ident, qv, depth_c, depth_mean, overall, n_changed = _quality(
        draft, polished, depth, agree, lens)
    overall_f = float(overall)
    return ConsensusResult(
        codes=polished, lengths=lens, states=states, depth=depth,
        agree=agree, depth_mean=depth_c, identity=ident, qv=qv,
        n_contigs=cset.n_contigs,
        stats={
            "consensus_depth_mean": float(depth_mean),
            "identity_estimate": overall_f,
            "qv_estimate": float(-10.0 * math.log10(max(1.0 - overall_f, 1e-6))),
            "n_changed": int(n_changed),
            "n_junction_shifted": int(n_shifted),
        },
    )
