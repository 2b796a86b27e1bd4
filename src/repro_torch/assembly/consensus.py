"""Consensus stage: pileup polishing of the contig set (DESIGN.md §2.8),
in torch.

The PyTorch counterpart of ``repro.assembly.consensus``, on the packed
layout of ``ContigSet``: every array holds live slots only, contig by
contig, end to end (a piece a chain read, a column a contig base), where
the JAX package pads them to the most reads and the longest contig
(``ConsensusResult.padded`` gives that layout).  Every chain read is mapped
back onto its contig through the Contigs-stage layout
(``ContigSet.offsets/widths``), then

1. junction refinement re-estimates each piece's placement against its
   predecessor by banded cross-correlation over the junction end of the
   overlap (shift search in ``[−junction_radius, junction_radius]``);
2. the refined layout re-materializes the draft;
3. the ``consensus`` op (``kernels/pileup``) accumulates the per-column
   pileup of every read at its refined placement and re-calls each column
   by strict-majority vote.

Vote agreement and depth give a per-contig identity/QV estimate.  The
steps are spans: ``Consensus.gather`` (the pieces), ``Consensus.refine``
(1–2) and ``Consensus.vote`` (3 and the estimates).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

from ..core.backend import dispatch
from ..obs import span
from .contigs import Contig, materialize_packed, pad_rows

JUNCTION_WIN = 64
_I32 = torch.int32
_I64 = torch.int64
# the pieces the gathers below take at once (a row of LR bases each)
PIECE_BLOCK = 1 << 14


def _blocks(ids: torch.Tensor):
    """``ids`` in blocks of ``PIECE_BLOCK``."""
    return [ids[i:i + PIECE_BLOCK] for i in range(0, ids.numel(), PIECE_BLOCK)]


@dataclasses.dataclass
class ConsensusResult:
    """Polished contigs + per-column/per-contig quality evidence, packed as
    ``ContigSet``: contig ``c`` takes ``lengths[c]`` of the columns and
    ``n_pieces[c]`` of the states."""

    codes: Any  # (B,) uint8, polished bases, every contig's end to end
    lengths: Any  # (C,) int32, refined contig lengths
    states: Any  # (P,) int32, every contig's chain end to end
    n_pieces: Any  # (C,) int32
    depth: Any  # (B,) int32
    agree: Any  # (B,) int32
    depth_mean: Any  # (C,) f32
    identity: Any  # (C,) f32
    qv: Any  # (C,) f32
    n_contigs: int
    stats: Dict[str, float]

    def to_contigs(self) -> List[Contig]:
        """The polished contigs as host ``Contig`` records."""
        return materialize_packed(self.codes, self.lengths, self.states,
                                  self.n_pieces)

    def padded(self, rows=None, cols=None, slots=None):
        """``(codes, lengths, states, depth, agree)`` in the padded layout:
        ``(rows, cols)`` columns, ``(rows, slots)`` states (−1 padded), by
        default as small as holds the set.  For comparisons with the padded
        layout; the pipeline never builds it."""
        rows = self.n_contigs if rows is None else rows
        lens = torch.zeros(rows, dtype=self.lengths.dtype,
                           device=self.lengths.device)
        lens[:self.n_contigs] = self.lengths
        return (pad_rows(self.codes, self.lengths, rows=rows, cols=cols),
                lens,
                pad_rows(self.states, self.n_pieces, rows=rows, cols=slots,
                         fill=-1),
                pad_rows(self.depth, self.lengths, rows=rows, cols=cols),
                pad_rows(self.agree, self.lengths, rows=rows, cols=cols))


def _piece_slots(n_pieces, n: int):
    """Each of the ``n`` pieces' contig and its slot in the contig's chain:
    ``(contig, slot)``, ``(n,)`` int64 each."""
    k = n_pieces.to(_I64)
    contig = torch.repeat_interleave(torch.arange(k.numel(), device=k.device),
                                     k, output_size=n)
    slot = torch.arange(n, device=k.device) - (torch.cumsum(k, 0) - k)[contig]
    return contig, slot


def _segment_first(values, n_pieces):
    """The value at each contig's first piece, for every piece."""
    k = n_pieces.to(_I64)
    first = torch.cumsum(k, 0) - k
    return values[torch.repeat_interleave(first, k,
                                          output_size=values.numel())]


def _gather_pieces(states, offsets, widths, codes, lengths):
    """Every chain read in contig orientation and its nominal placement:
    ``(pieces (P, LR) uint8, start (P,) int32, plen (P,) int32)``."""
    lr = codes.shape[1]
    r = (states >> 1).to(_I64)
    ln = lengths[r]
    start = offsets + widths - ln
    pieces = torch.empty((states.numel(), lr), dtype=torch.uint8,
                         device=codes.device)
    b = torch.arange(lr, dtype=_I32, device=codes.device)[None, :]
    for ids in _blocks(torch.arange(states.numel(), device=codes.device)):
        rc = ((states[ids] & 1) == 1)[:, None]
        n = ln[ids][:, None]
        idx = torch.where(rc, n - 1 - b, b)
        base = torch.gather(codes[r[ids]], 1,
                            torch.clamp(idx, 0, lr - 1).to(_I64))
        base = torch.where(rc, 3 - base, base)
        pieces[ids] = torch.where(b < n, base, 0).to(torch.uint8)
    return pieces, start.to(_I32), ln.to(_I32)


def _junction_scores(pieces, plen, pair, delta0, ov, shifts):
    """``(P, S)`` banded-correlation scores of each junction (a piece and
    its predecessor) at each shift; 0 off the junctions, so only theirs
    are computed."""
    p, lr = pieces.shape
    dev = pieces.device
    sc = torch.zeros((p, len(shifts)), dtype=_I32, device=dev)
    b = torch.arange(lr, dtype=_I32, device=dev)[None, :]
    for ids in _blocks(torch.nonzero(pair).reshape(-1)):
        # a junction's piece is no contig's first: id - 1 is its predecessor
        cur = pieces[ids].to(_I32)
        prev = pieces[ids - 1].to(_I32)
        prev_len = plen[ids - 1][:, None]
        d0 = delta0[ids][:, None]
        near = ((b < plen[ids][:, None])
                & (b >= (ov[ids] - JUNCTION_WIN)[:, None]))
        cols = []
        for d in shifts:
            idx = b + d0 + d
            ok = near & (idx >= 0) & (idx < prev_len)
            pv = torch.gather(prev, 1, torch.clamp(idx, 0, lr - 1).to(_I64))
            cols.append(torch.sum(ok & (pv == cur), dim=1, dtype=_I32))
        sc[ids] = torch.stack(cols, dim=-1)
    return sc


def _refine_layout(pieces, start, plen, n_pieces, *, radius: int):
    """Re-estimate each junction's relative offset by banded correlation
    (see ``repro.assembly.consensus._refine_layout``), contig by contig.
    Returns ``(start', offset', width', lengths', n_shifted)``: per piece,
    then per contig."""
    p = plen.numel()
    dev = pieces.device
    contig, slot = _piece_slots(n_pieces, p)
    prev = torch.clamp(torch.arange(p, device=dev) - 1, min=0)
    valid = plen > 0
    head = slot == 0
    prev_len = torch.where(head, 0, plen[prev])
    prev_start = torch.where(head, 0, start[prev])
    pair = valid & ~head & (prev_len > 0)
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

    # the running sum and maximum restart at each contig's first piece
    step = torch.where(pair, delta0 + dbest, 0).to(_I64)
    run = torch.cumsum(step, 0)
    new_start = (run - _segment_first(run - step, n_pieces)).to(_I32)
    ends = torch.where(valid, new_start + plen, 0).to(_I64)
    key = (contig << 32) + ends + (1 << 31)
    run_end = (torch.cummax(key, 0).values - (contig << 32)
               - (1 << 31)).to(_I32)
    prev_end = torch.where(head, 0, run_end[prev])
    new_width = torch.where(valid, torch.clamp(run_end - prev_end, min=0), 0)
    new_off = torch.where(valid, prev_end, 0)
    last = torch.cumsum(n_pieces.to(_I64), 0) - 1
    new_len = run_end[last].to(_I32)
    n_shifted = torch.sum(dbest != 0)
    return (new_start, new_off.to(_I32), new_width.to(_I32), new_len,
            n_shifted)


def _rescatter_draft(pieces, offs, widths, plen, n_pieces, lengths, *,
                     total: int):
    """Re-materialize the draft under a (refined) layout: piece t writes its
    last ``width`` bases at columns ``[offset, offset + width)`` of its
    contig; ``(total,)`` uint8, the contigs end to end."""
    p, lr = pieces.shape
    dev = pieces.device
    contig, _ = _piece_slots(n_pieces, p)
    first = (torch.cumsum(lengths.to(_I64), 0) - lengths)[contig]
    clen = lengths[contig]
    b = torch.arange(lr, dtype=_I32, device=dev)[None, :]
    out = torch.zeros(total, dtype=torch.uint8, device=dev)
    for ids in _blocks(torch.nonzero(plen > 0).reshape(-1)):
        n = plen[ids][:, None]
        skip = n - widths[ids][:, None]
        cols = offs[ids][:, None] + b - skip
        on = ((b >= skip) & (b < n) & (cols >= 0)
              & (cols < clen[ids][:, None]))
        # pieces of one contig never overlap in the refined layout, so each
        # column is written at most once
        out[(first[ids][:, None] + cols)[on]] = pieces[ids][on]
    return out


def _quality(draft, polished, depth, agree, lengths):
    """Backend-independent reductions over the op outputs (each contig's
    columns are its own: no padding to mask)."""
    dev = draft.device
    end = torch.cumsum(lengths.to(_I64), 0)
    start = end - lengths

    def per_contig(x):
        # a contig's sum as the difference of a running sum at its two
        # ends: an index_add_ into C bins would make every column of a
        # contig an atomic on one address
        run = torch.cat([torch.zeros(1, dtype=_I64, device=dev),
                         torch.cumsum(x, 0, dtype=_I64)])
        return (run[end] - run[start]).to(_I32)

    covered = depth > 0
    num = per_contig(torch.where(covered, agree, 0))
    den = per_contig(torch.where(covered, depth, 0))
    ident = num.to(torch.float32) / torch.clamp(den, min=1).to(torch.float32)
    ident = torch.where(den > 0, ident, 1.0)
    qv = -10.0 * torch.log10(torch.clamp(1.0 - ident, min=1e-6))
    dsum = per_contig(depth)
    depth_c = dsum.to(torch.float32) / torch.clamp(lengths, min=1).to(
        torch.float32)
    n_cols = torch.clamp(torch.sum(lengths, dtype=_I32), min=1)
    depth_mean = torch.sum(dsum, dtype=_I32).to(torch.float32) / n_cols.to(
        torch.float32)
    overall = torch.sum(num, dtype=_I32).to(torch.float32) / torch.clamp(
        torch.sum(den, dtype=_I32), min=1).to(torch.float32)
    n_changed = torch.sum(polished != draft)
    return ident, qv, depth_c, depth_mean, overall, n_changed


def polish_contig_set(cset, codes, lengths, *, backend: str = "auto",
                      min_depth: int = 2,
                      junction_radius: int = 12) -> ConsensusResult:
    """Polish a packed ``ContigSet`` against its own reads via the
    ``consensus`` op.  The steps' spans carry the sizes: contigs, the
    longest chain, and the live pieces and columns held against the slots
    a layout padded to the longest chain and contig would take."""
    dev = codes.device
    n = cset.n_contigs
    n_pieces = cset.n_pieces.to(_I32)
    p = cset.states.numel()
    longest = int(torch.amax(n_pieces)) if n else 0
    with span("Consensus.gather", kind="step", n_contigs=n,
              longest_chain=longest, live_slots=p, padded_slots=n * longest):
        states = cset.states.to(_I32)
        pieces, start, plen = _gather_pieces(
            states, cset.offsets.to(_I32), cset.widths.to(_I32),
            codes.to(torch.uint8), lengths.to(_I32))
    with span("Consensus.refine", kind="step", radius=junction_radius) as sp:
        if junction_radius > 0:
            start, offs, widths, lens, n_shifted = _refine_layout(
                pieces, start, plen, n_pieces, radius=junction_radius)
            total = int(torch.sum(lens, dtype=_I64))
            draft = _rescatter_draft(pieces, offs, widths, plen, n_pieces,
                                     lens, total=total)
        else:
            lens = cset.lengths.to(_I32)
            n_shifted = torch.zeros((), dtype=_I32, device=dev)
            draft = cset.codes.to(torch.uint8)
            total = draft.numel()
        l_op = max(int(torch.amax(lens)) if n else 0, 1)
        sp.annotate(live_columns=total, padded_columns=n * l_op)
    with span("Consensus.vote", kind="step", live_columns=total):
        contig, _ = _piece_slots(n_pieces, p)
        polished, depth, agree = dispatch("consensus", backend, dev)(
            draft, lens, pieces, contig.to(_I32), start, plen, l=l_op,
            min_depth=min_depth)
        ident, qv, depth_c, depth_mean, overall, n_changed = _quality(
            draft, polished, depth, agree, lens)
        overall_f = float(overall)
    return ConsensusResult(
        codes=polished, lengths=lens, states=states, n_pieces=n_pieces,
        depth=depth, agree=agree, depth_mean=depth_c, identity=ident, qv=qv,
        n_contigs=n,
        stats={
            "consensus_depth_mean": float(depth_mean),
            "identity_estimate": overall_f,
            "qv_estimate": float(-10.0 * math.log10(max(1.0 - overall_f, 1e-6))),
            "n_changed": int(n_changed),
            "n_junction_shifted": int(n_shifted),
        },
    )
