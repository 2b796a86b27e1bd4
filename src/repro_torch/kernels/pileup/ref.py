"""Plain PyTorch version of the banded pileup-vote consensus op.

A mirror of ``repro.kernels.pileup.ref.pileup_vote_ref`` (DESIGN.md §2.8)
on the packed layout: the contigs' columns lie end to end in one flat
draft, contig ``c`` taking ``lengths[c]`` of them, and each piece names its
contig.  Every piece scatters its oriented bases onto its contig's columns
``start + b``; a base votes only if it is coherent — in the ±``COH_WIN``
window around it (centre excluded) the read matches the draft on at least
``COH_NUM/COH_DEN`` of the positions where both are defined, with at least
``COH_MIN_VALID`` such positions.  The window's columns run to ``l``, the
longest contig's length, and past a contig's end read as code 0: what the
JAX package's draft, padded to ``l`` columns with zeros, holds there.  A
column is re-called to the first maximum of its counts where ``depth ≥
min_depth`` and the winner holds a strict majority, else the draft base is
kept; ``agree`` is the count of the final base.  All quantities are integer
counts, so parity is exact.  :func:`from_padded` and :func:`to_padded`
carry the JAX package's padded ``(C, L)`` / ``(C, M, LR)`` layout over.
"""

from __future__ import annotations

import torch

COH_WIN = 4
COH_NUM, COH_DEN = 3, 4
COH_MIN_VALID = 4


def _vote(counts, draft, *, min_depth: int):
    """Vote epilogue: counts (..., 4) int32, draft (...) uint8."""
    depth = torch.sum(counts, dim=-1, dtype=torch.int32)
    win = torch.amax(counts, dim=-1)
    winner = torch.argmax(counts, dim=-1).to(torch.uint8)
    change = (depth >= min_depth) & (2 * win > depth)
    polished = torch.where(change, winner, draft)
    agree = torch.gather(counts, -1, polished.to(torch.int64)[..., None])[..., 0]
    return polished, depth, agree


def pileup_vote_ref(draft, lengths, pieces, contig, start, plen, *, l: int,
                    min_depth: int = 2):
    """draft (B,) uint8 (the contigs' columns end to end), lengths (C,)
    int32, pieces (P, LR) uint8, contig/start/plen (P,) int32, ``l`` the
    longest contig's length -> (polished (B,) uint8, depth (B,) int32,
    agree (B,) int32)."""
    total = draft.numel()
    p, lr = pieces.shape
    dev = draft.device
    counts = torch.zeros((total + 1, 4), dtype=torch.int32, device=dev)
    first = torch.cumsum(lengths.to(torch.int64), 0) - lengths
    b = torch.arange(lr, dtype=torch.int32, device=dev)[None, :]
    di = draft.to(torch.int32)
    step = max(1, (1 << 22) // max(lr, 1))
    for p0 in range(0, p if total else 0, step):
        sl = slice(p0, p0 + step)
        pc = pieces[sl].to(torch.int32)
        c = contig[sl].to(torch.int64)
        base0 = first[c][:, None]
        lc = lengths[c][:, None]
        pl_ = plen[sl, None]
        col = start[sl, None] + b
        ok = (b < pl_) & (col >= 0) & (col < l)
        match = torch.zeros(col.shape, dtype=torch.int32, device=dev)
        valid = torch.zeros(col.shape, dtype=torch.int32, device=dev)
        for w in range(-COH_WIN, COH_WIN + 1):
            if w == 0:
                continue
            rb = b + w
            cb = col + w
            v = (rb >= 0) & (rb < pl_) & (cb >= 0) & (cb < l)
            rv = torch.gather(pc, 1,
                              torch.clamp(rb, 0, lr - 1).to(torch.int64)
                              .expand(pc.shape))
            inside = (cb >= 0) & (cb < lc)
            dv = torch.where(inside, di[torch.where(inside, base0 + cb, 0)], 0)
            match = match + (v & (rv == dv)).to(torch.int32)
            valid = valid + v.to(torch.int32)
        # a vote past its contig's end lands on no column of the result
        ok &= ((COH_DEN * match >= COH_NUM * valid)
               & (valid >= COH_MIN_VALID) & (col < lc))
        counts.index_put_(
            (torch.where(ok, base0 + col, total).to(torch.int64),
             torch.clamp(pc, 0, 3).to(torch.int64)),
            ok.to(torch.int32), accumulate=True,
        )
    return _vote(counts[:total], draft, min_depth=min_depth)


def from_padded(draft, pieces, start, plen, lengths=None):
    """The op's arguments for the padded layout — draft (C, L), pieces (C,
    M, LR), start/plen (C, M) — as ``(args, kwargs)`` of the packed op;
    contig ``c`` keeps the first ``lengths[c]`` columns of its row (all L
    by default; ``L`` stays the window's bound)."""
    c, l = draft.shape
    m, lr = pieces.shape[1], pieces.shape[2]
    dev = draft.device
    if lengths is None:
        lengths = torch.full((c,), l, dtype=torch.int32, device=dev)
    keep = torch.arange(l, device=dev)[None, :] < lengths[:, None]
    args = (draft[keep], lengths.to(torch.int32), pieces.reshape(c * m, lr),
            torch.arange(c, dtype=torch.int32, device=dev).repeat_interleave(m),
            start.reshape(-1), plen.reshape(-1))
    return args, {"l": l}


def to_padded(outputs, lengths, l: int):
    """The op's outputs as ``(C, L)`` tensors, 0 past each contig's end."""
    keep = (torch.arange(l, device=lengths.device)[None, :]
            < lengths[:, None])
    out = []
    for x in outputs:
        y = torch.zeros(keep.shape, dtype=x.dtype, device=x.device)
        y[keep] = x
        out.append(y)
    return tuple(out)
