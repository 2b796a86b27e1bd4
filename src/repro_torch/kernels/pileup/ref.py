"""Plain PyTorch version of the banded pileup-vote consensus op.

A mirror of ``repro.kernels.pileup.ref.pileup_vote_ref`` (DESIGN.md §2.8):
every piece scatters its oriented bases onto contig columns
``start + b``; a base votes only if it is coherent — in the ±``COH_WIN``
window around it (centre excluded) the read matches the draft on at least
``COH_NUM/COH_DEN`` of the positions where both are defined, with at least
``COH_MIN_VALID`` such positions.  A column is re-called to the first
maximum of its counts where ``depth ≥ min_depth`` and the winner holds a
strict majority, else the draft base is kept; ``agree`` is the count of the
final base.  All quantities are integer counts, so parity is exact.
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


def pileup_vote_ref(draft, pieces, start, plen, *, min_depth: int = 2):
    """draft (C, L) uint8, pieces (C, M, LR) uint8, start/plen (C, M) int32
    -> (polished (C, L) uint8, depth (C, L) int32, agree (C, L) int32)."""
    c, l = draft.shape
    m, lr = pieces.shape[1], pieces.shape[2]
    dev = draft.device
    counts = torch.zeros((c, l + 1, 4), dtype=torch.int32, device=dev)
    rows = torch.arange(c, device=dev)[:, None, None]
    b = torch.arange(lr, dtype=torch.int32, device=dev)[None, None, :]
    di = draft.to(torch.int32)
    step = max(1, min(m, (1 << 22) // max(c * lr, 1)))
    for m0 in range(0, m, step):
        pc = pieces[:, m0:m0 + step].to(torch.int32)
        mc = pc.shape[1]
        pl_ = plen[:, m0:m0 + step, None]
        col = start[:, m0:m0 + step, None] + b
        ok = (b < pl_) & (col >= 0) & (col < l)
        match = torch.zeros(col.shape, dtype=torch.int32, device=dev)
        valid = torch.zeros(col.shape, dtype=torch.int32, device=dev)
        for w in range(-COH_WIN, COH_WIN + 1):
            if w == 0:
                continue
            rb = b + w
            cb = col + w
            v = (rb >= 0) & (rb < pl_) & (cb >= 0) & (cb < l)
            rv = torch.gather(
                pc, 2, torch.clamp(rb, 0, lr - 1).to(torch.int64).expand(c, mc, lr)
            )
            dv = torch.gather(
                di[:, None, :].expand(c, mc, l), 2,
                torch.clamp(cb, 0, l - 1).to(torch.int64),
            )
            match = match + (v & (rv == dv)).to(torch.int32)
            valid = valid + v.to(torch.int32)
        ok &= (COH_DEN * match >= COH_NUM * valid) & (valid >= COH_MIN_VALID)
        counts.index_put_(
            (rows.expand(c, mc, lr), torch.where(ok, col, l).to(torch.int64),
             torch.clamp(pc, 0, 3).to(torch.int64)),
            ok.to(torch.int32), accumulate=True,
        )
    return _vote(counts[:, :l], draft, min_depth=min_depth)
