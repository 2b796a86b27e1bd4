"""Plain PyTorch version of the banded x-drop extension kernel.

A mirror of the JAX oracle (``repro.kernels.xdrop.ref``, the vmap of
``repro.assembly.alignment.xdrop_extend``), batched over pairs: at step
s = i + j the wavefront holds scores for diagonal offsets d = i − j in a
band of ``band`` lanes; the moves are diagonal (H[s−2][d] + match or
mismatch), up (H[s−1][d−1] + gap) and left (H[s−1][d+1] + gap).  Cells
below ``best − xdrop`` retire to ``NEG``.  A pair stops once no cell is
alive or at ``min(max_steps, len_a + len_b − 1)`` steps; the batch loop
runs until every pair has stopped.  Ties of the best cell go to the first
lane (``torch.argmax`` returns the first maximum).
"""

from __future__ import annotations

import torch

NEG = -(10**9) // 2


def _fetch(seq, base, step, t, limit):
    """seq[p, base[p] + step[p]·t] with validity 0 ≤ t < limit[p]."""
    idx = base[:, None] + step[:, None] * t[None, :]
    safe = torch.clamp(idx, 0, seq.shape[1] - 1).to(torch.int64)
    return torch.gather(seq, 1, safe), (t[None, :] >= 0) & (t[None, :] < limit[:, None])


def xdrop_extend_batch_ref(a, base_a, step_a, len_a, b, base_b, step_b, len_b,
                           *, xdrop=15, match=1, mismatch=-1, gap=-1, band=33,
                           max_steps=256, with_cells=False):
    """Batched single-direction x-drop extension: ``a`` (E, LA) and ``b``
    (E, LB) uint8, the rest (E,) int32 → (score, ai, bj) (E,) int32.
    ``with_cells=True`` also returns, per pair, the band cells that exist
    on the steps it ran (right parity, inside both sequences): the cells
    whose score the kernel computes."""
    e = a.shape[0]
    dev = a.device
    i32 = torch.int32
    ba, sa, la = (x.to(i32) for x in (base_a, step_a, len_a))
    bb, sb, lb = (x.to(i32) for x in (base_b, step_b, len_b))
    c = band // 2
    offs = torch.arange(band, dtype=i32, device=dev) - c
    limit = torch.clamp(la + lb - 1, max=max_steps)
    m_t = torch.tensor(match, dtype=i32, device=dev)
    mm_t = torch.tensor(mismatch, dtype=i32, device=dev)

    h1 = torch.full((e, band), NEG, dtype=i32, device=dev)
    h2 = torch.where(offs == 0, 0, NEG).to(i32).expand(e, band).clone()
    negcol = torch.full((e, 1), NEG, dtype=i32, device=dev)
    best = torch.zeros(e, dtype=i32, device=dev)
    bi = torch.zeros(e, dtype=i32, device=dev)
    bj = torch.zeros(e, dtype=i32, device=dev)
    alive = torch.ones(e, dtype=torch.bool, device=dev)
    cells = torch.zeros(e, dtype=i32, device=dev)
    s = 0
    while True:
        active = alive & (s < limit)
        if not bool(torch.any(active)):
            break
        i = torch.div(s + offs, 2, rounding_mode="floor")
        j = torch.div(s - offs, 2, rounding_mode="floor")
        parity = torch.remainder(s + offs, 2) == 0
        av, va = _fetch(a, ba, sa, i, la)
        bv, vb = _fetch(b, bb, sb, j, lb)
        valid = parity[None, :] & va & vb & (i >= 0)[None, :] & (j >= 0)[None, :]
        sub = torch.where(av == bv, m_t, mm_t)
        diag = h2 + sub
        up = torch.cat([negcol, h1[:, :-1]], dim=1) + gap
        left = torch.cat([h1[:, 1:], negcol], dim=1) + gap
        h = torch.maximum(diag, torch.maximum(up, left))
        h = torch.where(valid, h, NEG)
        h = torch.where(h < (best - xdrop)[:, None], NEG, h)
        m = torch.amax(h, dim=1)
        am = torch.argmax(h, dim=1)
        improved = active & (m > best)
        best = torch.where(improved, m, best)
        bi = torch.where(improved, i[am] + 1, bi)
        bj = torch.where(improved, j[am] + 1, bj)
        act = active[:, None]
        h2 = torch.where(act, h1, h2)
        h1 = torch.where(act, h, h1)
        alive = torch.where(active, torch.any(h > NEG, dim=1), alive)
        if with_cells:
            cells = cells + (valid & act).sum(dim=1, dtype=i32)
        s += 1
    if with_cells:
        return best, bi, bj, cells
    return best, bi, bj
