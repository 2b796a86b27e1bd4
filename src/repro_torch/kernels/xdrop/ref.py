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

The bases, steps and lengths are ``(E,)`` (one direction) or ``(D, E)``:
``D`` directions over the same ``E`` rows of ``a`` and ``b``, each run as
its own pair, with ``(D, E)`` outputs.
"""

from __future__ import annotations

import torch

NEG = -(10**9) // 2

_WALK_KEYS = ("base_a", "step_a", "len_a", "base_b", "step_b", "len_b")


def check_walk_shapes(a, b, walks) -> tuple:
    """The common shape of the six walk tensors (``walks``, by name), which
    must be ``(E,)`` or ``(D, E)`` with ``E`` the rows of ``a`` and ``b``;
    raises ``ValueError`` otherwise."""
    e = a.shape[0]
    for key, x in (("a", a), ("b", b)):
        if x.dim() != 2 or x.shape[0] != e:
            raise ValueError(f"xdrop: {key} must be (E, L) with E = {e}, "
                             f"got {tuple(x.shape)}")
    shape = tuple(walks["base_a"].shape)
    if not (shape == (e,) or (len(shape) == 2 and shape[1] == e)):
        raise ValueError(f"xdrop: base_a must be ({e},) or (D, {e}), got {shape}")
    for key in _WALK_KEYS:
        if tuple(walks[key].shape) != shape:
            raise ValueError(f"xdrop: {key} must be {shape} like base_a, got "
                             f"{tuple(walks[key].shape)}")
    return shape


def _fetch(seq, rows, base, step, t, limit):
    """seq[rows[p], base[p] + step[p]·t] with validity 0 ≤ t < limit[p]."""
    idx = base[:, None] + step[:, None] * t[None, :]
    width = seq.shape[1]
    safe = torch.clamp(idx, 0, width - 1).to(torch.int64)
    flat = rows[:, None] * width + safe
    return (torch.take(seq, flat),
            (t[None, :] >= 0) & (t[None, :] < limit[:, None]))


def xdrop_extend_batch_ref(a, base_a, step_a, len_a, b, base_b, step_b, len_b,
                           *, xdrop=15, match=1, mismatch=-1, gap=-1, band=33,
                           max_steps=256, with_cells=False, with_steps=False):
    """Batched x-drop extension: ``a`` (E, LA) and ``b`` (E, LB) uint8, the
    walks (E,) or (D, E) int32 → (score, ai, bj) of the walks' shape, int32.
    ``with_cells=True`` also returns, per pair, the band cells that exist
    on the steps it ran (right parity, inside both sequences): the cells
    whose score the kernel computes.  ``with_steps=True`` also returns the
    steps each pair ran (its share of the launch's dependent chain)."""
    shape = check_walk_shapes(a, b, dict(
        base_a=base_a, step_a=step_a, len_a=len_a, base_b=base_b,
        step_b=step_b, len_b=len_b))
    dev = a.device
    i32 = torch.int32
    ba, sa, la = (x.to(i32).reshape(-1) for x in (base_a, step_a, len_a))
    bb, sb, lb = (x.to(i32).reshape(-1) for x in (base_b, step_b, len_b))
    e = ba.shape[0]
    rows = torch.arange(e, device=dev) % a.shape[0]
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
    steps = torch.zeros(e, dtype=i32, device=dev)
    s = 0
    while True:
        active = alive & (s < limit)
        if not bool(torch.any(active)):
            break
        i = torch.div(s + offs, 2, rounding_mode="floor")
        j = torch.div(s - offs, 2, rounding_mode="floor")
        parity = torch.remainder(s + offs, 2) == 0
        av, va = _fetch(a, rows, ba, sa, i, la)
        bv, vb = _fetch(b, rows, bb, sb, j, lb)
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
        steps = steps + active.to(i32)
        s += 1
    out = [best, bi, bj]
    if with_cells:
        out.append(cells)
    if with_steps:
        out.append(steps)
    return tuple(x.reshape(shape) for x in out)
