"""Plain banded x-drop extension, batched over walks.

The alignment model the configuration states (paper §IV-D): from a seed,
extend along both reads with unit match, mismatch and gap scores, on the
anti-diagonal wavefront s = i + j, in a band of ``band`` diagonals
d = i - j centred on the seed's; a cell whose score falls more than
``xdrop`` below the best score seen so far is dropped, and a walk ends
when no cell is left or after ``min(max_steps, len_a + len_b - 1)`` steps.
The result is the best score and the characters of each read it consumed;
a tie for the best cell of a step goes to the lowest diagonal.

A walk reads ``a[row, base_a + step_a * t]`` for ``0 <= t < len_a``
(``step`` -1 walks backwards from a seed), likewise for ``b``.  Walks that
have ended are dropped from the batch every ``COMPACT`` steps, which
changes no walk's result.
"""

from __future__ import annotations

import torch

DEAD = -(1 << 29)
COMPACT = 256  # steps between two drops of the walks that have ended


def xdrop_walks(a, base_a, step_a, len_a, b, base_b, step_b, len_b, *,
                xdrop, match, mismatch, gap, band, max_steps,
                count_cells=False):
    """``a``/``b`` (E, L) uint8 rows; the walks (E,) int.  Returns
    ``(score, used_a, used_b)`` (E,) int32, and with ``count_cells`` the
    band cells each walk evaluated inside both sequences (E,) int64."""
    dev = a.device
    e = a.shape[0]
    i32 = torch.int32
    base_a, step_a, len_a, base_b, step_b, len_b = (
        torch.as_tensor(x, device=dev).to(torch.int64)
        for x in (base_a, step_a, len_a, base_b, step_b, len_b))
    half = band // 2
    diag = torch.arange(band, device=dev, dtype=torch.int64) - half
    stop = torch.clamp(len_a + len_b - 1, max=max_steps)
    width_a, width_b = a.shape[1], b.shape[1]
    flat_a = a.reshape(-1).to(torch.int64)
    flat_b = b.reshape(-1).to(torch.int64)
    row_a = torch.arange(e, device=dev, dtype=torch.int64)[:, None] * width_a
    row_b = torch.arange(e, device=dev, dtype=torch.int64)[:, None] * width_b

    # the results of every walk; the loop holds the state of those still
    # running, ``idx`` their places here
    out_best = torch.zeros(e, dtype=i32, device=dev)
    out_a = torch.zeros(e, dtype=i32, device=dev)
    out_b = torch.zeros(e, dtype=i32, device=dev)
    out_cells = torch.zeros(e, dtype=torch.int64, device=dev)
    idx = torch.arange(e, device=dev)

    prev1 = torch.full((e, band), DEAD, dtype=i32, device=dev)  # step s - 1
    prev2 = torch.full((e, band), DEAD, dtype=i32, device=dev)  # step s - 2
    prev2[:, half] = 0  # the seed
    best = torch.zeros(e, dtype=i32, device=dev)
    used_a = torch.zeros(e, dtype=i32, device=dev)
    used_b = torch.zeros(e, dtype=i32, device=dev)
    live = torch.ones(e, dtype=torch.bool, device=dev)
    cells = torch.zeros(e, dtype=torch.int64, device=dev)
    s = 0
    while True:
        run = live & (s < stop)
        if s % COMPACT == 0 and idx.numel():
            keep = torch.nonzero(run).reshape(-1)
            if keep.numel() < idx.numel():
                out_best[idx] = best
                out_a[idx] = used_a
                out_b[idx] = used_b
                out_cells[idx] = cells
                (idx, prev1, prev2, best, used_a, used_b, live, cells, run,
                 base_a, step_a, len_a, base_b, step_b, len_b, stop, row_a,
                 row_b) = (x[keep] for x in (
                     idx, prev1, prev2, best, used_a, used_b, live, cells, run,
                     base_a, step_a, len_a, base_b, step_b, len_b, stop, row_a,
                     row_b))
        if not bool(run.any()):
            break
        pad = torch.full((idx.numel(), 1), DEAD, dtype=i32, device=dev)
        ia = torch.div(s + diag, 2, rounding_mode="floor")  # (band,)
        jb = torch.div(s - diag, 2, rounding_mode="floor")
        on_parity = ((s + diag) % 2 == 0) & (ia >= 0) & (jb >= 0)
        in_a = ia[None, :] < len_a[:, None]
        in_b = jb[None, :] < len_b[:, None]
        pa = base_a[:, None] + step_a[:, None] * ia[None, :]
        pb = base_b[:, None] + step_b[:, None] * jb[None, :]
        ca = flat_a[row_a + torch.clamp(pa, 0, width_a - 1)]
        cb = flat_b[row_b + torch.clamp(pb, 0, width_b - 1)]
        ok = on_parity[None, :] & in_a & in_b
        score = prev2 + torch.where(ca == cb, match, mismatch).to(i32)
        from_up = torch.cat([pad, prev1[:, :-1]], dim=1) + gap
        from_left = torch.cat([prev1[:, 1:], pad], dim=1) + gap
        h = torch.maximum(score, torch.maximum(from_up, from_left))
        h = torch.where(ok & (h >= (best - xdrop)[:, None]), h, DEAD)
        top, lane = torch.max(h, dim=1)
        # torch.max returns the first lane of a tie, as the model asks
        better = run & (top > best)
        best = torch.where(better, top, best)
        used_a = torch.where(better, (ia[lane] + 1).to(i32), used_a)
        used_b = torch.where(better, (jb[lane] + 1).to(i32), used_b)
        prev2 = torch.where(run[:, None], prev1, prev2)
        prev1 = torch.where(run[:, None], h, prev1)
        live = torch.where(run, (h > DEAD).any(dim=1), live)
        if count_cells:
            cells += (ok & run[:, None]).sum(dim=1)
        s += 1
    out_best[idx] = best
    out_a[idx] = used_a
    out_b[idx] = used_b
    out_cells[idx] = cells
    if count_cells:
        return out_best, out_a, out_b, out_cells
    return out_best, out_a, out_b
