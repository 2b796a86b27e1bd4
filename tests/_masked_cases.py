"""Inputs of the ``spgemm_masked`` op (the fused TR's sampled min-plus
square): seeded min-plus ELL matrices with +inf combos, empty rows, rows
holding every slot, a mask apart from A and B, B rows of more than 32 live
slots, K = 40 over many blocks and mask rows too wide for 48 KB of shared
memory.  The port's ``EllMatrix`` on the CPU; shared by the CPU parity
tests and the card tests."""

import numpy as np
import torch

from repro_torch.core.semiring import MP, minplus_orient_semiring
from repro_torch.core.spmat import from_coo

#: cases small enough for the CPU tests against JAX
CPU_CASES = ("random", "empty_rows", "full_rows", "other_mask", "wide_k_rows")
#: and the card's wider ones
CASES = CPU_CASES + ("cell_width", "wide_mask")


def mp_ell(rng, n_rows, n_cols, cap, *, per_row=6, empty_rows=(),
           full_rows=(), p_inf=0.5):
    """``per_row`` random entries a row on average, integer lengths in
    random orientation combos and the rest +inf (some entries all +inf),
    ``empty_rows`` with none and ``full_rows`` with all ``cap`` slots
    live."""
    rows = rng.integers(0, n_rows, n_rows * per_row)
    full = [np.full(cap, r) for r in full_rows]
    rows = np.concatenate([rows, *full]) if full else rows
    cols = rng.integers(0, n_cols, rows.size)
    for i, r in enumerate(full_rows):  # distinct columns fill the row
        at = rows.size - (len(full_rows) - i) * cap
        cols[at:at + cap] = rng.choice(n_cols, cap, replace=False)
    ok = ~np.isin(rows, list(empty_rows))
    e = rows.size
    vals = np.where(rng.random((e, 4)) < p_inf, np.inf,
                    rng.integers(1, 500, (e, 4))).astype(np.float32)
    vals[rng.random(e) < 0.1] = np.inf
    m, _ = from_coo(torch.from_numpy(rows.astype(np.int32)),
                    torch.from_numpy(cols.astype(np.int32)),
                    {MP: torch.from_numpy(vals)}, torch.from_numpy(ok),
                    n_rows=n_rows, n_cols=n_cols, capacity=cap,
                    semiring=minplus_orient_semiring)
    return m


def operands(case, seed):
    """(A, B, mask) of one case."""
    rng = np.random.default_rng(seed)
    if case == "random":
        r = mp_ell(rng, 40, 40, 10)
        return r, r, r
    if case == "empty_rows":
        r = mp_ell(rng, 30, 30, 8, empty_rows=(0, 7, 29))
        return r, r, r
    if case == "full_rows":
        r = mp_ell(rng, 36, 36, 12, per_row=3, full_rows=(1, 5, 35))
        return r, r, r
    if case == "other_mask":  # A (n, m), B (m, p), mask (n, p): all apart
        return (mp_ell(rng, 20, 30, 9),
                mp_ell(rng, 30, 25, 11, full_rows=(3,)),
                mp_ell(rng, 20, 25, 7, empty_rows=(4,)))
    if case == "wide_k_rows":  # B rows of more than 32 live slots
        return (mp_ell(rng, 24, 80, 40, per_row=8, full_rows=(2,)),
                mp_ell(rng, 80, 90, 48, per_row=20, full_rows=(0, 9, 40, 79)),
                mp_ell(rng, 24, 90, 45, per_row=30, full_rows=(6,)))
    if case == "cell_width":  # K = 40 over many blocks
        r = mp_ell(rng, 15000, 15000, 40, per_row=25, full_rows=(0, 14999))
        return r, r, r
    if case == "wide_mask":  # 400 mask slots: 64 KB of shared memory a block
        return (mp_ell(rng, 70, 600, 30),
                mp_ell(rng, 600, 600, 64, per_row=40),
                mp_ell(rng, 70, 600, 400, per_row=200, full_rows=(3,)))
    raise ValueError(case)
