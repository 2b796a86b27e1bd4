"""Inputs of the pileup-vote op at the parity traps of the card's
tile-list kernel (``csrc/pileup.cu``): pieces longer than LR, negative
starts, starts at or past L, empty pieces, L around 9 and around the tile,
a tile that 220 pieces reach, a contig with no pieces, and contigs of
ragged lengths (one of none), whose tiles follow each other in the packed
layout.  Numpy arrays ``(draft, pieces, start, plen)`` in the padded layout
and each contig's length (:func:`case_lengths`; the draft is 0 past it),
which ``kernels.pileup.ref.from_padded`` packs; shared by the CPU emulation
tests and the card tests."""

import numpy as np

from repro_torch.kernels.pileup.ops import TILE


def _inputs(seed, c, m, l, lr, *, s_lo, s_hi, p_lo, p_hi, err=0.06):
    """Seeded pieces that copy a truth where they lie on the contig (so
    most votes pass the coherence gate), with errors, and a draft with
    errors; random bytes past L and before 0."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 4, (c, l)).astype(np.uint8)
    start = rng.integers(s_lo, s_hi, (c, m)).astype(np.int32)
    plen = rng.integers(p_lo, p_hi, (c, m)).astype(np.int32)
    pieces = rng.integers(0, 4, (c, m, lr)).astype(np.uint8)
    for i in range(c):
        for t in range(m):
            cols = start[i, t] + np.arange(lr)
            on = (cols >= 0) & (cols < l)
            pieces[i, t, on] = truth[i, cols[on]]
    flip = rng.random(pieces.shape) < err
    pieces = np.where(flip, (pieces + 1) % 4, pieces).astype(np.uint8)
    draft = np.where(rng.random((c, l)) < err, (truth + 2) % 4,
                     truth).astype(np.uint8)
    return draft, pieces, start, plen


def case_inputs(name):
    t = TILE
    if name == "random":
        return _inputs(0, 3, 6, 300, 170, s_lo=-40, s_hi=240, p_lo=0, p_hi=160)
    if name == "plen_gt_lr":
        # every piece claims more bases than its LR bytes hold: window
        # positions past LR read byte LR - 1 and still count as valid
        return _inputs(1, 2, 8, 400, 60, s_lo=-20, s_hi=380, p_lo=61,
                       p_hi=140)
    if name == "neg_start":
        return _inputs(2, 2, 8, 300, 200, s_lo=-180, s_hi=-1, p_lo=150,
                       p_hi=200)
    if name == "start_ge_l":
        d, p, s, ln = _inputs(3, 2, 8, 300, 120, s_lo=-30, s_hi=290, p_lo=60,
                              p_hi=120)
        s[:, ::2] = 300 + np.arange(4)[None, :] * 7  # at or past L
        return d, p, s, ln
    if name == "plen_zero":
        d, p, s, ln = _inputs(4, 2, 9, 300, 120, s_lo=-30, s_hi=250, p_lo=60,
                              p_hi=120)
        ln[:, ::3] = 0
        ln[:, 1::4] = -5
        return d, p, s, ln
    if name.startswith("l_"):
        l = {"1": 1, "8": 8, "9": 9, "tm1": t - 1, "t": t, "tp1": t + 1}[name[2:]]
        return _inputs(5 + l, 2, 7, l, max(l, 12), s_lo=-6, s_hi=max(l, 1),
                       p_lo=1, p_hi=max(l, 12) + 1)
    if name == "dense_tile":
        # 220 pieces reach the columns of tile 1 (two chunks of the staging)
        return _inputs(6, 1, 220, 2 * t + 40, 90, s_lo=t - 60, s_hi=2 * t - 10,
                       p_lo=40, p_hi=90, err=0.03)
    if name == "ragged":
        d, p, s, ln = _inputs(8, 5, 6, 600, 170, s_lo=-30, s_hi=560, p_lo=0,
                              p_hi=170)
        d[np.arange(600)[None, :] >= case_lengths(name)[:, None]] = 0
        return d, p, s, ln
    if name == "empty_contig":
        d, p, s, ln = _inputs(7, 3, 5, 300, 100, s_lo=-10, s_hi=280, p_lo=20,
                              p_hi=100)
        ln[1] = 0
        return d, p, s, ln
    raise ValueError(name)


def case_lengths(name):
    """Each contig's length: its row of the draft, but for ``ragged``."""
    if name == "ragged":
        return np.array([600, 37, 0, 257, 300], np.int32)
    draft = case_inputs(name)[0]
    return np.full(draft.shape[0], draft.shape[1], np.int32)


CASES = ["random", "plen_gt_lr", "neg_start", "start_ge_l", "plen_zero",
         "l_1", "l_8", "l_9", "l_tm1", "l_t", "l_tp1", "dense_tile",
         "empty_contig", "ragged"]
