"""The tile-list algorithm of the port's pileup kernel (``csrc/pileup.cu``),
emulated in torch on the CPU, against the port's plain version
``pileup_vote_ref``, JAX's oracle and JAX's ``pileup_pallas`` in interpret
mode, bit for bit (the Pallas kernel off the columns where it departs from
its own oracle: it lets a piece longer than LR vote past LR).

The emulation follows the card's three launches: the count pass and the
fill pass (each piece listed in every tile of :data:`TILE` columns its vote
columns reach; the fill order reversed, as atomics may order it), then one
vote block per (contig, tile) that visits only its list, forms the ballot
words of "piece base == draft base" inside the piece's window range (halo
words masked to the 4 columns the kernel ballots), counts a vote's matches
with a popcount over the 64-bit window of three words, and its comparable
positions in closed form.  The cases are the parity traps of the design:
pieces longer than LR (a byte past LR reads byte LR - 1 and still counts as
valid), negative starts, starts at or past L, empty pieces, L < 9, L not a
multiple of the tile, a tile that 200 pieces reach, and a contig with no
pieces.  The kernel itself is held to the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pileup.pileup import pileup_pallas
from repro.kernels.pileup.ref import pileup_vote_ref as j_ref
from repro_torch.kernels import pileup_vote, pileup_vote_ref
from repro_torch.kernels.pileup import ops as pops

from _pileup_cases import CASES, case_inputs

TILE = pops.TILE
WARPS = TILE // 32
WINDOW = [k for k in range(9) if k != 4]  # the bits of 0x1EF


def _bins(start, plen, l, lr):
    """The count pass, the cumsum and the fill pass: ``(ends, slots)``."""
    c, m = start.shape
    nt = -(-l // TILE)
    lo, hi = pops.vote_ranges(start, plen, l, lr)
    cnt = torch.zeros(c * nt, dtype=torch.int32)
    tiles = {}
    for ci in range(c):
        for pm in range(m):
            if hi[ci, pm] > lo[ci, pm]:
                ks = [ci * nt + t for t in range(int(lo[ci, pm]) // TILE,
                                                 (int(hi[ci, pm]) - 1) // TILE + 1)]
                tiles[ci, pm] = ks
                for k in ks:
                    cnt[k] += 1
    ends = torch.cumsum(cnt, 0, dtype=torch.int32)
    slots = torch.full((pops.list_capacity(c, m, lr),), -1, dtype=torch.int32)
    for (ci, pm), ks in reversed(list(tiles.items())):
        for k in ks:
            old = int(cnt[k])
            cnt[k] -= 1
            slots[int(ends[k]) - old] = pm
    assert int(cnt.abs().sum()) == 0
    return ends, slots


def _vote_block(drow, prows, start, plen, slots, t0, l, lr, min_depth):
    """One vote block: (polished, depth, agree) of the tile's columns."""
    tid = torch.arange(TILE)
    col, lane, w = t0 + tid, tid % 32, tid // 32
    d_own = torch.where(col < l, drow[col.clamp(max=l - 1)], 0).long()
    x = t0 - 32 + torch.arange(TILE + 64)  # the columns of words 0 .. WARPS+1
    halo = ((x >= t0 - 4) & (x < t0)) | ((x >= t0 + TILE) & (x < t0 + TILE + 4))
    ballot = (x >= t0) & (x < t0 + TILE) | halo
    shifts = torch.arange(32, dtype=torch.int64)
    counts = torch.zeros(TILE, 4, dtype=torch.int32)
    for slot in slots.tolist():
        s, ln = int(start[slot]), int(plen[slot])
        lo, hi = max(s, 0), min(s + ln, l)
        inside = (x >= lo) & (x < hi)
        pbx = prows[slot][(x - s).clamp(0, lr - 1)].long()
        e = ballot & inside & (pbx == drow[x.clamp(0, l - 1)].long())
        words = (e.view(WARPS + 2, 32).long() << shifts).sum(1)
        big = (((words[w + 2] & 0x0FFFFFFF) << 36) | (words[w + 1] << 4)
               | (words[w] >> 28))
        match = sum(((big >> (lane + k)) & 1) for k in WINDOW)
        valid = torch.minimum(col + 5, torch.tensor(hi)) \
            - torch.maximum(col - 4, torch.tensor(lo)) - 1
        vhi = min(s + min(ln, lr), l)
        vote = (col >= lo) & (col < vhi) & (4 * match >= 3 * valid) \
            & (valid >= 4)
        base = pbx[32:32 + TILE].clamp(max=3)
        counts[tid[vote], base[vote]] += 1
    depth = counts.sum(1)
    best, winner = counts[:, 0].clone(), torch.zeros(TILE, dtype=torch.int64)
    for q in range(1, 4):
        better = counts[:, q] > best
        best = torch.where(better, counts[:, q], best)
        winner = torch.where(better, q, winner)
    pol = torch.where((depth >= min_depth) & (2 * best > depth), winner, d_own)
    agree = torch.gather(counts, 1, pol.clamp(max=3)[:, None])[:, 0]
    agree = torch.where(pol <= 3, agree, 0)
    return pol, depth, agree


def emulate(draft, pieces, start, plen, *, min_depth):
    """The card's algorithm on CPU tensors: (polished, depth, agree)."""
    c, l = draft.shape
    lr = pieces.shape[2]
    nt = -(-l // TILE)
    ends, slots = _bins(start, plen, l, lr)
    pol = torch.empty((c, l), dtype=torch.uint8)
    dep = torch.empty((c, l), dtype=torch.int32)
    agr = torch.empty((c, l), dtype=torch.int32)
    for ci in range(c):
        for t in range(nt):
            k = ci * nt + t
            b0 = int(ends[k - 1]) if k else 0
            p, d, a = _vote_block(draft[ci], pieces[ci], start[ci], plen[ci],
                                  slots[b0:int(ends[k])], t * TILE, l, lr,
                                  min_depth)
            hi = min(TILE, l - t * TILE)
            pol[ci, t * TILE:t * TILE + hi] = p[:hi].to(torch.uint8)
            dep[ci, t * TILE:t * TILE + hi] = d[:hi]
            agr[ci, t * TILE:t * TILE + hi] = a[:hi]
    return pol, dep, agr


@pytest.mark.parametrize("min_depth", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_tile_list_emulation_matches_plain_and_jax(case, min_depth):
    args = case_inputs(case)
    t_args = [torch.from_numpy(np.ascontiguousarray(x)) for x in args]
    got = emulate(*t_args, min_depth=min_depth)
    ref = pileup_vote_ref(*t_args, min_depth=min_depth)
    port = pileup_vote(*t_args, min_depth=min_depth)
    orc = j_ref(*map(jnp.asarray, args), min_depth=min_depth)
    pal = pileup_pallas(*map(jnp.asarray, args), min_depth=min_depth,
                        band=128, interpret=True)
    # JAX's Pallas kernel lacks its oracle's ``b < LR``: where a piece
    # claims more than LR bases it votes byte LR - 1 on the columns past
    # LR, so there it is held only off those columns
    past = np.zeros(args[0].shape, bool)
    lr = args[1].shape[2]
    for ci, pm in zip(*np.nonzero(args[3] > lr)):
        s = int(args[2][ci, pm])
        past[ci, max(s + lr, 0):max(s + int(args[3][ci, pm]), 0)] = True
    assert past.any() == (case == "plen_gt_lr")
    for g, r, p, o, q in zip(got, ref, port, orc, pal):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
        np.testing.assert_array_equal(p.numpy(), r.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))
        np.testing.assert_array_equal(g.numpy()[~past], np.asarray(q)[~past])
    if case in ("random", "plen_gt_lr", "dense_tile"):
        assert int(got[1].sum()) > 0  # votes were cast
    if case == "empty_contig":
        assert int(got[1][1].sum()) == 0
        np.testing.assert_array_equal(got[0][1].numpy(), args[0][1])


@pytest.mark.parametrize("case", ["random", "plen_gt_lr", "neg_start",
                                  "start_ge_l", "plen_zero", "l_1",
                                  "dense_tile"])
def test_tile_lists_hold_each_piece_once_per_tile(case):
    """The lists hold, per (contig, tile), exactly the pieces whose vote
    columns reach the tile, once each, within the capacity sized from
    shapes alone; ``tile_entries`` counts them."""
    draft, pieces, start, plen = (torch.from_numpy(x) for x in case_inputs(case))
    c, l = draft.shape
    lr = pieces.shape[2]
    nt = -(-l // TILE)
    ends, slots = _bins(start, plen, l, lr)
    total = int(ends[-1])
    assert total == int(pops.tile_entries(start, plen, l, lr).sum())
    assert total <= pops.list_capacity(c, *pieces.shape[1:])
    lo, hi = pops.vote_ranges(start, plen, l, lr)
    for ci in range(c):
        for t in range(nt):
            k = ci * nt + t
            got = sorted(slots[(int(ends[k - 1]) if k else 0):int(ends[k])].tolist())
            want = [pm for pm in range(start.shape[1])
                    if lo[ci, pm] < min(hi[ci, pm], (t + 1) * TILE)
                    and hi[ci, pm] > max(lo[ci, pm], t * TILE)]
            assert got == want
    if case == "dense_tile":
        assert int(ends[1] - ends[0]) >= 200


def test_vote_ranges_are_the_oracles_vote_columns():
    """A piece votes on column ``start + b`` exactly where the oracle lets
    it: ``0 <= b < min(plen, LR)`` and ``0 <= col < L``."""
    draft, pieces, start, plen = (torch.from_numpy(x) for x in case_inputs("plen_zero"))
    l, lr = draft.shape[1], pieces.shape[2]
    lo, hi = pops.vote_ranges(start, plen, l, lr)
    b = torch.arange(lr)
    col = start[..., None].long() + b
    ok = (b < plen[..., None]) & (col >= 0) & (col < l)
    for ci in range(start.shape[0]):
        for pm in range(start.shape[1]):
            cols = col[ci, pm][ok[ci, pm]].tolist()
            assert cols == list(range(int(lo[ci, pm]), max(int(hi[ci, pm]),
                                                           int(lo[ci, pm]))))
