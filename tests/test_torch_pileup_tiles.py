"""The tile-list algorithm of the port's pileup kernel (``csrc/pileup.cu``),
emulated in torch on the CPU, against the port's plain version
``pileup_vote_ref``, JAX's oracle and JAX's ``pileup_pallas`` in interpret
mode, bit for bit (the Pallas kernel off the columns where it departs from
its own oracle: it lets a piece longer than LR vote past LR).  The port
works on the packed layout (``kernels.pileup.ref.from_padded`` packs each
case, ``to_padded`` lays the outputs back out); JAX on the padded one, whose
columns past a contig's end the comparison leaves out.

The emulation follows the card's three launches: the count pass and the
fill pass (each piece listed in every tile of :data:`TILE` columns of its
contig that its vote columns reach, tiles numbered contig after contig; the
fill order reversed, as atomics may order it), then one vote block per tile
that visits only its list, forms the ballot words of "piece base == draft
base" inside the piece's window range (halo words masked to the 4 columns
the kernel ballots; the draft 0 past the contig's end, up to L), counts a
vote's matches with a popcount over the 64-bit window of three words, and
its comparable positions in closed form.  The cases are the parity traps
of the design: pieces longer than LR (a byte past LR reads byte LR - 1 and
still counts as valid), negative starts, starts at or past L, empty
pieces, L < 9, L not a multiple of the tile, a tile that 200 pieces reach,
a contig with no pieces and contigs of ragged lengths.  The kernel itself
is held to the plain version on the card in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pileup.pileup import pileup_pallas
from repro.kernels.pileup.ref import pileup_vote_ref as j_ref
from repro_torch.kernels import pileup_vote, pileup_vote_ref
from repro_torch.kernels.pileup import ops as pops
from repro_torch.kernels.pileup.ref import from_padded, to_padded

from _pileup_cases import CASES, case_inputs, case_lengths

TILE = pops.TILE
WARPS = TILE // 32
WINDOW = [k for k in range(9) if k != 4]  # the bits of 0x1EF


def _packed(case):
    """``(padded numpy args, packed torch args, kwargs, lengths)``."""
    args = case_inputs(case)
    lengths = torch.from_numpy(case_lengths(case))
    packed, kw = from_padded(*(torch.from_numpy(np.ascontiguousarray(x))
                               for x in args), lengths=lengths)
    return args, packed, kw, lengths


def _bins(lengths, contig, start, plen, lr):
    """The count pass, the cumsum and the fill pass: ``(tile_first,
    tile_contig, ends, slots)``."""
    tile_first, tile_contig = pops.tile_layout(lengths, int(lengths.sum()))
    lo, hi = pops.vote_ranges(start, plen, lengths[contig.long()], lr)
    cnt = torch.zeros(tile_contig.numel(), dtype=torch.int32)
    tiles = {}
    for p in range(start.numel()):
        if hi[p] > lo[p]:
            k0 = int(tile_first[contig[p]])
            ks = [k0 + t for t in range(int(lo[p]) // TILE,
                                        (int(hi[p]) - 1) // TILE + 1)]
            tiles[p] = ks
            for k in ks:
                cnt[k] += 1
    ends = torch.cumsum(cnt, 0, dtype=torch.int32)
    slots = torch.full((pops.list_capacity(start.numel(), lr),), -1,
                       dtype=torch.int32)
    for p, ks in reversed(list(tiles.items())):
        for k in ks:
            old = int(cnt[k])
            cnt[k] -= 1
            slots[int(ends[k]) - old] = p
    assert int(cnt.abs().sum()) == 0
    return tile_first, tile_contig, ends, slots


def _vote_block(drow, lc, pieces, start, plen, slots, t0, l, lr, min_depth):
    """One vote block: (polished, depth, agree) of the tile's columns; the
    draft reads 0 past the contig's end."""
    tid = torch.arange(TILE)
    col, lane, w = t0 + tid, tid % 32, tid // 32

    def draft_at(x):
        return torch.where(x < lc, drow[x.clamp(0, max(lc - 1, 0))], 0).long()

    d_own = draft_at(col)
    x = t0 - 32 + torch.arange(TILE + 64)  # the columns of words 0 .. WARPS+1
    halo = ((x >= t0 - 4) & (x < t0)) | ((x >= t0 + TILE) & (x < t0 + TILE + 4))
    ballot = (x >= t0) & (x < t0 + TILE) | halo
    shifts = torch.arange(32, dtype=torch.int64)
    counts = torch.zeros(TILE, 4, dtype=torch.int32)
    for p in slots.tolist():
        s, ln = int(start[p]), int(plen[p])
        lo, hi = max(s, 0), min(s + ln, l)
        inside = (x >= lo) & (x < hi)
        pbx = pieces[p][(x - s).clamp(0, lr - 1)].long()
        e = ballot & inside & (pbx == draft_at(x))
        words = (e.view(WARPS + 2, 32).long() << shifts).sum(1)
        big = (((words[w + 2] & 0x0FFFFFFF) << 36) | (words[w + 1] << 4)
               | (words[w] >> 28))
        match = sum(((big >> (lane + k)) & 1) for k in WINDOW)
        valid = torch.minimum(col + 5, torch.tensor(hi)) \
            - torch.maximum(col - 4, torch.tensor(lo)) - 1
        vhi = min(s + min(ln, lr), lc)
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


def emulate(draft, lengths, pieces, contig, start, plen, *, l, min_depth):
    """The card's algorithm on CPU tensors: (polished, depth, agree),
    packed."""
    lr = pieces.shape[1]
    tile_first, tile_contig, ends, slots = _bins(lengths, contig, start,
                                                 plen, lr)
    first = torch.cumsum(lengths.long(), 0) - lengths
    pol = torch.empty(draft.numel(), dtype=torch.uint8)
    dep = torch.empty(draft.numel(), dtype=torch.int32)
    agr = torch.empty(draft.numel(), dtype=torch.int32)
    for k in range(tile_contig.numel()):
        c = int(tile_contig[k])
        if c >= lengths.numel():
            continue  # past the last tile: the block returns
        lc, f = int(lengths[c]), int(first[c])
        t0 = (k - int(tile_first[c])) * TILE
        b0 = int(ends[k - 1]) if k else 0
        p, d, a = _vote_block(draft[f:f + lc], lc, pieces, start, plen,
                              slots[b0:int(ends[k])], t0, l, lr, min_depth)
        hi = min(TILE, lc - t0)
        pol[f + t0:f + t0 + hi] = p[:hi].to(torch.uint8)
        dep[f + t0:f + t0 + hi] = d[:hi]
        agr[f + t0:f + t0 + hi] = a[:hi]
    return pol, dep, agr


@pytest.mark.parametrize("min_depth", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_tile_list_emulation_matches_plain_and_jax(case, min_depth):
    args, packed, kw, lengths = _packed(case)
    l = kw["l"]

    def padded(out):
        return [x.numpy() for x in to_padded(out, lengths, l)]

    got = padded(emulate(*packed, **kw, min_depth=min_depth))
    ref = padded(pileup_vote_ref(*packed, **kw, min_depth=min_depth))
    port = padded(pileup_vote(*packed, **kw, min_depth=min_depth))
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
    # JAX's padded rows run past a contig's end; the packed ones do not
    live = np.arange(l)[None, :] < lengths.numpy()[:, None]
    assert live.all() == (case != "ragged")
    for g, r, p, o, q in zip(got, ref, port, orc, pal):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(g[live], np.asarray(o)[live])
        np.testing.assert_array_equal(g[~past & live],
                                      np.asarray(q)[~past & live])
    if case in ("random", "plen_gt_lr", "dense_tile", "ragged"):
        assert int(got[1].sum()) > 0  # votes were cast
    if case == "empty_contig":
        assert int(got[1][1].sum()) == 0
        np.testing.assert_array_equal(got[0][1], args[0][1])


@pytest.mark.parametrize("case", ["random", "plen_gt_lr", "neg_start",
                                  "start_ge_l", "plen_zero", "l_1",
                                  "dense_tile", "ragged"])
def test_tile_lists_hold_each_piece_once_per_tile(case):
    """The lists hold, per tile, exactly the pieces of the tile's contig
    whose vote columns reach the tile, once each, within the capacity sized
    from shapes alone; ``tile_entries`` counts them."""
    _, (draft, lengths, pieces, contig, start, plen), _, _ = _packed(case)
    lr = pieces.shape[1]
    tile_first, tile_contig, ends, slots = _bins(lengths, contig, start,
                                                 plen, lr)
    lc = lengths[contig.long()]
    total = int(ends[-1])
    assert total == int(pops.tile_entries(start, plen, lc, lr).sum())
    assert total <= pops.list_capacity(start.numel(), lr)
    lo, hi = pops.vote_ranges(start, plen, lc, lr)
    n_tiles = 0
    for k in range(tile_contig.numel()):
        c = int(tile_contig[k])
        got = sorted(slots[(int(ends[k - 1]) if k else 0):int(ends[k])].tolist())
        if c >= lengths.numel():
            assert got == []
            continue
        n_tiles += 1
        t = k - int(tile_first[c])
        assert 0 <= t * TILE < int(lengths[c])
        want = [p for p in range(start.numel()) if int(contig[p]) == c
                and lo[p] < min(hi[p], (t + 1) * TILE)
                and hi[p] > max(lo[p], t * TILE)]
        assert got == want
    assert n_tiles == sum(-(-int(x) // TILE) for x in lengths)
    if case == "dense_tile":
        assert int(ends[1] - ends[0]) >= 200


def test_vote_ranges_are_the_oracles_vote_columns():
    """A piece votes on column ``start + b`` of its contig exactly where the
    oracle lets it: ``0 <= b < min(plen, LR)`` and ``0 <= col < L_c``."""
    _, (draft, lengths, pieces, contig, start, plen), _, _ = _packed("ragged")
    lr = pieces.shape[1]
    lc = lengths[contig.long()]
    lo, hi = pops.vote_ranges(start, plen, lc, lr)
    b = torch.arange(lr)
    col = start[:, None].long() + b
    ok = (b < plen[:, None]) & (col >= 0) & (col < lc[:, None])
    for p in range(start.numel()):
        cols = col[p][ok[p]].tolist()
        assert cols == list(range(int(lo[p]), max(int(hi[p]), int(lo[p]))))
