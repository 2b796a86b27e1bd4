"""Wrapper of the pileup-vote kernels (``csrc/pileup.cu``) + dispatch
registration of the ``consensus`` op (``(draft, lengths, pieces, contig,
start, plen, *, l, min_depth) -> (polished, depth, agree)``, on the packed
layout of ``ref.pileup_vote_ref``).

A call is three launches of the library and no host read:
:func:`tile_lists` (a count pass and a fill pass, with a device cumsum
between them) lists, for every tile of :data:`TILE` columns of a contig,
the pieces whose vote columns reach the tile; the vote launch then runs one
block per tile over its list only.  A contig of ``L_c`` columns has
``ceil(L_c / TILE)`` tiles, numbered contig after contig
(:func:`tile_layout`).
"""

from __future__ import annotations

import ctypes

import torch

from ...core.backend import register_op
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import pileup_vote_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the vote launch: (draft, pieces, start, plen, tile_contig, tile_first,
#: first, lengths, ends, list, polished, depth, agree, C, tiles, L, LR,
#: min_depth, stream)
KERNEL = CudaKernel("pileup", [_P] * 13 + [_I] * 5 + [_P])
_BIN_COUNT_ARGS = [_P] * 6 + [_I, _I, _P]
_BIN_FILL_ARGS = [_P] * 8 + [_I, _I, _P]
#: columns of a tile: the threads of one vote block (``csrc/pileup.cu``)
TILE = 256


def vote_ranges(start, plen, lc, lr: int):
    """The columns each piece votes on, ``[lo, hi)`` (empty where ``hi <=
    lo``): ``0 <= col - start < min(plen, LR)`` and ``0 <= col < lc``, the
    piece's contig's length.  int64 each."""
    lo = start.long().clamp(min=0)
    hi = torch.minimum(start.long() + plen.long().clamp(max=lr), lc.long())
    return lo, hi


def list_capacity(p: int, lr: int) -> int:
    """Entries the tile lists of a call may need, from shapes alone: a
    piece's vote columns (at most LR of them) reach at most ``ceil(LR /
    TILE) + 1`` tiles."""
    return max(p * (-(-lr // TILE) + 1), 1)


def tile_entries(start, plen, lc, lr: int) -> torch.Tensor:
    """Per piece, the tiles its vote columns reach (int64): the entries it
    adds to the tile lists."""
    lo, hi = vote_ranges(start, plen, lc, lr)
    return torch.where(hi > lo, (hi - 1) // TILE - lo // TILE + 1, 0)


def tile_layout(lengths, total: int):
    """The tiles of a call: ``(tile_first, tile_contig)``.  Contig ``c``'s
    tiles are ``tile_first[c] ..``, ``ceil(lengths[c] / TILE)`` of them
    (``(C,)`` int64); ``tile_contig`` (int32) names each tile's contig, C
    past the last tile.  Its length, ``total // TILE + C``, bounds the
    tiles from shapes alone, so nothing is read to the host."""
    nt = torch.div(lengths.long() + TILE - 1, TILE, rounding_mode="floor")
    end = torch.cumsum(nt, 0)
    n = total // TILE + lengths.numel()
    tile_contig = torch.searchsorted(
        end, torch.arange(n, device=lengths.device), right=True)
    return end - nt, tile_contig.to(torch.int32)


def _check(draft, lengths, pieces, contig, start, plen):
    dev = check_cuda("pileup", draft=draft, lengths=lengths, pieces=pieces,
                     contig=contig, start=start, plen=plen)
    check_dtype("pileup", draft, torch.uint8, "draft")
    check_dtype("pileup", lengths, torch.int32, "lengths")
    check_dtype("pileup", pieces, torch.uint8, "pieces")
    for name, t in (("contig", contig), ("start", start), ("plen", plen)):
        check_dtype("pileup", t, torch.int32, name)
    p = pieces.shape[0]
    if draft.dim() != 1 or lengths.dim() != 1 or pieces.dim() != 2 \
            or any(tuple(t.shape) != (p,) for t in (contig, start, plen)):
        raise ValueError("pileup: need draft (B,), lengths (C,), pieces "
                         "(P, LR), contig/start/plen (P,)")
    return dev


def tile_lists(lengths, contig, start, plen, tile_first, n_tiles: int,
               lr: int, stream=None):
    """The tile lists of a call, on the card: ``(ends, slots)``, where the
    pieces of tile ``k`` (:func:`tile_layout`'s numbering) are
    ``slots[ends[k - 1]:ends[k]]`` in no fixed order.  Two launches and a
    device cumsum; nothing is read to the host."""
    p = start.numel()
    dev = start.device
    cnt = torch.zeros(max(n_tiles, 1), dtype=torch.int32, device=dev)
    slots = torch.empty(list_capacity(p, lr), dtype=torch.int32, device=dev)
    stream = stream_handle(start) if stream is None else stream
    with span("kernel_launch", kind="kernel", kernel="pileup_vote",
              phase="bin_count", pieces=p):
        KERNEL.launch(start.data_ptr(), plen.data_ptr(), contig.data_ptr(),
                      lengths.data_ptr(), tile_first.data_ptr(),
                      cnt.data_ptr(), p, lr, stream,
                      entry=KERNEL.entry("pileup_bin_count", _BIN_COUNT_ARGS))
    ends = torch.cumsum(cnt, 0, dtype=torch.int32)
    with span("kernel_launch", kind="kernel", kernel="pileup_vote",
              phase="bin_fill", pieces=p):
        KERNEL.launch(start.data_ptr(), plen.data_ptr(), contig.data_ptr(),
                      lengths.data_ptr(), tile_first.data_ptr(),
                      cnt.data_ptr(), ends.data_ptr(), slots.data_ptr(), p,
                      lr, stream,
                      entry=KERNEL.entry("pileup_bin_fill", _BIN_FILL_ARGS))
    return ends, slots


def vote_tiles(draft, lengths, pieces, start, plen, tile_first, tile_contig,
               ends, slots, *, l: int, min_depth: int = 2, stream=None):
    """The vote launch over the tile lists of :func:`tile_lists`."""
    dev = draft.device
    total = draft.numel()
    first = torch.cumsum(lengths.long(), 0) - lengths
    pol = torch.empty(total, dtype=torch.uint8, device=dev)
    dep = torch.empty(total, dtype=torch.int32, device=dev)
    agr = torch.empty(total, dtype=torch.int32, device=dev)
    with span("kernel_launch", kind="kernel", kernel="pileup_vote",
              phase="vote", contigs=lengths.numel(),
              tiles=tile_contig.numel()):
        KERNEL.launch(draft.data_ptr(), pieces.data_ptr(), start.data_ptr(),
                      plen.data_ptr(), tile_contig.data_ptr(),
                      tile_first.data_ptr(), first.data_ptr(),
                      lengths.data_ptr(), ends.data_ptr(), slots.data_ptr(),
                      pol.data_ptr(), dep.data_ptr(), agr.data_ptr(),
                      lengths.numel(), tile_contig.numel(), l,
                      pieces.shape[1], min_depth,
                      stream_handle(draft) if stream is None else stream)
    return pol, dep, agr


def pileup_vote(draft, lengths, pieces, contig, start, plen, *, l: int,
                min_depth: int = 2):
    """Banded pileup + majority vote on the packed layout (see
    :func:`ref.pileup_vote_ref`): draft (B,) uint8, lengths (C,) int32,
    pieces (P, LR) uint8, contig/start/plen (P,) int32 -> (polished (B,)
    uint8, depth (B,) int32, agree (B,) int32)."""
    args = (draft, lengths, pieces, contig, start, plen)
    if all(t.device.type == "cpu" for t in args):
        return pileup_vote_ref(*args, l=l, min_depth=min_depth)
    dev = _check(*args)
    total = draft.numel()
    if not (total and lengths.numel()):
        return (torch.empty(total, dtype=torch.uint8, device=dev),
                *(torch.empty(total, dtype=torch.int32, device=dev)
                  for _ in range(2)))
    stream = stream_handle(draft)
    tile_first, tile_contig = tile_layout(lengths, total)
    ends, slots = tile_lists(lengths, contig, start, plen, tile_first,
                             tile_contig.numel(), pieces.shape[1], stream)
    return vote_tiles(draft, lengths, pieces, start, plen, tile_first,
                      tile_contig, ends, slots, l=l, min_depth=min_depth,
                      stream=stream)


register_op("consensus", "cuda", pileup_vote)
register_op("consensus", "reference", pileup_vote_ref)
