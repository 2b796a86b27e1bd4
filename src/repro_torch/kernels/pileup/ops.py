"""Wrapper of the pileup-vote kernels (``csrc/pileup.cu``) + dispatch
registration of the ``consensus`` op (``(draft, pieces, start, plen, *,
min_depth) -> (polished, depth, agree)``).

A call is three launches of the library and no host read:
:func:`tile_lists` (a count pass and a fill pass, with a device cumsum
between them) lists, for every (contig, tile of :data:`TILE` columns), the
piece slots whose vote columns reach the tile; the vote launch then runs
one block per (contig, tile) over its list only.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.backend import register_op
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import pileup_vote_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the vote launch: (draft, pieces, start, plen, ends, list, polished,
#: depth, agree, C, L, M, LR, min_depth, stream)
KERNEL = CudaKernel("pileup", [_P] * 9 + [_I] * 5 + [_P])
_BIN_COUNT_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P]
_BIN_FILL_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
#: columns of a tile: the threads of one vote block (``csrc/pileup.cu``)
TILE = 256


def vote_ranges(start, plen, l: int, lr: int):
    """The columns each piece votes on, ``[lo, hi)`` (empty where ``hi <=
    lo``): ``0 <= col - start < min(plen, LR)`` and ``0 <= col < L``.
    ``(C, M)`` int64 each."""
    lo = start.long().clamp(min=0)
    hi = (start.long() + plen.long().clamp(max=lr)).clamp(max=l)
    return lo, hi


def list_capacity(c: int, m: int, lr: int) -> int:
    """Entries the tile lists of a call may need, from shapes alone: a
    piece's vote columns (at most LR of them) reach at most ``ceil(LR /
    TILE) + 1`` tiles."""
    return max(c * m * (-(-lr // TILE) + 1), 1)


def tile_entries(start, plen, l: int, lr: int) -> torch.Tensor:
    """Per piece, the tiles its vote columns reach (``(C, M)`` int64): the
    entries it adds to the tile lists."""
    lo, hi = vote_ranges(start, plen, l, lr)
    return torch.where(hi > lo, (hi - 1) // TILE - lo // TILE + 1, 0)


def _check(draft, pieces, start, plen):
    dev = check_cuda("pileup", draft=draft, pieces=pieces, start=start,
                     plen=plen)
    check_dtype("pileup", draft, torch.uint8, "draft")
    check_dtype("pileup", pieces, torch.uint8, "pieces")
    check_dtype("pileup", start, torch.int32, "start")
    check_dtype("pileup", plen, torch.int32, "plen")
    c = draft.shape[0]
    if draft.dim() != 2 or pieces.dim() != 3 or pieces.shape[0] != c \
            or tuple(start.shape) != tuple(pieces.shape[:2]) \
            or tuple(plen.shape) != tuple(pieces.shape[:2]):
        raise ValueError("pileup: need draft (C, L), pieces (C, M, LR), "
                         "start/plen (C, M)")
    return dev


def tile_lists(start, plen, l: int, lr: int, stream=None):
    """The tile lists of a call, on the card: ``(ends, slots)``, where the
    slots of tile ``t`` of contig ``c`` (``k = c * ceil(L / TILE) + t``)
    are ``slots[ends[k - 1]:ends[k]]`` in no fixed order.  Two launches and
    a device cumsum; nothing is read to the host."""
    c, m = start.shape
    nt = -(-l // TILE)
    dev = start.device
    cnt = torch.zeros(c * nt, dtype=torch.int32, device=dev)
    slots = torch.empty(list_capacity(c, m, lr), dtype=torch.int32, device=dev)
    stream = stream_handle(start) if stream is None else stream
    with span("kernel_launch", kind="kernel", kernel="pileup_vote",
              phase="bin_count", pieces=c * m):
        KERNEL.launch(start.data_ptr(), plen.data_ptr(), cnt.data_ptr(), c, m,
                      l, lr, stream,
                      entry=KERNEL.entry("pileup_bin_count", _BIN_COUNT_ARGS))
    ends = torch.cumsum(cnt, 0, dtype=torch.int32)
    with span("kernel_launch", kind="kernel", kernel="pileup_vote",
              phase="bin_fill", pieces=c * m):
        KERNEL.launch(start.data_ptr(), plen.data_ptr(), cnt.data_ptr(),
                      ends.data_ptr(), slots.data_ptr(), c, m, l, lr, stream,
                      entry=KERNEL.entry("pileup_bin_fill", _BIN_FILL_ARGS))
    return ends, slots


def vote_tiles(draft, pieces, start, plen, ends, slots, *, min_depth: int = 2,
               stream=None):
    """The vote launch over the tile lists of :func:`tile_lists`."""
    c, l = draft.shape
    m, lr = pieces.shape[1], pieces.shape[2]
    dev = draft.device
    pol = torch.empty((c, l), dtype=torch.uint8, device=dev)
    dep = torch.empty((c, l), dtype=torch.int32, device=dev)
    agr = torch.empty((c, l), dtype=torch.int32, device=dev)
    with span("kernel_launch", kind="kernel", kernel="pileup_vote",
              phase="vote", contigs=c, tiles=c * -(-l // TILE)):
        KERNEL.launch(draft.data_ptr(), pieces.data_ptr(), start.data_ptr(),
                      plen.data_ptr(), ends.data_ptr(), slots.data_ptr(),
                      pol.data_ptr(), dep.data_ptr(), agr.data_ptr(), c, l, m,
                      lr, min_depth,
                      stream_handle(draft) if stream is None else stream)
    return pol, dep, agr


def pileup_vote(draft, pieces, start, plen, *, min_depth: int = 2):
    """Banded pileup + majority vote: draft (C, L) uint8, pieces (C, M, LR)
    uint8, start/plen (C, M) int32 -> (polished (C, L) uint8, depth (C, L)
    int32, agree (C, L) int32)."""
    args = dict(draft=draft, pieces=pieces, start=start, plen=plen)
    if all(t.device.type == "cpu" for t in args.values()):
        return pileup_vote_ref(draft, pieces, start, plen, min_depth=min_depth)
    dev = _check(draft, pieces, start, plen)
    c, l = draft.shape
    if not (c and l):
        return (torch.empty((c, l), dtype=torch.uint8, device=dev),
                *(torch.empty((c, l), dtype=torch.int32, device=dev)
                  for _ in range(2)))
    stream = stream_handle(draft)
    ends, slots = tile_lists(start, plen, l, pieces.shape[2], stream)
    return vote_tiles(draft, pieces, start, plen, ends, slots,
                      min_depth=min_depth, stream=stream)


register_op("consensus", "cuda", pileup_vote)
register_op("consensus", "reference", pileup_vote_ref)
