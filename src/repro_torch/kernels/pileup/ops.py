"""Wrapper of the pileup-vote kernel (``csrc/pileup.cu``) + dispatch
registration of the ``consensus`` op (``(draft, pieces, start, plen, *,
min_depth) -> (polished, depth, agree)``)."""

from __future__ import annotations

import ctypes

import torch

from ...core.backend import register_op
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import pileup_vote_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("pileup", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _P])


def pileup_vote(draft, pieces, start, plen, *, min_depth: int = 2):
    """Banded pileup + majority vote: draft (C, L) uint8, pieces (C, M, LR)
    uint8, start/plen (C, M) int32 -> (polished (C, L) uint8, depth (C, L)
    int32, agree (C, L) int32)."""
    args = dict(draft=draft, pieces=pieces, start=start, plen=plen)
    if all(t.device.type == "cpu" for t in args.values()):
        return pileup_vote_ref(draft, pieces, start, plen, min_depth=min_depth)
    dev = check_cuda("pileup", **args)
    check_dtype("pileup", draft, torch.uint8, "draft")
    check_dtype("pileup", pieces, torch.uint8, "pieces")
    check_dtype("pileup", start, torch.int32, "start")
    check_dtype("pileup", plen, torch.int32, "plen")
    c, l = draft.shape
    if pieces.dim() != 3 or pieces.shape[0] != c \
            or tuple(start.shape) != tuple(pieces.shape[:2]) \
            or tuple(plen.shape) != tuple(pieces.shape[:2]):
        raise ValueError("pileup: need draft (C, L), pieces (C, M, LR), "
                         "start/plen (C, M)")
    m, lr = pieces.shape[1], pieces.shape[2]
    pol = torch.empty((c, l), dtype=torch.uint8, device=dev)
    dep = torch.empty((c, l), dtype=torch.int32, device=dev)
    agr = torch.empty((c, l), dtype=torch.int32, device=dev)
    if c and l:
        with span("kernel_launch", kind="kernel", kernel="pileup_vote",
                  contigs=c):
            KERNEL.launch(draft.data_ptr(), pieces.data_ptr(),
                          start.data_ptr(), plen.data_ptr(), pol.data_ptr(),
                          dep.data_ptr(), agr.data_ptr(), c, l, m, lr,
                          min_depth, stream_handle(draft))
    return pol, dep, agr


register_op("consensus", "cuda", pileup_vote)
register_op("consensus", "reference", pileup_vote_ref)
