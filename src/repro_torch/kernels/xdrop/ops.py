"""Wrapper of the x-drop kernel (``csrc/xdrop.cu``) + dispatch registration.

``xdrop_extend_batch`` launches the CUDA kernel for CUDA tensors and runs
the plain version (``ref.py``) for CPU tensors; a CUDA request it cannot
launch raises.  Any band >= 1 runs: up to :data:`WARP_BAND` the one-warp
instance, above it the block instance (``csrc/xdrop.cu``).  Both backends of the ``xdrop_extend`` op share one
signature: the walks (bases, steps, lengths) are ``(E,)`` for one
direction or ``(D, E)`` for ``D`` directions over the same rows of ``a``
and ``b``, which one launch runs as ``D · E`` pairs.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.backend import register_op
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import check_walk_shapes, xdrop_extend_batch_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("xdrop", [
    _P, _I, _P, _P, _P,  # a, lda, base_a, step_a, len_a
    _P, _I, _P, _P, _P,  # b, ldb, base_b, step_b, len_b
    _P, _I, _I,  # order (scratch, written by the launch), rows, pairs
    _I, _I, _I, _I, _I, _I,  # band, max_steps, xdrop, match, mismatch, gap
    _P, _P, _P, _P, _P,  # score, ai, bj, scratch, stream
])
#: the widest band of the one-warp instance (128 cells of one parity: 4 a
#: lane); wider bands run the block instance
WARP_BAND = 256
#: the block instance keeps its two rows of ``band`` ints in shared memory
#: up to this many bytes, else in global scratch for its WIDE_GRID blocks
#: (``csrc/xdrop.cu``)
WIDE_MAX_SHARED = 200 * 1024
WIDE_GRID = 512


def scratch_bytes(band: int) -> int:
    """Global scratch a launch at ``band`` needs (``csrc/xdrop.cu:
    xdrop_scratch_bytes``): the block instance's rows where they do not fit
    in shared memory, else 0."""
    if band <= WARP_BAND or 8 * band <= WIDE_MAX_SHARED:
        return 0
    return 8 * band * WIDE_GRID


def xdrop_extend_batch(a, base_a, step_a, len_a, b, base_b, step_b, len_b, *,
                       xdrop: int = 15, match: int = 1, mismatch: int = -1,
                       gap: int = -1, band: int = 33, max_steps: int = 256):
    """Batched x-drop extension: ``a`` (E, LA) and ``b`` (E, LB) uint8, the
    bases/steps/lengths (E,) or (D, E) int32 → (score, ai, bj) int32 of the
    walks' shape."""
    args = dict(a=a, base_a=base_a, step_a=step_a, len_a=len_a, b=b,
                base_b=base_b, step_b=step_b, len_b=len_b)
    if all(t.device.type == "cpu" for t in args.values()):
        return xdrop_extend_batch_ref(
            a, base_a, step_a, len_a, b, base_b, step_b, len_b, xdrop=xdrop,
            match=match, mismatch=mismatch, gap=gap, band=band,
            max_steps=max_steps,
        )
    dev = check_cuda("xdrop", **args)
    shape = check_walk_shapes(a, b, args)
    for key in ("a", "b"):
        check_dtype("xdrop", args[key], torch.uint8, key)
    for key in ("base_a", "step_a", "len_a", "base_b", "step_b", "len_b"):
        check_dtype("xdrop", args[key], torch.int32, key)
    if band < 1:
        raise ValueError(f"xdrop: band must be >= 1, got {band}")
    score, ai, bj = (torch.empty(shape, dtype=torch.int32, device=dev)
                     for _ in range(3))
    pairs = score.numel()
    if pairs == 0:
        return score, ai, bj
    order = torch.empty(pairs, dtype=torch.int32, device=dev)  # scratch
    # the block instance's rows, where they do not fit in shared memory
    rows_bytes = scratch_bytes(band)
    rows = torch.empty(rows_bytes, dtype=torch.uint8, device=dev) \
        if rows_bytes else None
    with span("kernel_launch", kind="kernel", kernel="xdrop_extend",
              pairs=pairs, band=band,
              instance="warp" if band <= WARP_BAND else "block"):
        KERNEL.launch(
            a.data_ptr(), a.shape[1], base_a.data_ptr(), step_a.data_ptr(),
            len_a.data_ptr(), b.data_ptr(), b.shape[1], base_b.data_ptr(),
            step_b.data_ptr(), len_b.data_ptr(), order.data_ptr(), a.shape[0],
            pairs, band, max_steps, xdrop, match, mismatch, gap,
            score.data_ptr(), ai.data_ptr(), bj.data_ptr(),
            rows.data_ptr() if rows is not None else None, stream_handle(a),
        )
    return score, ai, bj


register_op("xdrop_extend", "cuda", xdrop_extend_batch)
register_op("xdrop_extend", "reference", xdrop_extend_batch_ref)
