"""Wrapper of the sampled min-plus kernel (``csrc/spgemm_masked.cu``) +
dispatch registration of the ``spgemm_masked`` op.

``spgemm_masked_minplus(a_cols, a_vals, b_cols, b_vals, m_cols)`` is
``⊕_k A[i,k] ⊗ B[k, m_cols[i,q]]`` over the min-plus orientation semiring
at every slot of the mask's pattern: a ``(n, K_M, 4)`` f32 tensor, +inf
where nothing is found and in the mask's empty slots (the values of
``core.spgemm.spgemm_masked(A, B, M).vals[MP]``).  It launches the kernel
for CUDA tensors (one launch a call) and runs the plain version
(``ref.py``) for CPU tensors.  The three operands are ELL: rows sorted
ascending, empty slots (-1) last, no column twice in a row; an A column
past B's rows selects nothing.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.backend import register_op
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import spgemm_masked_minplus_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("spgemm_masked", [_P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _P])
#: warps (rows) of a block and the shared bytes a mask slot takes in one
#: (``csrc/spgemm_masked.cu``); a block may use 232,448 bytes on Hopper
WARPS = 8
SLOT_BYTES = 20
MAX_SHARED_BYTES = 232448


def spgemm_masked_minplus(a_cols, a_vals, b_cols, b_vals, m_cols):
    """a_cols (n, K_A), b_cols (n_b, K_B), m_cols (n, K_M) int32; a_vals
    (n, K_A, 4), b_vals (n_b, K_B, 4) f32 -> (n, K_M, 4) f32."""
    tensors = dict(a_cols=a_cols, a_vals=a_vals, b_cols=b_cols,
                   b_vals=b_vals, m_cols=m_cols)
    if all(t.device.type == "cpu" for t in tensors.values()):
        return spgemm_masked_minplus_ref(a_cols, a_vals, b_cols, b_vals,
                                         m_cols)
    dev = check_cuda("spgemm_masked", **tensors)
    for key in ("a_cols", "b_cols", "m_cols"):
        check_dtype("spgemm_masked", tensors[key], torch.int32, key)
    for key in ("a_vals", "b_vals"):
        check_dtype("spgemm_masked", tensors[key], torch.float32, key)
        if tensors[key].data_ptr() % 16:
            raise ValueError(f"spgemm_masked: {key} must be 16-byte aligned")
    n, ka = a_cols.shape
    nb, kb = b_cols.shape
    km = m_cols.shape[1]
    if tuple(a_vals.shape) != (n, ka, 4) or tuple(b_vals.shape) != (nb, kb, 4) \
            or m_cols.shape[0] != n:
        raise ValueError(
            f"spgemm_masked: need a_cols (n, K_A), a_vals (n, K_A, 4), b_cols "
            f"(n_b, K_B), b_vals (n_b, K_B, 4), m_cols (n, K_M); got "
            f"{tuple(a_cols.shape)}, {tuple(a_vals.shape)}, "
            f"{tuple(b_cols.shape)}, {tuple(b_vals.shape)}, "
            f"{tuple(m_cols.shape)}")
    if WARPS * SLOT_BYTES * km > MAX_SHARED_BYTES:
        raise ValueError(f"spgemm_masked: mask rows of {km} slots do not fit "
                         f"a block's shared memory")
    out = torch.empty((n, km, 4), dtype=torch.float32, device=dev)
    if n and km:
        with span("kernel_launch", kind="kernel", kernel="spgemm_masked",
                  rows=n, ka=ka, kb=kb, km=km):
            KERNEL.launch(a_cols.data_ptr(), a_vals.data_ptr(),
                          b_cols.data_ptr(), b_vals.data_ptr(),
                          m_cols.data_ptr(), out.data_ptr(), n, ka, nb, kb,
                          km, stream_handle(a_cols))
    return out


register_op("spgemm_masked", "cuda", spgemm_masked_minplus)
register_op("spgemm_masked", "reference", spgemm_masked_minplus_ref)
