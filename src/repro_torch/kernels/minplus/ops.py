"""Wrapper of the min-plus kernel (``csrc/minplus.cu``) + dispatch
registration of the ``minplus_dense`` op (``(a, b) -> n``)."""

from __future__ import annotations

import ctypes

import torch

from ...core.backend import register_op
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import minplus_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("minplus", [_P, _P, _P, _I, _I, _I, _P])


def minplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense orientation-resolved min-plus product: a (M, K, 4), b (K, N, 4)
    f32 -> (M, N, 4) f32."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return minplus_matmul_ref(a, b)
    dev = check_cuda("minplus", a=a, b=b)
    check_dtype("minplus", a, torch.float32, "a")
    check_dtype("minplus", b, torch.float32, "b")
    if a.dim() != 3 or b.dim() != 3 or a.shape[2] != 4 or b.shape[2] != 4 \
            or a.shape[1] != b.shape[0]:
        raise ValueError(f"minplus: need a (M, K, 4), b (K, N, 4); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    for key, t in (("a", a), ("b", b)):
        if t.data_ptr() % 16:
            raise ValueError(f"minplus: {key} must be 16-byte aligned")
    m, k, _ = a.shape
    n = b.shape[1]
    out = torch.empty((m, n, 4), dtype=torch.float32, device=dev)
    if m and n:
        with span("kernel_launch", kind="kernel", kernel="minplus_dense",
                  m=m, k=k, n=n):
            KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                          stream_handle(a))
    return out


register_op("minplus_dense", "cuda", minplus_matmul)
register_op("minplus_dense", "reference", minplus_matmul_ref)
