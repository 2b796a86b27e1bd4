"""Plain PyTorch version of the dense orientation-resolved min-plus product.

``N[i, j, 2x+y] = min_k min_c A[i, k, 2x+c] + B[k, j, 2c+y]`` (+inf =
absent) — a mirror of ``repro.kernels.minplus.ref.minplus_matmul_ref``,
reducing k in chunks to bound the (M, kc, N, 2, 2, 2) expansion.
"""

from __future__ import annotations

import torch


def minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K, 4), b (K, N, 4) -> (M, N, 4) f32, +inf = absent."""
    m, k, _ = a.shape
    n = b.shape[1]
    am = a.reshape(m, k, 2, 2)
    bm = b.reshape(k, n, 2, 2)
    out = torch.full((m, n, 2, 2), float("inf"), dtype=torch.float32,
                     device=a.device)
    step = max(1, min(k, 512 * 512 // max(m * n // max(m, n), 1), 64))
    for k0 in range(0, k, step):
        ak = am[:, k0:k0 + step]  # (M, kc, 2, 2)
        bk = bm[k0:k0 + step]  # (kc, N, 2, 2)
        s = ak[:, :, None, :, :, None] + bk[None, :, :, None, :, :]
        # (M, kc, N, x, c, y) -> min over kc and c
        out = torch.minimum(out, torch.amin(s, dim=(1, 4)))
    return out.reshape(m, n, 4)
