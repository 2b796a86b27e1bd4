"""Plain PyTorch version of the sampled min-plus product (the
``spgemm_masked`` op).

The kernel's walk, one A slot at a time over every row: slot ``a`` of row
i selects B row ``k = a_cols[i, a]``; each live column ``j`` of that row
is looked up among the mask row's sorted columns, and where it is there at
``q`` the 2×2 orientation product ``A[i, a] ⊗ B[k, b]`` is folded into
``out[i, q]`` with a min.  Written apart from ``core.spgemm`` (which
materialises every candidate and reduces them per mask slot), so the two
check each other.
"""

from __future__ import annotations

import torch

_BIG = 2**31 - 1


def _orient_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``out[2x+y] = min(a[2x] + b[y], a[2x+1] + b[2+y])`` over the last
    axis (4,)."""
    return torch.stack([torch.minimum(x[..., 0] + y[..., 0], x[..., 1] + y[..., 2]),
                        torch.minimum(x[..., 0] + y[..., 1], x[..., 1] + y[..., 3]),
                        torch.minimum(x[..., 2] + y[..., 0], x[..., 3] + y[..., 2]),
                        torch.minimum(x[..., 2] + y[..., 1], x[..., 3] + y[..., 3])],
                       dim=-1)


def spgemm_masked_minplus_ref(a_cols, a_vals, b_cols, b_vals, m_cols):
    """a_cols (n, K_A), b_cols (n_b, K_B), m_cols (n, K_M) int32; a_vals
    (n, K_A, 4), b_vals (n_b, K_B, 4) f32 -> (n, K_M, 4) f32, +inf where
    nothing is found and in the mask's empty slots."""
    n, ka = a_cols.shape
    nb = b_cols.shape[0]
    km = m_cols.shape[1]
    dev = a_cols.device
    out = torch.full((n * km, 4), float("inf"), dtype=torch.float32,
                     device=dev)
    if n == 0 or km == 0 or nb == 0:
        return out.reshape(n, km, 4)
    # the mask rows as sorted search keys (empty slots last, as _BIG)
    keys = torch.where(m_cols >= 0, m_cols.to(torch.int64), _BIG).contiguous()
    rows = torch.arange(n, device=dev)[:, None]
    for a in range(ka):
        k = a_cols[:, a].to(torch.int64)
        live = (k >= 0) & (k < nb)
        kk = torch.where(live, k, 0)
        j = b_cols[kk].to(torch.int64)  # (n, K_B)
        pos = torch.searchsorted(keys, torch.where(j >= 0, j, 0).contiguous())
        pos = torch.clamp(pos, max=km - 1)
        hit = (torch.gather(keys, 1, pos) == j) & (j >= 0) & live[:, None]
        prod = _orient_product(a_vals[:, a, None, :], b_vals[kk])
        idx = (rows * km + pos)[hit]
        out.scatter_reduce_(0, idx[:, None].expand(-1, 4), prod[hit], "amin")
    return out.reshape(n, km, 4)
