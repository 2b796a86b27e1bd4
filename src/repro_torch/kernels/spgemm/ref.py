"""Plain PyTorch version of the ring-SUMMA local SpGEMM stage batch
(the ``spgemm_ring_stages`` op).

One ring-SUMMA stage multiplies the local A panel, its global column ids
rebased into the current B row block, by the local B panel, and compacts
the result into a ``capacity``-slot ELL buffer: ``core.spgemm.spgemm`` on
the rebased panel.  The op batches ``S`` stages and keeps their buffers
apart (stage axis leading): the overlap semiring's ⊕ keeps the first
position pairs, so the caller (``core.summa.summa_ring``) reorders them
into canonical k-block order before its single final merge.  A mirror of
``repro.kernels.spgemm.ref.spgemm_ring_stages_ref``.
"""

from __future__ import annotations

import torch

from ...core.semiring import Semiring
from ...core.spgemm import spgemm
from ...core.spmat import NO_COL, EllMatrix


def rebase_panel(a_cols: torch.Tensor, off, nb: int) -> torch.Tensor:
    """Rebase global A column ids into the B row block ``[off, off + nb)``;
    slots outside it (other stages' k-blocks) become empty."""
    rebased = a_cols - off
    in_range = (a_cols >= 0) & (rebased >= 0) & (rebased < nb)
    return torch.where(in_range, rebased, NO_COL).to(torch.int32)


def spgemm_ring_stages_ref(offsets, a_cols, a_vals, b_cols, b_vals, *,
                           semiring: Semiring, capacity: int,
                           n_cols_out: int):
    """Per stage ``s``: rebase ``a_cols[s]`` by ``offsets[s]``, then
    ``spgemm`` against ``b_cols[s]``.

    ``offsets`` (S,) int32; ``a_cols`` (S, n, K_A) and ``b_cols`` (S, nb,
    K_B) int32 with value dicts of leaves ``(S, rows, K, ...)``.  Returns
    ``(st_cols, st_vals, overflow)``: stage buffers ``(S, n, capacity)`` and
    the overflow summed over rows and stages (0-d int32)."""
    stages = a_cols.shape[0]
    nb = b_cols.shape[1]
    st_cols, st_vals = [], []
    ovf = torch.zeros((), dtype=torch.int32, device=a_cols.device)
    for s in range(stages):
        a = EllMatrix(cols=rebase_panel(a_cols[s], offsets[s], nb),
                      vals={k: v[s] for k, v in a_vals.items()}, n_cols=nb)
        b = EllMatrix(cols=b_cols[s], vals={k: v[s] for k, v in b_vals.items()},
                      n_cols=n_cols_out)
        c, so = spgemm(a, b, semiring=semiring, capacity=capacity)
        st_cols.append(c.cols)
        st_vals.append(c.vals)
        ovf = ovf + so
    return (torch.stack(st_cols),
            {k: torch.stack([v[k] for v in st_vals]) for k in st_vals[0]},
            ovf)
