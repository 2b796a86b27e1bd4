"""Device-side graph primitives for contig generation, in torch.

The PyTorch counterpart of ``repro.core.components`` (DESIGN.md §2.7):

* ``expand_states`` / ``expand_state_rows`` — the n×n MinPlus string matrix
  as the 2n-vertex state graph (vertex ``2·read + strand``) with scalar
  suffix values;
* ``degrees`` — out-degree per row, in-degree per column;
* ``break_cycles`` / ``chain_rank`` / ``path_components`` — pointer
  doubling over a functional successor/predecessor pair, O(log n) rounds;
* ``connected_components`` — min-label hook/shortcut components of any
  ELL adjacency, dispatched as the op ``cc_labels`` (``kernels/cc``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .semiring import MP
from .spmat import EllMatrix, NO_COL

_BIG = 2**30


def _log2_ceil(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def expand_state_rows(cols: torch.Tensor, vals: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand ``(m, K)`` string-matrix rows (values ``(m, K, 4)``) into the
    ``(2m, 2K)`` state-graph rows, sorted ascending by column."""
    n, k = cols.shape
    v4 = vals.reshape(n, k, 2, 2).permute(0, 2, 1, 3)  # [read, a, slot, b]
    j = cols[:, None, :, None]
    tgt = 2 * j + torch.arange(2, dtype=torch.int32, device=cols.device)
    out = torch.where((j >= 0) & torch.isfinite(v4), tgt, NO_COL)
    out = out.reshape(2 * n, 2 * k).to(torch.int32)
    sval = v4.reshape(2 * n, 2 * k)
    key = torch.where(out >= 0, out, _BIG)
    order = torch.sort(key, dim=1, stable=True).indices
    sorted_key = torch.gather(key, 1, order)
    out_cols = torch.where(sorted_key < _BIG, sorted_key, NO_COL).to(torch.int32)
    out_vals = torch.gather(sval, 1, order)
    out_vals = torch.where(out_cols >= 0, out_vals, float("inf"))
    return out_cols, out_vals


def expand_states(s: EllMatrix) -> EllMatrix:
    """The 2n×2n state graph of string matrix ``s``: combo ``2a+b`` of edge
    ``i→j`` becomes edge ``2i+a → 2j+b`` with value ``{MP: suffix}``."""
    n = s.cols.shape[0]
    out_cols, out_vals = expand_state_rows(s.cols, s.vals[MP])
    return EllMatrix(cols=out_cols, vals={MP: out_vals}, n_cols=2 * n)


def degrees(adj: EllMatrix) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out_deg, in_deg) of a square ELL adjacency, both (n,) int32."""
    m = adj.mask
    out_deg = torch.sum(m, dim=1).to(torch.int32)
    in_deg = torch.zeros(adj.n_cols, dtype=torch.int32, device=m.device)
    in_deg.index_add_(0, adj.cols[m].to(torch.int64),
                      torch.ones_like(adj.cols[m]))
    return out_deg, in_deg


def connected_components(adj: EllMatrix, *, max_iters: Optional[int] = None,
                         backend: str = "auto") -> Tuple[torch.Tensor, int]:
    """Minimum-label connected components of an ELL adjacency, treated as
    undirected (labels hook across ``u→v`` in both directions).

    Each round hooks (a min over out-neighbours, then over in-neighbours)
    and shortcuts (``l ← l[l]``); the loop ends when labels stop changing.
    Typical graphs converge in O(log n) rounds, but an adversarial vertex
    order (a path with its ids permuted along it) needs Θ(n), so the
    default cap is ``n``.  For the disjoint paths of the contig stage use
    :func:`path_components`, O(log n) unconditionally.

    The loop is the op ``cc_labels``: ``"reference"`` runs one round at a
    time and reports the exact rounds to convergence; ``"cuda"`` runs eight
    rounds per launch of the ``cc`` kernel and reports the rounds executed
    (a multiple of eight plus a tail); the labels are identical.  ``"auto"``
    resolves against the adjacency's device.

    Returns ``(labels (n,) int32 — the minimum vertex id of each
    component, n_iterations)``."""
    from .backend import dispatch

    return dispatch("cc_labels", backend, adj.cols.device)(
        adj.cols, max_iters=max_iters)


def _jump(t: torch.Tensor, m: torch.Tensor):
    safe = torch.where(t >= 0, t, 0).to(torch.int64)
    m2 = torch.where(t >= 0, torch.minimum(m, m[safe]), m)
    t2 = torch.where(t >= 0, t[safe], -1)
    return t2, m2


def path_components(succ: torch.Tensor, pred: torch.Tensor
                    ) -> Tuple[torch.Tensor, int]:
    """Component labels (minimum vertex id) of a disjoint union of simple
    paths given successor/predecessor pointers (−1 = none), by pointer
    doubling with running minima both ways.  Returns (labels, rounds)."""
    n = succ.shape[0]
    max_iters = _log2_ceil(n) + 1
    ids = torch.arange(n, dtype=torch.int32, device=succ.device)
    tf, tb, mf, mb, it = succ, pred, ids, ids, 0
    while bool(torch.any(tf >= 0) | torch.any(tb >= 0)) and it < max_iters:
        tf, mf = _jump(tf, mf)
        tb, mb = _jump(tb, mb)
        it += 1
    return torch.minimum(mf, mb), it


def break_cycles(succ: torch.Tensor, pred: torch.Tensor):
    """Cut every cycle of a functional graph at its minimum-id vertex
    (the edge entering it is deleted).  Returns (succ', pred', n_cut)."""
    n = succ.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=succ.device)
    t, m = succ, ids
    for _ in range(_log2_ceil(n) + 1):
        t, m = _jump(t, m)
    on_cycle = t >= 0
    cut = on_cycle & (succ == m)
    n_cut = torch.sum(cut).to(torch.int32)
    succ2 = torch.where(cut, -1, succ)
    pred2 = torch.where(on_cycle & (ids == m), -1, pred)
    return succ2, pred2, n_cut


def chain_rank(pred: torch.Tensor):
    """Head and rank of every vertex of a cycle-free union of paths, given
    predecessor pointers (−1 = head).  Returns (head, rank, rounds)."""
    n = pred.shape[0]
    max_iters = _log2_ceil(n) + 1
    ids = torch.arange(n, dtype=torch.int32, device=pred.device)
    par = torch.where(pred >= 0, pred, ids)
    d = (pred >= 0).to(torch.int32)
    it = 0
    while it < max_iters:
        pp = par[par.to(torch.int64)]
        if not bool(torch.any(pp != par)):
            break
        d = d + d[par.to(torch.int64)]
        par = pp
        it += 1
    return par, d, it
