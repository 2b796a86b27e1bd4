"""Parallel transitive reduction (paper Algorithm 2) over the MinPlus
semiring, in torch.

The PyTorch counterpart of ``repro.core.transitive_reduction``:

* ``transitive_reduction`` — paper-faithful: each round builds the full
  two-hop matrix ``N = R²`` (capacity-bounded ELL square, overflow counted),
  flags combos with ``N ≤ rowmax(R) + fuzz`` and prunes them, until nnz is
  stable;
* ``transitive_reduction_fused`` — the sampled square ``N∘pattern(R)``.
  With the ``"cuda"`` backend the square is the dense min-plus kernel
  (``minplus_dense`` op) on ``R.to_dense()``, sampled back at R's pattern,
  while n ≤ ``TR_DENSE_MAX_ROWS``, and the sampled min-plus kernel
  (``spgemm_masked`` op) on R's ELL above it; the ``"reference"`` backend
  squares with the torch-ops ``spgemm_masked``.  ``TRStats.backend``
  records the path that ran.

The convergence loop is a host loop: each iteration reads nnz.  Each
iteration opens two step spans, ``TrReduction.square`` and
``TrReduction.prune`` (attributes ``iter``, ``path`` — ``"minplus"``,
``"masked"`` or ``"ell"`` — and the nnz the loop holds).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..obs import span
from .backend import dispatch, resolve_backend
from .semiring import INF, MP, minplus_orient_semiring as SR
from .spgemm import spgemm, spgemm_masked
from .spmat import EllMatrix, prune

# Above this many rows the dense square would materialize an (n, n, 4) f32
# operand per iteration (4096 rows ≈ 256 MB); the sampled square on R's ELL
# takes over.
TR_DENSE_MAX_ROWS = 4096

# TRStats.backend of the fused TR -> the path its step spans carry
_PATHS = {"cuda": "minplus", "cuda_masked": "masked"}


@dataclasses.dataclass
class TRStats:
    """Convergence + integrity counters of one transitive-reduction run;
    ``backend`` is the path that actually ran: ``"cuda"`` (the dense
    min-plus kernel), ``"cuda_masked"`` (the sampled min-plus kernel) or
    ``"reference"`` (the torch-ops square)."""

    iterations: int
    nnz_initial: int
    nnz_final: int
    n_overflow: int  # N-capacity overflow events (faithful path only)
    backend: str = "reference"


def row_max_suffix(r: EllMatrix) -> torch.Tensor:
    """Per-row max finite suffix over all slots and combos (paper line 5)."""
    v = r.vals[MP]
    vals = torch.where(torch.isfinite(v), v, -INF)
    vals = torch.where(r.mask[:, :, None], vals, -INF)
    return torch.amax(vals, dim=(1, 2))


def _transitive_combos(r: EllMatrix, n_at_r, found, v) -> torch.Tensor:
    """Line 8: combo (a,b) of R[i,j] is transitive iff N[i,j][a,b] is
    finite and ≤ v[i].  Returns (n, K, 4) bool."""
    cond = (n_at_r <= v[:, None, None]) & torch.isfinite(n_at_r)
    return (cond & found[:, :, None] & r.mask[:, :, None]
            & torch.isfinite(r.vals[MP]))


def _prune_combos(r: EllMatrix, transitive: torch.Tensor) -> EllMatrix:
    """Set transitive combos to +inf, drop slots whose combos are all +inf
    (paper line 9: R ← R ∘ ¬I) and recompact rows."""
    new_vals = torch.where(transitive, INF, r.vals[MP])
    dead = ~torch.any(torch.isfinite(new_vals), dim=-1) & r.mask
    r2 = EllMatrix(cols=r.cols, vals={MP: new_vals}, n_cols=r.n_cols)
    return prune(r2, dead, SR)


def _tr_impl(r: EllMatrix, fuzz: float, *, n_capacity: int, max_iters: int,
             fused: bool, backend: str) -> Tuple[EllMatrix, TRStats]:
    fuzz = torch.tensor(fuzz, dtype=torch.float32, device=r.cols.device)
    nnz0 = int(r.nnz())
    prev, cur, it, ovf = -1, nnz0, 0, 0
    path = _PATHS.get(backend, "ell") if fused else "ell"
    while cur != prev and it < max_iters:
        with span("TrReduction.square", kind="step", iter=it, path=path,
                  nnz=cur):
            v = row_max_suffix(r) + fuzz
            if path == "minplus":
                # dense square on the min-plus kernel, sampled at R's
                # pattern: absent entries are +inf, the additive identity,
                # so the dense contraction equals the sampled ELL one
                minplus = dispatch("minplus_dense", "cuda")
                dense = r.to_dense(SR)[MP]
                nd = minplus(dense, dense)
                n = r.cols.shape[0]
                safe = torch.where(r.mask, r.cols, 0).to(torch.int64)
                rows = torch.arange(n, device=r.cols.device)[:, None]
                vals_at_r = nd[rows, safe]
                found = r.mask
                step_ovf = 0
            elif path == "masked":
                # the sampled square in one launch: N at R's own pattern
                masked = dispatch("spgemm_masked", "cuda")
                vals_at_r = masked(r.cols, r.vals[MP], r.cols, r.vals[MP],
                                   r.cols)
                found = r.mask
                step_ovf = 0
            elif fused:
                vals_at_r = spgemm_masked(r, r, r, semiring=SR).vals[MP]
                found = r.mask
                step_ovf = 0
            else:
                n_full, step_ovf = spgemm(r, r, semiring=SR,
                                          capacity=n_capacity)
                got, found = n_full.lookup(SR, torch.where(r.mask, r.cols, -1))
                vals_at_r = got[MP]
                step_ovf = int(step_ovf)
        with span("TrReduction.prune", kind="step", iter=it,
                  path=path) as sp:
            trans = _transitive_combos(r, vals_at_r, found, v)
            r = _prune_combos(r, trans)
            prev, cur, it, ovf = cur, int(r.nnz()), it + 1, ovf + step_ovf
            sp.annotate(nnz=cur)
    return r, TRStats(iterations=it, nnz_initial=nnz0, nnz_final=cur,
                      n_overflow=ovf,
                      backend=backend if fused else "reference")


def transitive_reduction(r: EllMatrix, fuzz: float = 200.0, *,
                         n_capacity: int | None = None, max_iters: int = 10,
                         backend: str = "reference"
                         ) -> Tuple[EllMatrix, TRStats]:
    """Paper-faithful Algorithm 2; ``n_capacity`` bounds N = R² rows
    (default min(K², 4K)).  ``backend`` is validated and ignored: the
    faithful path always runs the capacity-bounded ELL square, whose
    overflow accounting is part of its contract."""
    k = r.capacity
    if n_capacity is None:
        n_capacity = min(k * k, 4 * k)
    resolve_backend(backend, r.cols.device)
    return _tr_impl(r, fuzz, n_capacity=n_capacity, max_iters=max_iters,
                    fused=False, backend="reference")


def transitive_reduction_fused(r: EllMatrix, fuzz: float = 200.0, *,
                               max_iters: int = 10, backend: str = "reference"
                               ) -> Tuple[EllMatrix, TRStats]:
    """Sampled-square variant; ``backend="cuda"`` squares on the dense
    min-plus kernel while n ≤ ``TR_DENSE_MAX_ROWS`` and on the sampled
    min-plus kernel above it (``TRStats.backend`` ``"cuda_masked"``)."""
    b = resolve_backend(backend, r.cols.device)
    if b == "cuda" and r.cols.shape[0] > TR_DENSE_MAX_ROWS:
        b = "cuda_masked"
    return _tr_impl(r, fuzz, n_capacity=1, max_iters=max_iters, fused=True,
                    backend=b)
