"""Parallel transitive reduction (paper Algorithm 2) over the MinPlus
semiring, in torch.

The PyTorch counterpart of ``repro.core.transitive_reduction``:

* ``transitive_reduction`` — paper-faithful: each pass builds the whole
  two-hop matrix ``N = R²`` (capacity-bounded ELL, overflow counted);
* ``transitive_reduction_fused`` — the sampled square ``N∘pattern(R)``: on
  the ``"cuda"`` backend the dense min-plus kernel (``minplus_dense``)
  while n ≤ ``TR_DENSE_MAX_ROWS`` and the sampled one (``spgemm_masked``)
  above it, else the torch-ops ``spgemm_masked``.

Algorithm 2 is one host loop, :func:`reduction_loop`: prune the combos
with ``N ≤ rowmax(R) + fuzz`` until nnz is stable.  It is handed a square:
one of the one-card squares below (picked by :func:`_square_for`, named in
``TRStats.backend``), or the ring or all-gather square of
``core/summa.py``.  Each pass opens two step spans,
``TrReduction.square`` (row bound and square) and ``TrReduction.prune``
(prune and nnz), with attributes ``iter``, ``path`` (``"minplus"``,
``"masked"``, ``"ell"``, ``"ring"`` or ``"allgather"``) and the loop's nnz.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

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


def _row_bound(r: EllMatrix, fuzz: torch.Tensor, row_max: Callable
               ) -> torch.Tensor:
    """Line 5: each row's max finite suffix over its live slots and combos,
    reduced by ``row_max`` over the ranks that share the row, plus fuzz."""
    v = r.vals[MP]
    vals = torch.where(torch.isfinite(v) & r.mask[:, :, None], v, -INF)
    return row_max(torch.amax(vals, dim=(1, 2))) + fuzz


def _prune_transitive(r: EllMatrix, got: torch.Tensor, found: torch.Tensor,
                      bound: torch.Tensor) -> EllMatrix:
    """Lines 8–9: combo (a,b) of R[i,j] is transitive iff N[i,j][a,b] is
    finite and ≤ ``bound[i]``; set those to +inf, drop the slots whose
    combos are all +inf (R ← R ∘ ¬I) and recompact the rows."""
    v = r.vals[MP]
    trans = ((got <= bound[:, None, None]) & torch.isfinite(got)
             & found[:, :, None] & r.mask[:, :, None] & torch.isfinite(v))
    new_vals = torch.where(trans, INF, v)
    dead = ~torch.any(torch.isfinite(new_vals), dim=-1) & r.mask
    return prune(EllMatrix(cols=r.cols, vals={MP: new_vals}, n_cols=r.n_cols),
                 dead, SR)


def reduction_loop(r: EllMatrix, square: Callable, path: str,
                   name: str = "reference", *, fuzz: float, max_iters: int,
                   nnz: Callable = lambda m: int(m.nnz()),
                   row_max: Callable = lambda x: x
                   ) -> Tuple[EllMatrix, TRStats]:
    """Algorithm 2 on R (one card's matrix, or a rank's block of it): prune
    the transitive edges until ``nnz`` (the global count) stops changing or
    ``max_iters`` passes ran.  ``square(r)`` gives N at R's slots
    ``(n, K, 4)``, the found mask ``(n, K)`` and its overflow.  Returns S
    and its ``TRStats`` (overflow summed, ``backend`` = ``name``)."""
    fuzz_t = torch.tensor(fuzz, dtype=torch.float32, device=r.cols.device)
    nnz0 = nnz(r)
    prev, cur, it, ovf = -1, nnz0, 0, 0
    while cur != prev and it < max_iters:
        with span("TrReduction.square", kind="step", iter=it, path=path,
                  nnz=cur):
            bound = _row_bound(r, fuzz_t, row_max)
            got, found, step_ovf = square(r)
        with span("TrReduction.prune", kind="step", iter=it,
                  path=path) as sp:
            r = _prune_transitive(r, got, found, bound)
            prev, cur, it, ovf = cur, nnz(r), it + 1, ovf + step_ovf
            sp.annotate(nnz=cur)
    return r, TRStats(iterations=it, nnz_initial=nnz0, nnz_final=cur,
                      n_overflow=int(ovf), backend=name)


# --- the one-card squares: (N at R's slots, found, overflow) -----------


def _minplus_square(r: EllMatrix):
    """The dense square on the min-plus kernel, sampled at R's pattern
    (absent entries are +inf, the additive identity)."""
    dense = r.to_dense(SR)[MP]
    nd = dispatch("minplus_dense", "cuda")(dense, dense)
    safe = torch.where(r.mask, r.cols, 0).to(torch.int64)
    rows = torch.arange(r.cols.shape[0], device=r.cols.device)[:, None]
    return nd[rows, safe], r.mask, 0


def _masked_square(r: EllMatrix):
    """The sampled square in one launch of the sampled min-plus kernel."""
    got = dispatch("spgemm_masked", "cuda")(r.cols, r.vals[MP], r.cols,
                                           r.vals[MP], r.cols)
    return got, r.mask, 0


def _sampled_square(r: EllMatrix):
    """The sampled square in torch ops."""
    return spgemm_masked(r, r, r, semiring=SR).vals[MP], r.mask, 0


def _ell_square(r: EllMatrix, n_capacity: int):
    """All of N = R² in ``n_capacity`` slots a row, looked up at R."""
    n_full, ovf = spgemm(r, r, semiring=SR, capacity=n_capacity)
    got, found = n_full.lookup(SR, torch.where(r.mask, r.cols, -1))
    return got[MP], found, ovf


def _square_for(r: EllMatrix, *, backend: str, fused: bool,
                n_capacity: int | None = None):
    """The one-card square and its names: ``(square, span path,
    TRStats.backend)``.  The faithful TR squares in ELL (``n_capacity``
    default min(K², 4K)) whatever the backend; the fused one on the
    ``cuda`` backend squares densely up to ``TR_DENSE_MAX_ROWS`` (read at
    call time) and on the sampled kernel above it."""
    b = resolve_backend(backend, r.cols.device)
    if not fused:
        k = r.capacity
        cap = min(k * k, 4 * k) if n_capacity is None else n_capacity
        return (functools.partial(_ell_square, n_capacity=cap), "ell",
                "reference")
    if b != "cuda":
        return _sampled_square, "ell", "reference"
    if r.cols.shape[0] <= TR_DENSE_MAX_ROWS:
        return _minplus_square, "minplus", "cuda"
    return _masked_square, "masked", "cuda_masked"


def transitive_reduction(r: EllMatrix, fuzz: float = 200.0, *,
                         n_capacity: int | None = None, max_iters: int = 10,
                         backend: str = "reference"
                         ) -> Tuple[EllMatrix, TRStats]:
    """Paper-faithful Algorithm 2; ``n_capacity`` bounds N = R² rows
    (default min(K², 4K)).  ``backend`` is validated and ignored: the
    faithful path always runs the capacity-bounded ELL square, whose
    overflow accounting is part of its contract."""
    return reduction_loop(r, *_square_for(r, backend=backend, fused=False,
                                          n_capacity=n_capacity),
                          fuzz=fuzz, max_iters=max_iters)


def transitive_reduction_fused(r: EllMatrix, fuzz: float = 200.0, *,
                               max_iters: int = 10, backend: str = "reference"
                               ) -> Tuple[EllMatrix, TRStats]:
    """Sampled-square variant; ``backend="cuda"`` squares on the dense
    min-plus kernel while n ≤ ``TR_DENSE_MAX_ROWS`` and on the sampled
    min-plus kernel above it (``TRStats.backend`` ``"cuda_masked"``)."""
    return reduction_loop(r, *_square_for(r, backend=backend, fused=True),
                          fuzz=fuzz, max_iters=max_iters)
