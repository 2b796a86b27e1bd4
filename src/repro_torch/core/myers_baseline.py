"""Sequential Myers-style transitive reduction — the correctness oracle.

The port's own copy of ``repro.core.myers_baseline`` (plain Python and
numpy); only :func:`from_ell` differs, reading the port's ``EllMatrix``
(torch tensors, min-plus values under ``MP``).

Myers' linear-time fragment-assembly algorithm [paper ref 10] iterates over
each node v, bounds candidate paths by ``longest(v) + fuzz`` and marks edges
v→w transitive when reachable via a valid two-hop walk.  The paper's
Algorithm 2 is the semiring-parallel formulation of exactly this rule, so the
two must produce identical string graphs; tests assert graph equality.

This module is deliberately plain Python/numpy (host-side, sequential) — it is
both the oracle for property-based tests and the "competing implementation" in
our Table-VI-style benchmark (SORA/Spark being unavailable, Myers' own
algorithm is the natural sequential baseline; see DESIGN.md §2).

Graph representation: ``{(i, j): [s00, s01, s10, s11]}`` — suffix length per
(strand_i, strand_j) combo, ``math.inf`` = absent.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .semiring import MP

Edges = Dict[Tuple[int, int], list]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_ell(mat) -> Edges:
    """EllMatrix (MinPlus 4-vector values) -> dict graph."""
    cols = _np(mat.cols)
    vals = _np(mat.vals[MP])
    edges: Edges = {}
    for i in range(cols.shape[0]):
        for q in range(cols.shape[1]):
            j = int(cols[i, q])
            if j < 0:
                continue
            v = [float(x) if np.isfinite(x) else math.inf for x in vals[i, q]]
            if any(math.isfinite(x) for x in v):
                edges[(i, j)] = v
    return edges


def myers_transitive_reduction(
    edges: Edges, fuzz: float = 200.0, max_iters: int = 10
) -> Tuple[Edges, int]:
    """Iterated Myers rule, combo-resolved. Returns (string graph, rounds)."""
    edges = {k: list(v) for k, v in edges.items()}
    out_adj: Dict[int, list] = {}

    def rebuild():
        out_adj.clear()
        for (i, j), v in edges.items():
            out_adj.setdefault(i, []).append(j)

    rounds = 0
    for _ in range(max_iters):
        rebuild()
        rowmax = {}
        for (i, j), v in edges.items():
            m = max((x for x in v if math.isfinite(x)), default=-math.inf)
            rowmax[i] = max(rowmax.get(i, -math.inf), m)

        marks = []  # (i, j, combo)
        for (i, j), vij in edges.items():
            bound = rowmax[i] + fuzz
            for a in (0, 1):
                for b in (0, 1):
                    if not math.isfinite(vij[2 * a + b]):
                        continue
                    best = math.inf
                    for k in out_adj.get(i, ()):  # middle nodes
                        vik = edges.get((i, k))
                        vkj = edges.get((k, j))
                        if vik is None or vkj is None:
                            continue
                        for c in (0, 1):
                            s = vik[2 * a + c] + vkj[2 * c + b]
                            if s < best:
                                best = s
                    if best <= bound:
                        marks.append((i, j, 2 * a + b))
        if not marks:
            break
        for i, j, combo in marks:
            edges[(i, j)][combo] = math.inf
        dead = [k for k, v in edges.items() if not any(math.isfinite(x) for x in v)]
        for k in dead:
            del edges[k]
        rounds += 1
    return edges, rounds


def graphs_equal(a: Edges, b: Edges, tol: float = 1e-4) -> bool:
    if set(a) != set(b):
        return False
    for k in a:
        for x, y in zip(a[k], b[k]):
            fx, fy = math.isfinite(x), math.isfinite(y)
            if fx != fy:
                return False
            if fx and abs(x - y) > tol:
                return False
    return True


def dense_square_transitive_reduction(
    edges: Edges, n: int, fuzz: float = 200.0, max_iters: int = 10
) -> Tuple[Edges, int]:
    """Naive dense baseline: materializes the full n×n×4 min-plus square each
    round (the O(n³) comparison point for the Table-VI benchmark)."""
    inf = math.inf
    # Doubled-vertex formulation: T[(i,a), (j,b)] = suffix of edge i→j at
    # strand combo (a, b); the orientation-valid square is then a plain
    # min-plus matrix square of the 2n×2n matrix.
    t = np.full((2 * n, 2 * n), inf, dtype=np.float64)
    for (i, j), v in edges.items():
        for a in (0, 1):
            for b in (0, 1):
                t[2 * i + a, 2 * j + b] = v[2 * a + b]
    rounds = 0
    for _ in range(max_iters):
        finite = np.isfinite(t)
        rowmax = np.where(finite, t, -inf).reshape(n, 2 * 2 * n).max(axis=1)
        # blocked min-plus square to bound memory at O(n²) per row-block
        nsq = np.empty_like(t)
        for r0 in range(0, 2 * n, 64):
            r1 = min(r0 + 64, 2 * n)
            nsq[r0:r1] = np.min(t[r0:r1, :, None] + t[None, :, :], axis=1)
        bound = np.repeat(rowmax, 2)[:, None] + fuzz
        trans = finite & np.isfinite(nsq) & (nsq <= bound)
        if not trans.any():
            break
        t[trans] = inf
        rounds += 1
    out: Edges = {}
    fin = np.isfinite(t)
    for i in range(n):
        for j in range(n):
            blk = t[2 * i : 2 * i + 2, 2 * j : 2 * j + 2]
            if np.isfinite(blk).any():
                out[(i, j)] = list(blk.reshape(4))
    return out, rounds
