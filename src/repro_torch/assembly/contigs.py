"""Contig extraction: the host walk of the bidirected string graph.

The port's copy of the numpy host walk in ``repro.assembly.contigs`` — the
``"reference"`` backend of the Contigs stage (``contig_gen.py`` holds the
device path; both give identical contigs).  Inputs may be torch tensors on
any device: they are read through ``.cpu().numpy()``.

A walk state is (read, strand); edge (i→j, strands (a, b), suffix ℓ)
connects state (i, a) to (j, b) and appends the last ℓ bases of oriented-j.
Canonical unitig partition (DESIGN.md §2.7): an edge u→v of the state graph
is kept iff out-degree(u) == 1 and in-degree(v) == 1; kept edges form
disjoint paths and cycles; cycles are cut at their minimum state, which
becomes the head; one contig is emitted per chain whose head has an
outgoing edge in the original graph.  A chain is dropped iff its reverse-
complement twin is also emitted and is lexicographically smaller.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.semiring import MP


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Contig:
    """One contig: its (read, strand) chain, length and bases."""

    reads: List[Tuple[int, int]]
    length: int
    codes: np.ndarray


@dataclasses.dataclass
class ContigStats:
    """Summary statistics of a contig set."""

    n_contigs: int
    total_length: int
    n50: int
    longest: int
    l50: int
    mean_length: float


def _oriented(codes_row: np.ndarray, length: int, strand: int) -> np.ndarray:
    r = codes_row[:length]
    return (3 - r[::-1]) if strand else r


def materialize_rows(codes, lengths, states, n_contigs: int) -> List[Contig]:
    """Rows of ``codes``/``lengths`` with their ``states`` chains (−1
    padded) as ``Contig`` records — shared by the draft ``ContigSet`` and
    the polished ``ConsensusResult``."""
    codes = _np(codes)
    lens = _np(lengths)
    states = _np(states)
    out: List[Contig] = []
    for i in range(n_contigs):
        ss = states[i][states[i] >= 0]
        out.append(Contig(
            reads=[(int(s) >> 1, int(s) & 1) for s in ss],
            length=int(lens[i]),
            codes=codes[i, : lens[i]].copy(),
        ))
    return out


def state_edges(s_mat):
    """Host-side state-graph expansion: ``(out_edges, in_deg, has_edge)``
    where ``out_edges[u] = [(v, suffix), ...]`` over states ``u = 2·read +
    strand`` and ``has_edge`` is per read."""
    cols = _np(s_mat.cols)
    vals = _np(s_mat.vals[MP])
    n = cols.shape[0]
    out_edges: Dict[int, List] = {}
    in_deg: Dict[int, int] = {}
    has_edge = np.zeros(n, bool)
    for i in range(n):
        for q in range(cols.shape[1]):
            j = int(cols[i, q])
            if j < 0:
                continue
            for combo in range(4):
                suf = vals[i, q, combo]
                if not np.isfinite(suf):
                    continue
                a, b = combo >> 1, combo & 1
                out_edges.setdefault(2 * i + a, []).append((2 * j + b, int(suf)))
                in_deg[2 * j + b] = in_deg.get(2 * j + b, 0) + 1
                has_edge[i] = has_edge[j] = True
    return out_edges, in_deg, has_edge


def extract_contig_chains(s_mat, _edges=None):
    """Canonical unitig partition of the state graph.  Returns ``(chains,
    n_branch_cut)``: each chain a list of ``(state, in_suffix)`` (the head's
    in_suffix is 0), sorted by minimum state, twins deduplicated."""
    out_edges, in_deg, _ = _edges if _edges is not None else state_edges(s_mat)

    succ: Dict[int, Tuple[int, int]] = {}
    pred: Dict[int, int] = {}
    n_branch_cut = 0
    for u, es in out_edges.items():
        if len(es) == 1 and in_deg.get(es[0][0], 0) == 1:
            v, suf = es[0]
            succ[u] = (v, suf)
            pred[v] = u
        else:
            n_branch_cut += len(es)

    # cut cycles at their minimum state (canonical head)
    seen: set = set()
    for u in list(succ):
        if u in seen:
            continue
        path = []
        on_path: set = set()
        cur = u
        while cur in succ and cur not in seen and cur not in on_path:
            path.append(cur)
            on_path.add(cur)
            cur = succ[cur][0]
        seen.update(on_path)
        if cur in on_path:
            cyc = path[path.index(cur):]
            mn = min(cyc)
            prv = pred.pop(mn)
            del succ[prv]

    # chains from heads (no kept in-edge); emit iff head has out-edges
    states = set(out_edges) | set(in_deg)
    emitted: List[List[Tuple[int, int]]] = []
    for h in states:
        if h in pred or h not in out_edges:
            continue
        chain = [(h, 0)]
        cur = h
        while cur in succ:
            v, suf = succ[cur]
            chain.append((v, suf))
            cur = v
        emitted.append(chain)

    # RC-twin dedup: drop c iff its twin is also emitted and twin < c
    keys = {tuple(s for s, _ in c): c for c in emitted}
    kept = []
    for key, c in keys.items():
        twin = tuple(s ^ 1 for s in reversed(key))
        if twin in keys and twin < key:
            continue
        kept.append(c)
    kept.sort(key=lambda c: min(s for s, _ in c))
    return kept, n_branch_cut


def materialize_contigs(chains, has_edge, codes, lengths, contained=None
                        ) -> List[Contig]:
    """Chains of ``(state, in_suffix)`` as sequence-bearing contigs, then
    the isolated-read singletons."""
    codes = _np(codes)
    lengths = _np(lengths)
    n = codes.shape[0]
    contigs: List[Contig] = []
    for chain in chains:
        seq = []
        for t, (state, suf) in enumerate(chain):
            r, s = state >> 1, state & 1
            orient = _oriented(codes[r], lengths[r], s)
            if t == 0:
                seq.append(orient)
            else:
                # a state appends at most its whole read
                suf = min(suf, len(orient))
                seq.append(orient[len(orient) - suf:] if suf > 0 else orient[:0])
        full = np.concatenate(seq) if seq else np.zeros(0, np.uint8)
        contigs.append(Contig(reads=[(s >> 1, s & 1) for s, _ in chain],
                              length=len(full), codes=full))

    cont = np.zeros(n, bool) if contained is None else _np(contained).astype(bool)
    for i in range(n):
        if not has_edge[i] and not cont[i]:
            contigs.append(Contig(reads=[(i, 0)], length=int(lengths[i]),
                                  codes=codes[i][: lengths[i]].copy()))
    return contigs


def contig_stats(contigs: List[Contig]) -> ContigStats:
    """N50, L50, longest, total and mean length of a contig list."""
    if not contigs:
        return ContigStats(0, 0, 0, 0, 0, 0.0)
    ls = sorted((c.length for c in contigs), reverse=True)
    total = sum(ls)
    if total == 0:
        return ContigStats(len(ls), 0, 0, 0, 0, 0.0)
    acc, n50, l50 = 0, 0, 0
    for rank, x in enumerate(ls):
        acc += x
        if acc * 2 >= total:
            n50, l50 = x, rank + 1
            break
    return ContigStats(len(ls), total, n50, ls[0], l50, total / len(ls))
