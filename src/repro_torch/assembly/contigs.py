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

Besides the walk: :func:`extract_contigs` (walk + materialisation in one
call), :func:`materialize_packed` and :func:`pad_rows` (the packed contig
tensors as host records and as padded rows), :func:`pileup_polish_host`
(the dict-and-loop cross-check of the ``consensus`` op),
:func:`read_components` / :func:`contig_components` (the component
grouping of the FASTA output) and :func:`contig_str`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.semiring import MP
from .kmers import BASES


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


def materialize_packed(codes, lengths, states, n_pieces) -> List[Contig]:
    """Packed contig tensors as host ``Contig`` records — shared by the
    draft ``ContigSet`` and the polished ``ConsensusResult``.  The contigs
    lie end to end: ``codes`` holds their bases and ``states`` their chains,
    contig ``c`` taking ``lengths[c]`` bases and ``n_pieces[c]`` states of
    each.  The bases reach the host in one transfer, and each record's
    codes are its slice of that one array."""
    flat = _np(codes)
    lens = _np(lengths).astype(np.int64)
    counts = _np(n_pieces).astype(np.int64)
    states = _np(states)
    out: List[Contig] = []
    for ln, end, k, pend in zip(lens.tolist(), np.cumsum(lens).tolist(),
                                counts.tolist(), np.cumsum(counts).tolist()):
        ss = states[pend - k:pend].tolist()
        out.append(Contig(reads=[(s >> 1, s & 1) for s in ss], length=ln,
                          codes=flat[end - ln:end]))
    return out


def pad_rows(values, counts, *, rows=None, cols=None, fill=0):
    """Packed ``values`` (row after row, row ``c`` taking ``counts[c]`` of
    them) as a ``(rows, cols)`` tensor padded with ``fill``, by default as
    small as holds them: the padded layout of a packed one, for comparisons
    with it."""
    n = counts.to(torch.int64)
    rows = n.numel() if rows is None else rows
    if cols is None:
        cols = int(n.max()) if n.numel() else 0
    out = torch.full((rows, cols), fill, dtype=values.dtype,
                     device=values.device)
    r = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n,
                                output_size=values.numel())
    j = torch.arange(values.numel(), device=n.device) - (torch.cumsum(n, 0)
                                                         - n)[r]
    out[r, j] = values
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


def extract_contigs(s_mat, codes, lengths, contained=None) -> List[Contig]:
    """The host walk's contigs of string matrix ``s_mat`` (min-plus
    values); reads marked ``contained`` are not emitted as singletons."""
    edges = state_edges(s_mat)
    chains, _ = extract_contig_chains(s_mat, _edges=edges)
    return materialize_contigs(chains, edges[2], codes, lengths, contained)


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


def pileup_polish_host(draft_codes, draft_lengths, states, offsets, widths,
                       read_codes, read_lengths, *, min_depth: int = 2):
    """Host dict-and-loop walk of the consensus pileup — the slow,
    obviously-correct cross-check of the ``consensus`` op's two backends.
    Votes pass the coherence gate (read-vs-draft agreement on the
    ±``COH_WIN`` window) before counting; a column is re-called to the
    smallest-code argmax of its votes iff ``depth ≥ min_depth`` and the
    winner holds a strict majority, else the draft base stays.  Returns
    ``(polished, depth, agree)`` numpy arrays."""
    from ..kernels.pileup.ref import COH_DEN, COH_MIN_VALID, COH_NUM, COH_WIN

    draft = _np(draft_codes)
    dlens = _np(draft_lengths)
    states = _np(states)
    offsets = _np(offsets)
    widths = _np(widths)
    rcodes = _np(read_codes)
    rlens = _np(read_lengths)
    c = draft.shape[0]
    # the max contig length, not the input's padding (as polish_contig_set)
    l = max(int(dlens.max(initial=0)), 1)
    draft = draft[:, :l] if draft.shape[1] >= l else np.pad(
        draft, ((0, 0), (0, l - draft.shape[1])))
    counts = np.zeros((c, l, 4), np.int64)
    for i in range(c):
        for t in range(states.shape[1]):
            s = int(states[i, t])
            if s < 0:
                continue
            r, flip = s >> 1, s & 1
            ln = int(rlens[r])
            oriented = _oriented(rcodes[r], ln, flip)
            start = int(offsets[i, t]) + int(widths[i, t]) - ln
            for b in range(ln):
                col = start + b
                if not 0 <= col < l:
                    continue
                match = valid = 0
                for w in range(-COH_WIN, COH_WIN + 1):
                    if w == 0 or not 0 <= b + w < ln:
                        continue
                    if not 0 <= col + w < l:
                        continue
                    valid += 1
                    match += int(oriented[b + w]) == int(draft[i, col + w])
                if COH_DEN * match >= COH_NUM * valid and valid >= COH_MIN_VALID:
                    counts[i, col, int(oriented[b])] += 1
    depth = counts.sum(axis=2)
    win = counts.max(axis=2)
    winner = counts.argmax(axis=2)
    change = (depth >= min_depth) & (2 * win > depth)
    polished = np.where(change, winner, draft).astype(np.uint8)
    agree = np.take_along_axis(
        counts, polished[:, :, None].astype(np.int64), axis=2)[:, :, 0]
    # columns past each contig's length are padding in every backend
    colmask = np.arange(l)[None, :] < dlens[:, None]
    polished = np.where(colmask, polished, 0).astype(np.uint8)
    return polished, depth.astype(np.int32), agree.astype(np.int32)


def read_components(s_mat) -> np.ndarray:
    """Connected components of the string graph at read granularity (both
    strands of a read are one vertex): ``(n,)`` labels, each the minimum
    read id of its component — the grouping key of
    ``io_fasta.write_contig_fasta``."""
    cols = _np(s_mat.cols)
    vals = _np(s_mat.vals[MP])
    n = cols.shape[0]
    parent = np.arange(n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i in range(n):
        for q in range(cols.shape[1]):
            j = int(cols[i, q])
            if j < 0 or not np.isfinite(vals[i, q]).any():
                continue
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[max(ri, rj)] = min(ri, rj)
    return np.asarray([find(i) for i in range(n)])


def contig_components(contigs: List[Contig], components: np.ndarray):
    """Component label per contig: that of its reads (a chain never
    crosses components)."""
    return [int(components[c.reads[0][0]]) for c in contigs]


def contig_str(c: Contig) -> str:
    """The contig's bases as an ``ACGT`` string."""
    return "".join(BASES[int(x)] for x in c.codes)
