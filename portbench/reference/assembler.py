"""The plain reference of the assembler: the diBELLA 2D pipeline's stages in
plain torch (any device) and numpy, written from the stated semantics.

Nothing here imports the program: the stages are the paper's and the
configuration's, computed a different way (sorted COO lists, joins and host
walks where the program keeps static-capacity ELL blocks and kernels), so
that an agreement means something.

* :func:`count_kmers` — canonical k-mers of every read (2 bits a base,
  the smaller of the k-mer and its reverse complement), their exact counts
  and the reliable window ``[lower, upper]``; reliable k-mers get column
  ids in value order.
* :func:`kmer_matrix` — A (reads × reliable k-mers): a read keeps the
  ``read_capacity`` smallest column ids it holds, each with the position
  and strand of its first occurrence; Aᵀ keeps every (k-mer, read).
* :func:`overlap_candidates` — C = A·Aᵀ under the overlap semiring: the
  count of shared k-mers of each read pair and the positions of the first
  shared k-mer (in column order); a row keeps its ``overlap_capacity``
  smallest columns; the pairs i < j sharing ``min_shared_kmers`` are the
  alignment candidates, each with its seed and relative strand.
* :func:`align` — seed-and-extend x-drop of candidate pairs
  (``reference.xdrop``), the score test and the overlap classes.
* :func:`r_rows` — rows of the overlap graph R for chosen reads, from all
  their candidates' alignments: a read's contained flag, its dovetail
  edges (suffix lengths by strand combination), the row capacity and the
  removal of edges to contained reads.
* :func:`transitive_reduction` — Algorithm 2 on an edge list: the
  two-hop min-plus products at R's pattern, the row's longest suffix plus
  ``fuzz``, pruning until the edge count stops changing.
* :func:`contigs` — the unitig walk of the bidirected state graph: keep
  u→v where u has one out-edge and v one in-edge, cut cycles at their
  least state, one contig per chain whose head has an out-edge, reverse-
  complement twins kept once, then the isolated reads.
* :func:`polish` — junction refinement by banded correlation and the
  coherence-gated strict-majority pileup vote.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .xdrop import xdrop_walks

_I64 = torch.int64
INF = float("inf")
JUNCTION_WIN = 64
COH_WIN, COH_NUM, COH_DEN, COH_MIN_VALID = 4, 3, 4, 4
PIECE_BLOCK = 4096  # pieces a block of the polish's gathers


# --------------------------------------------------------------------------
# CountKmer
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KmerTable:
    """Reliable k-mer instances and the counting statistics."""

    read: torch.Tensor  # (I,) int64, instances of reliable k-mers
    pos: torch.Tensor  # (I,) int64
    strand: torch.Tensor  # (I,) int64, 1 where the reverse complement is smaller
    col: torch.Tensor  # (I,) int64, column id of the k-mer
    m_reliable: int
    n_unique: int
    n_singleton: int


def count_kmers(codes, lengths, *, k: int, lower: int, upper: int,
                rows_per_block: int = 4096) -> KmerTable:
    """Count every canonical k-mer of the reads exactly."""
    dev = codes.device
    n, width = codes.shape
    npos = width - k + 1
    vals, reads, poss, strands = [], [], [], []
    for r0 in range(0, n, rows_per_block):
        c = codes[r0:r0 + rows_per_block].to(_I64)
        fwd = torch.zeros((c.shape[0], npos), dtype=_I64, device=dev)
        rev = torch.zeros_like(fwd)
        for t in range(k):
            fwd = fwd * 4 + c[:, t:t + npos]
            rev = rev * 4 + (3 - c[:, k - 1 - t:k - 1 - t + npos])
        ln = lengths[r0:r0 + rows_per_block].to(_I64)
        ok = torch.arange(npos, device=dev)[None, :] < (ln - k + 1)[:, None]
        r, p = torch.nonzero(ok, as_tuple=True)
        f, rv = fwd[r, p], rev[r, p]
        vals.append(torch.minimum(f, rv))
        strands.append((rv < f).to(_I64))
        reads.append(r + r0)
        poss.append(p)
    val = torch.cat(vals)
    read, pos, strand = torch.cat(reads), torch.cat(poss), torch.cat(strands)
    uniq, inverse, counts = torch.unique(val, sorted=True, return_inverse=True,
                                         return_counts=True)
    reliable = (counts >= lower) & (counts <= upper)
    colmap = torch.where(reliable, torch.cumsum(reliable.to(_I64), 0) - 1, -1)
    col = colmap[inverse]
    keep = col >= 0
    return KmerTable(
        read=read[keep], pos=pos[keep], strand=strand[keep], col=col[keep],
        m_reliable=int(reliable.sum()), n_unique=int(uniq.numel()),
        n_singleton=int((counts < lower).sum()))


# --------------------------------------------------------------------------
# CreateSpMat
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KmerMatrix:
    """A's kept entries by (read, col) and Aᵀ's entries grouped by col."""

    a_read: torch.Tensor
    a_col: torch.Tensor
    a_code: torch.Tensor  # 2·pos + strand of the k-mer's first occurrence
    at_ptr: torch.Tensor  # (m + 1,) start of each column's reads
    at_read: torch.Tensor  # reads of each column, ascending
    at_code: torch.Tensor
    nnz_a: int
    overflow_a: int


def kmer_matrix(kt: KmerTable, n_reads: int, *, read_capacity: int
                ) -> KmerMatrix:
    """A and Aᵀ from the reliable instances."""
    dev = kt.read.device
    m = kt.m_reliable
    width = int(kt.pos.max()) + 1 if kt.pos.numel() else 1
    key = (kt.read * max(m, 1) + kt.col) * width + kt.pos
    order = torch.sort(key).indices
    pair = (kt.read * max(m, 1) + kt.col)[order]
    first = torch.ones_like(pair, dtype=torch.bool)
    first[1:] = pair[1:] != pair[:-1]
    idx = order[first]  # one instance a (read, col): its first occurrence
    read, col = kt.read[idx], kt.col[idx]
    code = 2 * kt.pos[idx] + kt.strand[idx]
    # rank among the read's distinct columns (already ascending)
    start = torch.searchsorted(read, read, side="left")
    rank = torch.arange(read.numel(), device=dev) - start
    kept = rank < read_capacity
    # Aᵀ: every (col, read), reads ascending in a column
    order_t = torch.sort(col * n_reads + read).indices
    at_ptr = torch.zeros(m + 1, dtype=_I64, device=dev)
    at_ptr[1:] = torch.cumsum(torch.bincount(col, minlength=m), 0)
    return KmerMatrix(
        a_read=read[kept], a_col=col[kept], a_code=code[kept],
        at_ptr=at_ptr, at_read=read[order_t], at_code=code[order_t],
        nnz_a=int(kept.sum()), overflow_a=int((~kept).sum()))


# --------------------------------------------------------------------------
# SpGEMM
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Candidates:
    """C's kept entries and the alignment candidates among them."""

    nnz_c: int
    overflow_c: int
    products: int  # semiring products of A·Aᵀ (shared k-mer instances)
    i: torch.Tensor  # candidate pairs, i < j, by (i, j)
    j: torch.Tensor
    cnt: torch.Tensor
    a_code: torch.Tensor  # the first shared k-mer in i and in j
    b_code: torch.Tensor


def overlap_candidates(km: KmerMatrix, n_reads: int, *, overlap_capacity: int,
                       min_shared: int, rows_per_block: int = 8192
                       ) -> Candidates:
    """C = A·Aᵀ, row by row block; returns the candidate pairs."""
    dev = km.a_read.device
    deg = km.at_ptr[km.a_col + 1] - km.at_ptr[km.a_col]
    row_start = torch.searchsorted(
        km.a_read, torch.arange(0, n_reads + rows_per_block, rows_per_block,
                                device=dev))
    nnz = ovf = products = 0
    out = {key: [] for key in ("i", "j", "cnt", "a", "b")}
    for blk in range(row_start.numel() - 1):
        e0, e1 = int(row_start[blk]), int(row_start[blk + 1])
        if e1 <= e0:
            continue
        d = deg[e0:e1]
        total = int(d.sum())
        products += total
        src = torch.repeat_interleave(torch.arange(e0, e1, device=dev), d,
                                      output_size=total)
        off = torch.arange(total, device=dev) - torch.repeat_interleave(
            torch.cumsum(d, 0) - d, d, output_size=total)
        at = km.at_ptr[km.a_col[src]] + off
        i, j = km.a_read[src], km.at_read[at]
        # products are in (i, col, j) order: a stable sort by (i, j)
        # leaves each pair's shared k-mers in column order
        order = torch.sort(i * n_reads + j, stable=True).indices
        key = (i * n_reads + j)[order]
        head = torch.ones_like(key, dtype=torch.bool)
        head[1:] = key[1:] != key[:-1]
        first = torch.nonzero(head).reshape(-1)
        cnt = torch.diff(first, append=torch.tensor([key.numel()], device=dev))
        pi, pj = key[first] // n_reads, key[first] % n_reads
        rank = torch.arange(pi.numel(), device=dev) - torch.searchsorted(
            pi, pi, side="left")
        kept = rank < overlap_capacity
        nnz += int(kept.sum())
        ovf += int((~kept).sum())
        cand = kept & (pj > pi) & (cnt >= min_shared)
        out["i"].append(pi[cand])
        out["j"].append(pj[cand])
        out["cnt"].append(cnt[cand])
        out["a"].append(km.a_code[src[order[first[cand]]]])
        out["b"].append(km.at_code[at[order[first[cand]]]])
    cat = {key: (torch.cat(v) if v else torch.zeros(0, dtype=_I64, device=dev))
           for key, v in out.items()}
    return Candidates(nnz_c=nnz, overflow_c=ovf, products=products,
                      i=cat["i"], j=cat["j"], cnt=cat["cnt"], a_code=cat["a"],
                      b_code=cat["b"])


# --------------------------------------------------------------------------
# Alignment and BuildR
# --------------------------------------------------------------------------

def revcomp_rows(rows, lengths):
    """Reverse complement of zero-padded code rows (padding at the end)."""
    width = rows.shape[1]
    idx = lengths.to(_I64)[:, None] - 1 - torch.arange(width, device=rows.device)
    got = torch.gather(rows.to(_I64), 1, torch.clamp(idx, 0, width - 1))
    return torch.where(idx >= 0, 3 - got, 0).to(torch.uint8)


def align(codes, lengths, i, j, a_code, b_code, cfg: dict, *,
          count_cells: bool = False) -> Dict[str, torch.Tensor]:
    """Seed-and-extend of pairs (i, j) from their first shared k-mer: score,
    spans, the score test and the overlap classes."""
    k = cfg["k"]
    li = lengths[i].to(_I64)
    lj = lengths[j].to(_I64)
    strand = (a_code % 2) ^ (b_code % 2)
    pa = a_code // 2
    pb = torch.where(strand == 1, lj - k - b_code // 2, b_code // 2)
    pa, pb = torch.clamp(pa, min=0), torch.clamp(pb, min=0)
    ra = codes[i]
    rb = codes[j]
    rb = torch.where((strand == 1)[:, None], revcomp_rows(rb, lj), rb)
    kw = dict(xdrop=cfg["xdrop"], match=cfg["match"], mismatch=cfg["mismatch"],
              gap=cfg["gap"], band=cfg["band"], max_steps=cfg["max_steps"],
              count_cells=count_cells)
    one = torch.ones_like(pa)
    # both directions as one batch of walks over the same rows
    out = xdrop_walks(
        torch.cat([ra, ra]), torch.cat([pa + k, pa - 1]), torch.cat([one, -one]),
        torch.cat([li - pa - k, pa]), torch.cat([rb, rb]),
        torch.cat([pb + k, pb - 1]), torch.cat([one, -one]),
        torch.cat([lj - pb - k, pb]), **kw)
    e = pa.numel()
    fs, bs = out[0][:e].to(_I64), out[0][e:].to(_I64)
    fa, ba = out[1][:e].to(_I64), out[1][e:].to(_I64)
    fb, bb = out[2][:e].to(_I64), out[2][e:].to(_I64)
    res = {"score": k * cfg["match"] + fs + bs, "bi": pa - ba, "ei": pa + k + fa,
           "bj": pb - bb, "ej": pb + k + fb, "li": li, "lj": lj,
           "strand": strand}
    if count_cells:
        res["cells"] = out[3][:e] + out[3][e:]
    span = torch.minimum(res["ei"] - res["bi"], res["ej"] - res["bj"])
    frac = torch.tensor(cfg["score_frac"], dtype=torch.float32)
    res["passed"] = ((res["score"].float() >= frac.to(span.device)
                      * span.float()) & (span >= cfg["min_overlap"]))
    fuzz = cfg["end_fuzz"]
    left_i, right_i = res["bi"], li - res["ei"]
    left_j, right_j = res["bj"], lj - res["ej"]
    ci = (left_i <= fuzz) & (right_i <= fuzz)
    cj = (left_j <= fuzz) & (right_j <= fuzz)
    both = ci & cj  # equal spans: the shorter read is contained, ties to i
    ci, cj = ci & (~both | (li <= lj)), cj & (~both | (lj < li))
    res["cont_i"], res["cont_j"] = ci, cj
    res["fwd_ij"] = (right_i <= fuzz) & (left_j <= fuzz) & ~(ci | cj)
    res["fwd_ji"] = (left_i <= fuzz) & (right_j <= fuzz) & ~(ci | cj)
    return res


def _edge_value(suffix: int, combo: int) -> np.ndarray:
    v = np.full(4, INF, np.float32)
    v[combo] = suffix
    return v


def r_rows(reads, al: Dict[str, torch.Tensor],
           contained_other: Optional[np.ndarray], *, r_capacity: int,
           totals: Optional[dict] = None):
    """Rows of R for ``reads``, from the alignments ``al`` of every
    candidate pair that holds one of them (``al`` rows follow ``cand``'s
    order on the subset the caller chose).  ``contained_other`` gives the
    contained flag of every other read; ``None`` where ``reads`` are all
    the reads, whose own flags then serve.  Returns ``{read: (contained,
    [(col, value(4,)), ...])}`` with each row as the graph keeps it, and
    fills ``totals`` with the edges past the rows' capacity
    (``overflow``), the contained reads and the edges kept (``nnz``)."""
    h = {key: v.cpu().numpy() for key, v in al.items()}
    want = set(int(r) for r in reads)
    rows: Dict[int, list] = {r: [] for r in want}
    cont = {r: False for r in want}
    for t in range(h["i"].shape[0]):
        i, j = int(h["i"][t]), int(h["j"][t])
        if not h["passed"][t]:
            continue
        s = int(h["strand"][t])
        if h["cont_i"][t] and i in want:
            cont[i] = True
        if h["cont_j"][t] and j in want:
            cont[j] = True
        if h["fwd_ij"][t]:
            if i in want:  # i → j, suffix of j, strands (0, s)
                rows[i].append((j, _edge_value(int(h["lj"][t] - h["ej"][t]), s)))
            if j in want:  # its complement j → i, strands (1 - s, 1)
                rows[j].append((i, _edge_value(int(h["bi"][t]),
                                               2 * (1 - s) + 1)))
        if h["fwd_ji"][t]:
            if j in want:  # j → i, suffix of i, strands (s, 0)
                rows[j].append((i, _edge_value(int(h["li"][t] - h["ei"][t]),
                                               2 * s)))
            if i in want:  # its complement i → j, strands (1, 1 - s)
                rows[i].append((j, _edge_value(int(h["bj"][t]), 2 + 1 - s)))
    if contained_other is None:
        contained_other = np.zeros(max(want) + 1 if want else 0, bool)
        contained_other[[r for r in want if cont[r]]] = True
    out = {}
    for r in want:
        row = sorted(rows[r], key=lambda e: e[0])[:r_capacity]
        if cont[r]:
            row = []
        row = [(c, v) for c, v in row if not contained_other[c]]
        out[r] = (cont[r], row)
    if totals is not None:
        totals["overflow"] = sum(max(0, len(rows[r]) - r_capacity)
                                 for r in want)
        totals["contained"] = sum(cont.values())
        totals["nnz"] = sum(len(row) for _, row in out.values())
    return out


# --------------------------------------------------------------------------
# TrReduction
# --------------------------------------------------------------------------

def _mp_product(a, b):
    """2×2 min-plus product of (E, 4) values: out[2x+y] = min_c a[2x+c] +
    b[2c+y]."""
    out = []
    for x in range(2):
        for y in range(2):
            out.append(torch.minimum(a[:, 2 * x] + b[:, y],
                                     a[:, 2 * x + 1] + b[:, 2 + y]))
    return torch.stack(out, dim=1)


def transitive_reduction(ri, rj, rv, n_reads: int, *, fuzz: float,
                         max_iters: int):
    """Algorithm 2 on an edge list (rows ``ri``, cols ``rj``, values ``rv``
    (E, 4) float32, sorted by (ri, rj)).  Returns ``(si, sj, sv,
    iterations, products)``: ``products`` the two-hop min-plus products
    each iteration formed and ``sizes`` its edge count as it began."""
    dev = rv.device
    fz = torch.tensor(fuzz, dtype=torch.float32, device=dev)
    prev, cur, it, products, sizes = -1, int(ri.numel()), 0, [], []
    while cur != prev and it < max_iters:
        e = ri.numel()
        sizes.append(e)
        fin = torch.isfinite(rv)
        rowmax = torch.full((n_reads,), -INF, dtype=torch.float32, device=dev)
        rowmax.scatter_reduce_(0, ri, torch.where(fin, rv, -INF).amax(dim=1),
                               "amax")
        limit = rowmax + fz
        # two-hop paths i → k → j with (i, j) an edge
        ptr = torch.searchsorted(ri, torch.arange(n_reads + 1, device=dev))
        deg = (ptr[1:] - ptr[:-1])[rj]  # out-edges of k for each (i, k)
        total = int(deg.sum())
        first = torch.repeat_interleave(torch.arange(e, device=dev), deg,
                                        output_size=total)
        off = torch.arange(total, device=dev) - torch.repeat_interleave(
            torch.cumsum(deg, 0) - deg, deg, output_size=total)
        second = ptr[rj[first]] + off
        key = ri * n_reads + rj
        want = ri[first] * n_reads + rj[second]
        at = torch.clamp(torch.searchsorted(key, want), max=max(e - 1, 0))
        hit = (key[at] == want) if e else torch.zeros(0, dtype=torch.bool,
                                                      device=dev)
        prod = _mp_product(rv[first[hit]], rv[second[hit]])
        products.append(int(hit.sum()))
        two_hop = torch.full((e, 4), INF, dtype=torch.float32, device=dev)
        two_hop.scatter_reduce_(0, at[hit][:, None].expand(-1, 4), prod,
                                "amin")
        transitive = (fin & torch.isfinite(two_hop)
                      & (two_hop <= limit[ri][:, None]))
        rv = torch.where(transitive, INF, rv)
        alive = torch.isfinite(rv).any(dim=1)
        ri, rj, rv = ri[alive], rj[alive], rv[alive]
        prev, cur, it = cur, int(ri.numel()), it + 1
    return ri, rj, rv, it, products, sizes


# --------------------------------------------------------------------------
# Contigs
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ContigLayout:
    """Contigs as chains of states (2·read + strand) with each piece's
    width, offset and read length, and the draft bases."""

    states: List[List[int]]
    widths: List[List[int]]
    offsets: List[List[int]]
    codes: List[np.ndarray]
    n_branch_cut: int


def _oriented(codes: np.ndarray, lengths: np.ndarray, state: int) -> np.ndarray:
    r = state >> 1
    row = codes[r, :lengths[r]]
    return (3 - row[::-1]) if state & 1 else row


def contigs(si, sj, sv, contained, codes: np.ndarray, lengths: np.ndarray
            ) -> ContigLayout:
    """The unitig walk of the string graph S (edge list, host numpy)."""
    n = codes.shape[0]
    si, sj, sv = (x.cpu().numpy() for x in (si, sj, sv))
    e, combo = np.nonzero(np.isfinite(sv))
    u = 2 * si[e] + (combo >> 1)
    v = 2 * sj[e] + (combo & 1)
    suf = sv[e, combo].astype(np.int64)
    out_deg = np.bincount(u, minlength=2 * n)
    in_deg = np.bincount(v, minlength=2 * n)
    keep = (out_deg[u] == 1) & (in_deg[v] == 1)
    n_branch_cut = int(u.size - keep.sum())
    succ = np.full(2 * n, -1, np.int64)
    pred = np.full(2 * n, -1, np.int64)
    insuf = np.zeros(2 * n, np.int64)
    succ[u[keep]] = v[keep]
    pred[v[keep]] = u[keep]
    insuf[v[keep]] = suf[keep]
    # cut every cycle at its least state
    seen = np.zeros(2 * n, bool)
    for s0 in np.flatnonzero(succ >= 0):
        if seen[s0]:
            continue
        path, cur = [], s0
        while cur >= 0 and not seen[cur]:
            seen[cur] = True
            path.append(cur)
            cur = succ[cur]
        if cur >= 0 and cur in path:  # closed on itself
            cyc = path[path.index(cur):]
            head = min(cyc)
            succ[pred[head]] = -1
            pred[head] = -1
    chains = []
    for h in np.flatnonzero((pred < 0) & (out_deg > 0)):
        chain, cur = [int(h)], int(h)
        while succ[cur] >= 0:
            cur = int(succ[cur])
            chain.append(cur)
        chains.append(chain)
    emitted = {tuple(c) for c in chains}
    kept = [c for c in chains
            if not ((tw := tuple(s ^ 1 for s in reversed(c))) in emitted
                    and tw < tuple(c))]
    kept.sort(key=min)
    lay = ContigLayout([], [], [], [], n_branch_cut)
    for chain in kept:
        widths, offsets, parts, off = [], [], [], 0
        for t, s in enumerate(chain):
            ln = int(lengths[s >> 1])
            w = ln if t == 0 else min(int(insuf[s]), ln)
            o = _oriented(codes, lengths, s)
            parts.append(o[ln - w:])
            widths.append(w)
            offsets.append(off)
            off += w
        lay.states.append(chain)
        lay.widths.append(widths)
        lay.offsets.append(offsets)
        lay.codes.append(np.concatenate(parts).astype(np.uint8))
    has_edge = np.zeros(n, bool)
    has_edge[si[e]] = True
    has_edge[sj[e]] = True
    for r in np.flatnonzero(~has_edge & ~np.asarray(contained, bool)):
        ln = int(lengths[r])
        lay.states.append([2 * int(r)])
        lay.widths.append([ln])
        lay.offsets.append([0])
        lay.codes.append(codes[r, :ln].astype(np.uint8).copy())
    return lay


# --------------------------------------------------------------------------
# Consensus
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Polished:
    """Polished contigs and the stage's counts."""

    codes: List[np.ndarray]
    n_changed: int
    n_shifted: int
    votes: int  # (column, piece) positions that were tested for a vote


def polish(lay: ContigLayout, codes: np.ndarray, lengths: np.ndarray, *,
           min_depth: int, radius: int, device="cpu") -> Polished:
    """Refine each junction, re-lay the draft and re-call every column."""
    dev = torch.device(device)
    pc, pt, ps, pstart, plen = [], [], [], [], []
    for c, (states, widths, offsets) in enumerate(
            zip(lay.states, lay.widths, lay.offsets)):
        for t, (s, w, o) in enumerate(zip(states, widths, offsets)):
            ln = int(lengths[s >> 1])
            pc.append(c)
            pt.append(t)
            ps.append(s)
            pstart.append(o + w - ln)
            plen.append(ln)
    pc, pt, ps, pstart, plen = (torch.tensor(x, dtype=_I64, device=dev)
                                for x in (pc, pt, ps, pstart, plen))
    n_pieces, width = pc.numel(), codes.shape[1]
    codes_t = torch.as_tensor(codes, device=dev)
    lens_t = torch.as_tensor(lengths, device=dev).to(_I64)
    rows = codes_t[ps >> 1]
    pieces = torch.where((ps & 1 == 1)[:, None], revcomp_rows(rows, lens_t[ps >> 1]),
                         rows).to(_I64)

    # junction refinement: shift 0 first, then outward, first best wins
    shifts = [0] + [d for a in range(1, radius + 1) for d in (-a, a)]
    jn = torch.nonzero(pt >= 1).reshape(-1)
    prv = jn - 1
    delta0 = pstart[jn] - pstart[prv]
    ov = pstart[prv] + plen[prv] - pstart[jn]
    lo = torch.clamp(ov - JUNCTION_WIN, min=0)
    b = lo[:, None] + torch.arange(JUNCTION_WIN + radius + 1, device=dev)[None, :]
    in_cur = b < plen[jn][:, None]
    cur = torch.gather(pieces[jn], 1, torch.clamp(b, max=width - 1))
    scores = []
    for d in shifts:
        idx = b + delta0[:, None] + d
        ok = in_cur & (idx >= 0) & (idx < plen[prv][:, None])
        got = torch.gather(pieces[prv], 1, torch.clamp(idx, 0, width - 1))
        scores.append((ok & (got == cur)).sum(dim=1))
    sc = torch.stack(scores, dim=1)
    best, pick = torch.max(sc, dim=1)
    sc0 = sc[:, 0]
    take = ((best > sc0 + torch.clamp(sc0 // 2, min=8))
            & (5 * best >= 4 * torch.clamp(ov, max=JUNCTION_WIN)))
    dbest = torch.where(take, torch.tensor(shifts, device=dev)[pick], 0)
    step = torch.zeros(n_pieces, dtype=_I64, device=dev)
    step[jn] = delta0 + dbest

    # the refined layout, contig by contig (host loop over contigs)
    step_h, plen_h, pc_h = (x.cpu().numpy() for x in (step, plen, pc))
    start_h = np.zeros(n_pieces, np.int64)
    off_h = np.zeros(n_pieces, np.int64)
    wid_h = np.zeros(n_pieces, np.int64)
    n_contigs = len(lay.states)
    clen = np.zeros(n_contigs, np.int64)
    bounds = np.searchsorted(pc_h, np.arange(n_contigs + 1))
    for c in range(n_contigs):
        a0, a1 = bounds[c], bounds[c + 1]
        st = np.cumsum(step_h[a0:a1])
        run_end = np.maximum.accumulate(st + plen_h[a0:a1])
        prev_end = np.concatenate([[0], run_end[:-1]])
        start_h[a0:a1] = st
        off_h[a0:a1] = prev_end
        wid_h[a0:a1] = np.maximum(run_end - prev_end, 0)
        clen[c] = run_end.max()
    l_all = max(int(clen.max(initial=0)), 1)

    # the refined draft, all contigs end to end in one flat array: each
    # piece's last `width` bases at its offset
    base0 = np.concatenate([[0], np.cumsum(clen)])
    draft = torch.zeros(int(base0[-1]) + 1, dtype=_I64, device=dev)
    start_t, off_t, wid_t, cbase, clen_t = (
        torch.as_tensor(x, device=dev)
        for x in (start_h, off_h, wid_h, base0[:-1], clen))
    bpos = torch.arange(width, device=dev)[None, :]
    blocks = range(0, n_pieces, PIECE_BLOCK)
    for p0 in blocks:
        sl = slice(p0, p0 + PIECE_BLOCK)
        skip = (plen[sl] - wid_t[sl])[:, None]
        put = (bpos >= skip) & (bpos < plen[sl][:, None])
        dst = cbase[pc[sl]][:, None] + off_t[sl][:, None] + bpos - skip
        draft[dst[put]] = pieces[sl][put]

    # the coherence-gated vote; columns past a contig's end up to the
    # longest contig's read as A (code 0), as the padded draft holds them
    counts = torch.zeros((int(base0[-1]) + 1) * 4, dtype=_I64, device=dev)
    votes = 0
    for p0 in blocks:
        sl = slice(p0, p0 + PIECE_BLOCK)
        pl = plen[sl][:, None]
        col = start_t[sl][:, None] + bpos
        cb0 = cbase[pc[sl]][:, None]
        cl = clen_t[pc[sl]][:, None]
        tried = (bpos < pl) & (col >= 0) & (col < l_all)
        match = torch.zeros_like(col)
        valid = torch.zeros_like(col)
        for w in range(-COH_WIN, COH_WIN + 1):
            if w == 0:
                continue
            rb, cb = bpos + w, col + w
            ok = (rb >= 0) & (rb < pl) & (cb >= 0) & (cb < l_all)
            rv = torch.gather(pieces[sl], 1,
                              torch.clamp(rb, 0, width - 1).expand_as(col))
            inside = (cb >= 0) & (cb < cl)
            dv = torch.where(inside, draft[torch.where(inside, cb0 + cb, 0)], 0)
            match += (ok & (rv == dv)).to(_I64)
            valid += ok.to(_I64)
        ok = (tried & (col < cl) & (COH_DEN * match >= COH_NUM * valid)
              & (valid >= COH_MIN_VALID))
        votes += int(tried.sum())
        idx = (cb0 + col) * 4 + pieces[sl]
        counts.index_add_(0, idx[ok], torch.ones_like(idx[ok]))
    counts = counts.view(-1, 4)[:-1]
    draft = draft[:-1]
    depth = counts.sum(dim=1)
    win, winner = torch.max(counts, dim=1)  # the smallest code of a tie
    change = (depth >= min_depth) & (2 * win > depth)
    polished = torch.where(change, winner, draft)
    n_changed = int((polished != draft).sum())
    pol = polished.to(torch.uint8).cpu().numpy()
    return Polished(codes=[pol[base0[c]:base0[c + 1]] for c in range(n_contigs)],
                    n_changed=n_changed, n_shifted=int((dbest != 0).sum()),
                    votes=votes)
