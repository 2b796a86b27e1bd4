"""Device-side contig generation (DESIGN.md §2.7), in torch.

The PyTorch counterpart of ``repro.assembly.contig_gen``'s device path
(its ``distribution="shard_map"`` chain stage is
``core/components_dist.py``):

1. expand S into the 2n-vertex state graph;
2. branch cut: keep edge u→v iff out-degree(u) == 1 and in-degree(v) == 1;
3. cut cycles at their minimum state, label unitigs by pointer-doubling
   path components and rank states within each chain;
4. drop reverse-complement twin chains, lay each contig out as (row,
   offset) per state and gather the oriented read suffixes of the contigs,
   end to end, into one flat uint8 tensor of their live bases.

The only host reads are five scalars (#chains, max chain length, #contigs,
max contig length, total contig length) that size the chain rows (padded
to powers of two) and the packed contig set between the steps.  The steps are spans: ``Contigs.chains`` (1–3), ``Contigs.layout``
and ``Contigs.gather`` (4).  The op ``contig_gen`` is registered with ``"reference"`` = the host
walk of ``contigs.py`` and ``"cuda"`` = this device path; both give
identical contigs.  ``string_matrix_from_edges`` and
``consistent_chain_graph`` build string matrices for tests and benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.backend import dispatch, register_op, resolve_distribution
from ..core.components import (
    break_cycles,
    chain_rank,
    degrees,
    expand_states,
    path_components,
)
from ..core.semiring import MP, minplus_orient_semiring
from ..core.spmat import EllMatrix, from_coo, next_pow2
from ..obs import schema, span, validated
from .contigs import (
    Contig,
    extract_contig_chains,
    materialize_contigs,
    materialize_packed,
    pad_rows,
    state_edges,
)

_BIG = 2**30
_I32 = torch.int32


@dataclasses.dataclass
class ContigSet:
    """Batched contig tensors + per-piece provenance (see
    ``repro.assembly.contig_gen.ContigSet``), packed: the contigs lie end to
    end, contig ``c`` taking ``lengths[c]`` of the bases and ``n_pieces[c]``
    of the pieces.  A piece is one state of the contig's chain (a
    singleton's one read); it wrote the last ``widths[p]`` of its oriented
    read's bases at columns ``[offsets[p], offsets[p] + widths[p])`` of its
    contig.  Only live bases and pieces are held: :meth:`padded` gives the
    padded layout of the JAX package's ``ContigSet``."""

    codes: Any  # (B,) uint8, every contig's bases, end to end
    lengths: Any  # (C,) int32
    states: Any  # (P,) int32, every contig's chain, end to end
    offsets: Any  # (P,) int32
    widths: Any  # (P,) int32
    n_pieces: Any  # (C,) int32
    n_contigs: int
    stats: Dict[str, Any]

    def to_contigs(self) -> List[Contig]:
        """The contigs as host ``Contig`` records."""
        return materialize_packed(self.codes, self.lengths, self.states,
                                  self.n_pieces)

    def padded(self, rows=None, cols=None, slots=None):
        """``(codes (rows, cols), lengths (rows,), states, offsets, widths
        (rows, slots))``: the padded layout (``states`` −1 padded, the rest
        0), by default as small as holds the set.  For comparisons with the
        padded layout; the pipeline never builds it."""
        rows = self.n_contigs if rows is None else rows
        lens = torch.zeros(rows, dtype=self.lengths.dtype,
                           device=self.lengths.device)
        lens[:self.n_contigs] = self.lengths
        return (pad_rows(self.codes, self.lengths, rows=rows, cols=cols),
                lens,
                pad_rows(self.states, self.n_pieces, rows=rows, cols=slots,
                         fill=-1),
                pad_rows(self.offsets, self.n_pieces, rows=rows, cols=slots),
                pad_rows(self.widths, self.n_pieces, rows=rows, cols=slots))


ZERO_EXCHANGE_STATS = schema.zero_defaults("contig_exchange")


def string_matrix_from_edges(n_reads, edges, *, capacity=8) -> EllMatrix:
    """A min-plus string matrix (CPU tensors) from an explicit edge list —
    test and benchmark scaffolding.  ``edges``: iterable of ``(i, j, strand_i,
    strand_j, suffix)`` directed state-graph edges."""
    edges = list(edges)
    ok = torch.ones(len(edges), dtype=torch.bool)
    if not edges:
        edges = [(0, 0, 0, 0, 0)]
        ok = torch.zeros(1, dtype=torch.bool)
    arr = np.asarray(edges, np.int64)
    e = arr.shape[0]
    combo = 2 * arr[:, 2] + arr[:, 3]
    vals = np.full((e, 4), np.inf, np.float32)
    vals[np.arange(e), combo] = arr[:, 4]
    mat, _ = from_coo(
        torch.from_numpy(arr[:, 0].astype(np.int32)),
        torch.from_numpy(arr[:, 1].astype(np.int32)),
        {MP: torch.from_numpy(vals)}, ok,
        n_rows=n_reads, n_cols=n_reads, capacity=capacity,
        semiring=minplus_orient_semiring,
    )
    return mat


def consistent_chain_graph(n, seed, *, err=0.0, break_every=None):
    """Dovetail-chain string matrix whose reads are slices of one synthetic
    genome (optionally ``err`` substitutions, optionally broken into
    separate chains every ``break_every`` reads) — test and benchmark
    scaffolding for the consensus stage.  The same seed gives the same
    graph and reads as the JAX package's.  Returns ``(s_mat, codes,
    lengths, genome)`` with numpy reads."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(180, 250, n).astype(np.int32)
    pos = np.zeros(n, np.int64)
    edges = []
    for i in range(n - 1):
        ov = int(min(rng.integers(80, 140), lengths[i] - 1,
                     lengths[i + 1] - 1))
        pos[i + 1] = pos[i] + lengths[i] - ov
        if break_every is None or i % break_every != break_every - 1:
            edges.append((i, i + 1, 0, 0, int(lengths[i + 1]) - ov))
            edges.append((i + 1, i, 1, 1, int(lengths[i]) - ov))
    genome = rng.integers(0, 4, int(pos[-1] + lengths[-1]), dtype=np.uint8)
    lmax = int(lengths.max())
    codes = np.zeros((n, lmax), np.uint8)
    for i in range(n):
        codes[i, : lengths[i]] = genome[pos[i]: pos[i] + lengths[i]]
    if err > 0:
        flip = rng.random((n, lmax)) < err
        codes = np.where(
            flip, (codes + rng.integers(1, 4, (n, lmax))) % 4, codes
        ).astype(np.uint8)
    s = string_matrix_from_edges(n, edges, capacity=8)
    return s, codes, lengths, genome


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int64), 0).to(_I32)


def _graph_cut(s: EllMatrix):
    """State graph + branch cut: the functional succ/pred pointer pair."""
    g = expand_states(s)
    n2 = g.n_cols
    dev = g.cols.device
    out_deg, in_deg = degrees(g)
    tgt = torch.amax(torch.where(g.mask, g.cols, -1), dim=1)
    suf = torch.sum(torch.where(g.mask, g.vals[MP], 0.0), dim=1)
    tgt_safe = torch.where(tgt >= 0, tgt, 0).to(torch.int64)
    kept = (out_deg == 1) & (tgt >= 0) & (in_deg[tgt_safe] == 1)
    succ0 = torch.where(kept, tgt, -1).to(_I32)
    n_branch_cut = torch.sum(out_deg) - torch.sum(kept)
    # in_deg(target) == 1 makes each pred/insuf slot single-writer
    ids = torch.arange(n2, dtype=_I32, device=dev)
    tk = succ0[kept].to(torch.int64)
    pred0 = torch.full((n2,), -1, dtype=_I32, device=dev)
    pred0[tk] = ids[kept]
    insuf = torch.zeros(n2, dtype=torch.float32, device=dev)
    insuf[tk] = suf[kept]
    has_edge = (out_deg + in_deg).reshape(-1, 2).sum(dim=1) > 0  # per read
    return {
        "succ0": succ0,
        "pred0": pred0,
        "insuf": insuf,
        "out_deg": out_deg,
        "has_edge": has_edge,
        "n_branch_cut": n_branch_cut,
    }


def _doubling_local(succ0, pred0):
    """Cut cycles, label unitigs, rank states within each chain."""
    succ, pred, _ = break_cycles(succ0, pred0)
    labels, cc_iters = path_components(succ, pred)
    head, rank, _ = chain_rank(pred)
    return {"labels": labels, "head": head, "rank": rank,
            "cc_iterations": cc_iters}


def _order_chains(cut, dbl):
    """States grouped by (unitig label, in-chain rank), eligible chains
    first, label-ascending — the canonical chain order."""
    out_deg, insuf = cut["out_deg"], cut["insuf"]
    labels, head, rank = dbl["labels"], dbl["head"], dbl["rank"]
    n2 = labels.shape[0]
    dev = labels.device
    eligible = out_deg[head.to(torch.int64)] > 0
    primary = torch.where(eligible, labels, _BIG).to(torch.int64)
    order = torch.sort((primary << 31) | rank.to(torch.int64),
                       stable=True).indices
    state_s = order.to(_I32)
    elig_s = eligible[order]
    lab_s = labels[order]
    rank_s = rank[order]
    prev = torch.where(torch.arange(n2, device=dev) == 0, -1,
                       torch.roll(lab_s, 1))
    new_chain = elig_s & (lab_s != prev)
    return {
        "state_s": state_s,
        "elig_s": elig_s,
        "rank_s": rank_s,
        "chain_idx_s": _cumsum32(new_chain) - 1,
        "new_chain": new_chain,
        "insuf": insuf,
        "has_edge": cut["has_edge"],
        "n_chains": torch.sum(new_chain),
        "max_chain": torch.amax(torch.where(elig_s, rank_s, -1)) + 1,
        "n_branch_cut": cut["n_branch_cut"],
        "cc_iterations": dbl["cc_iterations"],
    }


def _chain_state(s: EllMatrix, *, distribution: str = "gspmd", mesh=None,
                 row_axes=None):
    """Graph cut → doubling → chain ordering.  Returns ``(st,
    dist_stats)``.

    ``"gspmd"`` runs the single-device path, with the exchange accounting
    present and zero; ``"shard_map"`` runs all three sub-stages over the
    grid rows of ``mesh`` (default: every rank a grid row), on its axes
    ``row_axes`` (default: its ``("pod", "data")`` axes), in
    ``core/components_dist.contig_stage_shard_map``, with its measured
    per-phase words and rounds."""
    if resolve_distribution(distribution) == "shard_map":
        from ..core.components_dist import contig_stage_shard_map

        st, xstats = contig_stage_shard_map(s, mesh=mesh, row_axes=row_axes)
        return st, {**ZERO_EXCHANGE_STATS, **xstats}
    cut = _graph_cut(s)
    st = _order_chains(cut, _doubling_local(cut["succ0"], cut["pred0"]))
    return st, dict(ZERO_EXCHANGE_STATS)


def _chain_layout(st, lengths, contained, *, ca: int, m: int):
    """Chain rows, RC-twin dedup and the per-piece destination layout."""
    state_s, elig_s = st["state_s"], st["elig_s"]
    rank_s, chain_idx_s = st["rank_s"], st["chain_idx_s"]
    n2 = state_s.shape[0]
    dev = state_s.device
    ar_m = torch.arange(m, device=dev)

    e_chain = chain_idx_s[elig_s].to(torch.int64)
    e_col = torch.clamp(rank_s[elig_s], max=m - 1).to(torch.int64)
    rows = torch.full((ca, m), -1, dtype=_I32, device=dev)
    rows[e_chain, e_col] = state_s[elig_s]
    valid = rows[:, 0] >= 0
    chain_len = torch.sum(rows >= 0, dim=1).to(_I32)
    heads = rows[:, 0]
    tail = torch.gather(rows, 1, torch.clamp(chain_len - 1, min=0)
                        .to(torch.int64)[:, None])[:, 0]

    # RC-twin dedup: chain c = [u0..uk] is dropped iff its twin
    # t = [uk^1..u0^1] is also an emitted chain and t < c lexicographically;
    # heads are unique, so "t emitted" ⇔ the chain headed by tail^1 equals t
    tcol = torch.clamp(chain_len[:, None] - 1 - ar_m[None, :], 0, m - 1)
    tw = torch.gather(rows, 1, tcol.to(torch.int64))
    in_chain = ar_m[None, :] < chain_len[:, None]
    tw = torch.where(in_chain, tw ^ 1, -1)
    chain_of_head = torch.full((n2,), -1, dtype=_I32, device=dev)
    chain_of_head[heads[valid].to(torch.int64)] = torch.arange(
        ca, dtype=_I32, device=dev)[valid]
    twin_head = torch.clamp(torch.where(valid, tail ^ 1, 0), 0, n2 - 1)
    cand = torch.where(valid, chain_of_head[twin_head.to(torch.int64)], -1)
    cand_safe = torch.where(cand >= 0, cand, 0).to(torch.int64)
    is_twin = ((cand >= 0) & (chain_len[cand_safe] == chain_len)
               & torch.all(rows[cand_safe] == tw, dim=1))
    neq = (rows != tw) & in_chain
    first = torch.argmax(neq.to(_I32), dim=1)[:, None]
    a = torch.gather(rows, 1, first)[:, 0]
    b = torch.gather(tw, 1, first)[:, 0]
    keep = valid & ~(is_twin & torch.any(neq, dim=1) & (b < a))

    n_chain_contigs = torch.sum(keep).to(_I32)

    # piece layout in sorted state space: width (bases this state appends)
    # and destination offset (segmented exclusive prefix sum in the chain)
    chain_clip = torch.clamp(chain_idx_s, 0, ca - 1).to(torch.int64)
    piece_on = elig_s & keep[chain_clip]
    read_len = lengths[(state_s >> 1).to(torch.int64)]
    width = torch.where(
        rank_s == 0,
        read_len,
        torch.minimum(torch.round(st["insuf"][state_s.to(torch.int64)]).to(_I32),
                      read_len),
    )
    width = torch.where(piece_on, width, 0).to(_I32)
    excl = _cumsum32(width) - width
    seg_total = torch.zeros(ca, dtype=_I32, device=dev)
    seg_total.index_add_(0, e_chain, width[elig_s])
    seg_base = _cumsum32(seg_total) - seg_total
    dst = torch.where(piece_on, excl - seg_base[chain_clip], 0).to(_I32)

    # isolated reads (no state-graph edges at all) → singleton contigs
    iso = ~st["has_edge"] & ~contained
    n_contigs = n_chain_contigs + torch.sum(iso).to(_I32)
    zero = torch.zeros((), dtype=_I32, device=dev)
    max_len = torch.maximum(
        torch.amax(torch.where(keep, seg_total, zero)),
        torch.amax(torch.where(iso, lengths, zero)),
    )
    total = (torch.sum(torch.where(keep, seg_total, zero), dtype=torch.int64)
             + torch.sum(torch.where(iso, lengths, zero), dtype=torch.int64))
    return {
        "keep": keep,
        "chain_len": chain_len,
        "contig_len": seg_total,
        "piece_on": piece_on,
        "dst": dst,
        "width": width,
        "iso": iso,
        "n_contigs": n_contigs,
        "max_len": max_len,
        "total": total,
    }


def _piece_bases(codes, lengths, states, widths, *, total: int):
    """The last ``widths[p]`` bases of each piece's oriented read, the
    pieces end to end: ``(total,)`` uint8, one gather of the live bases."""
    dev = codes.device
    w = widths.to(torch.int64)
    p = torch.repeat_interleave(torch.arange(w.numel(), device=dev), w,
                                output_size=total)
    b = torch.arange(total, device=dev) - (torch.cumsum(w, 0) - w)[p]
    s = states.to(torch.int64)[p]
    r = s >> 1
    rc = (s & 1) == 1
    take = w[p]
    idx = torch.where(rc, take - 1 - b, lengths.to(torch.int64)[r] - take + b)
    base = codes[r, idx]
    return torch.where(rc, 3 - base, base)


def _pack_contigs(st, lay, codes, lengths, *, total: int):
    """The packed contig set: the kept chains in row order, then the
    isolated reads' singletons.  Each chain's states come rank by rank,
    their offsets the running sum of their widths, so the pieces' bases
    follow each other and the contigs' bases lie end to end."""
    n = codes.shape[0]
    dev = codes.device
    on, iso, keep = lay["piece_on"], lay["iso"], lay["keep"]
    reads = torch.arange(n, dtype=_I32, device=dev)[iso]
    states = torch.cat([st["state_s"][on], 2 * reads])
    offsets = torch.cat([lay["dst"][on], torch.zeros_like(reads)])
    widths = torch.cat([lay["width"][on], lengths[iso]])
    out_len = torch.cat([lay["contig_len"][keep], lengths[iso]])
    n_pieces = torch.cat([lay["chain_len"][keep], torch.ones_like(reads)])
    bases = _piece_bases(codes, lengths, states, widths, total=total)
    return bases, out_len, states, offsets, widths, n_pieces


def _device_contig_gen(s_mat, codes, lengths, contained=None, *,
                       distribution: str = "gspmd", mesh=None,
                       row_axes=None) -> ContigSet:
    """Device array path of the ``contig_gen`` op."""
    codes = codes.to(torch.uint8)
    lengths = lengths.to(_I32)
    n = codes.shape[0]
    contained = (torch.zeros(n, dtype=torch.bool, device=codes.device)
                 if contained is None else contained.to(torch.bool))
    with span("Contigs.chains", kind="step", distribution=distribution) as sp:
        st, dist_stats = _chain_state(s_mat, distribution=distribution,
                                      mesh=mesh, row_axes=row_axes)
        n_chains = int(st["n_chains"])
        max_chain = int(st["max_chain"])
        sp.annotate(n_chains=n_chains, max_chain=max_chain)
    with span("Contigs.layout", kind="step") as sp:
        lay = _chain_layout(st, lengths, contained, ca=next_pow2(n_chains),
                            m=next_pow2(max_chain))
        n_contigs = int(lay["n_contigs"])
        max_len = int(lay["max_len"])
        total = int(lay["total"])
        sp.annotate(n_contigs=n_contigs, max_len=max_len)
    with span("Contigs.gather", kind="step", n_contigs=n_contigs,
              max_len=max_len, live_bases=total):
        out_codes, out_len, out_states, out_offs, out_widths, n_pieces = (
            _pack_contigs(st, lay, codes, lengths, total=total))
        stats = validated(
            {
                "n_branch_cut": int(st["n_branch_cut"]),
                "cc_iterations": int(st["cc_iterations"]),
                "distribution": distribution,
                **dist_stats,
            },
            context="contig_gen", require_groups=("contig_exchange",),
        )
    return ContigSet(codes=out_codes, lengths=out_len, states=out_states,
                     offsets=out_offs, widths=out_widths, n_pieces=n_pieces,
                     n_contigs=n_contigs, stats=stats)


def _reference_contig_gen(s_mat, codes, lengths, contained=None, *,
                          distribution: str = "gspmd", mesh=None,
                          row_axes=None) -> ContigSet:
    """Host walk (``contigs.py``) packed into the ContigSet contract; its
    stats report ``distribution="host"``."""
    del distribution, mesh, row_axes
    dev = codes.device
    codes_np = codes.cpu().numpy()
    lengths_np = lengths.cpu().numpy()
    edges = state_edges(s_mat)
    chains, n_branch_cut = extract_contig_chains(s_mat, _edges=edges)
    contigs = materialize_contigs(chains, edges[2], codes_np, lengths_np,
                                  contained)
    c = len(contigs)
    out = (np.concatenate([ct.codes for ct in contigs]) if contigs
           else np.zeros(0, np.uint8)).astype(np.uint8)
    lens = np.asarray([ct.length for ct in contigs], np.int32)
    n_pieces = np.asarray([len(ct.reads) for ct in contigs], np.int32)
    states = np.asarray([2 * r + s for ct in contigs for r, s in ct.reads],
                        np.int32)
    offs = np.zeros(states.shape, np.int32)
    widths = np.zeros(states.shape, np.int32)
    # materialize_contigs appends isolated singletons after the chain
    # contigs: chains[i] is the provenance of contigs[i], every later contig
    # a single full-read piece at offset 0
    p = 0
    for i, ct in enumerate(contigs):
        if i < len(chains):
            off = 0
            for t, (state, suf) in enumerate(chains[i]):
                rl = int(lengths_np[state >> 1])
                w = rl if t == 0 else min(int(suf), rl)
                offs[p + t] = off
                widths[p + t] = w
                off += w
        else:
            widths[p] = lens[i]
        p += len(ct.reads)

    def dev_t(x):
        return torch.from_numpy(x).to(dev)

    return ContigSet(
        codes=dev_t(out), lengths=dev_t(lens), states=dev_t(states),
        offsets=dev_t(offs), widths=dev_t(widths),
        n_pieces=dev_t(n_pieces), n_contigs=c,
        stats=validated(
            {
                "n_branch_cut": int(n_branch_cut),
                "cc_iterations": 0,
                "distribution": "host",
                **ZERO_EXCHANGE_STATS,
            },
            context="contig_gen_host", require_groups=("contig_exchange",),
        ),
    )


register_op("contig_gen", "reference", _reference_contig_gen)
register_op("contig_gen", "cuda", _device_contig_gen)


def generate_contigs(s_mat, codes, lengths, contained=None, *,
                     backend: str = "auto", distribution: str = "gspmd",
                     mesh=None, row_axes=None) -> ContigSet:
    """Contigs stage entry point: the registered ``contig_gen`` backend on
    string matrix S (``"reference"`` host walk, ``"cuda"`` device path,
    whose chain stage ``distribution="shard_map"`` runs over the grid rows
    ``row_axes`` of ``mesh``)."""
    return dispatch("contig_gen", backend, codes.device)(
        s_mat, codes, lengths, contained,
        distribution=resolve_distribution(distribution), mesh=mesh,
        row_axes=row_axes,
    )
