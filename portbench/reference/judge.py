"""The comparison that decides ``correct``, and the work the roofline
shares count.

:func:`judge` runs the plain reference (``reference.assembler``) on the
run's reads and compares what the program's timed path produced.  Every
number compared is a count of disagreements, with the limit 0:

* ``kmer_counts`` — the CountKmer stats (reliable, distinct and singleton
  k-mers) the program reports that differ from the reference's count;
* ``a_matrix`` — CreateSpMat's kept entries and overflow of A;
* ``c_matrix`` — SpGEMM's kept entries and overflow of C, and the pairs
  the Alignment stage extends (``n_aligned``);
* ``r_rows`` — for a sample of reads drawn from the seed, every candidate
  pair holding one of them is aligned by the reference; a sampled read
  whose contained flag or whose row of R (columns and suffix values)
  differs counts one.  The neighbours' contained flags are the program's
  (the sample checks those of its own reads).  Where the sample is every
  read (``sample_reads`` at least the read count: the whole check), the
  reference's own flags serve, and the pairs that passed, R's kept and
  overflowing edges and the contained reads are compared too;
* ``s_graph`` — rows of S that differ from the reference's transitive
  reduction of the program's R, plus the iteration and edge counts;
* ``contigs`` — draft contigs (chain and bases) that differ from the
  reference's walk of its own S, plus the count difference and the branch
  cuts;
* ``polished`` — polished contigs that differ from the reference's
  consensus of its own contigs, plus the changed columns and shifted
  junctions.

Only Alignment and BuildR are checked on a sample; every other stage is
checked whole.  Where the reference follows the program's state (R for the
transitive reduction, the contained flags of reads outside the sample),
that state is itself checked on the sample.  A fault in one
``align_chunk`` launch changes up to that many pairs, which touch about as
many reads; a sample of ``s`` reads out of ``n`` then misses all of them
with odds of about ``(1 - chunk / n) ** s``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import assembler as ref
from . import work as work_mod

_I64 = torch.int64
ALIGN_BLOCK = 65536  # pairs the plain x-drop takes at a time


@dataclasses.dataclass
class ProgramOutput:
    """What the program's timed path produced, as plain host arrays."""

    stats: dict
    r_cols: np.ndarray  # (n, K_R) int32, -1 empty
    r_vals: np.ndarray  # (n, K_R, 4) float32
    s_cols: np.ndarray
    s_vals: np.ndarray
    contained: np.ndarray  # (n,) bool
    draft: List[Tuple[List[int], np.ndarray]]  # (states, bases) a contig
    polished: List[Tuple[List[int], np.ndarray]]


def _edges(cols: np.ndarray, vals: np.ndarray):
    r, q = np.nonzero(cols >= 0)
    return r.astype(np.int64), cols[r, q].astype(np.int64), vals[r, q]


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _count_diff(pairs, what: str = "") -> int:
    bad = [(a, b) for a, b in pairs if a != b]
    if bad:
        _say(f"{what}: program / reference {bad}")
    return len(bad)


def _rows_differ(a, b) -> int:
    """Rows whose edge sets differ, between two (rows, cols, vals) lists."""
    def as_set(e):
        r, c, v = e
        return {(int(x), int(y), tuple(float(t) for t in z))
                for x, y, z in zip(r, c, v)}
    diff = as_set(a) ^ as_set(b)
    rows = sorted({t[0] for t in diff})
    if rows:
        _say(f"s_graph: rows {rows[:5]} differ")
    return len(rows)


def _contigs_differ(prog, states, codes, what: str) -> int:
    bad = abs(len(prog) - len(states))
    if bad:
        _say(f"{what}: {len(prog)} contigs / {len(states)}")
    for t, ((ps, pc), rs, rc) in enumerate(zip(prog, states, codes)):
        if list(ps) != list(rs) or not np.array_equal(pc, rc):
            bad += 1
            if bad <= 3:
                _say(f"{what}: contig {t}, {len(ps)} / {len(rs)} reads, "
                     f"{len(pc)} / {len(rc)} bases")
    return bad


def judge(codes, lengths, out: ProgramOutput, cfg: dict, *, seed: int,
          sample_reads: int):
    """Run the reference on ``codes``/``lengths`` (tensors on the device the
    reference should use) and compare ``out``.  Returns ``(checks, work)``:
    ``checks`` maps each name to ``(value, limit)``; ``work`` holds the
    stages' operation and byte counts (``reference.work``)."""
    dev = codes.device
    n = int(codes.shape[0])
    st = out.stats
    checks: Dict[str, Tuple[int, int]] = {}

    kt = ref.count_kmers(codes, lengths, k=cfg["k"], lower=cfg["lower"],
                         upper=cfg["upper"])
    checks["kmer_counts"] = (_count_diff([
        (st["m_reliable"], kt.m_reliable), (st["n_unique_kmers"], kt.n_unique),
        (st["n_singletons"], kt.n_singleton)], "kmer_counts"), 0)
    km = ref.kmer_matrix(kt, n, read_capacity=cfg["read_capacity"])
    del kt
    checks["a_matrix"] = (_count_diff([
        (st["nnz_A"], km.nnz_a), (st["overflow_A"], km.overflow_a)], "a_matrix"),
        0)
    cand = ref.overlap_candidates(km, n, overlap_capacity=cfg["overlap_capacity"],
                                  min_shared=cfg["min_shared_kmers"])
    checks["c_matrix"] = (_count_diff([
        (st["nnz_C"], cand.nnz_c), (st["overflow_C"], cand.overflow_c),
        (st["n_aligned"], int(cand.i.numel()))], "c_matrix"), 0)

    # Alignment and BuildR on the rows of a sample of reads
    whole = sample_reads >= n
    rng = np.random.default_rng([int(seed) % (1 << 64), 11])
    sample = (np.arange(n) if whole else
              np.sort(rng.choice(n, size=sample_reads, replace=False)))
    in_sample = torch.zeros(n, dtype=torch.bool, device=dev)
    in_sample[torch.as_tensor(sample, device=dev)] = True
    pick = torch.nonzero(in_sample[cand.i] | in_sample[cand.j]).reshape(-1)
    parts = []
    for p0 in range(0, int(pick.numel()), ALIGN_BLOCK):
        p = pick[p0:p0 + ALIGN_BLOCK]
        parts.append(ref.align(codes, lengths, cand.i[p], cand.j[p],
                               cand.a_code[p], cand.b_code[p], cfg,
                               count_cells=True))
    al = ({key: torch.cat([q[key] for q in parts]) for key in parts[0]}
          if parts else ref.align(codes, lengths, cand.i[:0], cand.j[:0],
                                  cand.a_code[:0], cand.b_code[:0], cfg,
                                  count_cells=True))
    al["i"], al["j"] = cand.i[pick], cand.j[pick]
    totals: dict = {}
    expect = ref.r_rows(sample, al, None if whole else out.contained,
                        r_capacity=cfg["r_capacity"], totals=totals)
    bad_rows = 0
    if whole:
        bad_rows += _count_diff([
            (st["n_passed"], int(al["passed"].sum())),
            (st["nnz_R"], totals["nnz"]), (st["overflow_R"], totals["overflow"]),
            (st["n_contained"], totals["contained"])], "r_rows")
    for r in sample:
        cont, row = expect[int(r)]
        live = out.r_cols[r] >= 0
        got_cols = out.r_cols[r][live].astype(np.int64)
        got_vals = out.r_vals[r][live]
        want_cols = np.asarray([c for c, _ in row], np.int64)
        want_vals = (np.stack([v for _, v in row]) if row
                     else np.zeros((0, 4), np.float32))
        if (bool(out.contained[r]) != cont
                or not np.array_equal(got_cols, want_cols)
                or not np.array_equal(got_vals, want_vals)):
            bad_rows += 1
            if bad_rows <= 3:
                _say(f"r_rows: read {int(r)} contained {bool(out.contained[r])}"
                     f" / {cont}, columns {got_cols.tolist()} / "
                     f"{want_cols.tolist()}")
    checks["r_rows"] = (bad_rows, 0)

    # TrReduction of the program's R
    ri, rj, rv = _edges(out.r_cols, out.r_vals)
    si, sj, sv, iters, tr_products, tr_sizes = ref.transitive_reduction(
        torch.as_tensor(ri, device=dev), torch.as_tensor(rj, device=dev),
        torch.as_tensor(rv, device=dev), n, fuzz=cfg["tr_fuzz"],
        max_iters=cfg["tr_max_iters"])
    s_ref = (si.cpu().numpy(), sj.cpu().numpy(), sv.cpu().numpy())
    checks["s_graph"] = (_rows_differ(_edges(out.s_cols, out.s_vals), s_ref)
                         + _count_diff([(st["tr_iterations"], iters),
                                        (st["nnz_S"], int(si.numel()))],
                                       "s_graph"), 0)

    # Contigs and Consensus from the reference's own S
    codes_h = codes.cpu().numpy()
    lengths_h = lengths.cpu().numpy()
    lay = ref.contigs(si, sj, sv, out.contained, codes_h, lengths_h)
    checks["contigs"] = (_contigs_differ(out.draft, lay.states, lay.codes, "contigs")
                         + _count_diff([(st["n_branch_cut"], lay.n_branch_cut)],
                                       "contigs"), 0)
    pol = ref.polish(lay, codes_h, lengths_h, min_depth=cfg["min_depth"],
                     radius=cfg["junction_radius"], device=dev)
    checks["polished"] = (_contigs_differ(out.polished, lay.states, pol.codes,
                                          "polished")
                          + _count_diff([
                              (st["consensus_changed"], pol.n_changed),
                              (st["n_junction_shifted"], pol.n_shifted)],
                              "polished"), 0)

    work = work_mod.stage_work(
        n_aligned=int(cand.i.numel()),
        sampled_cells=al["cells"], sampled_pairs=int(pick.numel()),
        pair_read_bytes=int((lengths[cand.i].to(_I64)
                             + lengths[cand.j].to(_I64)).sum()),
        nnz_a=km.nnz_a, nnz_at=int(km.at_read.numel()), nnz_c=cand.nnz_c,
        products=cand.products,
        tr_products=tr_products, tr_sizes=tr_sizes, nnz_s=int(si.numel()),
        votes=pol.votes, columns=int(sum(len(c) for c in pol.codes)))
    return checks, work
