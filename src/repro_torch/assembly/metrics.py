"""Truth-based assembly quality metrics.

The port's own copy of ``repro.assembly.metrics`` (host-side numpy, not
part of the compute path): map a contig back to its simulated-genome
interval through the per-read truth positions of ``simulate.ReadSet``, and
measure per-base identity with a banded edit-distance DP — the measured
counterpart of the consensus stage's vote-agreement estimate.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def banded_edit_distance(a, b, band: int = 64) -> int:
    """Levenshtein distance restricted to |i−j| ≤ band (unit costs).

    The band is widened to at least the length difference + 1, so the
    result is the exact distance whenever the optimal path stays inside
    it."""
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return la + lb
    band = max(int(band), abs(la - lb) + 1)
    ks = np.arange(-band, band + 1)  # slot k ↔ column j = i + k
    inf = la + lb + 1
    prev = np.where((ks >= 0) & (ks <= lb), np.abs(ks), inf)  # dp[0][j] = j
    for i in range(1, la + 1):
        j = i + ks
        bj = np.clip(j - 1, 0, lb - 1)
        sub = np.where(a[i - 1] == b[bj], 0, 1)
        diag = prev + sub  # dp[i-1][j-1] lives in the same slot
        up = np.concatenate([prev[1:], [inf]]) + 1  # dp[i-1][j]
        cand = np.minimum(diag, up)
        cand = np.where((j >= 1) & (j <= lb), cand, inf)
        if i <= band:  # the slot of j == 0 exists: dp[i][0] = i
            cand[band - i] = i
        # close the row under left gaps: dp[i][j] = min_{j'≤j} cand[j'] + (j−j')
        cur = np.minimum.accumulate(cand - j) + j
        prev = np.minimum(cur, inf)
    return int(prev[lb - la + band])


def identity(a, b, band: int = 64) -> float:
    """Per-base identity 1 − edit/max(len) between two code arrays."""
    la, lb = len(a), len(b)
    if max(la, lb) == 0:
        return 1.0
    return 1.0 - banded_edit_distance(a, b, band) / max(la, lb)


def contig_truth_interval(contig, readset) -> Tuple[int, int, int]:
    """Genome interval ``(lo, hi, orientation)`` a contig derives from: the
    union span of its reads' truth intervals, oriented by the majority of
    ``truth_strand[r] ^ s`` over its chain."""
    rs = [r for r, _ in contig.reads]
    lo = int(min(readset.truth_start[r] for r in rs))
    hi = int(max(readset.truth_end[r] for r in rs))
    flips = [int(readset.truth_strand[r]) ^ int(s) for r, s in contig.reads]
    o = int(sum(flips) * 2 >= len(flips))
    return lo, hi, o


def contig_identity_vs_truth(contig, readset, band: int = 64) -> float:
    """Identity of a contig against its own simulated-genome interval."""
    lo, hi, o = contig_truth_interval(contig, readset)
    ref = readset.genome[lo:hi]
    if o:
        ref = (3 - ref)[::-1]
    return identity(contig.codes, ref, band=band)


def assembly_identity(contigs: List, readset, *, min_reads: int = 1,
                      band: int = 64) -> Tuple[float, int]:
    """Length-weighted mean identity over the contigs with ≥ ``min_reads``
    chain reads.  Returns ``(identity, total_bases_measured)``."""
    num = 0.0
    den = 0
    for c in contigs:
        if len(c.reads) < min_reads or c.length == 0:
            continue
        num += contig_identity_vs_truth(c, readset, band=band) * c.length
        den += c.length
    return (num / den if den else 1.0), den
