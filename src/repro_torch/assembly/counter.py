"""Sort-based k-mer counting and A-matrix construction (paper §IV-C/D), in
torch.

The PyTorch counterpart of ``repro.assembly.counter``: one global stable
sort of the packed canonical k-mer stream gives exact counts, the reliable
window ``[lower, upper]``, compact column ids and, through the inverse
permutation, the COO triplets of A (reads × k-mers) and Aᵀ.  The JAX
package's ``lexsort((lo, hi))`` is one stable sort on the int64 key
``hi << 31 | lo`` (both words are below 2^31, the invalid sentinel 2^30
included).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.semiring import Semiring
from ..core.spmat import from_coo
from ..obs import span


def _first_runs(vals, run_id, run_start):
    return {"pos": vals["pos"][run_start]}


# "keep-first" semiring for A / Aᵀ: duplicate (row, col) instances of a k-mer
# within one read keep the first position
first_semiring = Semiring(
    name="first_pos",
    mul=lambda a, b: {"pos": a["pos"] + 0 * b["pos"]},
    add=lambda x, y: x,
    zero=lambda s, device=None: {"pos": torch.full(tuple(s), -1,
                                                   dtype=torch.int32,
                                                   device=device)},
    is_zero=lambda v: v["pos"] < 0,
    reduce_runs=_first_runs,
)


class KmerCount(NamedTuple):
    """Fused counting result (flat (n·P,) instance-aligned tensors)."""

    read_id: torch.Tensor
    pos_code: torch.Tensor  # pos*2 + strand
    col_id: torch.Tensor  # compact reliable-kmer id, -1 if unreliable
    count: torch.Tensor  # frequency of this instance's k-mer
    reliable: torch.Tensor  # bool
    m_reliable: torch.Tensor  # number of reliable unique k-mers
    n_unique: torch.Tensor
    n_singleton: torch.Tensor


def count_and_select(kmers: dict, *, lower: int = 2, upper: int = 8) -> KmerCount:
    """Count every canonical k-mer and select the reliable ones; ``kmers``
    is the dict of ``extract_kmers``."""
    n, p = kmers["hi"].shape
    e = n * p
    dev = kmers["hi"].device
    with span("CountKmer.sort", kind="step", instances=e):
        hi = kmers["hi"].reshape(e)
        lo = kmers["lo"].reshape(e)
        valid = kmers["valid"].reshape(e)
        read_id = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
        read_id = read_id.expand(n, p).reshape(e)
        pos_code = (kmers["pos"] * 2 + kmers["strand"]).reshape(e)

        big = 2**30
        hik = torch.where(valid, hi, big).to(torch.int64)
        lok = torch.where(valid, lo, big).to(torch.int64)
        order = torch.sort((hik << 31) | lok, stable=True).indices
        hs, ls, vs = hik[order], lok[order], valid[order]

    with span("CountKmer.runs", kind="step", instances=e) as sp:
        new_run = torch.ones(e, dtype=torch.bool, device=dev)
        new_run[1:] = (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])
        idx = torch.arange(e, dtype=torch.int64, device=dev)
        # each instance's count is its run's length: the run starts (one
        # host sync) give the lengths, a device-wide prefix sum of the
        # starts gives each instance's run
        starts = torch.nonzero(new_run).squeeze(1)
        sp.annotate(runs=starts.numel())
        lens = torch.diff(starts, append=starts.new_full((1,), e))
        run_id = torch.cumsum(new_run, 0, dtype=torch.int32) - 1
        count_s = lens.to(torch.int32).index_select(0, run_id)
        count_s = torch.where(vs, count_s, 0)

    with span("CountKmer.select", kind="step", instances=e):
        reliable_s = vs & (count_s >= lower) & (count_s <= upper)
        rel_run_start = new_run & reliable_s
        col_s = (torch.cumsum(rel_run_start.to(torch.int32), 0) - 1).to(
            torch.int32)
        col_s = torch.where(reliable_s, col_s, -1)

        inv = torch.empty(e, dtype=torch.int64, device=dev)
        inv[order] = idx
        return KmerCount(
            read_id=read_id,
            pos_code=pos_code,
            col_id=col_s[inv],
            count=count_s[inv],
            reliable=reliable_s[inv],
            m_reliable=torch.sum(rel_run_start).to(torch.int32),
            n_unique=torch.sum(new_run & vs).to(torch.int32),
            n_singleton=torch.sum(new_run & vs & (count_s < lower)).to(
                torch.int32),
        )


def build_matrices(kc: KmerCount, *, n_reads: int, m_capacity: int,
                   read_capacity: int, kmer_capacity: int):
    """A (reads × k-mers, value pos*2+strand) and Aᵀ from the counting
    result.  Returns (A, Aᵀ, overflow_a, overflow_at)."""
    ok = kc.reliable & (kc.col_id >= 0)
    vals = {"pos": kc.pos_code}
    a, ovf_a = from_coo(kc.read_id, kc.col_id, vals, ok, n_rows=n_reads,
                        n_cols=m_capacity, capacity=read_capacity,
                        semiring=first_semiring)
    at, ovf_at = from_coo(kc.col_id, kc.read_id, vals, ok, n_rows=m_capacity,
                          n_cols=n_reads, capacity=kmer_capacity,
                          semiring=first_semiring)
    return a, at, ovf_a, ovf_at
