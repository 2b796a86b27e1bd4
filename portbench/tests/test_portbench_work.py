"""The frozen work counts on cases small enough to count by hand."""

import numpy as np
import pytest
import torch

from portbench.reference import assembler as ref
from portbench.reference import work

INF = float("inf")


def _row(*vals):
    return [INF if v is None else float(v) for v in vals]


def test_transitive_reduction_counts_each_two_hop_product():
    # 0 → 1 → 2 and 0 → 2, all on the forward strands (combo 0): one two-hop
    # product at the pattern in the first iteration, none in the second
    ri = torch.tensor([0, 0, 1])
    rj = torch.tensor([1, 2, 2])
    rv = torch.tensor([_row(100, None, None, None), _row(250, None, None, None),
                       _row(150, None, None, None)])
    si, sj, sv, iters, products, sizes = ref.transitive_reduction(
        ri, rj, rv, 3, fuzz=10.0, max_iters=8)
    assert (si.tolist(), sj.tolist()) == ([0, 1], [1, 2])
    assert iters == 2 and products == [1, 0] and sizes == [3, 2]
    w = work.stage_work(
        n_aligned=0, sampled_cells=torch.zeros(0), sampled_pairs=0,
        pair_read_bytes=0, nnz_a=0, nnz_at=0, nnz_c=0, products=0,
        tr_products=products, tr_sizes=sizes, nnz_s=2, votes=0, columns=0)
    assert w["TrReduction"]["ops"] == 16
    assert w["TrReduction"]["bytes"] == 20 * (3 + 2) + 20 * 2


def test_overlap_products_are_the_shared_kmer_instances():
    # reads 0, 1, 2; k-mer columns 0 (reads 0, 1), 1 (reads 0, 1, 2), 2 (1, 2)
    kt = ref.KmerTable(
        read=torch.tensor([0, 1, 0, 1, 2, 1, 2]),
        pos=torch.tensor([5, 7, 9, 11, 3, 20, 8]),
        strand=torch.tensor([0, 0, 1, 0, 0, 1, 1]),
        col=torch.tensor([0, 0, 1, 1, 1, 2, 2]),
        m_reliable=3, n_unique=3, n_singleton=0)
    km = ref.kmer_matrix(kt, 3, read_capacity=8)
    assert km.nnz_a == 7 and km.overflow_a == 0
    cand = ref.overlap_candidates(km, 3, overlap_capacity=8, min_shared=2)
    # a product per (A entry, read of its column): 2·2 + 3·3 + 2·2
    assert cand.products == 17
    # C: 0-0, 0-1, 0-2, 1-0, 1-1, 1-2, 2-0, 2-1, 2-2
    assert cand.nnz_c == 9 and cand.overflow_c == 0
    # pairs i < j sharing two k-mers: (0, 1) (cols 0, 1) and (1, 2) (1, 2)
    assert list(zip(cand.i.tolist(), cand.j.tolist())) == [(0, 1), (1, 2)]
    assert cand.cnt.tolist() == [2, 2]
    # the seed is the first shared k-mer in column order
    assert cand.a_code.tolist() == [2 * 5 + 0, 2 * 11 + 0]
    assert cand.b_code.tolist() == [2 * 7 + 0, 2 * 3 + 0]


def test_row_capacity_keeps_the_smallest_columns():
    kt = ref.KmerTable(
        read=torch.tensor([0, 0, 0, 1, 2, 3]),
        pos=torch.tensor([0, 1, 2, 0, 0, 0]),
        strand=torch.zeros(6, dtype=torch.int64),
        col=torch.tensor([0, 1, 2, 0, 1, 2]),
        m_reliable=3, n_unique=3, n_singleton=0)
    km = ref.kmer_matrix(kt, 4, read_capacity=2)
    assert km.nnz_a == 5 and km.overflow_a == 1
    cand = ref.overlap_candidates(km, 4, overlap_capacity=2, min_shared=1)
    # row 0 holds columns 0, 1 (its k-mer 2 is cut from A, not from Aᵀ), so
    # reaches reads 0, 1, 2 and keeps 0 and 1; rows 1, 2, 3 each reach
    # themselves and read 0 (read 3 through column 2, which Aᵀ keeps)
    assert cand.nnz_c == 2 + 2 + 2 + 2 and cand.overflow_c == 1
    assert cand.products == 4 + 2 + 2 + 2


def test_xdrop_cells_of_an_exact_match():
    # identical 6-base walks: the band cells on each step's parity inside
    # both sequences are the whole 6 × 6 grid
    a = torch.tensor([[0, 1, 2, 3, 0, 1]], dtype=torch.uint8)
    one = torch.ones(1, dtype=torch.int64)
    s, ia, jb, cells = ref.xdrop_walks(
        a, 0 * one, one, 6 * one, a.clone(), 0 * one, one, 6 * one, xdrop=100,
        match=1, mismatch=-1, gap=-1, band=65, max_steps=4096, count_cells=True)
    assert (int(s), int(ia), int(jb)) == (6, 6, 6)
    assert int(cells) == 36  # every (i, j) of the 6 × 6 grid, once


def test_polish_tests_every_base_of_every_piece():
    lay = ref.ContigLayout(states=[[0]], widths=[[5]], offsets=[[0]],
                           codes=[np.array([0, 1, 2, 3, 0], np.uint8)],
                           n_branch_cut=0)
    codes = np.array([[0, 1, 2, 3, 0, 0]], np.uint8)
    pol = ref.polish(lay, codes, np.array([5], np.int32), min_depth=2,
                     radius=2)
    assert pol.votes == 5 and pol.n_changed == 0 and pol.n_shifted == 0
    assert pol.codes[0].tolist() == [0, 1, 2, 3, 0]


@pytest.mark.parametrize("ops,op_type,nbytes,bound", [
    (33.5e12, "f32", 1.0, "operations"),
    (1.0, "int32", 3.35e12 * 2, "bytes"),
])
def test_least_time_is_the_larger_bound(ops, op_type, nbytes, bound):
    t, by = work.least_time({"ops": ops, "op_type": op_type, "bytes": nbytes})
    assert by == bound
    assert t == pytest.approx(max(ops / work.PEAKS[op_type],
                                  nbytes / work.PEAKS["bytes"]))
