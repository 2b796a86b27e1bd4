"""``assembly/contigs.materialize_rows``: the padded contig tensors as host
``Contig`` records, from the live rows and bases alone, equal to slicing
each padded row (the records the draft ``ContigSet`` and the polished
``ConsensusResult`` give)."""

import numpy as np
import pytest
import torch

from repro_torch.assembly.contigs import _live_bases, materialize_rows


def _padded(seed, n_contigs, rows, width, m):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (rows, width)).astype(np.uint8)
    lengths = rng.integers(0, width + 1, rows).astype(np.int32)
    if n_contigs:
        lengths[0] = width  # a row filled to the padded width
    if n_contigs > 2:
        lengths[1] = 0
    states = np.full((rows, m), -1, np.int32)
    for i in range(rows):
        k = int(rng.integers(1, m + 1))
        states[i, :k] = rng.integers(0, 1000, k)
    return codes, lengths, states


def _by_slicing(codes, lengths, states, n_contigs):
    return [([(int(s) >> 1, int(s) & 1) for s in states[i] if s >= 0],
             int(lengths[i]), codes[i, :lengths[i]])
            for i in range(n_contigs)]


@pytest.mark.parametrize("as_tensor", [True, False])
@pytest.mark.parametrize("n_contigs,rows", [(5, 8), (8, 8), (1, 4), (0, 4)])
def test_materialize_rows_equals_slicing_each_row(as_tensor, n_contigs, rows):
    codes, lengths, states = _padded(n_contigs + rows, n_contigs, rows, 37, 6)
    want = _by_slicing(codes, lengths, states, n_contigs)
    args = ((torch.from_numpy(codes), torch.from_numpy(lengths),
             torch.from_numpy(states)) if as_tensor
            else (codes, lengths, states))
    got = materialize_rows(*args, n_contigs)
    assert len(got) == n_contigs
    for c, (reads, length, bases) in zip(got, want):
        assert c.reads == reads and c.length == length
        assert type(c.length) is int and all(
            type(x) is int for r in c.reads for x in r)
        assert c.codes.dtype == np.uint8
        np.testing.assert_array_equal(c.codes, bases)


def test_live_bases_take_the_live_prefix_of_each_row():
    codes = torch.arange(24, dtype=torch.uint8).reshape(4, 6)
    lens = np.array([2, 0, 6, 1], np.int64)
    np.testing.assert_array_equal(
        _live_bases(codes, lens), np.array([0, 1, 12, 13, 14, 15, 16, 17, 18],
                                           np.uint8))
    assert _live_bases(codes, lens[:0]).shape == (0,)
