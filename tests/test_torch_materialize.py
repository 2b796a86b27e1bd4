"""``assembly/contigs.materialize_packed`` and ``pad_rows``: the packed
contig tensors as host ``Contig`` records, from one transfer of the live
bases, equal to slicing each row of the padded layout (the records the
draft ``ContigSet`` and the polished ``ConsensusResult`` give); and the
packed tensors laid back out as padded rows."""

import numpy as np
import pytest
import torch

from repro_torch.assembly.contigs import materialize_packed, pad_rows


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


def _packed(codes, lengths, states, n_contigs):
    """The first ``n_contigs`` rows, packed: bases, lengths, states and
    the states of each row."""
    lens = lengths[:n_contigs]
    live = states[:n_contigs] >= 0
    flat = (np.concatenate([codes[i, :lens[i]] for i in range(n_contigs)])
            if n_contigs else np.zeros(0, np.uint8))
    return (flat, lens, states[:n_contigs][live],
            live.sum(axis=1).astype(np.int32))


@pytest.mark.parametrize("as_tensor", [True, False])
@pytest.mark.parametrize("n_contigs,rows", [(5, 8), (8, 8), (1, 4), (0, 4)])
def test_materialize_rows_equals_slicing_each_row(as_tensor, n_contigs, rows):
    codes, lengths, states = _padded(n_contigs + rows, n_contigs, rows, 37, 6)
    want = _by_slicing(codes, lengths, states, n_contigs)
    args = _packed(codes, lengths, states, n_contigs)
    if as_tensor:
        args = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in args)
    got = materialize_packed(*args)
    assert len(got) == n_contigs
    for c, (reads, length, bases) in zip(got, want):
        assert c.reads == reads and c.length == length
        assert type(c.length) is int and all(
            type(x) is int for r in c.reads for x in r)
        assert c.codes.dtype == np.uint8
        np.testing.assert_array_equal(c.codes, bases)


def test_live_bases_take_the_live_prefix_of_each_row():
    """``pad_rows`` lays packed values back out as rows, each row's live
    prefix then ``fill``, at the shape asked for or the least that holds
    them."""
    codes = torch.arange(24, dtype=torch.uint8).reshape(4, 6)
    lens = torch.tensor([2, 0, 6, 1], dtype=torch.int32)
    flat = codes[torch.arange(6)[None, :] < lens[:, None]]
    np.testing.assert_array_equal(
        flat.numpy(), np.array([0, 1, 12, 13, 14, 15, 16, 17, 18], np.uint8))
    back = pad_rows(flat, lens, rows=5, cols=7, fill=9)
    assert back.shape == (5, 7) and back.dtype == torch.uint8
    want = torch.full((5, 7), 9, dtype=torch.uint8)
    for i, n in enumerate(lens.tolist()):
        want[i, :n] = codes[i, :n]
    assert torch.equal(back, want)
    assert pad_rows(flat, lens).shape == (4, 6)
    assert pad_rows(flat[:0], lens[:0]).shape == (0, 0)
