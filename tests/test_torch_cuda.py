"""The port's CUDA kernels on the card, each against its plain version.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip elsewhere
(the decision is made inside the ``card`` fixture, never at import).  On
the card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.assembly.pipeline import PipelineConfig, assemble
from repro_torch.assembly.simulate import simulate_genome, simulate_reads
from repro_torch.core.semiring import (
    MP,
    minplus_orient_semiring,
    overlap_semiring,
)
from repro_torch.kernels.spgemm import ops as tops

import _kmer_cases
import _masked_cases
import _pileup_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("band,direction", [(9, 1), (33, -1), (65, 1), (97, -1)])
def test_xdrop_kernel_matches_plain(card, band, direction):
    rng = np.random.default_rng(band)
    e, la, lb = 37, 150, 130
    a = rng.integers(0, 4, (e, la)).astype(np.uint8)
    b = a[:, :lb].copy()
    b = np.where(rng.random(b.shape) < 0.08, (b + 1) % 4, b).astype(np.uint8)
    la_ = rng.integers(10, la + 1, e).astype(np.int32)
    lb_ = rng.integers(10, lb + 1, e).astype(np.int32)
    base_a = np.zeros(e, np.int32) if direction == 1 else la_ - 1
    base_b = np.zeros(e, np.int32) if direction == 1 else lb_ - 1
    step = np.full(e, direction, np.int32)
    args = [torch.from_numpy(np.array(x)).to(card)
            for x in (a, base_a, step, la_, b, base_b, step, lb_)]
    kw = dict(band=band, max_steps=la + lb, xdrop=25)
    got = K.xdrop_extend_batch(*args, **kw)
    want = K.xdrop_extend_batch_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _xdrop_walks(rng, e, la, lb, direction, err=0.08, alphabet=4):
    """Seeded pairs of related sequences and their walks: forward from 0 or
    backward from the last base; numpy arrays."""
    a = rng.integers(0, alphabet, (e, la)).astype(np.uint8)
    b = a[:, :lb].copy() if lb <= la else np.concatenate(
        [a, rng.integers(0, alphabet, (e, lb - la))], 1).astype(np.uint8)
    b = np.where(rng.random(b.shape) < err, (b + 1) % alphabet, b)
    la_ = rng.integers(1, la + 1, e).astype(np.int32)
    lb_ = rng.integers(1, lb + 1, e).astype(np.int32)
    base_a = np.zeros(e, np.int32) if direction == 1 else la_ - 1
    base_b = np.zeros(e, np.int32) if direction == 1 else lb_ - 1
    step = np.full(e, direction, np.int32)
    return [a, base_a, step, la_, b.astype(np.uint8), base_b, step, lb_]


def _xdrop_same(card, np_args, **kw):
    """One launch of the kernel equals the plain version exactly."""
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(card) for x in np_args]
    before = K.KERNELS["xdrop"].launches
    got = K.xdrop_extend_batch(*args, **kw)
    assert K.KERNELS["xdrop"].launches == before + 1
    want = K.xdrop_extend_batch_ref(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("band", [1, 2, 3, 31, 32, 33, 34, 63, 64, 65, 66,
                                  127, 255, 256])
def test_xdrop_kernel_every_register_count_and_parity(card, band):
    """Both parities of c = band // 2 and 1-4 registers a lane, forward and
    backward walks, pairs longer than several 64-step ring refills."""
    rng = np.random.default_rng(1000 + band)
    for direction in (1, -1):
        args = _xdrop_walks(rng, 45, 700, 650, direction)
        _xdrop_same(card, args, band=band, max_steps=4096, xdrop=30)


@pytest.mark.parametrize("band", [257, 300, 512, 513, 1024, 26000])
def test_xdrop_kernel_wide_bands(card, band):
    """Bands past the one-warp instance run the block instance (its two
    rows in shared memory; at 26000 in global scratch), forward and
    backward, with free gaps so the far cells of the band decide results;
    exact against the plain version, one launch each."""
    from repro_torch.obs import Tracer, tracing

    rng = np.random.default_rng(2000 + band)
    for direction in (1, -1):
        args = _xdrop_walks(rng, 45, 700, 420, direction)
        tr = Tracer(memory=False)
        with tracing(tr):
            _xdrop_same(card, args, band=band, max_steps=4096, xdrop=30)
            _xdrop_same(card, args, band=band, max_steps=4096, xdrop=400,
                        match=2, mismatch=-1, gap=0)
        assert {sp.attrs["instance"] for sp in tr.find("kernel_launch")} \
            == {"block"}
    # the wrapper's mirror of the launcher's scratch rule
    from repro_torch.kernels.xdrop import ops as xops

    query = K.KERNELS["xdrop"].entry("xdrop_scratch_bytes", [ctypes.c_int],
                                     ctypes.c_longlong)
    for b in (1, 256, 257, band, 25600, 25601):
        assert query(b) == xops.scratch_bytes(b)
    assert (xops.scratch_bytes(band) > 0) == (band == 26000)


def test_xdrop_kernel_two_directions_in_one_launch(card):
    """(2, E) walks: one launch, equal to the plain version and to two
    single-direction launches."""
    rng = np.random.default_rng(7)
    e, la, lb = 300, 900, 800
    fwd = _xdrop_walks(rng, e, la, lb, 1)
    a, b = fwd[0], fwd[4]
    bwd_base_a = rng.integers(0, la, e).astype(np.int32)
    bwd_base_b = rng.integers(0, lb, e).astype(np.int32)
    walks = [np.stack([f, g]) for f, g in (
        (fwd[1], bwd_base_a), (fwd[2], -fwd[2]), (fwd[3], bwd_base_a + 1),
        (fwd[5], bwd_base_b), (fwd[6], -fwd[6]), (fwd[7], bwd_base_b + 1))]
    kw = dict(band=65, max_steps=4096, xdrop=30)
    from repro_torch.obs import Tracer, tracing

    tr = Tracer(memory=False)
    with tracing(tr):
        got = _xdrop_same(card, [a, *walks[:3], b, *walks[3:]], **kw)
    (sp,) = tr.find("kernel_launch")
    assert sp.attrs["instance"] == "warp"  # the main path's band
    for d in range(2):
        one = _xdrop_same(card, [a, *(w[d] for w in walks[:3]), b,
                                 *(w[d] for w in walks[3:])], **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[d], o)


@pytest.mark.parametrize("band", [33, 65, 256, 512])
def test_xdrop_kernel_ties_across_lanes_and_registers(card, band):
    """A two-letter alphabet with free gaps scores many cells of a step
    alike: the first maximum (lowest band offset) must win, as in the plain
    version, across lanes and registers (one-warp instance) and across
    warps (the block instance at band 512)."""
    rng = np.random.default_rng(band)
    args = _xdrop_walks(rng, 64, 400, 400, 1, err=0.3, alphabet=2)
    _xdrop_same(card, args, band=band, max_steps=4096, xdrop=12, match=1,
                mismatch=0, gap=0)
    # identical sequences: equal scores on mirrored offsets
    args[4] = args[0].copy()
    _xdrop_same(card, args, band=band, max_steps=4096, xdrop=6, match=2,
                mismatch=-3, gap=-1)


def test_xdrop_kernel_edge_walks(card):
    """Zero and negative lengths, a backward walk from base 0 (every fetch
    clamped), xdrop = 0, and pairs stopped by max_steps."""
    rng = np.random.default_rng(11)
    e = 40
    a, base_a, step, la, b, base_b, _, lb = _xdrop_walks(rng, e, 300, 300, 1,
                                                         err=0.0)
    la[:5], lb[5:10] = 0, 0
    la[10:12], lb[10:12] = -3, 2
    base_a[12:20], base_b[12:20] = 0, 0
    step = step.copy()
    step[12:20] = -1
    for xd, ms in ((0, 4096), (30, 1), (30, 7), (30, 64), (30, 65), (30, 129)):
        _xdrop_same(card, [a, base_a, step, la, b, base_b, step, lb],
                    band=65, max_steps=ms, xdrop=xd)


def test_xdrop_kernel_malformed_walks_raise(card):
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(x).to(card)
            for x in _xdrop_walks(rng, 8, 50, 50, 1)]
    bad = list(args)
    bad[1] = torch.stack([args[1], args[1]])  # (2, E) base_a, (E,) others
    with pytest.raises(ValueError, match="base_a"):
        K.xdrop_extend_batch(*bad)
    with pytest.raises(ValueError, match="band"):
        K.xdrop_extend_batch(*args, band=0)


def test_assemble_on_card_pads_not_extended(card):
    """A bucket with n_live < bucket in 256-pair chunks: one x-drop launch
    per chunk that holds a live pair, and every result equal to the
    reference backend's."""
    import dataclasses

    from repro_torch.core.spmat import ell_equal

    genome = simulate_genome(np.random.default_rng(4), 15000)
    rs = simulate_reads(genome, depth=10, mean_len=900, std_len=150,
                        error_rate=0.03, seed=5)
    cfg = PipelineConfig(m_capacity=1 << 17, upper=40, read_capacity=96,
                         band=65, xdrop=25, align_chunk=256, device="cuda")
    K.reset_launch_counts()
    res = assemble(rs.codes, rs.lengths, cfg)
    n_live, bucket = res.stats["n_aligned"], res.stats["align_bucket"]
    assert 256 < n_live < bucket
    assert K.launch_counts()["xdrop"] == -(-n_live // 256)
    ref = assemble(rs.codes, rs.lengths,
                   dataclasses.replace(cfg, backend="reference"))
    assert ell_equal(res.r_graph, ref.r_graph)
    assert ell_equal(res.s_graph, ref.s_graph)
    for key in ref.stats:
        if key not in ("backend", "tr_backend", "distribution",
                       "cc_iterations", "peak_hbm_bytes", "hbm_bytes_in_use"):
            assert res.stats[key] == ref.stats[key], key


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (65, 33, 47), (200, 130, 70)])
def test_minplus_kernel_matches_plain(card, m, k, n):
    g = torch.Generator().manual_seed(m + n)
    a = torch.randint(1, 500, (m, k, 4), generator=g).float()
    b = torch.randint(1, 500, (k, n, 4), generator=g).float()
    a[torch.rand(a.shape, generator=g) < 0.6] = float("inf")
    b[torch.rand(b.shape, generator=g) < 0.6] = float("inf")
    a, b = a.to(card), b.to(card)
    assert torch.equal(K.minplus_matmul(a, b), K.minplus_matmul_ref(a, b))


def test_pileup_kernel_matches_plain(card):
    rng = np.random.default_rng(3)
    c, m, l, lr = 3, 9, 700, 300
    draft = rng.integers(0, 4, (c, l)).astype(np.uint8)
    start = rng.integers(-50, l - 50, (c, m)).astype(np.int32)
    plen = rng.integers(0, lr + 1, (c, m)).astype(np.int32)
    pieces = np.zeros((c, m, lr), np.uint8)
    for i in range(c):
        for t in range(m):
            cols = np.clip(start[i, t] + np.arange(lr), 0, l - 1)
            pieces[i, t] = draft[i, cols]
    pieces = np.where(rng.random(pieces.shape) < 0.05, (pieces + 1) % 4, pieces)
    args = [torch.from_numpy(np.array(x)).to(card)
            for x in (draft, pieces.astype(np.uint8), start, plen)]
    for md in (1, 2, 3):
        got = K.pileup_vote(*args, min_depth=md)
        want = K.pileup_vote_ref(*args, min_depth=md)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("min_depth", [1, 2])
@pytest.mark.parametrize("case", _pileup_cases.CASES)
def test_pileup_kernel_parity_traps(card, case, min_depth):
    """The tile-list kernel at each parity trap of its design (pieces
    longer than LR, negative starts, starts at or past L, empty pieces, L
    of 1, 8, 9 and around the tile, a tile that 220 pieces reach, a contig
    with no pieces): three launches, one kernel_launch span each, exact
    against the plain version."""
    from repro_torch.obs import Tracer, tracing

    args = [torch.from_numpy(np.ascontiguousarray(x)).to(card)
            for x in _pileup_cases.case_inputs(case)]
    before = K.KERNELS["pileup"].launches
    tr = Tracer(memory=False)
    with tracing(tr):
        got = K.pileup_vote(*args, min_depth=min_depth)
    assert K.KERNELS["pileup"].launches == before + 3
    assert [sp.attrs["phase"] for sp in tr.find("kernel_launch")] == [
        "bin_count", "bin_fill", "vote"]
    want = K.pileup_vote_ref(*args, min_depth=min_depth)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_pileup_tile_lists_on_card(card):
    """The count and fill launches list each piece once in every tile its
    vote columns reach (the order inside a list is free), within the
    capacity sized from shapes alone."""
    from repro_torch.kernels.pileup import ops as pops

    draft, pieces, start, plen = (
        torch.from_numpy(x).to(card)
        for x in _pileup_cases.case_inputs("dense_tile"))
    l, lr = draft.shape[1], pieces.shape[2]
    ends, slots = pops.tile_lists(start, plen, l, lr)
    torch.cuda.synchronize()
    lo, hi = (x.cpu() for x in pops.vote_ranges(start, plen, l, lr))
    nt = -(-l // pops.TILE)
    assert int(ends[-1]) == int(pops.tile_entries(start, plen, l, lr).sum())
    assert int(ends[-1]) <= slots.numel()
    ends = ends.cpu().tolist()
    for t in range(nt):
        got = sorted(slots[(ends[t - 1] if t else 0):ends[t]].cpu().tolist())
        want = [pm for pm in range(start.shape[1])
                if lo[0, pm] < min(hi[0, pm], (t + 1) * pops.TILE)
                and hi[0, pm] > max(lo[0, pm], t * pops.TILE)]
        assert got == want
    assert ends[1] - ends[0] >= 200


def _stage_panels(rng, kind, stages, n, nb, ka, kb, n_out):
    """Random stacked ring-stage panels: A ids over ``stages`` B row blocks
    of ``nb`` rows, row-sorted with empty slots last; B ids in ``n_out``."""
    def ell(rows, k, hi):
        cols = rng.integers(0, hi, (stages, rows, k))
        cols = np.sort(np.where(rng.random(cols.shape) < 0.3, 1 << 30, cols), -1)
        return np.where(cols < (1 << 30), cols, -1).astype(np.int32)
    a_cols, b_cols = ell(n, ka, stages * nb), ell(nb, kb, n_out)
    if kind == "overlap":
        def pos(cols):
            return {"pos": np.where(cols >= 0, rng.integers(0, 900, cols.shape),
                                    -1).astype(np.int32)}
        a_vals, b_vals = pos(a_cols), pos(b_cols)
    else:
        def mp(cols):
            v = rng.integers(1, 90, cols.shape + (4,)).astype(np.float32)
            v[rng.random(v.shape) < 0.6] = np.inf
            v[cols < 0] = np.inf
            return {MP: v}
        a_vals, b_vals = mp(a_cols), mp(b_cols)
    offsets = (rng.permutation(stages) * nb).astype(np.int32)
    return offsets, a_cols, a_vals, b_cols, b_vals


@pytest.mark.parametrize("kind", ["overlap", "minplus"])
@pytest.mark.parametrize("stages,n,nb,ka,kb,cap", [
    (1, 300, 2000, 160, 56, 64), (3, 50, 40, 12, 9, 8), (4, 64, 64, 40, 40, 160)])
def test_spgemm_kernel_matches_plain(card, kind, stages, n, nb, ka, kb, cap):
    rng = np.random.default_rng(stages * 100 + ka)
    offsets, a_cols, a_vals, b_cols, b_vals = _stage_panels(
        rng, kind, stages, n, nb, ka, kb, n_out=4 * kb)
    sr = overlap_semiring if kind == "overlap" else minplus_orient_semiring

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(card)
    args = (dev(offsets), dev(a_cols), {k: dev(v) for k, v in a_vals.items()},
            dev(b_cols), {k: dev(v) for k, v in b_vals.items()})
    kw = dict(semiring=sr, capacity=cap, n_cols_out=4 * kb)
    before = K.KERNELS["spgemm"].launches
    got = K.spgemm_ring_stages(*args, **kw)
    assert K.KERNELS["spgemm"].launches == before + 1
    want = K.spgemm_ring_stages_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for key in want[1]:
        assert torch.equal(got[1][key], want[1][key]), key
    assert int(got[2]) == int(want[2])
    if cap == 8:
        assert int(want[2]) > 0  # the overflow path ran


def _spgemm_same(card, kind, offsets, a_cols, a_vals, b_cols, b_vals, cap,
                 n_out):
    """One launch of the kernel against the plain version; returns the
    plain outputs."""
    sr = overlap_semiring if kind == "overlap" else minplus_orient_semiring

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(card)
    args = (dev(offsets), dev(a_cols), {k: dev(v) for k, v in a_vals.items()},
            dev(b_cols), {k: dev(v) for k, v in b_vals.items()})
    kw = dict(semiring=sr, capacity=cap, n_cols_out=n_out)
    before = K.KERNELS["spgemm"].launches
    got = K.spgemm_ring_stages(*args, **kw)
    assert K.KERNELS["spgemm"].launches == before + 1
    want = K.spgemm_ring_stages_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for key in want[1]:
        assert torch.equal(got[1][key], want[1][key]), key
    assert int(got[2]) == int(want[2])
    return want


@pytest.mark.parametrize("kind", ["overlap", "minplus"])
@pytest.mark.parametrize("stages", [1, 4])
def test_spgemm_kernel_empty_rows_and_ties(card, kind, stages):
    """Rows with no live A slot, rows whose slots all fall outside the
    stage's block, and many candidates on few columns (long runs, ties
    broken by candidate order), past capacity."""
    rng = np.random.default_rng(31 + stages)
    n, nb, ka, kb = 96, 48, 24, 40
    offsets, a_cols, a_vals, b_cols, b_vals = _stage_panels(
        rng, kind, stages, n, nb, ka, kb, n_out=6)
    a_cols[:, ::5] = -1  # empty rows
    a_cols[:, 1::7] = np.where(a_cols[:, 1::7] >= 0, 10 ** 6, -1)  # elsewhere
    want = _spgemm_same(card, kind, offsets, a_cols, a_vals, b_cols, b_vals,
                        cap=4, n_out=6)
    assert int(want[2]) > 0
    assert (want[0][:, ::5] < 0).all()


@pytest.mark.parametrize("kind", ["overlap", "minplus"])
def test_spgemm_kernel_wide_grid_whose_live_candidates_fit(card, kind):
    """K_A x K_B = 256 x 128 (32768 grid slots, 256 KB of 64-bit keys: more
    than a block's shared memory) with 2 live B slots a row: the launch is
    sized by the ~512 candidates that exist, and runs."""
    rng = np.random.default_rng(5)
    stages, n, nb, ka, kb = 2, 40, 300, 256, 128
    offsets, a_cols, a_vals, b_cols, b_vals = _stage_panels(
        rng, kind, stages, n, nb, ka, kb, n_out=700)
    keep = np.zeros_like(b_cols, bool)
    keep[:, :, [3, 90]] = True
    b_cols = np.where(keep & (b_cols >= 0), b_cols, -1).astype(np.int32)
    live = int(tops.live_candidates(*(torch.from_numpy(x) for x in (
        offsets, a_cols, b_cols))).max())
    assert 0 < live <= 2 * ka
    assert 8 * 32768 > tops.MAX_SHARED_BYTES  # the old sizing refused it
    _spgemm_same(card, kind, offsets, a_cols, a_vals, b_cols, b_vals,
                 cap=64, n_out=700)


@pytest.mark.parametrize("kind", ["overlap", "minplus"])
@pytest.mark.parametrize("case", ["at_limit", "just_above", "grid_full",
                                  "many_full"])
def test_spgemm_kernel_row_too_full_runs_global_instance(card, kind, case):
    """A row whose live candidates do not fit in a block's shared memory is
    computed by the global instance in the same launch, exact against the
    plain version (stage buffers, values, overflow): a row at the limit
    exactly (shared-memory instance), one just above it, the 512 x 64 grid
    with every slot live (32768 candidates a row, two stages), and more
    rows too full than the global instance has blocks."""
    from _spgemm_rows import rows_of_sizes

    from repro_torch.obs import Tracer, tracing

    sr_id = 0 if kind == "overlap" else 1
    rng = np.random.default_rng(len(case) + sr_id)
    ka, kb = 512, 64
    fit = tops.fit_candidates(sr_id, ka, kb)
    if case == "grid_full":
        stages, n, nb = 2, 3, 64
        offsets = (np.arange(stages) * nb).astype(np.int32)
        a_cols = (np.arange(ka, dtype=np.int32) % nb
                  + offsets[:, None, None]) * np.ones((1, n, 1), np.int32)
        a_cols[:, 1] = -1  # an empty row between two full ones
        b_cols = np.tile(np.arange(kb, dtype=np.int32), (stages, nb, 1))
        if kind == "overlap":
            a_vals = {"pos": rng.integers(0, 900, a_cols.shape).astype(np.int32)}
            b_vals = {"pos": rng.integers(0, 900, b_cols.shape).astype(np.int32)}
        else:  # finite: no product is zero
            a_vals = {MP: rng.integers(1, 90, a_cols.shape + (4,)).astype(
                np.float32)}
            b_vals = {MP: rng.integers(1, 90, b_cols.shape + (4,)).astype(
                np.float32)}
        n_out, want_global = kb, stages * (n - 1)
    else:
        sizes = {"at_limit": [fit, 17, 0, fit - 1],
                 "just_above": [fit + 1, fit, 5],
                 "many_full": [fit + 1 + (r % 7) for r in range(300)]
                 + [0, 3 * fit]}[case]
        offsets, a_cols, a_vals, b_cols, b_vals, n_out = rows_of_sizes(
            rng, sizes, kb, kind, ka=ka)
        want_global = sum(v > fit for v in sizes)
    tr = Tracer(memory=False)
    with tracing(tr):
        for cap in (8, 300):
            _spgemm_same(card, kind, offsets, a_cols, a_vals, b_cols, b_vals,
                         cap=cap, n_out=n_out)
    for sp in tr.find("kernel_launch"):
        assert sp.attrs["global_rows"] == want_global
        assert (sp.attrs["global_blocks"] > 0) == (want_global > 0)
    if case == "at_limit":
        (sp, _) = tr.find("kernel_launch")
        assert sp.attrs["max_candidates"] == fit
        assert sp.attrs["shared_bytes"] <= tops.MAX_SHARED_BYTES


def test_spgemm_occupancy_several_blocks_per_sm(card):
    """At the 4000-read overlap launch's fullest row (1891 candidates,
    K_A = 160) an SM holds more than one block."""
    assert tops.blocks_per_sm(overlap_semiring, 1891, 160, 56) > 1
    assert tops.blocks_per_sm(minplus_orient_semiring, 1891, 160, 56) > 1
    # the wrapper's mirror of the kernel's shared-memory layout
    size = tops.KERNEL.entry("spgemm_shared_bytes", [ctypes.c_int] * 4,
                             ctypes.c_longlong)
    for sr in (0, 1):
        for vcap, ka, kb in ((1892, 160, 56), (4, 1, 1), (100, 40, 40),
                             (512, 256, 128)):
            assert size(sr, vcap, ka, kb) == tops.shared_bytes(sr, vcap, ka,
                                                               kb)
    # and of the global instance's scratch a block
    gsize = tops.KERNEL.entry("spgemm_global_bytes", [ctypes.c_int] * 4,
                              ctypes.c_longlong)
    for sr in (0, 1):
        for vcap, ka, kb in ((32768, 512, 64), (4, 1, 1), (10356, 512, 64)):
            assert gsize(sr, vcap, ka, kb) == tops.global_bytes(sr, vcap, ka,
                                                                kb)


# --- spgemm_masked: the sampled min-plus square of the fused TR -------------


def _masked_same(card, a, b, mask):
    """One launch of the kernel equals the port's torch ``spgemm_masked``
    and the op's plain version, bit for bit; returns the result."""
    from repro_torch.core.spgemm import spgemm_masked

    want = spgemm_masked(a, b, mask, semiring=minplus_orient_semiring).vals[MP]
    args = (a.cols, a.vals[MP], b.cols, b.vals[MP], mask.cols)
    plain = K.spgemm_masked_minplus_ref(*args)
    assert torch.equal(plain, want)
    before = K.KERNELS["spgemm_masked"].launches
    got = K.spgemm_masked_minplus(*(x.to(card) for x in args))
    assert K.KERNELS["spgemm_masked"].launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    return got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", _masked_cases.CASES)
def test_spgemm_masked_kernel_matches_plain(card, case, seed):
    a, b, mask = _masked_cases.operands(case, seed)
    got = _masked_same(card, a, b, mask)
    assert torch.isfinite(got).any()
    assert torch.isinf(got[~mask.mask.to(card)]).all()


def test_spgemm_masked_kernel_refuses_what_it_cannot_take(card):
    a, b, _ = _masked_cases.operands("random", 0)
    args = [x.to(card) for x in (a.cols, a.vals[MP], b.cols, b.vals[MP])]
    with pytest.raises(ValueError, match="shared memory"):
        K.spgemm_masked_minplus(*args, torch.full((40, 1500), -1,
                                                  dtype=torch.int32,
                                                  device=card))
    with pytest.raises(ValueError, match="int32"):
        K.spgemm_masked_minplus(*args, a.cols.to(card).long())
    empty = K.spgemm_masked_minplus(*(x[:0] for x in args[:2]), *args[2:],
                                    a.cols[:0].to(card))
    assert empty.shape == (0, a.capacity, 4)


def test_spgemm_masked_kernel_on_every_tr_iteration_of_a_cell_sized_r(card):
    """An assembly of the benchmark's one-card cell (14,863 reads, K_R = 40)
    on the card: every TR iteration squares its R through the kernel, and
    each launch equals the torch ``spgemm_masked`` on the same R."""
    import sys
    from pathlib import Path

    from repro_torch.core import backend as B
    from repro_torch.core.spgemm import spgemm_masked
    from repro_torch.core.spmat import EllMatrix

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import load_cell
    from portbench.readgen import make_reads

    _, _, config, traffic = load_cell("hsapiens-gspmd.pb-d10-l7401")
    reads = make_reads(config["genome_length"], traffic, 2**31 + 7,
                       device=card)
    cfg = PipelineConfig(**config["pipeline"],
                         distribution=config["distribution"], device="cuda")
    seen = []

    def checked(a_cols, a_vals, b_cols, b_vals, m_cols):
        got = K.spgemm_masked_minplus(a_cols, a_vals, b_cols, b_vals, m_cols)
        r = EllMatrix(cols=a_cols, vals={MP: a_vals}, n_cols=a_cols.shape[0])
        want = spgemm_masked(r, r, r, semiring=minplus_orient_semiring)
        seen.append((int(r.nnz()), torch.equal(got, want.vals[MP])))
        return got

    B.register_op("spgemm_masked", "cuda", checked)
    try:
        res = assemble(reads.codes, reads.lengths, cfg)
    finally:
        B.register_op("spgemm_masked", "cuda", K.spgemm_masked_minplus)
    assert reads.n_reads > 4096
    assert res.stats["tr_backend"] == "cuda_masked"
    assert res.stats["tr_overflow"] == 0
    assert len(seen) == res.stats["tr_iterations"] >= 2
    assert all(same for _, same in seen), seen
    assert seen[0][0] == res.stats["nnz_R"]


def test_assemble_on_card_matches_reference_backend(card):
    genome = simulate_genome(np.random.default_rng(0), 20000)
    rs = simulate_reads(genome, depth=10, mean_len=1000, std_len=150,
                        error_rate=0.03, seed=1)
    cfg = PipelineConfig(m_capacity=1 << 17, upper=40, read_capacity=96,
                         band=33, xdrop=25, device="cuda")
    K.reset_launch_counts()
    res = assemble(rs.codes, rs.lengths, cfg)
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in ("xdrop", "minplus", "pileup")), counts
    ref = assemble(rs.codes, rs.lengths,
                   PipelineConfig(**{**cfg.__dict__, "backend": "reference"}))
    for key in ("n_aligned", "n_passed", "nnz_R", "nnz_S", "tr_iterations",
                "contigs", "consensus_changed"):
        assert res.stats[key] == ref.stats[key], key
    assert [c.reads for c in res.polished_contigs] == [
        c.reads for c in ref.polished_contigs]


def test_assemble_shard_map_on_card_matches_gspmd(card):
    """The shard_map path on one card (a 1×1 grid, no process group): the
    spgemm kernel runs, and R, S and the polished contigs equal gspmd's."""
    import dataclasses

    from repro_torch.core.spmat import ell_equal

    genome = simulate_genome(np.random.default_rng(0), 20000)
    rs = simulate_reads(genome, depth=10, mean_len=1000, std_len=150,
                        error_rate=0.03, seed=1)
    cfg = PipelineConfig(m_capacity=1 << 17, upper=40, read_capacity=96,
                         band=33, xdrop=25, device="cuda")
    gs = assemble(rs.codes, rs.lengths, cfg)
    K.reset_launch_counts()
    sm = assemble(rs.codes, rs.lengths,
                  dataclasses.replace(cfg, distribution="shard_map"))
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in ("xdrop", "minplus", "pileup", "spgemm")), \
        counts
    assert sm.stats["summa_backend"] == "cuda"
    assert sm.stats["spgemm_hbm_round_trips"] == 1  # one launch on a 1x1 grid
    assert sm.stats["distribution"] == "shard_map"
    assert ell_equal(gs.r_graph, sm.r_graph) and ell_equal(gs.s_graph, sm.s_graph)
    assert [c.reads for c in gs.polished_contigs] == [
        c.reads for c in sm.polished_contigs]


# --- kmer_pack: canonical packed k-mers from the read codes ------------------


def _kmer_pack_same(card, codes, lens, k):
    """One launch of the kernel equals the plain version bit for bit."""
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(card)
    ln = torch.from_numpy(np.ascontiguousarray(lens)).to(card)
    before = K.KERNELS["kmer_pack"].launches
    got = K.kmer_pack(c, ln, k=k)
    torch.cuda.synchronize()
    assert K.KERNELS["kmer_pack"].launches == before + 1
    want = K.kmer_pack_ref(c, ln, k=k)
    for name, g, w in zip(("hi", "lo", "strand", "valid"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("k", _kmer_cases.KS)
@pytest.mark.parametrize("case", _kmer_cases.CASES)
def test_kmer_pack_kernel_matches_plain(card, case, k):
    codes, lens = _kmer_cases.reads(case, k)
    _kmer_pack_same(card, codes, lens, k)


@pytest.mark.parametrize("k", [15, 16, 21, 30])
def test_kmer_pack_kernel_on_a_cell_sized_block(card, k):
    """512 reads of the benchmark's one-card cell at its 13,216 columns,
    half of them reverse-complemented (as the generator draws them)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import load_cell
    from portbench.readgen import make_reads

    _, _, config, traffic = load_cell("hsapiens-gspmd.pb-d10-l7401")
    reads = make_reads(config["genome_length"], traffic, 2**31 + 11,
                       device=card)
    codes = reads.codes[:512].contiguous()
    lens = reads.lengths[:512].to(torch.int32).contiguous()
    assert codes.shape[1] == 13216
    strand = reads.truth_strand[:512]
    assert 0 < int(strand.sum()) < 512
    _kmer_pack_same(card, codes.cpu().numpy(), lens.cpu().numpy(), k)


def test_kmer_pack_kernel_refuses_what_it_cannot_take(card):
    codes, lens = _kmer_cases.reads("seeded", 15)
    c = torch.from_numpy(codes).to(card)
    ln = torch.from_numpy(lens).to(card)
    before = K.KERNELS["kmer_pack"].launches
    with pytest.raises(ValueError, match="codes must be torch.uint8"):
        K.kmer_pack(c.to(torch.int32), ln, k=15)
    with pytest.raises(ValueError, match="lengths must be torch.int32"):
        K.kmer_pack(c, ln.long(), k=15)
    with pytest.raises(ValueError, match="codes must be contiguous"):
        K.kmer_pack(c[:, ::2], ln, k=15)
    with pytest.raises(ValueError, match="k must lie in 1..30"):
        K.kmer_pack(c, ln, k=31)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.kmer_pack(c, ln.cpu(), k=15)
    assert K.KERNELS["kmer_pack"].launches == before
    empty = K.kmer_pack(c[:0], ln[:0], k=15)
    assert [tuple(x.shape) for x in empty] == [(0, codes.shape[1] - 14)] * 4
    assert K.KERNELS["kmer_pack"].launches == before


def test_assemble_on_card_packs_kmers_in_one_launch(card):
    """``assemble()`` on the ``cuda`` backend: one ``kmer_pack`` launch, the
    step span's ``path`` is ``"kernel"``, and CountKmer's outputs (the
    packed instances and the counts) equal the ``reference`` backend's."""
    from repro_torch.core import backend as B

    genome = simulate_genome(np.random.default_rng(3), 20000)
    rs = simulate_reads(genome, depth=10, mean_len=1000, std_len=150,
                        error_rate=0.03, seed=4)
    cfg = PipelineConfig(m_capacity=1 << 17, upper=40, read_capacity=96,
                         band=33, xdrop=25, device="cuda", trace=True)
    seen = []

    def kept(codes, lengths, *, k):
        out = K.kmer_pack(codes, lengths, k=k)
        seen.append((out, K.kmer_pack_ref(codes, lengths, k=k)))
        return out

    B.register_op("kmer_pack", "cuda", kept)
    try:
        K.reset_launch_counts()
        res = assemble(rs.codes, rs.lengths, cfg)
        launches = K.launch_counts()
    finally:
        B.register_op("kmer_pack", "cuda", K.kmer_pack)
    assert launches["kmer_pack"] == 1
    (got, want), = seen
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    (ext,) = res.trace.find("CountKmer.extract")
    assert ext.attrs["path"] == "kernel"
    spans = [sp for sp in res.trace.find("kernel_launch")
             if sp.attrs["kernel"] == "kmer_pack"]
    assert len(spans) == 1
    ref = assemble(rs.codes, rs.lengths,
                   PipelineConfig(**{**cfg.__dict__, "backend": "reference",
                                     "trace": False}))
    for key in ("m_reliable", "n_unique_kmers", "n_singletons", "nnz_A",
                "overflow_A", "nnz_C", "nnz_R", "nnz_S"):
        assert res.stats[key] == ref.stats[key], key


# --- cc: hook / in-hook / pointer-jump rounds ---------------------------------


def _cc_graph(rng, n, k_out, empty_rows):
    """Random out-neighbour ELL (n, k_out): ~half the slots live, and a
    fraction of rows entirely empty."""
    cols = rng.integers(0, n, (n, k_out))
    cols = np.where(rng.random(cols.shape) < 0.5, cols, -1)
    cols[rng.random(n) < empty_rows] = -1
    return cols.astype(np.int32)


def _chain(n, seed):
    """A path with its vertex ids permuted along it (Θ(n) rounds)."""
    perm = np.random.default_rng(seed).permutation(n)
    cols = np.full((n, 1), -1, np.int32)
    cols[perm[:-1], 0] = perm[1:]
    return cols


@pytest.mark.parametrize("rounds", [1, 3, 8])
@pytest.mark.parametrize("n,k_out", [(1000, 3), (70000, 6)])
def test_cc_kernel_matches_plain(card, rounds, n, k_out):
    """One launch equals the plain rounds: labels and the changed flag,
    from the identity labels and from a half-converged state; ``k_in``
    differs from ``k_out`` and some rows are empty."""
    from repro_torch.kernels.cc import transpose_ell

    oc = torch.from_numpy(_cc_graph(np.random.default_rng(n + rounds), n,
                                    k_out, 0.2)).to(card)
    ic = transpose_ell(oc)
    assert ic.shape[1] != k_out
    lab = torch.arange(n, dtype=torch.int32, device=card)
    before = K.KERNELS["cc"].launches
    for _ in range(3):
        got = K.cc_rounds(oc, ic, lab, rounds)
        want = K.cc_rounds_ref(oc, ic, lab, rounds)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert int(got[1]) == int(want[1])
        lab = want[0]
    assert K.KERNELS["cc"].launches == before + 3


def _cc_plain_call(cols, max_iters):
    """The plain chunk driver over the plain rounds: (labels, rounds
    executed, chunks)."""
    from repro_torch.kernels.cc import ops as cc_ops

    n = cols.shape[0]
    rounds, n_chunks, rem = cc_ops.chunk_rule(n if max_iters is None
                                              else max_iters)
    return cc_ops._drive_chunks(
        cols, cc_ops.transpose_ell(cols),
        torch.arange(n, dtype=torch.int32, device=cols.device), rounds=rounds,
        n_chunks=n_chunks, rem=rem, rounds_fn=K.cc_rounds_ref)


@pytest.mark.parametrize("n,max_iters", [(1 << 12, 13), (1 << 12, 1003),
                                         (1 << 15, 13), (1 << 15, 1003)])
def test_cc_labels_capped_tail_matches_plain(card, n, max_iters):
    """One launch on the card equals the chunk driver over the plain rounds
    (labels, rounds executed, chunks) on a permuted chain that does not
    converge within ``max_iters``: 8-round chunks and a tail, on the block
    path (2^12 vertices) and the grid path (2^15); the reference backend's
    labels equal both."""
    from repro_torch.kernels.cc import ops as cc_ops

    cols = torch.from_numpy(_chain(n, 5)).to(card)
    assert cc_ops.cc_path(n, n - 1) == ("block" if n < 1 << 14 else "grid")
    before = K.KERNELS["cc"].launches
    got = cc_ops.cc_components(cols, max_iters=max_iters)
    assert K.KERNELS["cc"].launches == before + 1
    want_lab, want_it, want_chunks = _cc_plain_call(cols, max_iters)
    assert got[1] == want_it == max_iters
    assert got[2] == want_chunks
    assert torch.equal(got[0], want_lab)
    ref = K.cc_labels_ref(cols, max_iters=max_iters)
    assert torch.equal(ref[0], got[0]) and ref[1] == max_iters


@pytest.mark.parametrize("n,k_out,max_iters", [
    (1, 1, None), (300, 3, None), (300, 3, 5), (9000, 4, None),
    (9000, 4, 3), (9000, 4, 0), (70000, 6, None), (70000, 6, 11)])
def test_cc_call_one_launch_both_paths(card, n, k_out, max_iters):
    """A whole ``connected_components(backend="cuda")`` call is one launch
    on either side of the block path's size threshold (9000 vertices with
    ~14k edges: 234 KB, just past it), with and without a ``max_iters``
    tail; columns past n (clamped in the out-hook only) included."""
    from repro_torch.core.components import connected_components
    from repro_torch.core.spmat import EllMatrix
    from repro_torch.kernels.cc import ops as cc_ops

    rng = np.random.default_rng(n + k_out)
    cols = _cc_graph(rng, n, k_out, 0.2)
    cols[rng.random(cols.shape) < 0.01] = n + 3  # out of range
    cols = torch.from_numpy(cols).to(card)
    m = int((cols >= 0).sum())
    before = K.KERNELS["cc"].launches
    lab, it, chunks = cc_ops.cc_components(cols, max_iters=max_iters)
    assert K.KERNELS["cc"].launches == before + 1
    want = _cc_plain_call(cols, max_iters)
    assert torch.equal(lab, want[0]) and (it, chunks) == want[1:]
    adj = EllMatrix(cols=cols, vals={}, n_cols=n)
    assert torch.equal(connected_components(adj, max_iters=max_iters,
                                            backend="cuda")[0], lab)
    assert cc_ops.cc_path(n, m) == (
        "block" if cc_ops.block_bytes(n, m) <= cc_ops.MAX_SHARED_BYTES
        else "grid")


def test_cc_launch_refused_or_bad_input_raises(card):
    oc = torch.from_numpy(_chain(100, 1)).to(card)
    ic = oc.clone()
    lab = torch.arange(100, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="int32"):
        K.cc_rounds(oc, ic, lab.long(), 2)
    with pytest.raises(ValueError, match="rounds"):
        K.cc_rounds(oc, ic, lab, 0)
    before = K.KERNELS["cc"].launches
    edges = torch.zeros((1, 2), dtype=torch.int32, device=card)
    info = torch.zeros(3, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="cc kernel launch failed"):
        K.KERNELS["cc"].launch(edges.data_ptr(), 1, lab.data_ptr(),
                               lab.data_ptr(), info.data_ptr(),
                               info.data_ptr(), 100, 0, 1, 0, 0,
                               torch.cuda.current_stream().cuda_stream)
    assert K.KERNELS["cc"].launches == before
    # the wrapper's mirror of the block path's shared memory
    from repro_torch.kernels.cc import ops as cc_ops

    size = K.KERNELS["cc"].entry("cc_block_bytes", [ctypes.c_int] * 2,
                                 ctypes.c_longlong)
    for n, m in ((1, 0), (8000, 2716), (8000, 12914), (1 << 17, 1 << 17)):
        assert size(n, m) == cc_ops.block_bytes(n, m)


def test_cc_launch_spans_on_card(card):
    """On the card a ``connected_components`` call opens one
    ``kernel_launch`` span with JAX's kernel name, under the op's dispatch
    span, holding the rounds executed and the chunks of its one launch."""
    from repro_torch.core.components import connected_components
    from repro_torch.core.spmat import EllMatrix
    from repro_torch.obs import Tracer, tracing

    cols = torch.from_numpy(_chain(1 << 10, 3)).to(card)
    adj = EllMatrix(cols=cols, vals={}, n_cols=cols.shape[0])
    tr = Tracer(memory=False)
    before = K.KERNELS["cc"].launches
    with tracing(tr):
        connected_components(adj, backend="cuda", max_iters=21)
    (op,) = tr.roots
    assert op.name == "op:cc_labels" and op.attrs["backend"] == "cuda"
    (sp,) = op.children
    assert K.KERNELS["cc"].launches - before == 1
    assert sp.name == "kernel_launch" and sp.attrs["kernel"] == "cc_labels"
    assert (sp.attrs["rounds"], sp.attrs["chunks"]) == (21, 3)
    assert sp.attrs["path"] == "block"


def test_memory_source_follows_the_run_device(card):
    """With the CUDA allocator live in this process, a traced CPU run still
    reports live tensors and a traced card run the allocator's stats."""
    torch.ones(1, device=card)
    assert torch.cuda.is_initialized()
    rs = simulate_reads(simulate_genome(np.random.default_rng(7), 1500),
                        depth=6, mean_len=300, std_len=30, min_len=200, seed=8)
    for dev, source in (("cpu", "live_buffers"), ("cuda", "device_stats")):
        res = assemble(rs.codes, rs.lengths,
                       PipelineConfig(device=dev, trace=True))
        assert res.stats["hbm_source"] == source
        assert {sp.attrs["hbm_source"] for sp in res.trace.roots} == {source}
