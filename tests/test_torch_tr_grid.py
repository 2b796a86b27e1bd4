"""TrReduction on a grid of several ranks: Algorithm 2 on the 2D-blocked R
(``core/summa.transitive_reduction_shard_map``) inside ``assemble(
distribution="shard_map", device="cpu")``, on four gloo ranks of a 2×2
``ProcessGrid`` and tiny seeded reads.

Every rank's R, S, contained flags and draft and polished contigs equal
the single-device (gspmd) path's; S equals the plain reference's
transitive reduction (``portbench/reference/assembler.py``) of the
program's R; a 1×1 grid keeps the local TR; N's blocks cut too small count
the products they drop in ``tr_overflow``; and a planted fault (the
prune's row maximum taken per block, not over the grid row) gives another
S, which the comparison with the local TR catches."""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.assembly.simulate import simulate_genome, simulate_reads
from repro_torch.assembly.pipeline import PipelineConfig, assemble
from repro_torch.core.semiring import MP
from repro_torch.core.transitive_reduction import transitive_reduction_fused
from repro_torch.obs import schema

from _torch_dist import run_ranks

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.reference import assembler as ref  # noqa: E402

# CPU tensors on the "cuda" backend: every kernel's plain version and the
# device contig path with its distributed chain stage
CFG = {"backend": "cuda"}
# the fuzz of the planted fault: at the configured 150 a block's own row
# maximum already covers every transitive edge of these reads, at -50 the
# row maximum over the grid row decides some
FAULT_FUZZ = -50.0


def _reads():
    g = simulate_genome(np.random.default_rng(11), 3000)
    return simulate_reads(g, depth=8, mean_len=300, std_len=30, min_len=200,
                          seed=12)


def _assemble(rs, **kw):
    """One CPU assembly on one torch thread (small ops: under several test
    workers a thread pool only contends)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return assemble(rs.codes, rs.lengths,
                        PipelineConfig(**CFG, device="cpu", **kw))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    rs = _reads()
    outs = run_ranks(4, "job_tr_grid",
                     {"codes": rs.codes, "lengths": rs.lengths, "cfg": CFG,
                      "small_capacity": 1, "fault_fuzz": FAULT_FUZZ},
                     tmp_path_factory.mktemp("tr_grid"))
    return rs, outs, _assemble(rs)


def _ell_equal(got, want) -> bool:
    """``got`` (a job's numpy ELL) equals the tensor ELL ``want``, bit for
    bit."""
    return (np.array_equal(got["cols"], want.cols.numpy())
            and sorted(got["vals"]) == sorted(want.vals)
            and all(np.array_equal(got["vals"][k], want.vals[k].numpy())
                    for k in want.vals))


def _contigs(cs):
    return [(c.reads, c.length, c.codes) for c in cs]


def _same_contigs(a, b) -> bool:
    return len(a) == len(b) and all(
        x[0] == y[0] and x[1] == y[1] and np.array_equal(x[2], y[2])
        for x, y in zip(a, b))


@pytest.mark.dist
def test_grid_assembly_equals_the_single_device_path(grid4):
    _, outs, one = grid4
    assert one.stats["nnz_S"] < one.stats["nnz_R"]  # TR prunes something
    for out in outs:
        assert _ell_equal(out["R"], one.r_graph)
        assert _ell_equal(out["S"], one.s_graph)
        np.testing.assert_array_equal(out["contained"], one.contained.numpy())
        assert _same_contigs(out["contigs"], _contigs(one.contigs))
        assert _same_contigs(out["polished"], _contigs(one.polished_contigs))
        st = out["stats"]
        assert st["tr_backend"] == "ring_reference"
        assert st["tr_overflow"] == 0
        for key in ("tr_iterations", "nnz_S", "n_branch_cut"):
            assert st[key] == one.stats[key], key
        assert schema.validate_stats(st) == []


def _grid_nccl():
    spec = importlib.util.spec_from_file_location(
        "grid_nccl", REPO / "scripts" / "grid_nccl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.dist
@pytest.mark.parametrize("plant", [None, "nnz_S"])
def test_four_card_check_holds_grid_stats_to_one_card(grid4, plant):
    """``scripts/grid_nccl.py``'s ``same`` passes every rank's grid stats
    (the TR exchange counts of ``schema.PORT_ONLY`` included, which one
    card has not) and catches a result stat that differs."""
    _, outs, one = grid4
    same = _grid_nccl().same
    for rank, out in enumerate(outs):
        stats = dict(out["stats"])
        assert set(schema.PORT_ONLY) <= set(stats)
        if plant:
            stats[plant] += 1
        got = SimpleNamespace(r_graph=one.r_graph, s_graph=one.s_graph,
                              stats=stats,
                              polished_contigs=one.polished_contigs)
        if plant:
            with pytest.raises(AssertionError, match=plant):
                same(got, one, f"rank {rank}")
        else:
            same(got, one, f"rank {rank}")


@pytest.mark.dist
def test_grid_s_equals_the_reference_tr_of_r(grid4):
    rs, outs, one = grid4
    n = rs.codes.shape[0]
    for out in outs:
        cols, vals = out["R"]["cols"], out["R"]["vals"][MP]
        r, q = np.nonzero(cols >= 0)
        si, sj, sv, iters, _, _ = ref.transitive_reduction(
            torch.from_numpy(r.astype(np.int64)),
            torch.from_numpy(cols[r, q].astype(np.int64)),
            torch.from_numpy(vals[r, q]), n,
            fuzz=PipelineConfig().tr_fuzz,
            max_iters=PipelineConfig().tr_max_iters)
        s_cols, s_vals = out["S"]["cols"], out["S"]["vals"][MP]
        sr, sq = np.nonzero(s_cols >= 0)
        np.testing.assert_array_equal(sr, si.numpy())
        np.testing.assert_array_equal(s_cols[sr, sq], sj.numpy())
        np.testing.assert_array_equal(s_vals[sr, sq], sv.numpy())
        assert out["stats"]["tr_iterations"] == iters


def test_one_rank_grid_keeps_the_local_tr():
    rs = _reads()
    one = _assemble(rs)
    grid = _assemble(rs, distribution="shard_map")
    assert grid.stats["tr_backend"] == one.stats["tr_backend"] == "cuda"
    assert not set(schema.PORT_ONLY) & set(grid.stats)
    assert torch.equal(grid.s_graph.cols, one.s_graph.cols)


@pytest.mark.dist
def test_n_blocks_too_small_count_what_they_drop(grid4):
    _, outs, one = grid4
    for out in outs:
        s_small, overflow, _ = out["small"]
        assert overflow > 0
        # dropped products leave transitive edges standing
        assert not _ell_equal(s_small, one.s_graph)


@pytest.mark.dist
def test_planted_block_local_row_max_is_caught(grid4):
    _, outs, one = grid4
    want, _ = transitive_reduction_fused(
        one.r_graph, FAULT_FUZZ, max_iters=PipelineConfig().tr_max_iters,
        backend="cuda")
    for out in outs:
        assert _ell_equal(out["sound"][0], want)
        s_fault, overflow, _ = out["fault"]
        assert overflow == 0
        assert not _ell_equal(s_fault, want)
