"""The port's launch layer: the dibella config and registry, the roofline
on the H100's published peaks, process grids for launches, the dibella
cell against JAX's and its dry run.

The cell's specs are JAX's ``build_cells`` specs divided per rank, and its
outputs equal JAX's programs run on the same inputs, on a 1×1 grid (JAX in
this process) and on a 2×2 grid (4 gloo ranks against JAX in a subprocess
with 4 host devices), with ``row_chunk`` None and 64: the results do not
depend on it."""

import dataclasses
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch.dibella_cell import build_cells as j_build_cells
from repro.launch.mesh import make_test_mesh
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.grid import POD_AXES, ProcessGrid
from repro_torch.launch import dryrun, mesh
from repro_torch.launch.dibella_cell import (
    build_cells,
    cell_specs,
    local_inputs,
    make_global_inputs,
    tree_bytes,
)
from repro_torch.launch.roofline import (
    RooflineTerms,
    model_flops,
    roofline_fraction,
)

from _dist_helpers import run_with_devices
from _torch_dist import run_ranks

ROW_CHUNKS = (None, 64)


# --- configs -----------------------------------------------------------------


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_dibella_config_equals_jax(which):
    get = (get_config, j_get_config) if which == "full" else (
        reduced_config, j_reduced_config)
    port, ref = get[0]("dibella"), get[1]("dibella")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if which == "full":
        assert (port.n_reads, port.m_kmers, port.tr_fuzz) == (
            4_194_304, 1 << 24, 1000.0)
        assert (port.read_capacity, port.kmer_capacity,
                port.overlap_block_capacity, port.r_block_capacity) == (
            64, 8, 16, 8)


def test_lm_archs_are_not_ported():
    for get in (get_config, reduced_config):
        with pytest.raises(NotImplementedError, match="item 14"):
            get("qwen3-4b")
    with pytest.raises(KeyError):
        get_config("nope")
    with pytest.raises(NotImplementedError, match="item 14"):
        dryrun.main(["--arch", "yi-9b", "--device", "cpu"])


# --- roofline on the H100's peaks ---------------------------------------------


def test_roofline_terms():
    t = RooflineTerms(
        arch="x", shape="train_4k", mesh="single", chips=256,
        flops_per_device=989e12,  # exactly 1 second of BF16 compute
        bytes_per_device=3.35e12,  # exactly 1 second of HBM3
        collective_bytes_per_device=900e9 * 2,  # 2 s of all 18 NVLinks
        model_flops_global=989e12 * 256,
    ).finalize()
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 1.0) < 1e-9
    assert abs(t.collective_s - 2.0) < 1e-9
    assert t.bottleneck == "collective"
    assert abs(roofline_fraction(t) - 0.5) < 1e-9
    # one link carries 1/18 of the card's NVLink bandwidth
    t1 = dataclasses.replace(t).finalize(links=1)
    assert abs(t1.collective_s - 36.0) < 1e-9
    # the genome path's f32 add/min rate
    t2 = dataclasses.replace(t, flops_per_device=33.5e12).finalize(
        peak_flops=mesh.F32_ADD_MIN_OPS)
    assert abs(t2.compute_s - 1.0) < 1e-9 and t2.peak_flops == 33.5e12


def test_model_flops():
    class C:
        def active_param_count(self):
            return 1_000_000

    assert model_flops(C(), "train", 10, 2) == 6e6 * 20
    assert model_flops(C(), "prefill", 10, 2) == 2e6 * 20
    assert model_flops(C(), "decode", 9999, 4) == 2e6 * 4


def test_h100_constants_and_grids():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW) == (989e12, 3.35e12)
    assert mesh.NVLINK_LINKS == 18
    assert mesh.NVLINK_BW_PER_LINK * mesh.NVLINK_LINKS == 900e9
    assert (mesh.F32_ADD_MIN_OPS, mesh.INT32_OPS) == (33.5e12, 16.75e12)
    assert mesh.PRODUCTION_SHAPES == {
        "single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), POD_AXES)}
    g = mesh.make_test_grid((1, 1, 1), POD_AXES)
    assert g.shape == {"pod": 1, "data": 1, "model": 1}
    assert mesh.make_test_grid((1, 1)).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="4 ranks"):
        mesh.make_test_grid()  # JAX's (2, 2) default
    for multi in (False, True):  # 256 / 512 ranks: not this process
        with pytest.raises(ValueError, match="ranks"):
            mesh.make_production_grid(multi_pod=multi)


# --- the dibella cell ------------------------------------------------------------


def _jax_specs(cells):
    return {k: [(tuple(s.shape), str(np.dtype(s.dtype)))
                for s in jax.tree.leaves(v[1])] for k, v in cells.items()}


def _per_rank(specs, pr, pc):
    return {k: [((s[0] // pr, s[1] // pc) + s[2:], d) for s, d in v]
            for k, v in specs.items()}


def _torch_specs(specs):
    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for v in (x.values() if isinstance(x, dict) else x)
                for t in leaves(v)]
    return {k: [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in leaves(v)] for k, v in specs.items()}


@pytest.mark.parametrize("shape,axes", [
    ((16, 16), ("data", "model")), ((2, 16, 16), POD_AXES),
    ((2, 2), ("data", "model"))])
def test_cell_specs_are_jax_specs_per_rank(shape, axes):
    """JAX's global specs come from its ``build_cells`` on a 1×1 mesh with
    the widths of ``shape``'s ``pc`` (``ka = pc · read_capacity`` ...)."""
    cfg = reduced_config("dibella")
    size = dict(zip(axes, shape))
    pr = size.get("pod", 1) * size["data"]
    pc = size["model"]
    # JAX's widths on a pc-column grid, its rows n and m
    jcfg = j_reduced_config("dibella")
    want = {"overlap": [((jcfg.n_reads, pc * jcfg.read_capacity), "int32"),
                        ((jcfg.n_reads, pc * jcfg.read_capacity), "int32"),
                        ((jcfg.m_kmers, pc * jcfg.kmer_capacity), "int32"),
                        ((jcfg.m_kmers, pc * jcfg.kmer_capacity), "int32")],
            "tr": [((jcfg.n_reads, pc * jcfg.r_block_capacity), "int32"),
                   ((jcfg.n_reads, pc * jcfg.r_block_capacity, 4),
                    "float32")]}
    if pc == 1:  # the very specs of JAX's build_cells on a 1x1 mesh
        assert _jax_specs(j_build_cells(jcfg, make_test_mesh((1, 1)))) == want
    got = _torch_specs(cell_specs(cfg, shape, axes))
    assert got == _per_rank(want, pr, pc)
    ints = sum(np.prod(s) for s, d in got["overlap"]) * 4
    assert tree_bytes(cell_specs(cfg, shape, axes)["overlap"]) == ints


@pytest.fixture(scope="module")
def inputs1():
    return make_global_inputs(reduced_config("dibella"), 1, seed=0,
                              device="cpu")


def _np_tree(x):
    if isinstance(x, dict):
        return {k: np.asarray(v) for k, v in x.items()}
    return np.asarray(x)


@pytest.mark.parametrize("row_chunk", ROW_CHUNKS)
def test_cell_on_one_by_one_grid_equals_jax(inputs1, row_chunk):
    g = inputs1
    jcells = j_build_cells(j_reduced_config("dibella"), make_test_mesh((1, 1)),
                           row_chunk=row_chunk)
    cells = build_cells(reduced_config("dibella"), ProcessGrid.square(),
                        row_chunk=row_chunk)
    assert _torch_specs({k: v[1] for k, v in cells.items()}) == _jax_specs(
        jcells)
    args = local_inputs(g, ProcessGrid.square())
    for stage in ("overlap", "tr"):
        want = jcells[stage][0](*jax.tree.map(np.asarray, [
            _np_tree(a) for a in args[stage]]))
        got = cells[stage][0](*args[stage])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for w, v in zip(jax.tree.leaves(want[1]),
                        jax.tree.leaves(_np_tree(got[1]))):
            np.testing.assert_array_equal(v, np.asarray(w))
        for w, v in zip(want[2:], got[2:]):
            assert int(v) == int(w)
    assert got[2] >= 1 and got[3] < int((g["R"][0] >= 0).sum())  # TR pruned


JAX_CELL_2X2 = """
import pickle
import numpy as np, jax
from repro.configs import reduced_config
from repro.launch.dibella_cell import build_cells
from repro.launch.mesh import make_test_mesh

g = pickle.load(open(SRC, "rb"))
mesh = make_test_mesh((2, 2))
out = {}
for rc in (None, 64):
    cells = build_cells(reduced_config("dibella"), mesh, row_chunk=rc)
    out["specs"] = {k: [(tuple(s.shape), str(np.dtype(s.dtype)))
                        for s in jax.tree.leaves(v[1])]
                    for k, v in cells.items()}
    o = cells["overlap"][0](g["A"][0], g["A"][1], g["At"][0], g["At"][1])
    t = cells["tr"][0](*g["R"])
    out[rc] = {"overlap": jax.tree.map(np.asarray, o),
               "tr": jax.tree.map(np.asarray, t)}
pickle.dump(out, open(DST, "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def cell_2x2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cell2x2")
    g = make_global_inputs(reduced_config("dibella"), 2, seed=1,
                           device="cpu")
    g = {k: (tuple(_np_tree(x) for x in v) if isinstance(v, tuple) else v)
         for k, v in g.items()}
    src, dst = tmp / "in.pkl", tmp / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump(g, f)
    run_with_devices(JAX_CELL_2X2.replace("SRC", repr(str(src)))
                     .replace("DST", repr(str(dst))), n_devices=4)
    with open(dst, "rb") as f:
        jax_out = pickle.load(f)
    (tmp / "ranks").mkdir()
    port = run_ranks(4, "job_cell", {"seed": 1, "row_chunks": ROW_CHUNKS},
                     tmp / "ranks")
    return jax_out, port


def _block(x, i, j, pr=2, pc=2):
    nb, kb = x.shape[0] // pr, x.shape[1] // pc
    return x[i * nb:(i + 1) * nb, j * kb:(j + 1) * kb]


@pytest.mark.dist
def test_cell_specs_on_four_ranks_are_jax_specs_per_rank(cell_2x2):
    jax_out, port = cell_2x2
    want = _per_rank(jax_out["specs"], 2, 2)
    for out in port:
        assert {k: [(tuple(s), d.replace("torch.", "")) for s, d in v]
                for k, v in out["specs"].items()} == want


@pytest.mark.dist
@pytest.mark.parametrize("row_chunk", ROW_CHUNKS)
def test_cell_on_four_ranks_equals_jax(cell_2x2, row_chunk):
    jax_out, port = cell_2x2
    want = jax_out[row_chunk]
    for out in port:
        i, j = out["ij"]
        got = out[row_chunk]
        for stage in ("overlap", "tr"):
            w, g = want[stage], got[stage]
            np.testing.assert_array_equal(g[0], _block(w[0], i, j))
            for wl, gl in zip(jax.tree.leaves(w[1]),
                              jax.tree.leaves(_np_tree(g[1]))):
                np.testing.assert_array_equal(gl, _block(wl, i, j))
            assert [int(x) for x in g[2:]] == [int(x) for x in w[2:]]
        # the result does not depend on row_chunk
        for stage in ("overlap", "tr"):
            np.testing.assert_array_equal(out[None][stage][0],
                                          got[stage][0])


# --- row_chunk and build_only of the all-gather SUMMA and the TR --------------


def _mp_dist(seed=4, n=24, e=90, cap=8):
    from repro_torch.core import summa as S
    from repro_torch.core.semiring import MP
    from repro_torch.core.semiring import minplus_orient_semiring as MPSR

    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    # a chain-like pattern too, so the reduction prunes
    rows = torch.cat([rows, torch.arange(n - 2, dtype=torch.int32)])
    cols = torch.cat([cols, torch.arange(2, n, dtype=torch.int32)])
    m = rows.shape[0]
    vals = torch.full((m, 4), float("inf"))
    vals[torch.arange(m), torch.from_numpy(rng.integers(0, 4, m))] = (
        torch.from_numpy(rng.integers(1, 100, m).astype(np.float32)))
    d, _ = S.distribute_ell(rows, cols, {MP: vals}, rows != cols, n_rows=n,
                            n_cols=n, block_capacity=cap, semiring=MPSR)
    return d


@pytest.mark.parametrize("row_chunk", [1, 5, 7, 24, 64])
def test_row_chunk_leaves_summa_and_tr_results_unchanged(row_chunk):
    from repro_torch.core import summa as S
    from repro_torch.core.semiring import MP
    from repro_torch.core.semiring import minplus_orient_semiring as MPSR

    d = _mp_dist()
    base, ovf = S.summa_allgather(d, d, semiring=MPSR, out_block_capacity=32)
    got, ovf_c = S.summa_allgather(d, d, semiring=MPSR, out_block_capacity=32,
                                   row_chunk=row_chunk)
    assert torch.equal(got.mat.cols, base.mat.cols)
    assert torch.equal(got.mat.vals[MP], base.mat.vals[MP])
    assert int(ovf_c) == int(ovf)
    fn = S.summa_allgather(d, d, semiring=MPSR, out_block_capacity=32,
                           row_chunk=row_chunk, build_only=True)
    cc, cv, ovf_b = fn(d.mat.cols, d.mat.vals, d.mat.cols, d.mat.vals)
    assert torch.equal(cc, base.mat.cols) and int(ovf_b) == int(ovf)
    assert torch.equal(cv[MP], base.mat.vals[MP])
    for fused in (False, True):
        s0, it0, nnz0 = S.dist_transitive_reduction(d, 50.0, fused=fused)
        s1, it1, nnz1 = S.dist_transitive_reduction(d, 50.0, fused=fused,
                                                    row_chunk=row_chunk)
        assert (it1, nnz1) == (it0, nnz0) and nnz0 < int(d.mat.nnz())
        assert torch.equal(s1.mat.cols, s0.mat.cols)
        assert torch.equal(s1.mat.vals[MP], s0.mat.vals[MP])
        fn = S.dist_transitive_reduction(d, 50.0, fused=fused,
                                         row_chunk=row_chunk, build_only=True)
        cols, vals, it, nnz = fn(d.mat.cols, d.mat.vals[MP])
        assert torch.equal(cols, s0.mat.cols) and (it, nnz) == (it0, nnz0)
        assert torch.equal(vals, s0.mat.vals[MP])
    with pytest.raises(ValueError, match="ring"):
        S.dist_transitive_reduction(d, 50.0, summa="ring",
                                    row_chunk=row_chunk)


# --- the dry run ----------------------------------------------------------------


def test_dryrun_reduced_on_the_cpu(tmp_path):
    path = tmp_path / "cell.json"
    rec = dryrun.main(["--arch", "dibella", "--reduced", "--device", "cpu",
                       "--mesh", "multi", "--out", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert rec["grid"] == [1, 1] and rec["chips"] == 1
    for stage in ("overlap", "tr"):
        st = rec["stages"][stage]
        assert st["ms"] > 0 and st["memory"]["argument"] > 0
        assert st["collective_bytes_per_device"] == 0  # 1x1: none issued
        assert st["collective_by_op"] == {"all_gather": 0, "all_reduce": 0,
                                          "permute": 0}
    assert rec["stages"]["tr"]["tr_iterations"] >= 1
    prod = rec["production"]
    assert prod["grid"] == [2, 16, 16] and prod["row_axes"] == ["pod", "data"]
    cfg = reduced_config("dibella")
    assert prod["argument_bytes_per_device"]["tr"] == (
        cfg.n_reads // 32 * cfg.r_block_capacity * (4 + 16))
    rt = rec["roofline"]
    assert rt["peak_flops"] == mesh.F32_ADD_MIN_OPS
    assert rt["model_flops_global"] == (
        cfg.n_reads * cfg.read_capacity * cfg.kmer_capacity
        + 3 * cfg.n_reads * cfg.r_block_capacity ** 2 * 8)
    assert rec["roofline_fraction"] > 0
