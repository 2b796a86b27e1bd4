"""Multi-rank runs of the port on the CPU: ``run_ranks`` starts N ranks with
``torch.multiprocessing`` (spawn), joins them into a gloo process group
(rendezvous through a file in the test's temporary directory, so parallel
test workers never race for a port), runs one job function of this module
on every rank and returns what each rank's job returned.

Jobs import torch and ``repro_torch`` only (never JAX): they take a dict of
numpy inputs, pickled by the test, and return plain values and numpy
arrays.  Each rank runs on one thread.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 240


def _worker(rank, world, job, in_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        out = globals()[job](inputs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, job: str, inputs: dict, tmp_dir) -> list:
    """Run ``job`` (a function of this module) on ``world`` gloo ranks;
    returns the per-rank results, rank 0 first."""
    tmp_dir = str(tmp_dir)
    in_path = os.path.join(tmp_dir, f"{job}_in.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(_worker, args=(world, job, in_path, tmp_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job} on {world} ranks exceeded "
                               f"{JOB_TIMEOUT_S} s")
    outs = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ---------------------------------------------------------------------------
# helpers shared by the jobs
# ---------------------------------------------------------------------------


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _ell(d):
    from repro_torch.convert import ell_from_numpy

    return ell_from_numpy(d["cols"], d["vals"], d["n_cols"])


def _ell_np(m):
    return {"cols": _np(m.cols), "vals": _np(m.vals), "n_cols": m.n_cols}


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def job_grid(inputs):
    """The grid's collectives on every shape of the world: ppermute
    direction, reductions over each axis, tiled all-gather."""
    from repro_torch.core.grid import ProcessGrid

    world = dist.get_world_size()
    rank = dist.get_rank()
    out = {"square": ProcessGrid.square().shape,
           "rows": ProcessGrid.rows().shape}
    for pr in (1, 2, 4):
        if world % pr:
            continue
        g = ProcessGrid(pr, world // pr)
        res = {"ij": (g.i, g.j)}
        x = torch.tensor([10 * rank + 1], dtype=torch.int32)
        for axis in ("data", "model"):
            n = g.shape[axis]
            left = [((t + 1) % n, t) for t in range(n)]
            res[f"left_{axis}"] = int(g.ppermute(x, axis, left)[0])
            res[f"right_{axis}"] = int(g.ppermute(
                x, axis, [(t, (t + 1) % n) for t in range(n)])[0])
            res[f"sum_{axis}"] = int(g.psum(x, axis)[0])
            res[f"max_{axis}"] = int(g.pmax(x, axis)[0])
            res[f"gather_{axis}"] = _np(g.all_gather(
                torch.tensor([[rank, rank]], dtype=torch.int32), axis, dim=0))
        res["sum_all"] = int(g.psum(x, ("data", "model"))[0])
        flag = torch.tensor([rank == 0])
        res["any_model"] = bool(g.psum(flag, "model")[0])
        res["max_f32_data"] = float(g.pmax(torch.tensor([float(rank)]),
                                           "data")[0])
        # a pair exchange with one idle index (odd-even transposition)
        n = g.shape["model"]
        if n >= 3:
            res["pair"] = int(g.ppermute(x, "model", [(0, 1), (1, 0)])[0])
        out[f"{pr}x{world // pr}"] = res
    return out


def job_grid_pod(inputs):
    """The collectives of a ``("pod", "data", "model")`` grid over each
    axis and over ``("pod", "data")``, with the grid's byte counts."""
    from repro_torch.core.grid import POD_AXES, ProcessGrid

    g = ProcessGrid(*inputs["shape"], axis_names=POD_AXES)
    rank = dist.get_rank()
    out = {"coords": g.coords, "pr": g.pr, "pc": g.pc, "i": g.i, "j": g.j,
           "row_axes": g.row_axes}
    x = torch.tensor([10 * rank + 1], dtype=torch.int32)
    for axes in ("pod", "data", "model", ("pod", "data")):
        key = axes if isinstance(axes, str) else "+".join(axes)
        n = g.size(axes)
        res = {"index": g.axis_index(axes), "members": g.members(axes)}
        res["left"] = int(g.ppermute(x, axes, [((t + 1) % n, t)
                                               for t in range(n)])[0])
        res["sum"] = int(g.psum(x, axes)[0])
        res["max"] = int(g.pmax(x, axes)[0])
        res["any"] = bool(g.psum(torch.tensor([rank == 0]), axes)[0])
        res["gather"] = _np(g.all_gather(
            torch.tensor([[rank, rank]], dtype=torch.int32), axes, dim=0))
        out[key] = res
    out["bytes"] = g.reset_collective_bytes()
    out["bytes_after_reset"] = dict(g.collective_bytes)
    return out


def job_summa(inputs):
    """Ring SUMMA on the square grid: the overlap product through the
    pipeline's entry point, the min-plus ring and all-gather products, and
    the Cannon skew by exchange against its global view."""
    from repro_torch.assembly.counter import first_semiring
    from repro_torch.core import summa as S
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.core.semiring import minplus_orient_semiring as MPSR
    from repro_torch.core.semiring import overlap_semiring

    grid = ProcessGrid.square()
    out = {"grid": (grid.pr, grid.pc)}
    a, at = _ell(inputs["A"]), _ell(inputs["At"])
    c, ovf, st = S.overlap_spgemm_shard_map(
        a, at, semiring=overlap_semiring, operand_semiring=first_semiring,
        capacity=inputs["cap"], mesh=grid)
    out["overlap"] = (_ell_np(c), int(ovf), st)
    c1, ovf1, st1 = S.overlap_spgemm_shard_map(
        a, at, semiring=overlap_semiring, operand_semiring=first_semiring,
        capacity=inputs["cap"], mesh=grid, stages_per_call=1)
    out["overlap_g1"] = (_ell_np(c1), int(ovf1), st1)

    r = _ell(inputs["R"])
    rd, ovf_d = S.distribute_ell_blocks(r, block_capacity=r.capacity,
                                        semiring=MPSR, mesh=grid)
    # the same matrix from its COO triplets
    coo = {k: torch.from_numpy(v) for k, v in inputs["R_coo"].items()}
    rc, ovf_c = S.distribute_ell(coo["rows"], coo["cols"], {"v": coo["vals"]},
                                 coo["valid"], n_rows=16, n_cols=16,
                                 block_capacity=r.capacity, semiring=MPSR,
                                 mesh=grid)
    out["coo_equal"] = bool(
        torch.equal(rc.mat.cols, rd.mat.cols)
        and torch.equal(rc.mat.vals["v"], rd.mat.vals["v"])
        and int(ovf_c) == int(ovf_d) == 0)
    c_rg, ovf_rg, st_rg = S.summa_ring(rd, rd, semiring=MPSR,
                                       out_block_capacity=16)
    c_ag, ovf_ag = S.summa_allgather(rd, rd, semiring=MPSR,
                                     out_block_capacity=16)
    out["mp_ring"] = (_ell_np(S.collect(c_rg)), int(ovf_rg), st_rg)
    out["mp_allgather"] = (_ell_np(S.collect(c_ag)), int(ovf_ag))
    c_h, ovf_h, _ = S.overlap_spgemm_shard_map(
        r, r, semiring=MPSR, operand_semiring=MPSR, capacity=16, mesh=grid)
    out["mp_host"] = (_ell_np(c_h), int(ovf_h))

    # the skew by exchange equals the global view's block
    g, _ = S.block_layout(r, pc=grid.pc, block_capacity=r.capacity,
                          semiring=MPSR)
    ac, av, bc, bv = S._skew_local(rd.mat, rd.mat, grid)
    ga = S.local_block(S._skew_a(g, grid.pr, grid.pc), grid.pr, grid.pc,
                       grid.i, grid.j)
    gb = S.local_block(S._skew_b(g, grid.pr, grid.pc), grid.pr, grid.pc,
                       grid.i, grid.j)
    out["skew_ok"] = bool(torch.equal(ac, ga.cols) and torch.equal(bc, gb.cols)
                          and torch.equal(av["v"], ga.vals["v"])
                          and torch.equal(bv["v"], gb.vals["v"]))
    return out


def job_tr(inputs):
    """Distributed transitive reduction: ring, all-gather, fused
    all-gather."""
    from repro_torch.core import summa as S
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.core.semiring import minplus_orient_semiring as MPSR

    grid = ProcessGrid.square()
    r = _ell(inputs["R"])
    rd, _ = S.distribute_ell_blocks(r, block_capacity=r.capacity,
                                    semiring=MPSR, mesh=grid)
    fuzz = inputs["fuzz"]
    out = {}
    s_rg, it_rg, nnz_rg, st = S.dist_transitive_reduction_ring(rd, fuzz)
    out["ring"] = (_ell_np(S.collect(s_rg)), it_rg, nnz_rg, st)
    s_ag, it_ag, nnz_ag = S.dist_transitive_reduction(rd, fuzz)
    out["allgather"] = (_ell_np(S.collect(s_ag)), it_ag, nnz_ag)
    s_fu, it_fu, nnz_fu = S.dist_transitive_reduction(rd, fuzz, fused=True)
    out["fused"] = (_ell_np(S.collect(s_fu)), it_fu, nnz_fu)
    s_kn, _, nnz_kn = S.dist_transitive_reduction(rd, fuzz, summa="ring")
    out["knob"] = (_ell_np(S.collect(s_kn)), nnz_kn)
    return out


def job_multipod(inputs):
    """The multipod cases of JAX's distributed tests on a ``(2, 2, 2)``
    ``("pod", "data", "model")`` grid: the all-gather SUMMA with grid rows
    on ``("pod", "data")``, the ring with rows on ``("data",)`` and its
    recorded fallback on ``("pod", "data")``, both distributed TRs, the
    doubling middle, the contig chain stage and the distributed x-drop."""
    from repro_torch.core import summa as S
    from repro_torch.core.align_dist import align_bucket_shard_map
    from repro_torch.core.components_dist import (
        contig_stage_shard_map,
        doubling_shard_map,
    )
    from repro_torch.core.grid import POD_AXES, ProcessGrid
    from repro_torch.core.semiring import MP
    from repro_torch.core.semiring import minplus_orient_semiring as MPSR

    grid = ProcessGrid.of_shape((2, 2, 2), POD_AXES)
    out = {}

    def dist_of(coo, row_axes):
        t = {k: torch.from_numpy(v) for k, v in coo.items()}
        d, ovf = S.distribute_ell(t["rows"], t["cols"], {MP: t["vals"]},
                                  t["ok"], n_rows=16, n_cols=16,
                                  block_capacity=8, semiring=MPSR, mesh=grid,
                                  row_axes=row_axes)
        assert int(ovf) == 0
        return d

    rd = dist_of(inputs["ag"], ("pod", "data"))
    c, ovf = S.summa_allgather(rd, rd, semiring=MPSR, out_block_capacity=16)
    out["allgather"] = (_ell_np(S.collect(c)), int(ovf))
    for name, row_axes in (("ring_data", ("data",)),
                           ("ring_pod_data", ("pod", "data"))):
        rd = dist_of(inputs["ring"], row_axes)
        c, ovf, st = S.summa_ring(rd, rd, semiring=MPSR,
                                  out_block_capacity=16)
        out[name] = (_ell_np(S.collect(c)), int(ovf), st)
        for fused in (False, True):
            s, it, nnz = S.dist_transitive_reduction(rd, 50.0, fused=fused)
            out[f"tr_{name}_{fused}"] = (_ell_np(S.collect(s)), it, nnz)
        s, it, nnz, st = S.dist_transitive_reduction_ring(rd, 50.0)
        out[f"trring_{name}"] = (_ell_np(S.collect(s)), it, nnz, st)

    d = doubling_shard_map(torch.from_numpy(inputs["succ"]),
                           torch.from_numpy(inputs["pred"]), mesh=grid)
    out["doubling"] = _np(d)
    st, xstats = contig_stage_shard_map(_ell(inputs["S"]), mesh=grid)
    out["contig_stage"] = (_np(st), xstats)

    cand = {k: torch.from_numpy(v) for k, v in inputs["cand"].items()}
    res, stats = align_bucket_shard_map(
        torch.from_numpy(inputs["codes"]), cand, k=inputs["k"], mesh=grid,
        **inputs["kw"])
    out["align"] = {"res": _np(tuple(res)), "stats": stats}
    return out


def job_cell(inputs):
    """The dibella cell at ``reduced()`` on the square grid: each stage's
    specs and, for each ``row_chunk``, the rank's outputs and grid
    position."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.launch.dibella_cell import (
        build_cells,
        local_inputs,
        make_global_inputs,
    )

    cfg = reduced_config("dibella")
    grid = ProcessGrid.square()
    args = local_inputs(make_global_inputs(cfg, grid.pc, seed=inputs["seed"],
                                           device="cpu"), grid)
    out = {"ij": (grid.i, grid.j)}
    for rc in inputs["row_chunks"]:
        cells = build_cells(cfg, grid, row_chunk=rc)
        out["specs"] = {k: _np([(tuple(t.shape), str(t.dtype))
                                for t in _leaves(v[1])])
                        for k, v in cells.items()}
        out[rc] = {k: _np(cells[k][0](*args[k])) for k in cells}
    return out


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    return [t for v in x for t in _leaves(v)]


def job_align(inputs):
    """The distributed x-drop over the default P×1 grid."""
    from repro_torch.core.align_dist import align_bucket_shard_map

    cand = {k: torch.from_numpy(v) for k, v in inputs["cand"].items()}
    res, stats = align_bucket_shard_map(
        torch.from_numpy(inputs["codes"]), cand, k=inputs["k"],
        **inputs["kw"])
    return {"res": _np(tuple(res)), "stats": stats}


def job_contigs(inputs):
    """The distributed contig chain stage, alone and inside the device
    contig path."""
    from repro_torch.assembly.contig_gen import _graph_cut, generate_contigs
    from repro_torch.core.components_dist import (
        contig_stage_shard_map,
        doubling_shard_map,
    )

    s = _ell(inputs["S"])
    st, stats = contig_stage_shard_map(s)
    cut = _graph_cut(s)
    dbl = doubling_shard_map(cut["succ0"], cut["pred0"])
    codes = torch.from_numpy(inputs["codes"])
    lengths = torch.from_numpy(inputs["lengths"])
    cset = generate_contigs(s, codes, lengths, backend="cuda",
                            distribution="shard_map")
    fields = ("codes", "lengths", "states", "offsets", "widths")
    return {"st": _np(st), "stats": stats, "doubling": _np(dbl),
            "cset": {f: _np(getattr(cset, f)) for f in fields},
            "n_contigs": cset.n_contigs, "cset_stats": cset.stats}


def job_assemble(inputs):
    """``assemble(distribution="shard_map", device="cpu")`` for each
    backend in ``inputs["backends"]``, on the grid ``inputs["grid"]``
    (``(shape, axes)``; default none: JAX's default grids).  Results are
    keyed by backend, or, for each grid-row choice of
    ``inputs["row_axes_list"]``, by ``(backend, row_axes)``."""
    from repro_torch.assembly.pipeline import PipelineConfig, assemble
    from repro_torch.core.grid import ProcessGrid

    mesh = (ProcessGrid.of_shape(*inputs["grid"]) if inputs.get("grid")
            else None)
    runs = [(b, None, b) for b in inputs["backends"]]
    if inputs.get("row_axes_list"):
        runs = [(b, ra, (b, ra)) for b in inputs["backends"]
                for ra in inputs["row_axes_list"]]
    out = {}
    for backend, row_axes, key in runs:
        cfg = PipelineConfig(**{**inputs["cfg"], "backend": backend,
                                "distribution": "shard_map", "device": "cpu",
                                "mesh": mesh, "row_axes": row_axes})
        res = assemble(inputs["codes"], inputs["lengths"], cfg)
        out[key] = {
            "R": _ell_np(res.r_graph), "S": _ell_np(res.s_graph),
            "stats": dict(res.stats), "contained": _np(res.contained),
            "contigs": [(c.reads, c.length, c.codes) for c in res.contigs],
            "polished": [(c.reads, c.length, c.codes)
                         for c in res.polished_contigs],
        }
    return out
