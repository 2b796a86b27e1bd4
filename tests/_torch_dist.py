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
    from repro_torch.core.grid import release_grids

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
        release_grids()


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
    fields = ("codes", "lengths", "states", "offsets", "widths", "n_pieces")
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


def _block_local_row_max(grid, row_max):
    """A planted fault of the distributed TR: the row maximum of the rank's
    block alone, not reduced over the grid row."""
    return row_max


def job_tr_grid(inputs):
    """TrReduction on the 2×2 grid: a traced ``assemble(distribution=
    "shard_map")`` (results, stats and the TrReduction stage's spans), then
    ``transitive_reduction_shard_map`` on its R with N's blocks cut to
    ``inputs["small_capacity"]`` slots, and at the fuzz
    ``inputs["fault_fuzz"]`` without and with the planted fault of
    :func:`_block_local_row_max`."""
    from unittest import mock

    from repro_torch.assembly.pipeline import PipelineConfig, assemble
    from repro_torch.core import summa as S
    from repro_torch.core.grid import ProcessGrid

    grid = ProcessGrid.square()
    cfg = PipelineConfig(**{**inputs["cfg"], "distribution": "shard_map",
                            "device": "cpu", "mesh": grid, "trace": True})
    res = assemble(inputs["codes"], inputs["lengths"], cfg)
    (tr_root,) = [r for r in res.trace.roots if r.name == "TrReduction"]
    spans = [(sp.label, sp.attrs.get("kind"), sp.attrs.get("iter"),
              sp.attrs.get("path")) for sp in tr_root.walk()]
    out = {"R": _ell_np(res.r_graph), "S": _ell_np(res.s_graph),
           "stats": dict(res.stats), "contained": _np(res.contained),
           "contigs": [(c.reads, c.length, c.codes) for c in res.contigs],
           "polished": [(c.reads, c.length, c.codes)
                        for c in res.polished_contigs],
           "spans": spans, "labels": sorted(res.trace.summary())}

    def tr(fuzz=cfg.tr_fuzz, **kw):
        s, st, xs = S.transitive_reduction_shard_map(
            res.r_graph, fuzz, max_iters=cfg.tr_max_iters, mesh=grid, **kw)
        return _ell_np(s), st.n_overflow, xs

    out["small"] = tr(n_block_capacity=inputs["small_capacity"])
    fuzz = inputs["fault_fuzz"]
    out["sound"] = tr(fuzz=fuzz)
    with mock.patch.object(S, "_grid_row_max", _block_local_row_max):
        out["fault"] = tr(fuzz=fuzz)
    return out


def job_compressed_reduce(inputs):
    """``CompressedAllReduce.reduce`` of this rank's gradients
    (``inputs["grads"][rank]``) over ``"data"`` of a ``(world, 1)`` grid,
    for each mode, with the grid's all-reduce byte count."""
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.runtime import CompressedAllReduce

    rank = dist.get_rank()
    grid = ProcessGrid(dist.get_world_size(), 1)
    grads = {k: torch.from_numpy(v) for k, v in inputs["grads"][rank].items()}
    out = {}
    for mode in ("none", "bf16", "int8"):
        grid.reset_collective_bytes()
        red = CompressedAllReduce(mode=mode).reduce(grads, grid, "data")
        out[mode] = {k: v.float().numpy() for k, v in red.items()}
        out[mode + "_bytes"] = grid.reset_collective_bytes()["all_reduce"]
    return out


# ---------------------------------------------------------------------------
# language-model mesh paths
# ---------------------------------------------------------------------------


def _lm_rows(x, grid, n_rows):
    """This rank's data-parallel rows of a global array (numpy)."""
    from repro_torch.runtime.sharding import dp_axes

    i = grid.axis_index(dp_axes(grid))
    return x[i * n_rows:(i + 1) * n_rows]


def job_lm_mesh(inputs):
    """Every case of ``inputs["cases"]`` on the grid ``inputs["grid"]``
    (``(shape, axes)``): the loss and every gradient (gathered to logical
    tensors, FSDP on) of the rank's rows, the residual's shape entering
    each block, and for each ``sharded_cache_update`` the rows' logits of
    prefill and the teacher-forced decode steps (``seq_shards`` = the
    model axis, caches sequence-sharded)."""
    import dataclasses

    from repro_torch.convert import lm_config_from_dict, lm_params_from_numpy
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.models import model as M
    from repro_torch.runtime.sharding import dp_axes, gather_tensor

    grid = ProcessGrid.of_shape(*inputs["grid"])
    n_dp = grid.size(dp_axes(grid))
    tp = grid.shape["model"]
    out = {}
    for case in inputs["cases"]:
        cfg = lm_config_from_dict(case["cfg"])
        rows = case["batch"]["labels"].shape[0] // n_dp
        res = {}
        model = lm_params_from_numpy(case["params"], cfg, train=True,
                                     mesh=grid, fsdp=True)
        shapes = []
        hooks = [blk.register_forward_pre_hook(
            lambda m, a: shapes.append(tuple(a[0].shape)))
            for s in model.slots for blk in s]
        batch = {k: torch.from_numpy(_lm_rows(v, grid, rows))
                 for k, v in case["batch"].items()}
        loss, grads = M.loss_and_grads(model, batch, cfg, mesh=grid)
        for h in hooks:
            h.remove()
        specs = model.sharding.specs
        res["loss"] = float(loss)
        res["grads"] = {n: _np(gather_tensor(g, specs[n], grid))
                        for n, g in grads.items()}
        res["block_input_shapes"] = sorted(set(shapes))
        serve = lm_params_from_numpy(case["params"], cfg, mesh=grid)
        prompt = {k: torch.from_numpy(_lm_rows(v, grid, rows))
                  for k, v in case["prompt"].items()}
        for scu in (False, True):
            c = dataclasses.replace(cfg, sharded_cache_update=scu)
            caches = M.init_cache(c, rows * n_dp, case["max_len"], mesh=grid,
                                  seq_sharded=True)
            logits = [M.make_prefill_step(c, mesh=grid)(serve, caches,
                                                        prompt)[0]]
            step = M.make_serve_step(c, mesh=grid, seq_shards=tp)
            for i, d in enumerate(case["decode"]):
                inp = {k: torch.from_numpy(_lm_rows(v, grid, rows))
                       for k, v in d.items()}
                logits.append(step(serve, caches, inp, case["pos0"] + i)[0])
            res[f"logits_scu{scu}"] = [_np(t) for t in logits]
        res["rows"] = (grid.axis_index(dp_axes(grid)) * rows, rows)
        out[case["name"]] = res
    return out


def job_lm_shardmap(inputs):
    """The shard_map bodies on a 2×2 grid, each rank on its blocks of the
    global numpy inputs: split-KV decode (window off and on), the
    owner-writes cache update, the expert-parallel MoE and the
    vocab-parallel cross entropy with its gradients."""
    from repro_torch.convert import lm_config_from_dict
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.moe import ExpertShard, moe_ffn_shardmap
    from repro_torch.runtime.sharding import gather_tensor, shard_tensor

    grid = ProcessGrid(2, 2)
    t = {k: torch.from_numpy(v) for k, v in inputs["arrays"].items()}
    out = {}
    kv = ("data", "model")  # the caches' (batch, sequence) blocks
    kc = shard_tensor(t["kc"], kv, grid)
    vc = shard_tensor(t["vc"], kv, grid)
    q = shard_tensor(t["q"], ("data",), grid)
    cur = shard_tensor(t["cur"], ("data",), grid)
    for w in (None, inputs["window"]):
        o = A.decode_attention_sharded(q, kc, vc, cur, mesh=grid, window=w)
        out[f"decode_{w}"] = _np(gather_tensor(o, ("data",), grid))
    kn = shard_tensor(t["kn"], ("data",), grid)
    vn = shard_tensor(t["vn"], ("data",), grid)
    for pos in inputs["positions"]:
        k2, v2 = A.cache_update_sharded(kc.clone(), vc.clone(), kn, vn, pos,
                                        mesh=grid)
        out[f"update_{pos}"] = (_np(gather_tensor(k2, kv, grid)),
                                _np(gather_tensor(v2, kv, grid)))
    p = ExpertShard(t["router"], *(shard_tensor(t[n], ("model",), grid)
                                   for n in ("w_gate", "w_up", "w_down")))
    y = moe_ffn_shardmap(shard_tensor(t["x_moe"], ("data",), grid), p,
                         mesh=grid, n_experts_real=inputs["n_real"],
                         top_k=inputs["top_k"], token_axes=("data",))
    out["moe"] = _np(gather_tensor(y, ("data",), grid))
    cfg = lm_config_from_dict(inputs["cfg"])
    x = shard_tensor(t["x_ce"], ("data",), grid).requires_grad_(True)
    w = shard_tensor(t["w_ce"], ("model", None), grid).requires_grad_(True)
    labels = shard_tensor(t["labels"], ("data",), grid)
    loss = M.chunked_ce_loss(x, labels, w, cfg, mesh=grid)
    loss.backward()
    # w is replicated over "data": each rank's gradient is its rows' share,
    # summed over the data axes as the train step's reduce_grads sums it
    gw = grid.psum(w.grad, "data")
    out["ce"] = (float(loss), _np(gather_tensor(x.grad, ("data",), grid)),
                 _np(gather_tensor(gw, ("model", None), grid)))
    return out


def job_lm_train_resume(inputs):
    """Three ``build_train_step(mesh=)`` steps on 2×2 beside the
    single-device steps on the same global batches; then ``reshard_state``
    onto 4×1 (logical leaves before and after), a checkpoint of the 2×2
    state restored onto 4×1 and trained to the end."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import reduced_config
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.launch import train as T
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import CompressedAllReduce, reshard_state
    from repro_torch.runtime.sharding import gather_model, gather_tensor

    import dataclasses

    cfg = dataclasses.replace(reduced_config(inputs["arch"]),
                              dtype=inputs["dtype"])
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 2, inputs["steps"]))
    comp = CompressedAllReduce(mode="none")
    g22 = ProcessGrid(2, 2)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=4,
                           seq_len=inputs["seq"], seed=0)

    def whole(step):  # the global batch: the shards, in order
        parts = [data.batch_at(step, shard=i, n_shards=2) for i in range(2)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def gen():
        return torch.Generator().manual_seed(0)

    ref = T.make_state(cfg, opt, gen())
    ref_step = T.build_train_step(cfg, opt, comp)
    state = T.make_state(cfg, opt, gen(), mesh=g22, fsdp=True)
    step_fn = T.build_train_step(cfg, opt, comp, mesh=g22)
    out = {"ref": [], "grid": []}
    for s in range(3):
        ref, _, m0 = ref_step(ref, as_tensors(whole(s), "cpu"), None)
        state, _, m1 = step_fn(state, as_tensors(T.rank_batch(data, s, g22),
                                                 "cpu"), None)
        out["ref"].append((float(m0["loss"]), float(m0["grad_norm"])))
        out["grid"].append((float(m1["loss"]), float(m1["grad_norm"])))
    ref_params = {n: p.detach().clone() for n, p in ref[0].named_parameters()}
    before = gather_model(state[0])
    out["param_err"] = max(float((before[n] - ref_params[n]).abs().max())
                           for n in ref_params)

    mgr = CheckpointManager(inputs["ckpt"], async_write=False)
    mgr.save(3, state)
    dist.barrier()
    g41 = ProcessGrid.of_shape((4, 1))
    old = dict(state[0].sharding.specs)
    moments = {(k, n): gather_tensor(m, old[n], g22)
               for k in ("mu", "nu") for n, m in getattr(state[1], k).items()}
    moved = reshard_state(state, g41, fsdp=True)
    after = gather_model(moved[0])
    specs = moved[0].sharding.specs
    out["reshard_equal"] = all(torch.equal(before[n], after[n]) for n in before)
    out["reshard_moments_equal"] = all(
        torch.equal(gather_tensor(getattr(moved[1], k)[n], specs[n], g41), m)
        for (k, n), m in moments.items())
    out["reshard_step"] = moved[2]
    out["local_shapes"] = {n: tuple(p.shape)
                           for n, p in moved[0].named_parameters()}

    # resume the checkpoint on 4x1 and run to the end, beside the straight run
    fresh = T.make_state(cfg, opt, torch.Generator().manual_seed(1), mesh=g41)
    restored = mgr.restore(3, fresh)
    restored = (restored[0], restored[1], int(restored[2]))
    step41 = T.build_train_step(cfg, opt, comp, mesh=g41)
    for s in range(3, inputs["steps"]):
        # the same global batch in 4 row blocks of 1
        b = whole(s)
        i = g41.axis_index(("data",))
        restored, _, m = step41(restored, as_tensors(
            {k: v[i:i + 1] for k, v in b.items()}, "cpu"), None)
        ref, _, m0 = ref_step(ref, as_tensors(b, "cpu"), None)
    out["resumed_final"] = float(m["loss"])
    out["straight_final"] = float(m0["loss"])
    return out
