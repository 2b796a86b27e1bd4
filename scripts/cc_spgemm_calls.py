#!/usr/bin/env python3
"""Time the port's ``cc`` and ``spgemm`` kernels per call, on one NVIDIA
card, for one source tree or several in turns.

    python3 scripts/cc_spgemm_calls.py                   # this checkout
    python3 scripts/cc_spgemm_calls.py --trees OLD .     # OLD, ., ., OLD
    python3 scripts/cc_spgemm_calls.py --trees . --variants cc_grid_256

Each tree runs in a process of its own, with ``TREE/src`` first on the
path (its kernels build into ``TREE/build/``), on ``chip_smoke.py``'s
4000 reads and configuration:

* ``cc``: the CUDA-event time of one whole ``connected_components(backend=
  "cuda")`` call (host reads included) on ``expand_states(S)``, on
  ``expand_states(R)`` and on a permuted chain of 2^17 vertices capped at
  1003 rounds, with the rounds and launches of one call; where the tree's
  wrapper takes an edge list (one launch a call), also ``launch_ms``, the
  launch and its one read of the result without the edge list's build;
* ``spgemm``: the CUDA-event time of one ``spgemm_ring_stages`` call on
  ``chip_smoke.py``'s three inputs: the shard_map run's overlap launch (a
  1x1 grid), rank (0, 0)'s four stage panels of a 4x4 grid, and the
  distributed transitive reduction's first launch; where the tree sizes
  its launches by a count launch, also ``count_ms``, that launch alone.

``--variants`` adds trees made from this checkout's ``src`` with the
named edits of ``VARIANTS`` applied to its CUDA sources (under
``build/variants/``); nothing checks their results, and one of them
(``spgemm_no_sort``) gives wrong ones on purpose.  Each process prints one JSON line ``{"tree": ...,
"cc": [...], "spgemm": [...]}``, after one line with the card's name and
power limit; the trees run in the order given, then in reverse (OLD, .,
., OLD), so all are measured on one card in turns.  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: [(source under src/repro_torch/csrc, text, replacement), ...]
VARIANTS = {
    # the cc grid path in blocks of 256 threads (four times the blocks at
    # each grid barrier)
    "cc_grid_256": [("cc.cu", "constexpr int GRID_THREADS = 1024;",
                     "constexpr int GRID_THREADS = 256;")],
    # the cc block path with 512 threads instead of 1024
    "cc_block_512": [("cc.cu", "constexpr int BLOCK_THREADS = 1024;",
                      "constexpr int BLOCK_THREADS = 512;")],
    # spgemm's overlap walk with one live A slot in flight a warp, not four
    "spgemm_unroll_1": [("spgemm.cu", "constexpr int UNROLL_OVERLAP = 4;",
                         "constexpr int UNROLL_OVERLAP = 1;")],
    # spgemm's min-plus walk with two live A slots in flight a warp, not one
    "spgemm_minplus_unroll_2": [("spgemm.cu",
                                 "constexpr int UNROLL_MINPLUS = 1;",
                                 "constexpr int UNROLL_MINPLUS = 2;")],
    # spgemm without its radix sort: wrong results, for the sort's share
    # of the time only
    "spgemm_no_sort": [("spgemm.cu", "shift < col_bits;", "shift < 0;")],
}


def variant_tree(name):
    """A copy of this checkout's ``src`` under ``build/variants/NAME`` with
    the variant's edits; returns its directory."""
    import shutil

    tree = os.path.join(ROOT, "build", "variants", name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(tree, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, old, new in VARIANTS[name]:
        path = os.path.join(tree, "src", "repro_torch", "csrc", src)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {src}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return tree


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(tree, genome_kb, seed):
    """The measurements of one tree, in this process."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch import kernels as K
    from repro_torch.assembly import simulate as sim
    from repro_torch.assembly.counter import first_semiring
    from repro_torch.assembly.pipeline import PipelineConfig, assemble
    from repro_torch.core import backend as B
    from repro_torch.core import summa as SU
    from repro_torch.core.components import connected_components, expand_states
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.core.semiring import minplus_orient_semiring
    from repro_torch.core.spmat import EllMatrix
    from repro_torch.kernels.build import build_all, stream_handle
    from repro_torch.kernels.cc import ops as cc_ops
    from repro_torch.kernels.spgemm import ops as sp_ops

    build_all(list(K.KERNELS))
    rng = np.random.default_rng(seed)
    reads = sim.simulate_reads(
        sim.simulate_genome(rng, genome_kb * 1000), depth=14, mean_len=1400,
        std_len=250, error_rate=0.05, indel_frac=0.6, seed=seed + 1)
    cfg = PipelineConfig(
        m_capacity=1 << 20, upper=56, read_capacity=160, overlap_capacity=64,
        r_capacity=40, band=65, max_steps=4096, xdrop=30, align_chunk=4096,
        device="cuda")
    res = assemble(reads.codes, reads.lengths, cfg)
    out = {"tree": tree, "reads": reads.n_reads, "cc": [], "spgemm": []}

    def cc_case(label, cols, max_iters, reps):
        adj = EllMatrix(cols=cols, vals={}, n_cols=cols.shape[0])
        before = K.KERNELS["cc"].launches
        _, it = connected_components(adj, max_iters=max_iters, backend="cuda")
        launches = K.KERNELS["cc"].launches - before
        ms = time_ms(lambda: connected_components(adj, max_iters=max_iters,
                                                  backend="cuda"), reps)
        rec = {"input": label, "n": cols.shape[0],
               "live_edges": int((cols >= 0).sum()), "rounds": it,
               "launches": launches, "ms_per_call": ms}
        if hasattr(cc_ops, "edge_list"):
            edges = cc_ops.edge_list(cols)
            n = cols.shape[0]
            lab0 = torch.arange(n, dtype=torch.int32, device=cols.device)
            rounds, n_chunks, rem = cc_ops.chunk_rule(
                n if max_iters is None else max_iters)
            rec["path"] = cc_ops.cc_path(n, edges.shape[0])
            rec["launch_ms"] = time_ms(lambda: cc_ops._launch(
                edges, lab0, rounds=rounds, n_chunks=n_chunks, rem=rem), reps)
        out["cc"].append(rec)

    cc_case("expand_states(S)", expand_states(res.s_graph).cols.contiguous(),
            None, 10)
    cc_case("expand_states(R)", expand_states(res.r_graph).cols.contiguous(),
            None, 10)
    perm = np.random.default_rng(seed).permutation(1 << 17)
    chain = np.full((1 << 17, 1), -1, np.int32)
    chain[perm[:-1], 0] = perm[1:]
    cc_case("permuted chain of 2^17 vertices", torch.from_numpy(chain).cuda(),
            1003, 3)

    captured = []
    kernel_fn = K.spgemm_ring_stages

    def capture(*a, **kw):
        captured.append((a, kw))
        return kernel_fn(*a, **kw)

    B.register_op("spgemm_ring_stages", "cuda", capture)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        assemble(reads.codes, reads.lengths,
                 dataclasses.replace(cfg, distribution="shard_map"))
        ov_args, ov_kw = captured[0]
        r_mat = res.r_graph
        rd, _ = SU.distribute_ell_blocks(
            r_mat, block_capacity=r_mat.capacity,
            semiring=minplus_orient_semiring, mesh=ProcessGrid.square())
        captured.clear()
        SU.dist_transitive_reduction_ring(
            rd, cfg.tr_fuzz, n_block_capacity=min(r_mat.capacity ** 2,
                                                  4 * r_mat.capacity),
            max_iters=cfg.tr_max_iters)
        tr_args, tr_kw = captured[0]
    finally:
        dist.destroy_process_group()
        B.register_op("spgemm_ring_stages", "cuda", kernel_fn)
    # rank (0, 0) of a 4x4 grid: stage t holds A block (0, t) and B block
    # (t, 0) of the Cannon-skewed layouts (as chip_smoke.py builds them)
    _, a_cols, a_vals, b_cols, b_vals = ov_args
    q = 4
    mats = []
    for cols, vals, n_cols in ((a_cols, a_vals, cfg.m_capacity),
                               (b_cols, b_vals, ov_kw["n_cols_out"])):
        m = EllMatrix(cols=cols[0], vals={k: v[0] for k, v in vals.items()},
                      n_cols=n_cols)
        mats.append(SU.block_layout(m, pc=q, block_capacity=m.capacity,
                                    semiring=first_semiring)[0])
    a_sk, b_sk = SU._skew_a(mats[0], q, q), SU._skew_b(mats[1], q, q)
    a_p = [SU.local_block(a_sk, q, q, 0, t) for t in range(q)]
    b_p = [SU.local_block(b_sk, q, q, t, 0) for t in range(q)]
    nb4 = mats[1].cols.shape[0] // q
    args4 = (torch.arange(q, dtype=torch.int32, device=a_cols.device) * nb4,
             torch.stack([p.cols for p in a_p]),
             {k: torch.stack([p.vals[k] for p in a_p]) for k in a_vals},
             torch.stack([p.cols for p in b_p]),
             {k: torch.stack([p.vals[k] for p in b_p]) for k in b_vals})
    for label, args, kw in (
            ("shard_map overlap launch, 1x1 grid", ov_args, ov_kw),
            ("rank (0, 0) of a 4x4 grid, S = 4", args4, ov_kw),
            ("dist TR first launch, min-plus orient", tr_args, tr_kw)):
        rec = {"input": label, "stages": args[1].shape[0],
               "rows": args[1].shape[1],
               "ms": time_ms(lambda: K.spgemm_ring_stages(*args, **kw), 10)}
        if hasattr(sp_ops, "_COUNT_ARGS"):
            count = sp_ops.KERNEL.entry("spgemm_count", sp_ops._COUNT_ARGS)
            vals = [next(iter(v.values())) for v in (args[2], args[4])]
            ptrs = (args[0].data_ptr(), args[1].data_ptr(), vals[0].data_ptr(),
                    args[3].data_ptr(), vals[1].data_ptr())
            sr_id = sp_ops.SEMIRINGS[kw["semiring"].name]
            i32 = dict(dtype=torch.int32, device=args[1].device)
            if hasattr(sp_ops, "fit_candidates"):
                # the count launch that also lists the rows too full for
                # shared memory
                maxes = torch.zeros(4, **i32)
                full = torch.empty(args[1].shape[0] * args[1].shape[1], **i32)
                outs = (maxes.data_ptr(), full.data_ptr(),
                        sp_ops.fit_candidates(sr_id, args[1].shape[2],
                                              args[3].shape[2]))
            else:
                maxes = torch.zeros(2, **i32)
                outs = (maxes.data_ptr(),)
            rec["count_ms"] = time_ms(lambda: count(
                sr_id, *ptrs, *outs, *args[1].shape, *args[3].shape[1:],
                stream_handle(args[1])), 10)
        out["spgemm"].append(rec)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[ROOT],
                    help="source trees (directories holding src/)")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(VARIANTS),
                    help="edited copies of this checkout to time as well")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--genome-kb", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    if args.one:
        print(json.dumps(measure(args.one, args.genome_kb, args.seed)),
              flush=True)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    trees = args.trees + [variant_tree(v) for v in args.variants]
    order = trees if len(trees) == 1 else trees + trees[::-1]
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--genome-kb", str(args.genome_kb), "--seed", str(args.seed)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            sys.exit(proc.returncode)
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
