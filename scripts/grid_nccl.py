#!/usr/bin/env python3
"""The port's ``distribution="shard_map"`` path on four cards, one rank a
card, over NCCL.

    python3 scripts/grid_nccl.py                    # needs 4 CUDA cards
    python3 scripts/grid_nccl.py --genome-kb 4641.652   # E. coli's length
    python3 scripts/grid_nccl.py --backend gloo --device cpu --genome-kb 20

Starts 4 processes, joins them into one process group
(``tcp://localhost:<free port>``; rank ``r`` on ``cuda:r``) and, on every
rank, on the same simulated reads (``chip_smoke.simulate`` and
``chip_smoke.assembly_config``; a 400 kb genome, ~4000 reads, by default;
4,641,652 bp, 46,417 reads, as phase 6b, at ``--genome-kb 4641.652``):

1. ``assemble()`` on the rank's own card alone (``distribution="gspmd"``):
   the one-card result;
2. after a warm-up on a 20 kb genome, ``assemble(distribution=
   "shard_map")`` on a 2×2 ``("data", "model")`` grid (the ring SUMMA over
   2 × 2, the x-drop and the contig chain stage over 2 grid rows) and on a
   ``(2, 1, 2)`` ``("pod", "data", "model")`` grid (rows on ``("pod",
   "data")``: the all-gather SUMMA, the other stages over the 2 pods).

R, S, the stats (but path, exchange, SUMMA and memory keys) and the
polished contigs of each grid run must equal the one-card result on every
rank.  Rank 0 prints one JSON line per grid: the run's wall time, each
stage's time, the exchange time (the host time inside the grid's
collectives, each bracketed by a device synchronise, so compute is not
counted in it), the collectives' bytes by op beside the stats'
``exchange_words_*``, ``exchange_rounds_*`` and ``tr_exchange_*``, the TR
path that ran (``tr_backend``), and every rank's
allocator peak (the one-card run's beside it).  The first line is the
cards' names and power limits.  Exits non-zero on any difference, and
without four cards (unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GRIDS = {"2x2": ((2, 2), ("data", "model")),
         "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# stats keys that name the path, count exchanges or memory, not the result
SKIP = ("backend", "tr_backend", "distribution", "overlap_distribution",
        "align_distribution", "cc_iterations", "summa_algorithm",
        "summa_stages", "summa_backend", "summa_fallback_reason",
        "spgemm_hbm_round_trips", "spgemm_hbm_round_trips_reference",
        "peak_hbm_bytes", "hbm_bytes_in_use", "hbm_source")


def timed_collectives(grid, device):
    """Wrap ``grid``'s collectives to add their host time, each bracketed
    by a device synchronise, to the returned dict (seconds by op)."""
    import torch

    spent = {"permute": 0.0, "all_reduce": 0.0, "all_gather": 0.0}

    def wrap(name, fn):
        def timed(*a, **kw):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            spent[name] += time.perf_counter() - t0
            return out
        return timed

    grid.ppermute = wrap("permute", grid.ppermute)
    grid._all_reduce = wrap("all_reduce", grid._all_reduce)
    grid.all_gather = wrap("all_gather", grid.all_gather)
    return spent


def same(a, b, label):
    """Raise unless two ``assemble`` results agree (R, S, stats but SKIP,
    exchange and ``PORT_ONLY`` keys, polished contigs)."""
    import numpy as np
    from repro_torch.core.spmat import ell_equal
    from repro_torch.obs.schema import PORT_ONLY

    if not (ell_equal(a.r_graph, b.r_graph) and ell_equal(a.s_graph,
                                                           b.s_graph)):
        raise AssertionError(f"{label}: R or S differs from one card's")
    # PORT_ONLY: the grid TR's exchange counts, which one card has not
    diff = [k for k in a.stats if k not in SKIP + PORT_ONLY
            and not k.startswith("exchange_") and a.stats[k] != b.stats.get(k)]
    if diff:
        raise AssertionError(f"{label}: stats differ from one card's: {diff}")
    x, y = a.polished_contigs, b.polished_contigs
    if len(x) != len(y) or not all(
            p.reads == q.reads and np.array_equal(p.codes, q.codes)
            for p, q in zip(x, y)):
        raise AssertionError(f"{label}: polished contigs differ")


def worker(rank, args, port):
    import torch
    import torch.distributed as dist

    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as CS
    from repro_torch.assembly import simulate as sim
    from repro_torch.assembly.pipeline import assemble
    from repro_torch.core.grid import ProcessGrid

    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 4) // WORLD))
        device = torch.device("cpu")
    dist.init_process_group(args.backend,
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        reads = CS.simulate(sim, args.genome_kb, args.seed)
        small = CS.simulate(sim, min(20, args.genome_kb), args.seed)
        cfg = CS.assembly_config(args.genome_kb, device=str(device))
        assemble(small.codes, small.lengths, cfg)
        t0 = time.perf_counter()
        one = assemble(reads.codes, reads.lengths, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        one_wall = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps({
                "one_card": True, "n_reads": int(reads.n_reads),
                "genome_bp": len(reads.genome), "m_capacity": cfg.m_capacity,
                "wall_s": one_wall, "stages_s": one.timings,
                "peak_hbm_bytes": one.stats["peak_hbm_bytes"]}), flush=True)
        for name, (shape, axes) in GRIDS.items():
            grid = ProcessGrid.of_shape(shape, axes)
            gcfg = dataclasses.replace(cfg, distribution="shard_map",
                                       mesh=grid)
            assemble(small.codes, small.lengths, gcfg)
            spent = timed_collectives(grid, device)
            grid.reset_collective_bytes()
            t0 = time.perf_counter()
            res = assemble(reads.codes, reads.lengths, gcfg)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            same(res, one, f"rank {rank}, grid {name}")
            peaks = [None] * WORLD
            dist.all_gather_object(peaks, res.stats["peak_hbm_bytes"])
            if rank == 0:
                st = res.stats
                print(json.dumps({
                    "grid": name, "shape": list(shape), "axes": list(axes),
                    "n_reads": int(reads.n_reads), "wall_s": wall,
                    "one_card_wall_s": one_wall,
                    "stages_s": res.timings,
                    "exchange_s": spent,
                    "collective_bytes": grid.reset_collective_bytes(),
                    "summa_algorithm": st["summa_algorithm"],
                    "tr_backend": st["tr_backend"],
                    **{k: v for k, v in st.items()
                       if k.startswith(("exchange_", "tr_exchange_"))},
                    "peak_hbm_bytes_by_rank": peaks,
                    "one_card_peak_hbm_bytes": one.stats["peak_hbm_bytes"],
                    "equal_to_one_card": True}), flush=True)
            del res
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-kb", type=float, default=400,
                    help="genome length in kb (rounded to a base)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < WORLD:
            sys.exit(f"grid_nccl.py needs {WORLD} CUDA cards; found {n}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(" | ".join(smi.splitlines()), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(worker, args=(args, port), nprocs=WORLD, join=True,
                       start_method="spawn")


if __name__ == "__main__":
    main()
