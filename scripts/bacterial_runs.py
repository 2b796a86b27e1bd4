#!/usr/bin/env python3
"""``assemble()`` on ``chip_smoke.py``'s reads and configuration (phase 3's
and 6b's, ``chip_smoke.assembly_config``) under variants, on one card:
other genome sizes, other row capacities of C and R, another tree's code.

    python3 scripts/bacterial_runs.py       # 4,641,652 bp, K_C/K_R 64/40
    python3 scripts/bacterial_runs.py --genome-kb 400 1000 2000
    python3 scripts/bacterial_runs.py --capacities 64,40 128,40 128,80
    python3 scripts/bacterial_runs.py --src build/parent/src --traced \\
        --distributions gspmd shard_map      # the parent's code, stage peaks

For each genome (reads from ``--seed``), capacity pair (``overlap_capacity``,
``r_capacity``; the rest of the configuration is ``assembly_config``'s) and
distribution (shard_map on a 1×1 grid over a 1-rank NCCL group), one JSON
line: wall seconds, stage seconds, the graph sizes and overflow counts,
branch cuts, the contigs (count, N50, longest, total length, reads a
contig), the S degree of the reads that are not contained, the genome
fraction (the union of the contigs' truth intervals), the allocator's peak
and, with ``--traced``, each stage's peak.  A run that runs out of device
memory prints its line with ``"out_of_memory": true``, the allocator's
peak before the failure and the failing frame, and the next run goes on.
The first line is the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_KEYS = ("m_reliable", "overflow_A", "nnz_C", "overflow_C", "n_aligned",
             "n_passed", "nnz_R", "overflow_R", "n_contained", "nnz_S",
             "tr_iterations", "tr_overflow", "tr_backend", "n_branch_cut",
             "contigs", "peak_hbm_bytes")


def run(reads, cfg, label):
    """One ``assemble()`` and its record (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.assembly.metrics import contig_truth_interval
    from repro_torch.assembly.pipeline import assemble

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = assemble(reads.codes, reads.lengths, cfg)
        torch.cuda.synchronize()
    except torch.OutOfMemoryError:
        return {**label, "out_of_memory": True,
                "seconds": time.perf_counter() - t0,
                "max_allocated": torch.cuda.max_memory_allocated(),
                "frame": traceback.format_exc(limit=-1).strip().splitlines()[-3:]}
    wall = time.perf_counter() - t0
    st = res.stats
    live = ~res.contained.cpu().numpy()
    deg = res.s_graph.row_nnz().cpu().numpy()
    chain = np.array([len(c.reads) for c in res.contigs])
    covered, end = 0, 0
    for lo, hi in sorted(contig_truth_interval(c, reads)[:2]
                         for c in res.contigs if c.reads):
        covered += max(0, hi - max(lo, end))
        end = max(end, hi)
    out = {**label, "wall_s": wall, "stages_s": res.timings,
           **{k: st.get(k) for k in STAT_KEYS},
           "s_degree_of_live_reads": {
               **{str(d): int(((deg == d) & live).sum()) for d in range(5)},
               ">=5": int(((deg >= 5) & live).sum())},
           "reads_a_contig": {
               "1": int((chain == 1).sum()),
               "2-9": int(((chain >= 2) & (chain < 10)).sum()),
               "10-99": int(((chain >= 10) & (chain < 100)).sum()),
               ">=100": int((chain >= 100).sum())},
           "genome_fraction": covered / len(reads.genome)}
    if res.trace is not None:
        out["stage_peaks"] = {sp.name: sp.attrs.get("peak_hbm_bytes")
                              for sp in res.trace.roots}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-kb", type=float, nargs="+", default=None,
                    help="genome lengths in kb (default: chip_smoke's "
                         "BACTERIAL_KB)")
    ap.add_argument("--capacities", nargs="+", default=["64,40"],
                    help="overlap_capacity,r_capacity pairs")
    ap.add_argument("--distributions", nargs="+", default=["gspmd"],
                    choices=["gspmd", "shard_map"])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree whose repro_torch runs")
    ap.add_argument("--traced", action="store_true",
                    help="trace the runs: each stage's allocator peak")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        sys.exit("bacterial_runs.py needs a CUDA card")
    import chip_smoke as CS
    import repro_torch
    from repro_torch.assembly import simulate as sim
    from repro_torch.assembly.pipeline import assemble

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(),
        flush=True)
    print(json.dumps({"package": os.path.dirname(repro_torch.__file__)}),
          flush=True)
    small = CS.simulate(sim, 20, args.seed)
    assemble(small.codes, small.lengths, CS.assembly_config(20))
    if "shard_map" in args.distributions:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        for kb in args.genome_kb or [CS.BACTERIAL_KB]:
            reads = CS.simulate(sim, kb, args.seed)
            for pair in args.capacities:
                kc, kr = (int(x) for x in pair.split(","))
                for d in args.distributions:
                    cfg = dataclasses.replace(
                        CS.assembly_config(kb), overlap_capacity=kc,
                        r_capacity=kr, distribution=d, trace=args.traced)
                    print(json.dumps(run(reads, cfg, {
                        "genome_bp": len(reads.genome),
                        "n_reads": int(reads.n_reads),
                        "overlap_capacity": kc, "r_capacity": kr,
                        "distribution": d})), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
