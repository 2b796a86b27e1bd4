#!/usr/bin/env python3
"""Time the port's ``pileup_vote`` (the consensus op's kernels) per call,
on one NVIDIA card, for one source tree or several in turns.

    python3 scripts/pileup_calls.py                   # this checkout
    python3 scripts/pileup_calls.py --trees OLD .     # OLD, ., ., OLD

The inputs are ``chip_smoke.py``'s consensus call: its 4000 reads and
configuration through ``assemble()`` on the card (this checkout), the
captured arguments of the packed layout (``draft, lengths, pieces,
contig, start, plen`` and ``l``) saved under ``build/pileup_calls/``; a
tree must take them (the packed op).  Each tree then runs in a process of its own, with
``TREE/src`` first on the path (its kernels build into ``TREE/build/``),
and prints one JSON line: the CUDA-event time of one whole ``pileup_vote``
call (every launch in it) over ``--reps`` calls, its launches, whether its
outputs equal the plain version's, the device time per call of each kernel
it launches (``torch.profiler``), and the time of the call's two parts,
the tile lists and the vote launch.  The trees run in
the order given, then in reverse, after one line with the card's name and
power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, "build", "pileup_calls", "consensus.pt")


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


def device_us(fn, reps):
    """Device time per call of each kernel ``fn`` launches (``torch.
    profiler``'s CUDA activity, microseconds), by kernel name; empty where
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            out[ev.key[:80]] = t / reps
    return out


def capture(genome_kb, seed):
    """Run ``chip_smoke.py``'s configuration once and save its consensus
    call's inputs to ``INPUTS``."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels as K
    from repro_torch.assembly import simulate as sim
    from repro_torch.assembly.pipeline import PipelineConfig, assemble
    from repro_torch.core import backend as B

    rng = np.random.default_rng(seed)
    reads = sim.simulate_reads(
        sim.simulate_genome(rng, genome_kb * 1000), depth=14, mean_len=1400,
        std_len=250, error_rate=0.05, indel_frac=0.6, seed=seed + 1)
    cfg = PipelineConfig(
        m_capacity=1 << 20, upper=56, read_capacity=160, overlap_capacity=64,
        r_capacity=40, band=65, max_steps=4096, xdrop=30, align_chunk=4096,
        device="cuda")
    calls = []

    def keep(*a, **kw):
        calls.append((a, kw))
        return K.pileup_vote(*a, **kw)

    B.register_op("consensus", "cuda", keep)
    assemble(reads.codes, reads.lengths, cfg)
    (args, kw), = calls
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save({"args": [t.cpu() for t in args], "kw": kw,
                "reads": reads.n_reads}, INPUTS)


def measure(tree, reps):
    """The measurements of one tree, in this process."""
    import torch

    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch import kernels as K
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.pileup import ops as pu_ops

    build_all(["pileup"])
    saved = torch.load(INPUTS)
    args = [t.cuda() for t in saved["args"]]
    kw = saved["kw"]
    before = K.KERNELS["pileup"].launches
    got = K.pileup_vote(*args, **kw)
    launches = K.KERNELS["pileup"].launches - before
    want = K.pileup_vote_ref(*args, **kw)
    draft, lengths, pieces, contig, start, plen = args
    out = {"tree": tree, "reads": saved["reads"],
           "shape": {"contigs": lengths.numel(), "columns": draft.numel(),
                     "longest": kw["l"], "pieces": pieces.shape[0],
                     "piece_len": pieces.shape[1]},
           "launches_per_call": launches,
           "exact": all(torch.equal(g, w) for g, w in zip(got, want)),
           "ms_per_call": time_ms(lambda: K.pileup_vote(*args, **kw), reps)}
    out["device_us_per_call"] = device_us(
        lambda: K.pileup_vote(*args, **kw), 20) or "not measured"
    tile_first, tile_contig = pu_ops.tile_layout(lengths, draft.numel())

    def bins():
        return pu_ops.tile_lists(lengths, contig, start, plen, tile_first,
                                 tile_contig.numel(), pieces.shape[1])

    ends, slots = bins()
    out["bins_ms"] = time_ms(bins, reps)
    out["vote_ms"] = time_ms(lambda: pu_ops.vote_tiles(
        draft, lengths, pieces, start, plen, tile_first, tile_contig, ends,
        slots, **kw), reps)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[ROOT],
                    help="source trees (directories holding src/)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--genome-kb", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    if args.one:
        print(json.dumps(measure(args.one, args.reps)), flush=True)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    capture(args.genome_kb, args.seed)
    order = args.trees if len(args.trees) == 1 else args.trees + args.trees[::-1]
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--reps", str(args.reps)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            sys.exit(proc.returncode)
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
