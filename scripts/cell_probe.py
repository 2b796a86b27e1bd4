#!/usr/bin/env python3
"""One traced ``assemble()`` of a benchmark cell's reads and configuration
on one card, with the sizes that decide whether the cell fits: each
stage's allocator peaks, the largest rows of C and R before their
capacities cut them, and the shapes of the Contigs and Consensus layouts.

    python3 scripts/cell_probe.py --workload celegans-gspmd.pb-d40-l11241 \\
        --seeds 1 2 3 [--set overlap_capacity=512 r_capacity=256] \\
        [--src build/parent/src] [--untraced]

For each seed, one JSON line: the reads (count, width, ``n_cut``), wall
and stage seconds, the stats that size the cell (overflow counts,
``m_reliable``, ``nnz_*``, ``n_contained``), ``c_row_max`` and
``r_row_max`` (the fullest row of C out of SpGEMM and of R out of
``build_overlap_graph``, before contained reads are dropped), the contig layout
(contigs, longest contig, longest chain, the bytes of the contig tensor
and of Consensus's pieces, the live bases and pieces against the slots
held) and, traced, every stage's own and running peak.  A run that fails
(out of device memory, or a capacity too small) prints its line with
``"error"``, the stage it was in, the allocator's peak and the failing
frame, and the next seed goes on.  ``--set`` changes the program's
configuration (as ``portbench/run.py``'s), ``--src`` runs another tree's
``repro_torch``.  The first line is the card's name and power limit.
Needs a card.
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
STAT_KEYS = ("m_reliable", "overflow_A", "nnz_A", "nnz_C", "overflow_C",
             "n_aligned", "n_passed", "nnz_R", "overflow_R", "n_contained",
             "tr_iterations", "tr_overflow", "tr_backend", "nnz_S",
             "n_branch_cut", "contigs", "consensus_changed",
             "n_junction_shifted", "peak_hbm_bytes")


def _hooks(pipeline, contig_gen, seen):
    """Wrap the pipeline's calls so that ``seen`` records what sizes the
    cell, even where a later stage fails."""
    import torch

    def wrap(mod, name, after):
        fn = getattr(mod, name)

        def hooked(*a, **kw):
            out = fn(*a, **kw)
            after(out, *a)
            return out
        setattr(mod, name, hooked)

    def rows(cols):
        return int(torch.amax(torch.sum(cols >= 0, dim=1))) if cols.numel() else 0

    def stage(key, kind=None, **kw):
        if kind == "stage":
            seen["stage"] = key
        return span(key, kind=kind, **kw)

    span = pipeline.span
    pipeline.span = stage
    wrap(pipeline, "spgemm",
         lambda out, *a: seen.update(c_row_max=rows(out[0].cols)))
    wrap(pipeline, "build_overlap_graph",
         lambda out, *a: seen.update(r_row_max=rows(out[0].cols)))

    def layout(lay, st, lengths, contained, **kw):
        seen.update(n_contigs=int(lay["n_contigs"]),
                    max_len=int(lay["max_len"]),
                    longest_chain=int(st["max_chain"]),
                    n_chains=int(st["n_chains"]))
    wrap(contig_gen, "_chain_layout",
         lambda out, *a, **kw: layout(out, *a, **kw))

    def polish_in(cset, codes, lengths, **kw):
        # either layout: padded (the slots past the live ones are empty) or
        # packed (every slot live)
        slots = cset.states.numel()
        seen.update(
            contig_tensor_bytes=cset.codes.numel(),
            live_bases=int(torch.sum(cset.lengths[:cset.n_contigs])),
            piece_slots=slots, live_pieces=int(torch.sum(cset.states >= 0)),
            piece_bytes=slots * codes.shape[1])
    fn = pipeline.polish_contig_set

    def polish(cset, codes, lengths, **kw):
        polish_in(cset, codes, lengths, **kw)
        return fn(cset, codes, lengths, **kw)
    pipeline.polish_contig_set = polish


def run(reads, cfg, label):
    """One ``assemble()`` and its record (see the module docstring)."""
    import torch

    from repro_torch.assembly import contig_gen, pipeline

    seen: dict = {}
    saved = {n: getattr(pipeline, n) for n in (
        "span", "spgemm", "build_overlap_graph", "polish_contig_set")}
    saved_layout = contig_gen._chain_layout
    _hooks(pipeline, contig_gen, seen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = pipeline.assemble(reads.codes, reads.lengths, cfg)
        torch.cuda.synchronize()
    except (torch.OutOfMemoryError, ValueError) as err:
        return {**label, **seen, "error": type(err).__name__,
                "seconds": time.perf_counter() - t0,
                "max_allocated": torch.cuda.max_memory_allocated(),
                "frame": traceback.format_exc(limit=-1).strip().splitlines()[-3:]}
    finally:
        for n, fn in saved.items():
            setattr(pipeline, n, fn)
        contig_gen._chain_layout = saved_layout
    out = {**label, **seen, "wall_s": time.perf_counter() - t0,
           "stages_s": res.timings,
           **{k: res.stats.get(k) for k in STAT_KEYS}}
    if res.trace is not None:
        out["own_peak_gib"] = {
            sp.name: sp.attrs.get("own_peak_hbm_bytes", 0) / 2**30
            for sp in res.trace.roots}
        out["peak_gib"] = {sp.name: sp.attrs.get("peak_hbm_bytes", 0) / 2**30
                           for sp in res.trace.roots}
        summary = res.trace.summary()
        out["steps"] = {k: {"device_s": v.get("device_s"),
                            "own_peak_gib": (v.get("own_peak_hbm_bytes") or 0)
                            / 2**30}
                        for k, v in summary.items() if "." in k
                        and k.split(".")[0] in ("Contigs", "Consensus")}
        out["step_attrs"] = {
            sp.name: {k: v for k, v in sp.attrs.items()
                      if isinstance(v, (int, float, str))
                      and "bytes" not in k}
            for sp in res.trace.spans()
            if sp.name.split(".")[0] in ("Contigs", "Consensus")
            and sp.attrs.get("kind") == "step"}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree whose repro_torch runs")
    ap.add_argument("--untraced", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import torch

    if not torch.cuda.is_available():
        sys.exit("cell_probe.py needs a CUDA card")
    import repro_torch
    from portbench import harness
    from portbench.readgen import make_reads
    from repro_torch.assembly.pipeline import PipelineConfig, assemble

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(),
        flush=True)
    print(json.dumps({"package": os.path.dirname(repro_torch.__file__)}),
          flush=True)
    _, cell, config, traffic = harness.load_cell(args.workload)
    cfg = PipelineConfig(**config["pipeline"],
                         distribution=config["distribution"], device="cuda",
                         trace=not args.untraced)
    cfg = dataclasses.replace(cfg, **harness.parse_changes(args.set))
    warm = make_reads(200_000, traffic, 0, device="cuda")
    assemble(warm.codes, warm.lengths, dataclasses.replace(cfg, trace=False))
    del warm
    for seed in args.seeds:
        reads = make_reads(config["genome_length"], traffic, seed,
                           device="cuda")
        print(json.dumps(run(reads, cfg, {
            "workload": args.workload, "seed": seed,
            "genome_bp": int(config["genome_length"]),
            "n_reads": reads.n_reads, "width": int(reads.codes.shape[1]),
            "n_cut": reads.n_cut, "changes": args.set})), flush=True)
        del reads


if __name__ == "__main__":
    main()
