#!/usr/bin/env python3
"""Hold the port's span tracer to a profile of the same assembly, on the card.

    python3 scripts/trace_steps.py --workload <cell> --seed <n> [--rounds 3]
                                   [--out build/trace_steps]

For one benchmark cell (``BENCHMARK.json``; the reads from ``--seed`` as the
benchmark makes them) it runs one untraced warm assembly, then ``--rounds``
pairs of untraced and traced assemblies in turns (the cost of tracing),
then one traced assembly under ``torch.profiler`` as ``portbench`` profiles
it, and prints one JSON line:

* ``untraced_s`` / ``traced_s``: each assembly's wall seconds, and the
  untraced runs' allocator peak (``peak_mem_gib``, as the benchmark reads
  it) beside the traced run's ``peak_hbm_bytes``;
* ``coverage``: for CountKmer, Alignment, TrReduction and Contigs, the share
  of the stage span's device interval that its step spans' device
  intervals cover;
* ``range_us``: the distance (range less span, microseconds) between a
  stage or step span's host interval and its ``record_function`` range in
  the profile, both on the profiler's clock (``ts`` +
  ``baseTimeNanoseconds``): the largest, and the least, median and largest
  at the start and at the end;
* ``own_peak_gib`` / ``peak_gib`` by stage, the largest own peak and which
  stage holds it, the profile's ``idle_gaps`` (``portbench/devtrace.py``);
* ``summary``: the tracer's summary of the profiled assembly by label.

``--device cpu --root <dir>`` rehearses the script on the CPU with the
benchmark files under ``<dir>`` (a tiny copy: ``portbench/tests/tiny.py``).
The tracer's Chrome trace goes under ``--out``; the profile's stays in
``build/trace_steps/`` (hundreds of MB).
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPPED = ("CountKmer", "Alignment", "TrReduction", "Contigs")


def _args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--out", default=str(ROOT / "build" / "trace_steps"))
    p.add_argument("--device", default="cuda",
                   help="cpu rehearses the script (with a tiny --root)")
    p.add_argument("--root", default=str(ROOT),
                   help="where BENCHMARK.json and portbench/ are read")
    return p.parse_args()


def _union(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def coverage(tracer):
    """Share of each stepped stage's device interval under its steps'."""
    out = {}
    for root in tracer.roots:
        if root.name not in STEPPED or root.device_s is None:
            continue
        steps = [(max(sp.device_t0, root.device_t0),
                  min(sp.device_t1, root.device_t1))
                 for sp in root.walk() if sp.attrs.get("kind") == "step"]
        out[root.name] = _union([(a, b) for a, b in steps if b > a]) / max(
            root.device_s, 1e-12)
    return out


def range_distance_us(tracer, doc):
    """Distances (us, range less span) between each stage or step span's
    interval and its profiler range, matched by label in order."""
    base = doc["baseTimeNanoseconds"]
    ranges = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = float(e["ts"]) * 1e3 + base
            ranges.setdefault(e["name"], []).append((a, a + float(e["dur"]) * 1e3))
    spans = {}
    for sp in tracer.spans():
        if sp.attrs.get("kind") in ("stage", "step"):
            spans.setdefault(sp.label, []).append(sp)
    starts, ends, missing = [], [], []
    for label, sps in spans.items():
        got = sorted(ranges.get(label, []))
        if len(got) != len(sps):
            missing.append(label)
            continue
        for sp, (a, b) in zip(sps, got):
            starts.append(((a - tracer.clock_ns(sp.t0)) * 1e-3, label))
            ends.append(((b - tracer.clock_ns(sp.t1)) * 1e-3, label))
    worst = max(starts + ends, key=lambda x: abs(x[0]))
    mid = sorted(x for x, _ in starts)[len(starts) // 2]
    return {"worst_us": worst, "start_us": [min(starts)[0], mid, max(starts)[0]],
            "end_us": [min(ends)[0], sorted(x for x, _ in ends)[len(ends) // 2],
                       max(ends)[0]], "missing": missing}


def main() -> int:
    args = _args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.devtrace import STAGES, WINDOW, reduce_trace
    from portbench.harness import load_cell
    from portbench.readgen import make_reads
    from repro_torch.assembly.pipeline import PipelineConfig, assemble
    from repro_torch.kernels.build import CSRC, build_all
    from repro_torch.obs import write_chrome_trace

    _, cell, config, traffic = load_cell(args.workload, Path(args.root))
    cuda = args.device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(0)
    mesh = None
    if config["distribution"] == "shard_map":
        import torch.distributed as dist

        from portbench.harness import free_port
        from repro_torch.core.grid import ProcessGrid

        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
        mesh = ProcessGrid(1, 1)
    reads = make_reads(config["genome_length"], traffic, args.seed, device=dev)
    if cuda:
        build_all(sorted(p.stem for p in CSRC.glob("*.cu")))
    cfg = PipelineConfig(**config["pipeline"], distribution=config["distribution"],
                         mesh=mesh, device=str(dev))
    tcfg = dataclasses.replace(cfg, trace=True)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if cuda else 0

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def one(c):
        t = time.perf_counter()
        res = assemble(reads.codes, reads.lengths, c)
        sync()
        return res, time.perf_counter() - t

    res, _ = one(cfg)
    del res
    walls = {"untraced_s": [], "traced_s": []}
    peaks = {"untraced": [], "traced": []}
    for _ in range(args.rounds):
        for c, key in ((cfg, "untraced"), (tcfg, "traced")):
            res, wall = one(c)
            walls[f"{key}_s"].append(wall)
            peaks[key].append(res.stats["peak_hbm_bytes"] if c.trace
                              else peak())
            del res
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            tres = assemble(reads.codes, reads.lengths, tcfg)
            sync()
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"{args.workload}.{args.seed}")
    os.makedirs(ROOT / "build" / "trace_steps", exist_ok=True)
    prof_path = str(ROOT / "build" / "trace_steps" / "profile.json")
    prof.export_chrome_trace(prof_path)
    with open(prof_path) as f:
        doc = json.load(f)
    tracer = tres.trace
    line = {"workload": args.workload, "seed": args.seed,
            "card": torch.cuda.get_device_name(dev) if cuda else "cpu", **walls,
            "peak_mem_gib": [p / 2**30 for p in peaks["untraced"]],
            "traced_peak_gib": [p / 2**30 for p in peaks["traced"]]}
    stage_peaks = {sp.name: int(sp.attrs["peak_hbm_bytes"]) for sp in tracer.roots
                   if "peak_hbm_bytes" in sp.attrs}
    summary = reduce_trace(prof_path, stage_peaks)
    line["peak_gib"] = {k: v / 2**30 for k, v in stage_peaks.items()}
    line["profiled_peak_gib"] = tres.stats["peak_hbm_bytes"] / 2**30
    line["idle_gaps"] = summary.idle_gaps
    if cuda:
        line["device_idle_pct"] = 100.0 * (1 - summary.busy_s / summary.window_s)
    rows = tracer.summary()
    own = {s: rows[s]["own_peak_hbm_bytes"] / 2**30 for s in STAGES if s in rows}
    line["own_peak_gib"] = own
    line["largest_own_peak"] = max(own.items(), key=lambda kv: kv[1])
    line["coverage"] = coverage(tracer)
    line["range_us"] = range_distance_us(tracer, doc)
    line["stage_device_s"] = {sp.name: sp.device_s for sp in tracer.roots}
    line["stage_host_s"] = {sp.name: sp.duration_s for sp in tracer.roots}
    line["summary"] = rows
    write_chrome_trace(tracer, stem + ".spans.json")
    if mesh is not None:
        import torch.distributed as dist

        from repro_torch.core.grid import release_grids

        dist.destroy_process_group()
        release_grids()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
