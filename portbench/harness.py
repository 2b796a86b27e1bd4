"""The benchmark of the port's assembler: one cell of ``BENCHMARK.json`` a
run.

A run (``python3 portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``):

1. makes the cell's reads from the seed (``readgen``, on the card), with
   the configuration's genome length and the traffic file's read model;
2. builds the configuration's ``PipelineConfig`` (and, for the 2D path, a
   process group of one rank a card and the square grid over them);
3. warms up with one ``assemble()`` on those reads; the time from process
   start to here is ``setup_s``;
4. runs whole ``assemble()`` calls back to back, each ending in a device
   synchronise, until the window's seconds have passed (the call running
   at the deadline finishes and counts): ``assembly_s`` is their mean wall
   time (on a grid, each call's slowest rank), ``peak_mem_gib`` the highest
   allocator peak of any of them (on a grid, of any rank);
5. with ``--trace 1``, profiles one more assembly with the program's stage
   spans (``devtrace``) and reports the per-layer metrics instead, read by
   the readers in ``portbench/metrics/`` (each claims its metric names);
6. checks, once the window has closed, that every assembly of the window
   gave the same outputs and that the last one agrees with the plain
   reference (``reference.judge``), and prints the checks and the one
   result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name in ``BENCHMARK.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# stats keys that read memory, not the result
VOLATILE = ("peak_hbm_bytes", "hbm_bytes_in_use", "hbm_source")


def log(*parts) -> None:
    """One line on standard error."""
    print(*parts, file=sys.stderr, flush=True)


def free_port() -> int:
    """A free TCP port on this machine, for a process group's rendezvous."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse_changes(pairs) -> dict:
    """``key=value`` words as a dict of numbers: changes of the program's
    configuration, for a control run."""
    out = {}
    for pair in pairs:
        key, val = pair.split("=", 1)
        out[key] = float(val) if "." in val else int(val)
    return out


def load_cell(name: str, root: Path = ROOT):
    """``(bench, cell, config, traffic)`` of the workload ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if not cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[0]
    here = root / HERE.name
    config = json.loads((here / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def readers() -> list:
    """The per-layer metric readers of ``portbench/metrics``."""
    out = []
    for p in sorted((HERE / "metrics").glob("*.py")):
        if p.stem != "__init__":
            out.append(importlib.import_module(f"portbench.metrics.{p.stem}"))
    return out


def reader_for(name: str, mods: list):
    """The one reader that claims ``name``."""
    claims = [m for m in mods if m.reads(name)]
    if len(claims) != 1:
        raise RuntimeError(f"metric {name}: {len(claims)} readers claim it")
    return claims[0]


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers read."""

    timings: List[Dict[str, float]]  # the window's stage seconds
    trace: Any = None  # devtrace.Summary of the profiled assembly
    work: Optional[dict] = None  # reference.work.stage_work
    collective_s: Optional[float] = None  # slowest rank's time in collectives


def digest(res) -> tuple:
    """A fingerprint of an assembly's outputs: graphs, contained flags,
    draft and polished contigs, and the stats that are not memory."""
    import torch

    parts = []
    for t in (res.r_graph.cols, *res.r_graph.vals.values(), res.s_graph.cols,
              *res.s_graph.vals.values(), res.contained, res.consensus.codes,
              res.consensus.lengths):
        x = t.reshape(-1)
        if x.is_floating_point():
            x = torch.where(torch.isinf(x), -1.0, x)
        x = x.to(torch.int64)
        w = torch.arange(x.numel(), device=x.device) % 1000003 + 1
        parts += [x.sum(), (x * w).sum()]
    h = hashlib.sha256()
    for c in res.contigs:
        h.update(repr(c.reads).encode())
        h.update(c.codes.tobytes())
    stats = tuple(sorted((k, repr(v)) for k, v in res.stats.items()
                         if k not in VOLATILE))
    return tuple(torch.stack(parts).tolist()), h.hexdigest(), stats


def program_output(res):
    """The judged outputs of an assembly as host arrays."""
    from portbench.reference.judge import ProgramOutput

    def states(c):
        return [2 * r + s for r, s in c.reads]

    (r_vals,) = res.r_graph.vals.values()
    (s_vals,) = res.s_graph.vals.values()
    return ProgramOutput(
        stats=dict(res.stats),
        r_cols=res.r_graph.cols.cpu().numpy(), r_vals=r_vals.cpu().numpy(),
        s_cols=res.s_graph.cols.cpu().numpy(), s_vals=s_vals.cpu().numpy(),
        contained=res.contained.cpu().numpy().astype(bool),
        draft=[(states(c), c.codes) for c in res.contigs],
        polished=[(states(c), c.codes) for c in res.polished_contigs])


class Comm:
    """The ranks of a run: agreement on the window and the gathers of its
    numbers.  One rank alone needs none of it."""

    def __init__(self, world: int, device):
        self.world = world
        self.device = device

    def _tensor(self, vals):
        import torch

        return torch.tensor(vals, dtype=torch.float64, device=self.device)

    def agree(self, go: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.world == 1:
            return go
        import torch.distributed as dist

        t = self._tensor([1.0 if go else 0.0])
        dist.broadcast(t, 0)
        return bool(t.item())

    def max_each(self, vals: List[float]) -> List[float]:
        """Element-wise maximum over the ranks."""
        if self.world == 1:
            return list(vals)
        import torch.distributed as dist

        t = self._tensor(vals)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


@contextlib.contextmanager
def timed_collectives(grid, device):
    """Add the host time of ``grid``'s collectives, each bracketed by a
    device synchronise (so compute before it is not counted), to the
    yielded one-element list while the block runs."""
    import torch

    spent = [0.0]
    names = ("ppermute", "_all_reduce", "all_gather", "psum_scatter")
    saved = {n: getattr(grid, n) for n in names}

    def wrap(fn):
        def timed(*a, **kw):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn(*a, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            spent[0] += time.perf_counter() - t
            return out
        return timed

    for n, fn in saved.items():
        setattr(grid, n, wrap(fn))
    try:
        yield spent
    finally:
        for n in names:
            delattr(grid, n)  # the class's methods again


def profile_assembly(assemble, reads, cfg, device):
    """One assembly under ``torch.profiler`` with the program's spans;
    returns ``(result, devtrace.Summary)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.devtrace import WINDOW, STAGES, reduce_trace

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            res = assemble(reads.codes, reads.lengths, cfg)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    peaks = {}
    for sp in res.trace.spans():
        if (sp.name in STAGES and sp.attrs.get("kind") == "stage"
                and "peak_hbm_bytes" in sp.attrs):
            peaks[sp.name] = int(sp.attrs["peak_hbm_bytes"])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = reduce_trace(path, peaks)
    finally:
        os.unlink(path)
    return res, summary


def run_rank(*args, **kwargs) -> Optional[dict]:
    """One rank of a run (see :func:`_run_rank`); leaves no process group
    behind."""
    try:
        return _run_rank(*args, **kwargs)
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            from repro_torch.core.grid import release_grids

            dist.destroy_process_group()
            release_grids()


def _run_rank(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", rank: int = 0,
             world: int = 1, port: Optional[int] = None, root: Path = ROOT,
             overrides: Optional[dict] = None,
             check_all: bool = False) -> Optional[dict]:
    """One rank of a run.  Rank 0 returns the result line (a dict); the
    other ranks return None.  ``overrides`` changes the program's
    configuration (a control run); the reference keeps the configuration
    as the file states it.  ``check_all`` has the reference align every
    candidate pair, not a sample (the whole check of ``reference.judge``).
    """
    import torch

    marks = [("imports", time.perf_counter())]
    bench, cell, config, traffic = load_cell(workload, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        torch.empty(1, device=dev)  # the card's context
    marks.append(("context", time.perf_counter()))

    from repro_torch.assembly.pipeline import PipelineConfig, assemble
    from repro_torch.kernels.build import CSRC, build_all

    from portbench.readgen import make_reads
    marks.append(("program import", time.perf_counter()))

    mesh = None
    if config["grid"] != "square":
        raise ValueError(f"grid {config['grid']!r}: the harness lays its ranks "
                         "out as the square grid over the cell's cards")
    if config["distribution"] == "shard_map" and config["process_group"]:
        import torch.distributed as dist

        from repro_torch.core.grid import ProcessGrid

        if world > 1 or dev.type == "cuda":
            dist.init_process_group(
                config["process_group"] if dev.type == "cuda" else "gloo",
                init_method=f"tcp://localhost:{port}", world_size=world,
                rank=rank)
            side = int(round(world ** 0.5))
            mesh = ProcessGrid(side, world // side)
    comm = Comm(world, dev)
    marks.append(("process group", time.perf_counter()))

    reads = make_reads(config["genome_length"], traffic, seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        # every kernel library at once (nvcc in parallel where the
        # checkout has not built them; a lookup where it has)
        marks.append(("reads", time.perf_counter()))
        build_all(sorted(p.stem for p in CSRC.glob("*.cu")))
        marks.append(("kernel libraries", time.perf_counter()))
    else:
        marks.append(("reads", time.perf_counter()))
    log(f"rank {rank}: {reads.n_reads} reads of width {reads.codes.shape[1]} "
        f"({reads.n_cut} cut)")
    cfg = PipelineConfig(**config["pipeline"], distribution=config["distribution"],
                         mesh=mesh, device=str(dev))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        log(f"rank {rank}: the program runs with {overrides} (a control)")

    def peak_now() -> int:
        return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)

    process_peak = peak_now()

    def one() -> tuple:
        t = time.perf_counter()
        res = assemble(reads.codes, reads.lengths, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t

    res, warm = one()
    process_peak = max(process_peak, peak_now())
    digests = [digest(res)]
    del res
    marks.append(("warm assembly", time.perf_counter()))
    setup_s = comm.max_each([time.perf_counter() - t_start])[0]
    prev, parts = t_start, []
    for what, t in marks:
        parts.append(f"{what} {t - prev:.3f}")
        prev = t
    log(f"rank {rank}: set-up s: {', '.join(parts)}")

    # the measured window
    walls, timings, peaks = [], [], []
    t_end = time.perf_counter() + seconds
    last = None
    while comm.agree(time.perf_counter() < t_end):
        last = None  # the previous result is not held through the call
        last, wall = one()
        walls.append(wall)
        timings.append(dict(last.timings))
        peaks.append(peak_now())
        digests.append(digest(last))
    process_peak = max([process_peak] + peaks)
    walls = comm.max_each(walls)
    peak = comm.max_each([float(max(peaks))])[0]
    memory_peak = int(comm.max_each([float(process_peak)])[0])
    if rank == 0:
        for w in walls:
            log(f"assembly {w:.4f} s")
    loaded = forbidden_modules()
    if loaded:
        log(f"rank {rank}: forbidden modules loaded: {', '.join(loaded)}")
        raise SystemExit(4)

    out = program_output(last)
    del last
    summary, collective_s = None, None
    if trace:
        tcfg = dataclasses.replace(cfg, trace=True)
        with contextlib.ExitStack() as stack:
            spent = (stack.enter_context(timed_collectives(mesh, dev))
                     if mesh is not None and world > 1 else None)
            tres, summary = profile_assembly(assemble, reads, tcfg, dev)
        if spent is not None:
            collective_s = comm.max_each([spent[0]])[0]
        digests.append(digest(tres))
        del tres
    summaries = comm.gather(summary)
    all_digests = comm.gather(digests)
    if rank != 0:
        return None

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from portbench.reference.judge import judge

    t0 = time.perf_counter()
    checks, work = judge(reads.codes, reads.lengths, out, config["pipeline"],
                         seed=seed, sample_reads=(
                             reads.n_reads if check_all
                             else config["check"]["sample_reads"]))
    log(f"reference and comparison {time.perf_counter() - t0:.3f} s")
    log("counts: " + ", ".join(
        f"{key} {out.stats.get(key)}" for key in (
            "n_aligned", "n_passed", "nnz_R", "overflow_R", "n_contained",
            "nnz_S", "n_branch_cut")) + f", contigs {len(out.draft)}")
    ref_ok = all(v <= lim for v, lim in checks.values())
    # every assembly of every rank (warm, window, traced) gave what the
    # judged one gave
    target = all_digests[0][len(walls)]
    checks["window_same"] = (sum(d != target for ds in all_digests
                                 for d in ds), 0)
    correct = ref_ok and checks["window_same"][0] == 0
    failed = 0 if correct else len(walls)

    record = RunRecord(timings=timings, trace=summary, work=work,
                       collective_s=collective_s)
    metrics = {}
    if trace:
        mods = readers()
        for m in cell_metrics(bench, workload, "per_layer"):
            rd = reader_for(m["name"], mods)
            val = rd.read(m["name"], record)
            if val is None:
                continue
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
            if hasattr(rd, "note"):
                log(f"{m['name']}: {rd.note(m['name'], record)}")
    else:
        e2e = {"assembly_s": sum(walls) / len(walls),
               "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    if dev.type == "cuda":
        device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                      "count": world, "memory_peak_bytes": memory_peak}
    else:
        device_rec = {"platform": "cpu", "kind": "cpu", "count": world,
                      "memory_peak_bytes": memory_peak}
    line = {"correct": bool(correct), "attempted": len(walls),
            "failed": int(failed), "metrics": metrics, "device": device_rec}
    if trace:
        live = [s for s in summaries if s is not None]
        device_rec["busy_s"] = sum(s.busy_s for s in live) / len(live)
        device_rec["window_s"] = sum(s.window_s for s in live) / len(live)
        line["breakdown"] = {
            "device_ops": [[k, v] for k, v in summary.device_ops],
            "idle_gaps": [[k, v] for k, v in summary.idle_gaps]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim)
                      in checks.items()}
    return line
