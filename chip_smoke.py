#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the full check, one card
    python3 chip_smoke.py --genome-kb 100   # a quicker, smaller run

Phases, each printing one line or block and failing the script (non-zero
exit, no result line) on any check that does not hold:

1. env     — the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build   — ``nvcc`` builds every kernel of the main path from
             ``src/repro_torch/csrc`` (one process per source, in parallel);
3. main    — after a warm-up on a 20 kb input, ``assemble()`` on the card
             at full size: a 400 kb genome at depth 14, CLR-like reads (mean
             1400, sd 250, 5 % error, 60 % indels; about 4000 reads, the
             largest run on which the dense min-plus kernel still runs).
             The launch counts are set to 0 just before and read just
             after: every kernel of the path (xdrop, minplus, pileup) must
             have run;
3a. traced — the same reads through ``assemble(trace=True)``: R, S, the
             stats and the polished contigs must equal phase 3's; the span
             roots must be the eight stages in order, each with the
             allocator's peak (``hbm_source == "device_stats"``), and the
             kernel-launch spans must name every kernel phase 3 launched.
             The Chrome trace goes to ``build/chip_smoke/trace.json``.  The
             report path follows: ``read_components`` →
             ``contig_components`` → ``write_contig_fasta`` →
             ``read_fasta_sharded`` on the polished contigs (a round trip),
             and ``assembly_identity`` of the draft and polished contigs;
3b. shard_map — a 1-rank NCCL process group (in-process store), then,
             after a 20 kb warm-up of its own, ``assemble(distribution=
             "shard_map")`` on the same reads: the ring SUMMA, the
             distributed alignment and contig chain stage on a 1×1 grid.
             Its counts are read the same way: spgemm, xdrop, minplus and
             pileup must have run, and R, S, the stats (but path and
             exchange keys) and the polished contigs must equal phase 3's.
             Then ``dist_transitive_reduction_ring`` on phase 3's R must
             give the S of the local Algorithm 2 (min-plus spgemm launches);
3c. pod grid — on the same NCCL group, a (1, 1, 1) ``("pod", "data",
             "model")`` grid: ``assemble(distribution="shard_map")`` on the
             same reads with the grid rows on ``("data",)`` (the ring: an
             spgemm launch counted) and on ``("pod", "data")`` (the
             recorded all-gather fallback: no spgemm launch), each read
             with its counts set to 0 just before: R, S, the stats (but
             path and exchange keys) and the polished contigs must equal
             phase 3's;
4. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's own inputs, exact equality; CUDA-event times of
             both and the least time the card could take (``bound_ms``).
             xdrop is held on both paths' launches: the gspmd run's first
             4096-pair chunk (both directions in one launch) and the
             shard_map run's one launch (its live pairs, both directions; a
             variant), with each launch's steps per pair, and on 300 pairs
             of that chunk at bands 300 and 1024 (the block instance).  The gspmd run
             must launch xdrop once per ``align_chunk`` block that holds a
             live pair, the shard_map run once, and the traced run must
             hold one ``kernel_launch`` span per launch.
             spgemm is held on five inputs: the shard_map run's overlap
             launch, the four stage panels rank (0, 0) of a 4×4 grid holds
             (non-zero offsets), the distributed TR's first launch, and,
             for both semirings, rows of 32768 live candidates (too full
             for shared memory: the global instance); each line gives the
             fullest row's live candidates, the shared memory a block gets
             for them, the blocks an SM holds at it, the rows the global
             instance took and the instances' registers and spills.
             pileup is held on the consensus call, its time split into the
             bin passes (two launches and a device cumsum) and the vote
             launch;
4b. cc     — ``connected_components(backend="cuda")`` on three inputs: the
             state graphs ``expand_states`` of phase 3's S (its launch
             counts, set to 0 just before, are the cc record's) and R, and
             a permuted chain of 2^17 vertices capped at ``max_iters=1003``
             (125 chunks and a 3-round tail, unconverged).  Each call must
             be one launch with one ``kernel_launch`` span; its labels,
             rounds and chunks must equal the chunk driver over the plain
             rounds on the same tensors, and its labels the ``reference``
             backend's; each line names the path the call took (one block,
             or the cooperative grid).  The cc record times a whole call on
             S's state graph;
5. parity  — ``assemble(backend="reference")`` (plain torch ops and the host
             contig walk) on the card: R, S, every stats key but the timing,
             memory and path labels, and the polished contigs must be equal;
6. dibella — the paper's H. sapiens cell (``launch/dibella_cell.py``, the
             overlap SpGEMM and the fused transitive reduction, torch ops,
             no hand kernel) on a 1×1 grid, inputs drawn from ``--seed`` on
             the card: at ``reduced()`` the overlap C and the TR's S must
             equal the local ``spgemm`` and ``transitive_reduction_fused``
             (both backends) exactly; at a cut size (``--dibella-cut``
             reads) ``row_chunk=None`` must equal ``row_chunk=4096``; then
             the cell at ``--dibella-reads`` reads (the full config's
             4,194,304 by default): per-stage ms, the allocator's peak and
             the record's roofline terms.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

KERNEL_NAMES = ("xdrop", "minplus", "pileup", "spgemm", "cc")
# the kernels of each path: the single-device path does not run spgemm,
# and only connected_components runs cc
GSPMD_KERNELS = ("xdrop", "minplus", "pileup")
SHARD_MAP_KERNELS = ("xdrop", "minplus", "pileup", "spgemm")
REPLACES = {
    "xdrop": "src/repro/kernels/xdrop/xdrop.py:105",
    "minplus": "src/repro/kernels/minplus/minplus.py:54",
    "pileup": "src/repro/kernels/pileup/pileup.py:106",
    "spgemm": "src/repro/kernels/spgemm/spgemm.py:133",
    "cc": "src/repro/kernels/cc/cc.py:66",
}
# the ``kernel`` attribute of each kernel's ``kernel_launch`` span: the
# name the JAX package's spans give the same kernel
SPAN_KERNEL = {"xdrop": "xdrop_extend", "minplus": "minplus_dense",
               "pileup": "pileup_vote", "spgemm": "spgemm_ring_stages",
               "cc": "cc_labels"}
STAGES = ["CountKmer", "CreateSpMat", "SpGEMM", "Alignment", "BuildR",
          "TrReduction", "Contigs", "Consensus"]
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; f32 add/min
# instructions/s (67 TFLOP/s counts an FMA as two); int32 operations/s
# (64 INT32 lanes per SM per clock, half the f32 lanes)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12 / 2
I32_OPS_S = 67e12 / 4
# stats keys that name the path or measure time/memory, not the result
PATH_KEYS = ("backend", "tr_backend", "distribution", "cc_iterations",
             "peak_hbm_bytes", "hbm_bytes_in_use", "hbm_source")
# keys the shard_map run adds or sets by its path: the distributions, the
# ring SUMMA's, and the exchange and round-trip counts
SHARD_MAP_KEYS = ("overlap_distribution", "align_distribution",
                  "summa_algorithm", "summa_stages", "summa_backend",
                  "spgemm_hbm_round_trips",
                  "spgemm_hbm_round_trips_reference")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-kb", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dibella-reads", type=int, default=None,
                    help="reads of phase 6's cell (default: the full config)")
    ap.add_argument("--dibella-cut", type=int, default=1 << 16,
                    help="reads of phase 6's row_chunk=None check")
    return ap.parse_args()


def simulate(simulate_mod, genome_kb: int, seed: int):
    rng = __import__("numpy").random.default_rng(seed)
    genome = simulate_mod.simulate_genome(rng, genome_kb * 1000)
    return simulate_mod.simulate_reads(
        genome, depth=14, mean_len=1400, std_len=250, error_rate=0.05,
        indel_frac=0.6, seed=seed + 1,
    )


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _entry(mangled: str) -> str:
    """``name<args>`` of a kernel's mangled entry name."""
    import re

    body = mangled[3:] if mangled.startswith("_ZN") else mangled
    name, i = mangled, 0
    while i < len(body) and body[i].isdigit():
        j = i
        while body[j].isdigit():
            j += 1
        k = int(body[i:j])
        name, i = body[j:j + k], j + k
    args = re.match(r"I((?:L[ib]\d+E)+)E", body[i:])
    if args:
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
    return name


def ptxas_summary(log: str):
    """``{kernel<args>: "registers, shared memory; spills"}`` of an ``nvcc
    -Xptxas -v`` log, one entry per kernel instance."""
    import re

    out, entry, spill = {}, "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = _entry(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out[entry] = f"{line.split(':', 1)[-1].strip()}; {spill}"
    return out


def main() -> None:
    args = parse_args()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    try:
        from repro_torch import kernels as K
        from repro_torch.assembly import simulate as sim
        from repro_torch.assembly.contigs import (
            contig_components,
            read_components,
        )
        from repro_torch.assembly.counter import first_semiring
        from repro_torch.assembly.io_fasta import (
            read_fasta_sharded,
            write_contig_fasta,
        )
        from repro_torch.assembly.metrics import assembly_identity
        from repro_torch.assembly.pipeline import PipelineConfig, assemble
        from repro_torch.core import backend as B
        from repro_torch.core import summa as SU
        from repro_torch.core.components import (
            connected_components,
            expand_states,
        )
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.core.grid import POD_AXES, ProcessGrid
        from repro_torch.core.spgemm import spgemm
        from repro_torch.core.semiring import overlap_semiring
        from repro_torch.core.semiring import MP, minplus_orient_semiring
        from repro_torch.core.spmat import EllMatrix, ell_equal
        from repro_torch.core.transitive_reduction import (
            transitive_reduction,
            transitive_reduction_fused,
        )
        from repro_torch.launch import dryrun as DR
        from repro_torch.kernels.build import BUILD_LOG, build_all
        from repro_torch.kernels.cc import ops as cc_ops
        from repro_torch.kernels.pileup import ops as pu_ops
        from repro_torch.kernels.spgemm import ops as sp_ops
        from repro_torch.obs import Tracer, tracing, write_chrome_trace
    except ImportError as e:
        fail(f"the repository's src/repro_torch is not beside this script: {e}")

    # --- 1. env ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 2. build ---
    t0 = time.perf_counter()
    paths = build_all(KERNEL_NAMES)
    print(f"[build] {len(paths)} kernels built in {time.perf_counter() - t0:.1f} s")
    ptxas = {name: ptxas_summary(BUILD_LOG.get(name, "")) for name in KERNEL_NAMES}
    for name in KERNEL_NAMES:
        for entry, line in ptxas[name].items():
            print(f"[build] {name}: {entry}: {line}")
    sys.stdout.flush()

    # --- 3. main ---
    reads = simulate(sim, args.genome_kb, args.seed)
    print(f"[main] genome {args.genome_kb} kb, {reads.n_reads} reads, depth "
          f"{reads.depth:.2f}, max read {reads.codes.shape[1]}", flush=True)
    cfg = PipelineConfig(
        m_capacity=1 << 20, upper=56, read_capacity=160, overlap_capacity=64,
        r_capacity=40, band=65, max_steps=4096, xdrop=30, align_chunk=4096,
        device="cuda",
    )
    captured = {}

    def capture(op, fn, keep):
        def wrapped(*a, **kw):
            if op not in captured or len(captured[op]) < keep:
                captured.setdefault(op, []).append((a, kw))
            return fn(*a, **kw)
        return wrapped

    # the registered cuda implementations of the ops captured below
    originals = {"xdrop_extend": K.xdrop_extend_batch,
                 "consensus": K.pileup_vote,
                 "spgemm_ring_stages": K.spgemm_ring_stages}
    for op, keep in (("xdrop_extend", 1), ("consensus", 1),
                     ("spgemm_ring_stages", 1)):
        B.register_op(op, "cuda", capture(op, originals[op], keep))

    # cold start (CUDA context, lazily loaded library kernels, allocator
    # growth) is paid on a small input first, so the stage times below are
    # the steady state; its launches are not counted
    small = simulate(sim, 20, args.seed)
    t0 = time.perf_counter()
    assemble(small.codes, small.lengths, cfg)
    torch.cuda.synchronize()
    print(f"[main] warm-up on {small.n_reads} reads: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    captured.clear()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = assemble(reads.codes, reads.lengths, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    st = res.stats
    print(f"[main] assemble {wall:.2f} s; stages (s): "
          + json.dumps({k: round(v, 4) for k, v in res.timings.items()}))
    print("[main] stats: " + json.dumps(st))
    print(f"[main] peak device memory {st['peak_hbm_bytes']} bytes "
          f"({st['hbm_source']}); launches {json.dumps(launches)}", flush=True)
    for name in GSPMD_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    # one x-drop launch (both directions) per align_chunk block of live pairs
    # one consensus call: the two bin passes and the vote launch
    check(launches["pileup"] == 3,
          f"{launches['pileup']} pileup launches for one consensus call")
    live_chunks = -(-max(st["n_aligned"], 1) // cfg.align_chunk)
    check(launches["xdrop"] == live_chunks,
          f"{launches['xdrop']} xdrop launches for {st['n_aligned']} live pairs "
          f"in {live_chunks} chunks of {cfg.align_chunk}")
    check(st["backend"] == "cuda", f"backend {st['backend']!r}")
    check(st["tr_backend"] == "cuda", f"tr_backend {st['tr_backend']!r}")
    check(st["n_passed"] > 0, "no alignment passed")
    cres = res.consensus
    check(cres is not None and cres.n_contigs > 0, "no contigs")
    check(int(cres.codes.max()) <= 3, "polished bases outside 0..3")
    check(all(np.isfinite(st[k]) for k in ("identity_estimate", "qv_estimate",
                                            "consensus_depth_mean")),
          "non-finite quality estimate")

    # --- 3a. traced ---
    K.reset_launch_counts()
    t0 = time.perf_counter()
    tres = assemble(reads.codes, reads.lengths,
                    dataclasses.replace(cfg, trace=True))
    torch.cuda.synchronize()
    wall_tr = time.perf_counter() - t0
    traced_launches = K.launch_counts()
    tracer = tres.trace
    print(f"[traced] assemble {wall_tr:.3f} s traced after {wall:.3f} s "
          f"untraced ({len(list(tracer.spans()))} spans); stages (s) traced / "
          "untraced: " + json.dumps({k: [round(tres.timings[k], 4),
                                         round(res.timings[k], 4)]
                                     for k in res.timings}), flush=True)
    check(ell_equal(res.r_graph, tres.r_graph), "R differs: traced vs untraced")
    check(ell_equal(res.s_graph, tres.s_graph), "S differs: traced vs untraced")
    check(list(tres.stats) == list(st), "stats keys differ: traced vs untraced")
    diff = [k for k in st if k not in ("peak_hbm_bytes", "hbm_bytes_in_use")
            and st[k] != tres.stats[k]]
    check(not diff, f"stats differ between traced and untraced: {diff}")
    a, b = res.polished_contigs, tres.polished_contigs
    check(len(a) == len(b) and all(
        x.reads == y.reads and np.array_equal(x.codes, y.codes)
        for x, y in zip(a, b)), "polished contigs differ: traced vs untraced")
    roots = [sp.name for sp in tracer.roots]
    check(roots == STAGES, f"trace roots {roots}")
    for sp in tracer.roots:
        check(sp.attrs.get("hbm_source") == "device_stats"
              and sp.attrs.get("peak_hbm_bytes", 0) > 0,
              f"stage span {sp.name} lacks the allocator's peak: {sp.attrs}")
        check(tres.timings[sp.name] == sp.duration_s,
              f"timing of {sp.name} is not its span's")
    # a kernel_launch span opens around each launch and nowhere else, so
    # its count per kernel is the traced run's launch count
    span_counts = {k: 0 for k in SPAN_KERNEL.values()}
    for sp in tracer.find("kernel_launch"):
        span_counts[sp.attrs["kernel"]] += 1
    traced_kernels = sorted(k for k, v in span_counts.items() if v)
    check(traced_launches == launches
          and all(span_counts[SPAN_KERNEL[k]] == v for k, v in launches.items()),
          f"kernel_launch spans {span_counts} / launches {traced_launches} vs "
          f"the untraced run's {launches}")
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke")
    os.makedirs(trace_dir, exist_ok=True)
    trace_path = write_chrome_trace(tracer, os.path.join(trace_dir,
                                                         "trace.json"))
    with open(trace_path) as f:
        doc = json.load(f)
    check([n["name"] for n in doc["spanTree"]] == STAGES,
          "the Chrome trace's span tree")
    # the overhead of tracing: untraced and traced runs in turns, all four
    # after the first run at this size (which pays the allocator's growth)
    walls = {"untraced": [], "traced": []}
    for trace in (False, True, False, True):
        t0 = time.perf_counter()
        assemble(reads.codes, reads.lengths,
                 dataclasses.replace(cfg, trace=trace))
        torch.cuda.synchronize()
        walls["traced" if trace else "untraced"].append(
            time.perf_counter() - t0)
    print(f"[traced] wall (s), in turns untraced, traced, untraced, traced: "
          f"untraced {walls['untraced']}, traced {walls['traced']}; the "
          f"traced run's peak {tres.stats['peak_hbm_bytes']} bytes (phase "
          f"3's results still live)", flush=True)
    print(f"[traced] == untraced: R, S, {len(st)} stats keys, {len(b)} "
          f"polished contigs; roots = the 8 stages, each with peak_hbm_bytes "
          f"(device_stats); kernel_launch spans {traced_kernels}; "
          f"Chrome trace {os.path.relpath(trace_path)} "
          f"({len(doc['traceEvents'])} events); stage peaks (bytes): "
          + json.dumps({sp.name: sp.attrs["peak_hbm_bytes"]
                        for sp in tracer.roots}), flush=True)

    # the report path: components, grouped FASTA, round trip, identity
    t0 = time.perf_counter()
    polished = tres.polished_contigs
    comps = contig_components(polished, read_components(tres.s_graph))
    nc = tres.consensus.n_contigs
    fasta = os.path.join(trace_dir, "contigs.fasta")
    n_rec = write_contig_fasta(
        fasta, polished, comps,
        identity=tres.consensus.identity[:nc].cpu().numpy(),
        depth=tres.consensus.depth_mean[:nc].cpu().numpy())
    names, fcodes, flens = read_fasta_sharded(fasta)
    order = [i for c in sorted(set(comps)) for i, x in enumerate(comps)
             if x == c]
    check(n_rec == len(polished) == len(names) and all(
        np.array_equal(fcodes[r][:flens[r]], polished[i].codes)
        for r, i in enumerate(order)), "FASTA round trip of the contigs")
    band = max(64, int(8 * 0.05 * 1400))
    draft_id, nb = assembly_identity(tres.contigs, reads, min_reads=2,
                                     band=band)
    pol_id, _ = assembly_identity(polished, reads, min_reads=2, band=band)
    check(0.5 < draft_id <= 1.0 and 0.5 < pol_id <= 1.0,
          f"identity vs truth: draft {draft_id}, polished {pol_id}")
    print(f"[report] {n_rec} FASTA records in {len(set(comps))} component "
          f"group(s), round trip exact; identity vs truth ({nb} bases): "
          f"draft {draft_id:.6f} -> polished {pol_id:.6f}; "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    del tres, tracer, doc

    # --- 3b. shard_map ---
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        sm_cfg = dataclasses.replace(cfg, distribution="shard_map")
        t0 = time.perf_counter()
        assemble(small.codes, small.lengths, sm_cfg)
        torch.cuda.synchronize()
        print(f"[shard_map] warm-up on {small.n_reads} reads: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        captured.pop("spgemm_ring_stages", None)
        # the gspmd run's x-drop chunk is kept; this run's launch (the live
        # pairs, both directions) is captured afresh
        cap_xdrop = captured.pop("xdrop_extend")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res_sm = assemble(reads.codes, reads.lengths, sm_cfg)
        torch.cuda.synchronize()
        wall_sm = time.perf_counter() - t0
        sm_launches = K.launch_counts()
        ss = res_sm.stats
        print(f"[shard_map] assemble {wall_sm:.2f} s on a "
              f"{ProcessGrid.square().pr}x{ProcessGrid.square().pc} grid; "
              "stages (s): "
              + json.dumps({k: round(v, 4) for k, v in res_sm.timings.items()}))
        print("[shard_map] stats: " + json.dumps(ss))
        print(f"[shard_map] peak device memory {ss['peak_hbm_bytes']} bytes; "
              f"launches {json.dumps(sm_launches)}", flush=True)
        for name in SHARD_MAP_KERNELS:
            check(sm_launches[name] > 0,
                  f"kernel {name} was not launched on the shard_map path")
        check(ss["summa_backend"] == "cuda", f"summa_backend {ss['summa_backend']!r}")
        for key in ("overlap_distribution", "align_distribution", "distribution"):
            check(ss[key] == "shard_map", f"{key} {ss[key]!r}")
        check(ell_equal(res.r_graph, res_sm.r_graph), "R differs: shard_map vs gspmd")
        check(ell_equal(res.s_graph, res_sm.s_graph), "S differs: shard_map vs gspmd")
        skip = set(PATH_KEYS) | set(SHARD_MAP_KEYS)
        diff = [k for k in st if k not in skip and not k.startswith("exchange_")
                and st[k] != ss.get(k)]
        check(not diff, f"stats differ between shard_map and gspmd: {diff}")
        a, b = res.polished_contigs, res_sm.polished_contigs
        check(len(a) == len(b) and all(
            x.reads == y.reads and np.array_equal(x.codes, y.codes)
            for x, y in zip(a, b)), "polished contigs differ: shard_map vs gspmd")
        print(f"[shard_map] == gspmd: R, S, "
              f"{len([k for k in st if k not in skip and not k.startswith('exchange_')])}"
              f" stats keys, {len(a)} polished contigs", flush=True)
        # the same run traced: one kernel_launch span per launch
        tr_sm = assemble(reads.codes, reads.lengths,
                         dataclasses.replace(sm_cfg, trace=True))
        sm_spans = {k: 0 for k in SPAN_KERNEL.values()}
        for sp in tr_sm.trace.find("kernel_launch"):
            sm_spans[sp.attrs["kernel"]] += 1
        check(ell_equal(res_sm.s_graph, tr_sm.s_graph)
              and all(sm_spans[SPAN_KERNEL[k]] == v
                      for k, v in sm_launches.items()),
              f"shard_map traced: kernel_launch spans {sm_spans} vs launches "
              f"{sm_launches}")
        print(f"[shard_map] traced: S equal, kernel_launch spans {sm_spans}",
              flush=True)
        del tr_sm
        cap_overlap = captured.pop("spgemm_ring_stages")[0]
        cap_xdrop_sm = captured.pop("xdrop_extend")
        check(len(cap_xdrop_sm) == sm_launches["xdrop"] == 1,
              f"shard_map x-drop: {len(cap_xdrop_sm)} calls captured, "
              f"{sm_launches['xdrop']} launches")
        check(cap_xdrop_sm[0][0][1].shape == (2, ss["n_aligned"]),
              f"shard_map x-drop walks {tuple(cap_xdrop_sm[0][0][1].shape)} for "
              f"{ss['n_aligned']} live pairs")

        # the distributed transitive reduction on phase 3's R, 1x1 grid
        grid = ProcessGrid.square()
        r_mat = res.r_graph
        rd, _ = SU.distribute_ell_blocks(
            r_mat, block_capacity=r_mat.capacity,
            semiring=minplus_orient_semiring, mesh=grid)
        nbc = min(r_mat.capacity ** 2, 4 * r_mat.capacity)
        before = K.KERNELS["spgemm"].launches
        t0 = time.perf_counter()
        s_d, tr_it, tr_nnz, tr_st = SU.dist_transitive_reduction_ring(
            rd, cfg.tr_fuzz, n_block_capacity=nbc, max_iters=cfg.tr_max_iters)
        torch.cuda.synchronize()
        tr_wall = time.perf_counter() - t0
        tr_launches = K.KERNELS["spgemm"].launches - before
        s_local, _ = transitive_reduction(r_mat, fuzz=cfg.tr_fuzz,
                                          n_capacity=nbc,
                                          max_iters=cfg.tr_max_iters)
        s_ring = SU.collect(s_d)
        check(tr_launches == tr_it, f"dist TR: {tr_launches} spgemm launches "
              f"for {tr_it} iterations")
        check(ell_equal(s_ring, s_local), "dist TR ring S differs from the local TR")
        print(f"[shard_map] dist_transitive_reduction_ring: {tr_wall:.3f} s, "
              f"{tr_it} iterations, nnz {tr_nnz}, {tr_launches} spgemm launches; "
              f"== local TR; == the pipeline's S: "
              f"{ell_equal(s_ring, res.s_graph)}", flush=True)
        cap_tr = captured.pop("spgemm_ring_stages")[0]

        # --- 3c. pod grid ---
        pod = ProcessGrid.of_shape((1, 1, 1), POD_AXES)
        skip = set(PATH_KEYS) | set(SHARD_MAP_KEYS) | {"summa_fallback_reason"}
        for row_axes in (("data",), ("pod", "data")):
            pcfg = dataclasses.replace(sm_cfg, mesh=pod, row_axes=row_axes)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            res_p = assemble(reads.codes, reads.lengths, pcfg)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t0
            pod_launches = K.launch_counts()
            sp_ = res_p.stats
            tag = f"[pod] rows on {row_axes}"
            ring = row_axes == ("data",)
            for name in GSPMD_KERNELS + (("spgemm",) if ring else ()):
                check(pod_launches[name] > 0,
                      f"{tag}: kernel {name} was not launched")
            if ring:
                check(sp_["summa_algorithm"] == "ring"
                      and sp_["summa_backend"] == "cuda",
                      f"{tag}: summa {sp_['summa_algorithm']}")
            else:
                check(sp_["summa_algorithm"] == "allgather_fallback"
                      and sp_["summa_fallback_reason"]
                      == "multi-axis grid rows ('pod', 'data')"
                      and pod_launches["spgemm"] == 0,
                      f"{tag}: summa {sp_['summa_algorithm']}, "
                      f"{pod_launches['spgemm']} spgemm launches")
            check(ell_equal(res.r_graph, res_p.r_graph), f"{tag}: R differs")
            check(ell_equal(res.s_graph, res_p.s_graph), f"{tag}: S differs")
            diff = [k for k in st if k not in skip
                    and not k.startswith("exchange_") and st[k] != sp_.get(k)]
            check(not diff, f"{tag}: stats differ from gspmd: {diff}")
            a, b = res.polished_contigs, res_p.polished_contigs
            check(len(a) == len(b) and all(
                x.reads == y.reads and np.array_equal(x.codes, y.codes)
                for x, y in zip(a, b)), f"{tag}: polished contigs differ")
            print(f"{tag}: assemble {wall_p:.2f} s, summa "
                  f"{sp_['summa_algorithm']}, launches "
                  f"{json.dumps(pod_launches)}; == gspmd: R, S, stats, "
                  f"{len(b)} polished contigs; stages (s): "
                  + json.dumps({k: round(v, 4)
                                for k, v in res_p.timings.items()}),
                  flush=True)
            del res_p
    finally:
        dist.destroy_process_group()

    # --- 4. kernels ---
    records = []

    def record(name, got, want, kernel_fn, plain_fn, bytes_, ops, ops_rate,
               plain_note=None, n_launches=None, reps=5):
        err = 0
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}")
            if not torch.equal(g, w):
                gf, wf = g.double(), w.double()
                both_inf = torch.isinf(gf) & torch.isinf(wf) & (gf == wf)
                diff = torch.where(both_inf, 0.0, (gf - wf).abs())
                err = max(err, float(diff.max()))
                fail(f"{name}: kernel differs from its plain version "
                     f"(max abs err {err})")
        ms = time_ms(kernel_fn, reps)
        plain_ms = time_ms(plain_fn, 1)
        t_bytes = bytes_ / HBM_BYTES_S * 1e3
        t_ops = ops / ops_rate * 1e3
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name] if n_launches is None else n_launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        if plain_note:
            rec["plain_scope"] = plain_note
        records.append(rec)
        print(f"[kernels] {json.dumps(rec)}", flush=True)

    def xdrop_case(label, call):
        """Kernel and plain outputs of a captured x-drop call ((D, E)
        walks), the band cells that exist, the bytes the function must move
        and the steps per pair, printed per direction."""
        a, kw = call
        got = K.xdrop_extend_batch(*a, **kw)
        *want, cells, steps = K.xdrop_extend_batch_ref(
            *a, **kw, with_cells=True, with_steps=True)
        walks = a[1].numel()  # pairs of the launch: directions x rows
        bytes_ = a[0].numel() + a[4].numel() + 4 * 6 * walks + 4 * 3 * walks
        stats = {"input": label, "pairs": walks,
                 "cells": int(cells.sum(dtype=torch.int64))}
        qs = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)
        for d, name in enumerate(("forward", "backward")[:steps.shape[0]]):
            x = steps[d].double().cpu()
            p50, p90, p99 = (float(v) for v in torch.quantile(x, qs))
            stats[f"steps_{name}"] = {"mean": float(x.mean()), "p50": p50,
                                      "p90": p90, "p99": p99,
                                      "max": int(x.max())}
        x = steps.double().cpu().reshape(-1)
        stats["steps_launch"] = {
            "mean": float(x.mean()), "p99": float(torch.quantile(x, 0.99)),
            "max": int(x.max())}
        print(f"[kernels] xdrop {json.dumps(stats)}", flush=True)
        return list(got), list(want), stats["cells"], bytes_, stats

    # xdrop: the first 4096-pair chunk of the main run, both directions in
    # one launch; only the cells of the right parity inside both sequences
    # exist: ~8 int32 operations each (two adds, a max of three, the x-drop
    # test)
    (cap_xdrop,) = cap_xdrop
    (cap_xdrop_sm,) = cap_xdrop_sm
    xa, xkw = cap_xdrop
    got, want, cells, bytes_, x_stats = xdrop_case(
        f"gspmd chunk 0, {xa[0].shape[0]} pairs x 2 directions", cap_xdrop)
    record("xdrop", got, want, lambda: K.xdrop_extend_batch(*xa, **xkw),
           lambda: K.xdrop_extend_batch_ref(*xa, **xkw),
           bytes_, 8 * cells, I32_OPS_S)
    rec_x = records[-1]
    rec_x["steps"] = x_stats

    # the same chunk as two single-direction launches (the launch count
    # before both directions shared one)
    def two_launches():
        for d in range(2):
            K.xdrop_extend_batch(xa[0], *(t[d] for t in xa[1:4]), xa[4],
                                 *(t[d] for t in xa[5:8]), **xkw)
    rec_x["ms_as_two_launches"] = time_ms(two_launches, 5)
    # the shard_map run's one launch: its live pairs, both directions (the
    # whole 65536-pair bucket before pad slots were skipped: another input)
    sa, skw = cap_xdrop_sm
    got, want, cells, bytes_, sm_stats = xdrop_case(
        f"shard_map launch, {sa[0].shape[0]} live pairs x 2 directions",
        cap_xdrop_sm)
    record("xdrop", got, want, lambda: K.xdrop_extend_batch(*sa, **skw),
           lambda: K.xdrop_extend_batch_ref(*sa, **skw),
           bytes_, 8 * cells, I32_OPS_S, n_launches=sm_launches["xdrop"])
    sm_rec = records.pop()
    rec_x["variants"] = [{
        "input": sm_stats["input"],
        **{k: sm_rec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by")},
        "steps": sm_stats}]
    # bands past the one-warp instance (the block instance) on the chunk's
    # first 300 pairs, both directions
    wa = (xa[0][:300].contiguous(), *(t[:, :300].contiguous() for t in xa[1:4]),
          xa[4][:300].contiguous(), *(t[:, :300].contiguous() for t in xa[5:8]))
    for wide in (300, 1024):
        wkw = {**xkw, "band": wide}
        before = K.KERNELS["xdrop"].launches
        got = K.xdrop_extend_batch(*wa, **wkw)
        check(K.KERNELS["xdrop"].launches == before + 1,
              f"xdrop band {wide}: not one launch")
        want = K.xdrop_extend_batch_ref(*wa, **wkw)
        for g, w in zip(got, want):
            check(torch.equal(g, w),
                  f"xdrop band {wide}: kernel differs from its plain version")
        rec_x["variants"].append({
            "input": f"gspmd chunk 0, first 300 pairs x 2 directions, band "
                     f"{wide} (block instance)",
            "max_abs_err": 0,
            "ms": time_ms(lambda: K.xdrop_extend_batch(*wa, **wkw), 3),
            "plain_ms": time_ms(lambda: K.xdrop_extend_batch_ref(*wa, **wkw),
                                1)})
        print(f"[kernels] xdrop {json.dumps(rec_x['variants'][-1])}",
              flush=True)
    del cap_xdrop, cap_xdrop_sm, sm_rec, xa, sa, wa

    # minplus: the first TR iteration's dense operand (R after BuildR)
    dense = res.r_graph.to_dense(minplus_orient_semiring)[MP].contiguous()
    n = dense.shape[0]
    full = K.minplus_matmul(dense, dense)
    rows = min(256, n)
    part = dense[:rows].contiguous()
    want = K.minplus_matmul_ref(part, dense)
    record("minplus", [full[:rows]], [want], lambda: K.minplus_matmul(dense, dense),
           lambda: K.minplus_matmul_ref(part, dense),
           16 * 3 * n * n, 16 * n * n * n, F32_OPS_S,
           plain_note=f"plain version on {rows} of {n} rows")
    del full, want

    # pileup: the real consensus call, in three launches: the bin passes
    # (count, device cumsum, fill) and the vote launch
    (draft, pieces, start, plen), kw = captured["consensus"][0]
    mdep = kw["min_depth"]
    got = K.pileup_vote(draft, pieces, start, plen, min_depth=mdep)
    want = K.pileup_vote_ref(draft, pieces, start, plen, min_depth=mdep)
    c, l = draft.shape
    m, lr = pieces.shape[1], pieces.shape[2]
    lo, hi = pu_ops.vote_ranges(start, plen, l, lr)
    votes = int(torch.clamp(hi - lo, min=0).sum())
    entries = int(pu_ops.tile_entries(start, plen, l, lr).sum())
    tiles = c * -(-l // pu_ops.TILE)
    # bytes: the draft, the piece bytes on vote columns, start and plen, the
    # three outputs; operations: ~12 int32 a (column, piece) vote (its
    # compare, the ballot and popcount of its window, the closed-form
    # count of comparable positions, the gate and the count) and ~12 a
    # column (the vote epilogue)
    bytes_ = c * l + votes + 8 * start.numel() + 9 * c * l
    ops = 12 * votes + 12 * c * l
    print(f"[kernels] pileup: {c} contigs x {l} columns, {m} pieces of {lr}, "
          f"{votes} (column, piece) votes; {tiles} tiles of "
          f"{pu_ops.TILE} columns, {entries} list entries "
          f"({entries / max(tiles, 1):.2f} pieces a tile)")
    record("pileup", got, want,
           lambda: K.pileup_vote(draft, pieces, start, plen, min_depth=mdep),
           lambda: K.pileup_vote_ref(draft, pieces, start, plen, min_depth=mdep),
           bytes_, ops, I32_OPS_S, reps=50)
    ends, slots = pu_ops.tile_lists(start, plen, l, lr)
    records[-1].update({
        "bins_ms": time_ms(lambda: pu_ops.tile_lists(start, plen, l, lr), 50),
        "vote_ms": time_ms(lambda: pu_ops.vote_tiles(
            draft, pieces, start, plen, ends, slots, min_depth=mdep), 50),
        "tiles": tiles, "list_entries": entries, "votes": votes,
        "ptxas": ptxas["pileup"]})
    print(f"[kernels] pileup split: bins {records[-1]['bins_ms']:.6f} ms, "
          f"vote {records[-1]['vote_ms']:.6f} ms", flush=True)
    del ends, slots

    # spgemm: the shard_map run's overlap launch, rank (0, 0)'s four stage
    # panels on a 4x4 grid, and the distributed TR's first launch
    def spgemm_case(label, args, kw):
        tr = Tracer(memory=False)
        with tracing(tr):
            got = K.spgemm_ring_stages(*args, **kw)
        (launch,) = tr.find("kernel_launch")
        want = K.spgemm_ring_stages_ref(*args, **kw)
        for key in want[1]:
            check(torch.equal(got[1][key], want[1][key]),
                  f"spgemm ({label}): {key} differs from the plain version")
        check(torch.equal(got[0], want[0]) and int(got[2]) == int(want[2]),
              f"spgemm ({label}): cols or overflow differ from the plain version")
        offsets, a_cols, a_vals, b_cols, b_vals = args
        stages, n_a, ka = a_cols.shape
        nb = b_cols.shape[1]
        # candidates that exist: a live A slot in range times the live B
        # slots of the row it selects; a sort of V keys needs V log2 V
        # comparisons at the least
        reb = a_cols.long() - offsets.long()[:, None, None]
        live_a = (a_cols >= 0) & (reb >= 0) & (reb < nb)
        b_live = (b_cols >= 0).sum(-1)  # (S, nb)
        sidx = torch.arange(stages, device=a_cols.device)[:, None, None]
        per = torch.where(live_a, b_live[sidx, reb.clamp(0, nb - 1)], 0)
        v = per.sum(-1).double()  # (S, n) candidates per row
        lg = torch.ceil(torch.log2(v.clamp(min=1)))
        cmp_ops = float((v * lg).sum())
        n_cand = float(v.sum())
        if kw["semiring"].name == "minplus_orient":
            # (x): 8 adds + 4 mins, (+): 4 mins a candidate
            t_ops = 16 * n_cand / F32_OPS_S + (cmp_ops + n_cand) / I32_OPS_S
        else:  # (+): a count add and the pair selection
            t_ops = (cmp_ops + 2 * n_cand) / I32_OPS_S
        # bytes: the A panels and the outputs in full, and of B only the
        # distinct rows a live A slot selects (most B rows are never read)
        tensors = [offsets, a_cols, *a_vals.values(), got[0], *got[1].values(),
                   got[2]]
        b_row = sum(t[0, 0].numel() * t.element_size()
                    for t in (b_cols, *b_vals.values()))
        b_rows = sum(int(torch.unique(reb[s][live_a[s]]).numel())
                     for s in range(stages))
        t_bytes = (sum(t.numel() * t.element_size() for t in tensors)
                   + b_rows * b_row) / HBM_BYTES_S
        sr = kw["semiring"]
        inst = f"<{sp_ops.SEMIRINGS[sr.name]}>"
        v_max = launch.attrs["max_candidates"]
        fit = sp_ops.fit_candidates(sp_ops.SEMIRINGS[sr.name], ka,
                                    b_cols.shape[2])
        # the rows routed to the global instance: those past `fit` (v counts
        # the candidates before the min-plus zero products, so it bounds
        # the min-plus routing from above)
        n_global = launch.attrs["global_rows"]
        routed = int(sp_ops.global_rows(v, fit).sum())
        check(n_global == routed if sr.name == "overlap_pospair"
              else n_global <= routed,
              f"spgemm ({label}): {n_global} rows took the global instance, "
              f"{routed} hold more than {fit} candidates")
        out = {
            "input": label, "stages": stages, "rows": n_a, "k_a": ka,
            "k_b": b_cols.shape[2], "candidates": int(n_cand),
            "b_rows_read": b_rows,
            # the block's sizing: the fullest row's live candidates (after
            # the min-plus zero products), its shared memory, and the blocks
            # an SM holds at it; the instances' registers and spills
            "max_candidates_per_row": v_max,
            "max_candidates_before_mul": int(v.max()),
            "shared_bytes_per_block": launch.attrs["shared_bytes"],
            "blocks_per_sm": sp_ops.blocks_per_sm(
                sr, v_max if not n_global else fit, ka, b_cols.shape[2]),
            # rows too full for shared memory: the global instance's rows,
            # blocks and scratch
            "global_rows": n_global,
            "global_blocks": launch.attrs["global_blocks"],
            "global_bytes": launch.attrs["global_bytes"],
            "ptxas": {k: ptxas["spgemm"].get(f"{k}{inst}") for k in (
                "spgemm_count_kernel", "spgemm_stages_kernel",
                "spgemm_stages_global_kernel")},
            "max_abs_err": 0,  # exact: any difference failed above
            "ms": time_ms(lambda: K.spgemm_ring_stages(*args, **kw), 5),
            "plain_ms": time_ms(lambda: K.spgemm_ring_stages_ref(*args, **kw), 1),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(f"[kernels] spgemm {json.dumps(out)}", flush=True)
        return out

    ov_args, ov_kw = cap_overlap
    sp_main = spgemm_case("shard_map overlap launch, 1x1 grid", ov_args, ov_kw)
    # rank (0, 0) of a 4x4 grid: stage s holds A block (0, s) and B block
    # (s, 0) of the Cannon-skewed block layouts of A and At
    _, a_cols, a_vals, b_cols, b_vals = ov_args
    a_full = SU.EllMatrix(cols=a_cols[0], vals={k: v[0] for k, v in a_vals.items()},
                          n_cols=cfg.m_capacity)
    b_full = SU.EllMatrix(cols=b_cols[0], vals={k: v[0] for k, v in b_vals.items()},
                          n_cols=ov_kw["n_cols_out"])
    q = 4
    a_g, _ = SU.block_layout(a_full, pc=q, block_capacity=a_full.capacity,
                             semiring=first_semiring)
    b_g, _ = SU.block_layout(b_full, pc=q, block_capacity=b_full.capacity,
                             semiring=first_semiring)
    a_sk, b_sk = SU._skew_a(a_g, q, q), SU._skew_b(b_g, q, q)
    a_p = [SU.local_block(a_sk, q, q, 0, t) for t in range(q)]
    b_p = [SU.local_block(b_sk, q, q, t, 0) for t in range(q)]
    nb4 = b_g.cols.shape[0] // q
    args4 = (torch.arange(q, dtype=torch.int32, device=a_cols.device) * nb4,
             torch.stack([p.cols for p in a_p]),
             {k: torch.stack([p.vals[k] for p in a_p]) for k in a_vals},
             torch.stack([p.cols for p in b_p]),
             {k: torch.stack([p.vals[k] for p in b_p]) for k in b_vals})
    del a_g, b_g, a_sk, b_sk, a_p, b_p
    sp_s4 = spgemm_case("rank (0, 0) of a 4x4 grid, S = 4", args4, ov_kw)
    sp_tr = spgemm_case("dist TR first launch, min-plus orient", *cap_tr)
    # rows of 32768 live candidates (K_A x K_B = 512 x 64, every slot live),
    # too full for a block's shared memory: the global instance, both
    # semirings, two stages, an empty row between full ones
    g = torch.Generator().manual_seed(args.seed)
    stages_f, n_f, nb_f, ka_f, kb_f = 2, 6, 128, 512, 64
    offs_f = torch.arange(stages_f, dtype=torch.int32) * nb_f
    a_cols_f = (torch.randint(0, nb_f, (stages_f, n_f, ka_f), generator=g,
                              dtype=torch.int32) + offs_f[:, None, None])
    a_cols_f[:, 2] = -1
    b_cols_f = torch.randint(0, 4000, (stages_f, nb_f, kb_f), generator=g,
                             dtype=torch.int32)
    sp_full = []
    for sr, shape in ((ov_kw["semiring"], ()), (minplus_orient_semiring, (4,))):
        vals = [torch.randint(1, 900, c.shape + shape, generator=g,
                              dtype=torch.int32) for c in (a_cols_f, b_cols_f)]
        if shape:  # finite min-plus operands: no product is zero
            vals = [{MP: v.float().cuda()} for v in vals]
        else:
            vals = [{"pos": v.cuda()} for v in vals]
        args_f = (offs_f.cuda(), a_cols_f.cuda(), vals[0], b_cols_f.cuda(),
                  vals[1])
        kw_f = dict(semiring=sr, capacity=64, n_cols_out=4000)
        sp_full.append(spgemm_case(
            f"rows of {ka_f * kb_f} live candidates, {kw_f['semiring'].name}",
            args_f, kw_f))
        check(sp_full[-1]["global_rows"] == stages_f * (n_f - 1)
              and sp_full[-1]["max_candidates_per_row"] == ka_f * kb_f,
              f"spgemm global instance: {sp_full[-1]['global_rows']} rows")
    del args_f, vals, a_cols_f, b_cols_f
    records.append({
        "name": "spgemm", "route": "cuda",
        "source": "src/repro_torch/csrc/spgemm.cu",
        "replaces": REPLACES["spgemm"], "launches": sm_launches["spgemm"],
        "max_abs_err": 0,
        "ms": sp_main["ms"], "plain_ms": sp_main["plain_ms"],
        "bound_ms": sp_main["bound_ms"], "bound_by": sp_main["bound_by"],
        "library_ms": None, "variants": [sp_s4, sp_tr, *sp_full],
    })
    del captured, cap_overlap, cap_tr, args4
    for op, fn in originals.items():
        B.register_op(op, "cuda", fn)

    # --- 4b. cc ---
    def cc_plain(cols, max_iters):
        """The chunk driver over the plain rounds: (labels, rounds, chunks)."""
        n = cols.shape[0]
        rounds, n_chunks, rem = cc_ops.chunk_rule(n if max_iters is None
                                                  else max_iters)
        return cc_ops._drive_chunks(
            cols, cc_ops.transpose_ell(cols),
            torch.arange(n, dtype=torch.int32, device=cols.device),
            rounds=rounds, n_chunks=n_chunks, rem=rem,
            rounds_fn=K.cc_rounds_ref)

    def cc_case(label, cols, max_iters=None):
        """One connected_components call on the card: one launch, its
        labels, rounds and chunks equal to the chunk driver over the plain
        rounds, its labels to the reference backend's."""
        n = cols.shape[0]
        adj = EllMatrix(cols=cols, vals={}, n_cols=n)
        tr = Tracer(memory=False)
        before = K.launch_counts()["cc"]
        t0 = time.perf_counter()
        with tracing(tr):
            lab, it = connected_components(adj, max_iters=max_iters,
                                           backend="cuda")
        torch.cuda.synchronize()
        wall_cc = time.perf_counter() - t0
        n_launch = K.launch_counts()["cc"] - before
        spans = list(tr.find("kernel_launch"))
        check(n_launch == 1 and len(spans) == 1,
              f"cc ({label}): {n_launch} launches, {len(spans)} launch spans "
              f"in one call")
        sp = spans[0].attrs
        p_lab, p_it, p_chunks = cc_plain(cols, max_iters)
        r_lab, r_it = connected_components(adj, max_iters=max_iters,
                                           backend="reference")
        check(torch.equal(lab, p_lab) and it == p_it == sp["rounds"]
              and sp["chunks"] == p_chunks,
              f"cc ({label}): kernel differs from the plain driver (rounds "
              f"{it} vs {p_it}, chunks {sp['chunks']} vs {p_chunks})")
        check(torch.equal(lab, r_lab),
              f"cc ({label}): labels differ from the reference backend")
        out = {"input": label, "n": n, "k_out": cols.shape[1],
               "edges": sp["edges"], "path": sp["path"],
               "max_iters": n if max_iters is None else max_iters,
               "rounds": it, "chunks": sp["chunks"],
               "reference_rounds": r_it, "launches": n_launch,
               "components": int(torch.unique(lab).numel()),
               "wall_s": wall_cc}
        print(f"[cc] {json.dumps(out)}", flush=True)
        return out

    s_states = expand_states(res.s_graph).cols.contiguous()
    K.reset_launch_counts()
    cc_s = cc_case("expand_states(S)", s_states)
    cc_launches = K.launch_counts()
    check(cc_launches["cc"] == 1, "kernel cc was not launched once on its path")
    cc_r = cc_case("expand_states(R)",
                   expand_states(res.r_graph).cols.contiguous())
    perm = np.random.default_rng(args.seed).permutation(1 << 17)
    chain = np.full((1 << 17, 1), -1, np.int32)
    chain[perm[:-1], 0] = perm[1:]
    cc_chain = cc_case("permuted chain of 2^17 vertices",
                       torch.from_numpy(chain).cuda(), max_iters=1003)
    check(cc_chain["rounds"] == 1003 and cc_chain["chunks"] == 126
          and cc_chain["components"] > 1 and cc_chain["path"] == "grid",
          f"capped chain: {cc_chain}")
    # the one-chunk entry (cc_rounds) on S's state graph, against the plain
    # rounds (not counted: the counts above are the record's)
    n_s = s_states.shape[0]
    ic_s = cc_ops.transpose_ell(s_states)
    lab0 = torch.arange(n_s, dtype=torch.int32, device=s_states.device)
    got = K.cc_rounds(s_states, ic_s, lab0, cc_ops.ROUNDS_PER_CALL)
    want = K.cc_rounds_ref(s_states, ic_s, lab0, cc_ops.ROUNDS_PER_CALL)
    check(torch.equal(got[0], want[0]) and int(got[1]) == int(want[1]),
          "cc: the one-chunk entry differs from the plain rounds")
    # the record: one whole call on S's state graph.  Bytes: the ELL read
    # once, the labels written once; operations, per round executed: a min
    # per live edge in each hook, and per vertex the jump, the compare and
    # the three label writes
    rounds_s, edges_s = cc_s["rounds"], cc_s["edges"]
    cc_bytes = 4 * (s_states.numel() + n_s)
    cc_ops_n = rounds_s * (edges_s + 4 * n_s)
    t_bytes = cc_bytes / HBM_BYTES_S * 1e3
    t_ops = cc_ops_n / I32_OPS_S * 1e3
    adj_s = EllMatrix(cols=s_states, vals={}, n_cols=n_s)
    records.append({
        "name": "cc", "route": "cuda", "source": "src/repro_torch/csrc/cc.cu",
        "replaces": REPLACES["cc"], "launches": cc_launches["cc"],
        "max_abs_err": 0,  # exact: any difference failed above
        "ms": time_ms(lambda: connected_components(adj_s, backend="cuda"), 20),
        "plain_ms": time_ms(lambda: cc_plain(s_states, None), 1),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "unit": "one connected_components call",
        "floor_barriers": 3 * rounds_s,
        "shapes": {"n": n_s, "k_out": s_states.shape[1], "edges": edges_s,
                   "rounds": rounds_s, "chunks": cc_s["chunks"],
                   "path": cc_s["path"]},
        "variants": [cc_s, cc_r, cc_chain],
    })
    print(f"[kernels] {json.dumps(records[-1])}", flush=True)
    del s_states, ic_s, chain

    # --- 5. parity ---
    t0 = time.perf_counter()
    ref = assemble(reads.codes, reads.lengths,
                   dataclasses.replace(cfg, backend="reference"))
    print(f"[parity] reference backend {time.perf_counter() - t0:.2f} s on "
          f"{reads.n_reads} reads; stages (s): "
          + json.dumps({k: round(v, 4) for k, v in ref.timings.items()}))
    check(ell_equal(res.r_graph, ref.r_graph), "R differs between backends")
    check(ell_equal(res.s_graph, ref.s_graph), "S differs between backends")
    diff = [k for k in res.stats
            if k not in PATH_KEYS and res.stats[k] != ref.stats.get(k)]
    check(not diff, f"stats differ between backends: {diff}")
    a, b = res.polished_contigs, ref.polished_contigs
    check(len(a) == len(b) and all(
        x.reads == y.reads and np.array_equal(x.codes, y.codes)
        for x, y in zip(a, b)), "polished contigs differ between backends")
    print(f"[parity] cuda == reference: R, S, {len(res.stats) - len(PATH_KEYS)} "
          f"stats keys, {len(a)} polished contigs", flush=True)

    # --- 6. dibella cell ---
    grid1 = ProcessGrid.square()  # no process group: the 1x1 grid
    rcfg = reduced_config("dibella")
    red = DR.run_cell(rcfg, grid1, seed=args.seed, device="cuda")
    a_cols, a_vals, at_cols, at_vals = red["inputs"]["overlap"]
    c_loc, ovf_loc = spgemm(
        EllMatrix(cols=a_cols, vals=a_vals, n_cols=rcfg.m_kmers),
        EllMatrix(cols=at_cols, vals=at_vals, n_cols=rcfg.n_reads),
        semiring=overlap_semiring, capacity=rcfg.overlap_block_capacity)
    cc, cv, c_ovf = red["outputs"]["overlap"]
    check(torch.equal(cc, c_loc.cols) and int(c_ovf) == int(ovf_loc)
          and all(torch.equal(cv[k], c_loc.vals[k]) for k in cv),
          "dibella reduced: the overlap C differs from the local spgemm")
    r_cols, r_vals = red["inputs"]["tr"]
    sc, sv, s_it, s_nnz = red["outputs"]["tr"]
    for backend in ("reference", "cuda"):
        s_loc, s_st = transitive_reduction_fused(
            EllMatrix(cols=r_cols, vals={MP: r_vals}, n_cols=rcfg.n_reads),
            fuzz=rcfg.tr_fuzz, backend=backend)
        check(torch.equal(sc, s_loc.cols) and torch.equal(sv, s_loc.vals[MP])
              and s_it == s_st.iterations,
              f"dibella reduced: the TR's S differs from the local "
              f"transitive_reduction_fused ({backend}, {s_st.backend})")
    print(f"[dibella] reduced ({rcfg.n_reads} reads): C == local spgemm "
          f"(overflow {int(c_ovf)}), S == local transitive_reduction_fused "
          f"on both backends ({s_it} iterations, nnz {s_nnz} of "
          f"{int((r_cols >= 0).sum())})", flush=True)
    del red

    cfg_full = get_config("dibella")
    cut = dataclasses.replace(cfg_full, n_reads=args.dibella_cut,
                              m_kmers=4 * args.dibella_cut)
    runs = {}
    for rc in (4096, None):
        out = DR.run_cell(cut, grid1, row_chunk=rc, seed=args.seed,
                          device="cuda")
        runs[rc] = out
        torch.cuda.synchronize()
    for stage in ("overlap", "tr"):
        x, y = runs[4096]["outputs"][stage], runs[None]["outputs"][stage]
        check(torch.equal(x[0], y[0]) and all(
            torch.equal(u, v) for u, v in zip(
                x[1].values() if isinstance(x[1], dict) else [x[1]],
                y[1].values() if isinstance(y[1], dict) else [y[1]]))
            and [int(v) for v in x[2:]] == [int(v) for v in y[2:]],
            f"dibella at {cut.n_reads} reads: {stage} differs between "
            "row_chunk=4096 and row_chunk=None")
    print(f"[dibella] {cut.n_reads} reads: row_chunk=4096 == row_chunk=None; "
          "ms (4096 / None): " + json.dumps({
              s: [runs[rc]["record"]["stages"][s]["ms"] for rc in (4096, None)]
              for s in ("overlap", "tr")}), flush=True)
    del runs, out

    n_full = args.dibella_reads or cfg_full.n_reads
    cell = (cfg_full if n_full == cfg_full.n_reads else dataclasses.replace(
        cfg_full, n_reads=n_full, m_kmers=4 * n_full))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full = DR.run_cell(cell, grid1, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    rec = full["record"]
    for stage in ("overlap", "tr"):
        o = full["outputs"][stage]
        check(o[0].shape[0] == cell.n_reads and bool(
            ((o[0] >= -1) & (o[0] < cell.n_reads)).all()),
            f"dibella {stage}: output columns out of range")
    sv = full["outputs"]["tr"][1]
    check(bool((torch.isfinite(sv) | torch.isinf(sv)).all()),
          "dibella tr: NaN in S")
    check(0 < rec["stages"]["tr"]["nnz"] < int((full["inputs"]["tr"][0] >= 0)
                                               .sum()),
          "dibella tr: nothing pruned")
    print(f"[dibella] {cell.n_reads} reads, {cell.m_kmers} k-mers on a 1x1 "
          f"grid in {time.perf_counter() - t0:.2f} s (inputs "
          f"{rec['input_seconds']:.2f} s): " + json.dumps({
              s: {k: v for k, v in st_.items()} for s, st_ in
              rec["stages"].items()}), flush=True)
    print(f"[dibella] allocator peak {torch.cuda.max_memory_allocated()} "
          f"bytes; roofline {json.dumps(rec['roofline'])}; fraction "
          f"{rec['roofline_fraction']}", flush=True)
    del full

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
