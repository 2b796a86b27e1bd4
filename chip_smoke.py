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
             after: every kernel must have run;
4. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's own inputs, exact equality; CUDA-event times of
             both and the least time the card could take (``bound_ms``);
5. parity  — ``assemble(backend="reference")`` (plain torch ops and the host
             contig walk) on the card: R, S, every stats key but the timing,
             memory and path labels, and the polished contigs must be equal.

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

KERNEL_NAMES = ("xdrop", "minplus", "pileup")
REPLACES = {
    "xdrop": "src/repro/kernels/xdrop/xdrop.py:105",
    "minplus": "src/repro/kernels/minplus/minplus.py:54",
    "pileup": "src/repro/kernels/pileup/pileup.py:106",
}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; f32 add/min
# instructions/s (67 TFLOP/s counts an FMA as two); int32 operations/s
# (64 INT32 lanes per SM per clock, half the f32 lanes)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12 / 2
I32_OPS_S = 67e12 / 4
# stats keys that name the path or measure time/memory, not the result
PATH_KEYS = ("backend", "tr_backend", "distribution", "cc_iterations",
             "peak_hbm_bytes", "hbm_bytes_in_use", "hbm_source")


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
        from repro_torch.assembly.pipeline import PipelineConfig, assemble
        from repro_torch.core import backend as B
        from repro_torch.core.semiring import MP, minplus_orient_semiring
        from repro_torch.core.spmat import ell_equal
        from repro_torch.kernels.build import BUILD_LOG, build_all
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
    for name in KERNEL_NAMES:
        for line in BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
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

    for op, keep in (("xdrop_extend", 2), ("consensus", 1)):
        B.register_op(op, "cuda", capture(op, B.dispatch(op, "cuda"), keep))

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
    for name in KERNEL_NAMES:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    check(st["backend"] == "cuda", f"backend {st['backend']!r}")
    check(st["tr_backend"] == "cuda", f"tr_backend {st['tr_backend']!r}")
    check(st["n_passed"] > 0, "no alignment passed")
    cres = res.consensus
    check(cres is not None and cres.n_contigs > 0, "no contigs")
    check(int(cres.codes.max()) <= 3, "polished bases outside 0..3")
    check(all(np.isfinite(st[k]) for k in ("identity_estimate", "qv_estimate",
                                            "consensus_depth_mean")),
          "non-finite quality estimate")

    # --- 4. kernels ---
    records = []

    def record(name, got, want, kernel_fn, plain_fn, bytes_, ops, ops_rate,
               plain_note=None):
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
        ms = time_ms(kernel_fn, 5)
        plain_ms = time_ms(plain_fn, 1)
        t_bytes = bytes_ / HBM_BYTES_S * 1e3
        t_ops = ops / ops_rate * 1e3
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        if plain_note:
            rec["plain_scope"] = plain_note
        records.append(rec)
        print(f"[kernels] {json.dumps(rec)}", flush=True)

    # xdrop: the first 4096-pair chunk of the main run, both directions
    calls = captured["xdrop_extend"]
    got, want, cells, bytes_ = [], [], 0, 0
    for a, kw in calls:
        got += K.xdrop_extend_batch(*a, **kw)
        out = K.xdrop_extend_batch_ref(*a, **kw, with_cells=True)
        want += out[:3]
        cells += int(out[3].sum(dtype=torch.int64))
        e = a[0].shape[0]
        bytes_ += a[0].numel() + a[4].numel() + 4 * 6 * e + 4 * 3 * e
    print(f"[kernels] xdrop: {calls[0][0][0].shape[0]} pairs x 2 directions, "
          f"{cells} band cells computed")
    # only the cells of the right parity inside both sequences exist: ~8
    # int32 operations each (two adds, a max of three, the x-drop test)
    record("xdrop", got, want,
           lambda: [K.xdrop_extend_batch(*a, **kw) for a, kw in calls],
           lambda: [K.xdrop_extend_batch_ref(*a, **kw) for a, kw in calls],
           bytes_, 8 * cells, I32_OPS_S)

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

    # pileup: the real consensus call
    (draft, pieces, start, plen), kw = captured["consensus"][0]
    mdep = kw["min_depth"]
    got = K.pileup_vote(draft, pieces, start, plen, min_depth=mdep)
    want = K.pileup_vote_ref(draft, pieces, start, plen, min_depth=mdep)
    c, l = draft.shape
    hi = torch.clamp(start + plen, max=l)
    lo = torch.clamp(start, min=0)
    votes = int(torch.clamp(hi - lo, min=0).sum())
    bytes_ = draft.numel() + pieces.numel() + 8 * start.numel() + 9 * c * l
    ops = 34 * votes + 12 * c * l  # 8-wide coherence window + vote epilogue
    print(f"[kernels] pileup: {c} contigs x {l} columns, {pieces.shape[1]} "
          f"pieces of {pieces.shape[2]}, {votes} (column, piece) votes")
    record("pileup", got, want,
           lambda: K.pileup_vote(draft, pieces, start, plen, min_depth=mdep),
           lambda: K.pileup_vote_ref(draft, pieces, start, plen, min_depth=mdep),
           bytes_, ops, I32_OPS_S)
    del captured, got, want

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

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
