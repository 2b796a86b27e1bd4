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
3b. shard_map — a 1-rank NCCL process group (in-process store), then,
             after a 20 kb warm-up of its own, ``assemble(distribution=
             "shard_map")`` on the same reads: the ring SUMMA, the
             distributed alignment and contig chain stage on a 1×1 grid.
             Its counts are read the same way: spgemm, xdrop, minplus and
             pileup must have run, and R, S, the stats (but path and
             exchange keys) and the polished contigs must equal phase 3's.
             Then ``dist_transitive_reduction_ring`` on phase 3's R must
             give the S of the local Algorithm 2 (min-plus spgemm launches);
4. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's own inputs, exact equality; CUDA-event times of
             both and the least time the card could take (``bound_ms``).
             xdrop is held on both paths' launches: a 4096-pair chunk of the
             gspmd run and the shard_map run's whole bucket (a variant).
             spgemm is held on three inputs: the shard_map run's overlap
             launch, the four stage panels rank (0, 0) of a 4×4 grid holds
             (non-zero offsets) and the distributed TR's first launch;
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

KERNEL_NAMES = ("xdrop", "minplus", "pileup", "spgemm")
# the kernels of each path: the single-device path does not run spgemm
GSPMD_KERNELS = ("xdrop", "minplus", "pileup")
REPLACES = {
    "xdrop": "src/repro/kernels/xdrop/xdrop.py:105",
    "minplus": "src/repro/kernels/minplus/minplus.py:54",
    "pileup": "src/repro/kernels/pileup/pileup.py:106",
    "spgemm": "src/repro/kernels/spgemm/spgemm.py:133",
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
        from repro_torch.assembly.counter import first_semiring
        from repro_torch.assembly.pipeline import PipelineConfig, assemble
        from repro_torch.core import backend as B
        from repro_torch.core import summa as SU
        from repro_torch.core.grid import ProcessGrid
        from repro_torch.core.semiring import MP, minplus_orient_semiring
        from repro_torch.core.spmat import ell_equal
        from repro_torch.core.transitive_reduction import transitive_reduction
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

    for op, keep in (("xdrop_extend", 2), ("consensus", 1),
                     ("spgemm_ring_stages", 1)):
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
    for name in GSPMD_KERNELS:
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
        # the gspmd run's x-drop chunk is kept; this run's launches (the
        # whole bucket, one per direction) are captured afresh
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
        for name in KERNEL_NAMES:
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
        cap_overlap = captured.pop("spgemm_ring_stages")[0]
        cap_xdrop_sm = captured.pop("xdrop_extend")
        check(len(cap_xdrop_sm) == sm_launches["xdrop"] == 2,
              f"shard_map x-drop: {len(cap_xdrop_sm)} calls captured, "
              f"{sm_launches['xdrop']} launches")

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
    finally:
        dist.destroy_process_group()

    # --- 4. kernels ---
    records = []

    def record(name, got, want, kernel_fn, plain_fn, bytes_, ops, ops_rate,
               plain_note=None, n_launches=None):
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

    def xdrop_case(calls):
        """Kernel and plain outputs of captured x-drop calls, the band
        cells that exist and the bytes the function must move."""
        got, want, cells, bytes_ = [], [], 0, 0
        for a, kw in calls:
            got += K.xdrop_extend_batch(*a, **kw)
            out = K.xdrop_extend_batch_ref(*a, **kw, with_cells=True)
            want += out[:3]
            cells += int(out[3].sum(dtype=torch.int64))
            e = a[0].shape[0]
            bytes_ += a[0].numel() + a[4].numel() + 4 * 6 * e + 4 * 3 * e
        print(f"[kernels] xdrop: {calls[0][0][0].shape[0]} pairs x "
              f"{len(calls)} directions, {cells} band cells computed")
        return got, want, cells, bytes_

    # xdrop: the first 4096-pair chunk of the main run, both directions;
    # only the cells of the right parity inside both sequences exist: ~8
    # int32 operations each (two adds, a max of three, the x-drop test)
    got, want, cells, bytes_ = xdrop_case(cap_xdrop)
    record("xdrop", got, want,
           lambda: [K.xdrop_extend_batch(*a, **kw) for a, kw in cap_xdrop],
           lambda: [K.xdrop_extend_batch_ref(*a, **kw) for a, kw in cap_xdrop],
           bytes_, 8 * cells, I32_OPS_S)
    # the shard_map run's two launches: the whole bucket, one per direction
    got, want, cells, bytes_ = xdrop_case(cap_xdrop_sm)
    record("xdrop", got, want,
           lambda: [K.xdrop_extend_batch(*a, **kw) for a, kw in cap_xdrop_sm],
           lambda: [K.xdrop_extend_batch_ref(*a, **kw) for a, kw in cap_xdrop_sm],
           bytes_, 8 * cells, I32_OPS_S, n_launches=sm_launches["xdrop"])
    sm_rec = records.pop()
    records[-1]["variants"] = [{
        "input": f"shard_map bucket, {cap_xdrop_sm[0][0][0].shape[0]} pairs "
                 "x 2 directions",
        **{k: sm_rec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by")}}]
    del cap_xdrop, cap_xdrop_sm, sm_rec

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

    # spgemm: the shard_map run's overlap launch, rank (0, 0)'s four stage
    # panels on a 4x4 grid, and the distributed TR's first launch
    def spgemm_case(label, args, kw):
        got = K.spgemm_ring_stages(*args, **kw)
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
        out = {
            "input": label, "stages": stages, "rows": n_a, "k_a": ka,
            "k_b": b_cols.shape[2], "candidates": int(n_cand),
            "b_rows_read": b_rows,
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
    records.append({
        "name": "spgemm", "route": "cuda",
        "source": "src/repro_torch/csrc/spgemm.cu",
        "replaces": REPLACES["spgemm"], "launches": sm_launches["spgemm"],
        "max_abs_err": 0,
        "ms": sp_main["ms"], "plain_ms": sp_main["plain_ms"],
        "bound_ms": sp_main["bound_ms"], "bound_by": sp_main["bound_by"],
        "library_ms": None, "variants": [sp_s4, sp_tr],
    })
    del captured, cap_overlap, cap_tr, args4

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
