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
             (``assembly_config``, one configuration for every assembly
             run): a 400 kb genome at depth 14, CLR-like reads (mean 1400,
             sd 250, 5 % error, 60 % indels; about 4000 reads, chosen as
             the largest run on which the TR's dense min-plus kernel still
             runs: n <= TR_DENSE_MAX_ROWS = 4096; phase 6b is the size users
             assemble).
             The launch counts are set to 0 just before and read just
             after: every kernel of the path (xdrop, minplus, pileup,
             kmer_pack) must have run, kmer_pack exactly once;
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
             launch.  spgemm_masked (the TR's sampled square above
             TR_DENSE_MAX_ROWS) is held on phase 3's R, against its plain
             version and the torch ``spgemm_masked``.  kmer_pack
             (CountKmer's extraction) is held on the benchmark's one-card
             cell's reads (``portbench``'s generator from ``--seed``:
             14,863 reads x 13,216 columns, k 15), its time beside its
             byte bound (the codes read once, 13 bytes written an
             instance) and the plain version's time there, and on phase
             3's reads (a variant);
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
             the record's roofline terms;
6b. bacterial — ``assemble()`` at the size of the smallest genomes users
             assemble from long reads: 4,641,652 bp (E. coli K-12 MG1655's
             length; the sequence random from ``--seed``), phase 3's read
             model, 46,417 reads, ``assembly_config`` (``m_capacity`` 1 <<
             23), nothing cut.  Phases 1-6 return first: under 1 GB may be
             allocated when it starts.  ``assemble()`` traced, gspmd, its
             counts set to 0 just before and read just after: xdrop once per
             ``align_chunk`` block of live pairs, pileup 3, kmer_pack 1,
             minplus 0 and
             spgemm_masked once a TR iteration (n > TR_DENSE_MAX_ROWS:
             ``tr_backend == "cuda_masked"``, the sampled square); then
             shard_map on a 1×1 grid over a 1-rank NCCL group (as 3b's):
             spgemm 1 (on ~416 M candidates), xdrop 1, pileup 3, kmer_pack 1,
             spgemm_masked once a TR iteration, and R, S, the stats (but
             path and exchange keys) and the polished contigs equal to the
             gspmd run's.  Each prints its
             stage times, its stage peaks, the overflow counts and the graph
             sizes.  Then, on this run's own captured inputs, exact against
             the plain versions, with CUDA-event times beside phase 4's:
             xdrop on the first and the last 4096-pair chunk (the plain
             version takes ~3.5 s a chunk, so not the whole bucket), the
             shard_map overlap launch of spgemm (the plain version in blocks
             of 4096 rows: each row is its own), one whole pileup call, the
             TR's first and last sampled squares (spgemm_masked, also held
             to the torch square).
             Against the truth, on the host: contig count, N50, longest, the
             genome fraction (the union of the contigs' truth intervals),
             and the draft's and polished contigs' identity on the genome's
             first 500 kb (polished >= draft); the phase's seconds;
7. serve   — the language-model serving path (``repro_torch.models``,
             ``launch/serve.py``: torch ops, no hand kernel; the JAX LM path
             reaches no Pallas kernel either, and the launch counts, set to
             0 before, must stay 0).  7a: qwen3-4b at full size (36 layers,
             d_model 2560, 4.411 B parameters), ``serve`` at batch 8, prompt
             512, 64 generated tokens after a warm-up (as ``python -m
             repro_torch.launch.serve --arch qwen3-4b --batch 8
             --prompt-len 512 --gen 64``): prefill ms beside its bf16 FLOP
             bound at 989 TFLOP/s, decode ms a step and tokens/s beside the
             byte bound a step (weights read once, the whole KV cache), the
             allocator's peak, the first tokens.  7b: prefill(S) + decode(1)
             logits against the last logits of forward(S + 1), S = 1040
             (past gemma3's and hymba's 1024 window), batch 8: qwen3-4b at
             full depth, the other nine at full width with 2 layers (6 for
             gemma3): finite, rtol = atol = 0.15, argmax equal on every row
             whose top-2 margin exceeds 0.3 (MoE: the rows whose last token
             both runs route alike; the capacity depends on a call's
             tokens).  7c: every arch's ``reduced()`` in f32, the same
             parameters made on the CPU and moved: prefill and 4
             teacher-forced decode steps on the card and the CPU, max |diff|
             ≤ 1e-3 and equal greedy tokens; then in bf16 within 0.15 (MoE:
             the card takes the CPU's top-k, and every place its own differs
             must be a near tie);
8. train   — the language-model training path (``models/model.py``
             ``make_train_step``, ``optim/``, ``data/``, ``checkpoint/``,
             ``launch/train.py``: torch ops and two autograd rules, no hand
             kernel; JAX's training path reaches no Pallas kernel either, and
             the launch counts, set to 0 before, must stay 0).  Phases 1-7
             return first and their tensors are freed: under 1 GB may be
             allocated when it starts.  8a: qwen3-4b at full width and depth
             (4.411 B parameters) trained on one row of ``train_4k`` (1 ×
             4096 tokens; cut to 1 × 2048, and said so, only if 4096 does
             not fit), bf16 compute on f32 master parameters and moments,
             ``AdamW(cosine_schedule(3e-3, 1, 5))``, ``SyntheticLMData
             (seed=0)``: the memory plan before, then a warm-up step and 4
             timed steps; loss and grad norm finite at every step, the first
             loss within 1.5 of ln(151,936), every parameter changed by the
             first step with lr > 0; step ms (median), tokens/s, the bound
             (6·N·T and the causal attention products at 989 TFLOP/s, plus
             the optimizer's 28 B a parameter at 3.35 TB/s) and the
             allocator's peak beside the plan.  8b: qwen3-4b at full width
             with 2 layers in f32 (TF32 off), 1 × 256 tokens, 2 steps from
             one state on the card and on the CPU: loss within rtol 1e-5,
             grad norm 1e-4, μ and ν each leaf within 1e-4 of its max |x|,
             the parameters each leaf within 1e-3 in relative L2 (Adam's
             normalised update: see PARAM_TOL).  8c: every arch's ``reduced()`` in f32, 3 steps,
             the same bounds; then ``launch.train.main`` on the card (bf16):
             8 steps straight against 5 steps, a checkpoint and ``--resume``
             to 8, final loss within rtol 1e-4.  8d: the SSM archs at full
             width and depth, mamba2-1.3b (48 layers, d_model 2048, state
             128) and hymba-1.5b (32 layers, d_model 1600, 25/5 heads,
             window 1024, 3 global layers), each trained as 8a on 1 × 4096
             tokens from seed 0: a warm-up step on batch 0 (lr 0), then two
             timed steps on batch 1; losses and grad norms finite, the first
             loss within 0.5 of ln(vocab), the second timed step's loss
             below the first's (the step learned its batch); step ms
             (median), tokens/s, the allocator's peak beside ``train_plan``
             and the losses and grad norms in hex (``scripts/
             train_trees.py`` holds them bit for bit against another tree);
9. mesh    — the language models' mesh paths (``mesh=`` a 1×1
             ``ProcessGrid`` over a 1-rank NCCL group; torch ops and the
             grid's collectives, no hand kernel: JAX's mesh paths reach no
             Pallas kernel either, and the launch counts, set to 0 before,
             must stay 0).  Phase 8's state is freed first.  9a: qwen3-4b at
             full width and depth, sharded by the rules: prefill logits of
             7a's prompt against the plain path's (rtol = atol = 0.15, argmax
             equal), then ``serve(mesh=)`` at batch 8, prompt 512, 64 tokens
             (caches sequence-sharded, ``seq_shards`` = the model axis): the
             same greedy tokens as 7a; then ``make_state(mesh=, fsdp=True)``
             and 2 steps of ``make_train_step(mesh=)`` on 8a's batches: the
             first step's loss and grad norm within 1e-5 relative of 8a's,
             with times and the allocator's peak beside 7a's and 8a's.  9b:
             the other nine archs at full width with 2 layers (gemma3 6)
             through the mesh entry points (``moe_ffn_shardmap`` at tp = 1,
             the SSM path, the vocab-parallel CE) against their plain
             paths: prefill and one decode step (batch 4, S 256) within
             0.15 with argmax equal, ``loss_and_grads`` on 1 × 256 within
             1e-5 (loss and grad norm).  9c: the LM dry run of qwen3-4b
             ``decode_32k`` (``launch/dryrun.py``) at the production
             grid's rows per rank (128 / 16 = 8, cache 32,768): its record
             (production argument bytes and roofline, the measured decode
             step) in one line, also written to ``build/chip_smoke/``.  9d:
             the dry run's measured ``prefill_32k`` step of qwen3-4b at the
             production grid's 2 rows a rank, the prompt cut to 16,384 tokens
             (the whole 32,768, three calls of ~60 s on an H100, runs in
             ``scripts/serve_profile.py --long-prefill``): ms and peak beside its bf16
             FLOP bound, then causality: the logits of each row's first 512
             positions (7a's prompt length) against a 512-token prefill of
             the same tokens, finite and within rtol = atol = 0.15.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import time

KERNEL_NAMES = ("xdrop", "minplus", "pileup", "spgemm", "spgemm_masked", "cc",
                "kmer_pack")
# the kernels of each path: the single-device path does not run spgemm,
# only connected_components runs cc, and spgemm_masked squares the TR only
# above TR_DENSE_MAX_ROWS (phase 6b); kmer_pack runs once an assembly
GSPMD_KERNELS = ("xdrop", "minplus", "pileup", "kmer_pack")
SHARD_MAP_KERNELS = ("xdrop", "minplus", "pileup", "spgemm", "kmer_pack")
REPLACES = {
    "xdrop": "src/repro/kernels/xdrop/xdrop.py:105",
    "minplus": "src/repro/kernels/minplus/minplus.py:54",
    "pileup": "src/repro/kernels/pileup/pileup.py:106",
    "spgemm": "src/repro/kernels/spgemm/spgemm.py:133",
    # no Pallas kernel: the JAX package's TR squares wide graphs in array code
    "spgemm_masked": "src/repro/core/spgemm.py:spgemm_masked (no kernel)",
    "cc": "src/repro/kernels/cc/cc.py:66",
    # no Pallas kernel: the JAX package extracts k-mers in array code
    "kmer_pack": "src/repro/assembly/kmers.py:extract_kmers (no kernel)",
}
# the ``kernel`` attribute of each kernel's ``kernel_launch`` span: the
# name the JAX package's spans give the same kernel
SPAN_KERNEL = {"xdrop": "xdrop_extend", "minplus": "minplus_dense",
               "pileup": "pileup_vote", "spgemm": "spgemm_ring_stages",
               "spgemm_masked": "spgemm_masked", "cc": "cc_labels",
               "kmer_pack": "kmer_pack"}
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


def simulate(simulate_mod, genome_kb: float, seed: int):
    """The reads of every assembly phase: a random ``genome_kb`` genome
    (rounded to a base) from ``seed``, depth 14, CLR-like reads (mean 1400,
    sd 250, 5 % error, 60 % of it indels)."""
    rng = __import__("numpy").random.default_rng(seed)
    genome = simulate_mod.simulate_genome(rng, round(genome_kb * 1000))
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


def xdrop_bytes(a) -> int:
    """Bytes an x-drop launch must move: both read batches, the six walk
    inputs and the three outputs of each walk (int32)."""
    walks = a[1].numel()  # pairs of the launch: directions x rows
    return a[0].numel() + a[4].numel() + 4 * 6 * walks + 4 * 3 * walks


def spgemm_work(args, kw, got):
    """The work of a ring-stage launch on ``args`` with outputs ``got``:
    ``candidates`` (a live A slot in range times the live B slots of the
    row it selects), ``b_rows_read``, ``per_row`` ((S, n) candidates) and
    the least time (``bound_ms``, ``bound_by``).  A sort of V keys needs
    V log2 V comparisons at the least."""
    import torch

    offsets, a_cols, a_vals, b_cols, b_vals = args
    stages, _, _ = a_cols.shape
    nb = b_cols.shape[1]
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
    return {"candidates": int(n_cand), "b_rows_read": b_rows, "per_row": v,
            "t_bytes": t_bytes, "t_ops": t_ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def masked_work(a_cols, a_vals, b_cols, b_vals, m_cols):
    """The work of one ``spgemm_masked`` launch: ``products`` (a live A
    slot's B slot whose column the mask row holds: 8 adds and 8 mins each,
    with the fold), and the least time, each operand read once and the
    output written once (``t_bytes``, ``t_ops``, in seconds)."""
    import torch

    keys = torch.where(m_cols >= 0, m_cols.long(), 1 << 31).contiguous()
    products = 0
    for a in range(a_cols.shape[1]):
        k = a_cols[:, a].long()
        j = b_cols[k.clamp(min=0)].long()
        pos = torch.searchsorted(keys, j.clamp(min=0).contiguous()).clamp(
            max=m_cols.shape[1] - 1)
        hit = (keys.gather(1, pos) == j) & (j >= 0) & (k >= 0)[:, None]
        products += int(hit.sum())
    n, km = m_cols.shape
    nbytes = (20 * int((a_cols >= 0).sum()) + 20 * int((b_cols >= 0).sum())
              + 4 * m_cols.numel() + 16 * n * km)
    return {"products": products, "t_bytes": nbytes / HBM_BYTES_S,
            "t_ops": 16 * products / F32_OPS_S}


def pileup_work(draft, pieces, start, plen):
    """``(bytes, operations, votes, tile list entries, tiles)`` of a
    consensus call.  Bytes: the draft, the piece bytes on vote columns,
    start and plen, the three outputs; operations: ~12 int32 a (column,
    piece) vote (its compare, the ballot and popcount of its window, the
    closed-form count of comparable positions, the gate and the count) and
    ~12 a column (the vote epilogue)."""
    import torch

    from repro_torch.kernels.pileup import ops as pu_ops

    c, l = draft.shape
    lr = pieces.shape[2]
    lo, hi = pu_ops.vote_ranges(start, plen, l, lr)
    votes = int(torch.clamp(hi - lo, min=0).sum())
    entries = int(pu_ops.tile_entries(start, plen, l, lr).sum())
    tiles = c * -(-l // pu_ops.TILE)
    bytes_ = c * l + votes + 8 * start.numel() + 9 * c * l
    return bytes_, 12 * votes + 12 * c * l, votes, entries, tiles


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


# --- phase 6b: assemble() at bacterial scale -------------------------------

BACTERIAL_KB = 4641.652  # E. coli K-12 MG1655: 4,641,652 bp
# reliable k-mers a genome base, with headroom: simulate()'s reads give
# 6,366,718 at 4,641,652 bp (1.37 a base)
RELIABLE_PER_BP = 1.5
IDENTITY_BP = 500_000  # 6b's identity: the genome's first 500 kb
SPGEMM_PLAIN_ROWS = 4096  # 6b's plain spgemm, in blocks of this many rows


def assembly_config(genome_kb: float, device: str = "cuda"):
    """The ``PipelineConfig`` of phases 3 and 6b and ``scripts/
    grid_nccl.py`` for ``simulate``'s reads of a ``genome_kb`` genome:
    ``m_capacity`` is the next power of two above ``RELIABLE_PER_BP``
    k-mers a genome base (1 << 20 at 400 kb, 1 << 23 at
    ``BACTERIAL_KB``)."""
    from repro_torch.assembly.pipeline import PipelineConfig
    from repro_torch.core.spmat import next_pow2

    return PipelineConfig(
        m_capacity=next_pow2(int(RELIABLE_PER_BP * genome_kb * 1000)),
        upper=56, read_capacity=160, overlap_capacity=64, r_capacity=40,
        band=65, max_steps=4096, xdrop=30, align_chunk=4096, device=device)


def truth_quality(res, reads) -> dict:
    """An ``assemble`` result against the simulated genome (host side):
    the contig count, N50 and longest contig, the genome fraction (the
    union of the contigs' truth intervals over the genome's length), and
    the identity of the draft and polished contigs on the genome's first
    ``IDENTITY_BP`` bases as the contigs of 2 reads or more cover them
    (``banded_edit_distance`` is a host loop over rows): each such
    contig's part whose truth lies there, length-weighted; a contig whose
    truth interval crosses ``IDENTITY_BP`` is cut where its length, scaled by
    its truth interval's, puts the crossing (so its indel drift up to
    there may count as edits at the cut)."""
    from repro_torch.assembly.metrics import contig_truth_interval, identity

    genome, window = reads.genome, IDENTITY_BP
    ivs = [contig_truth_interval(c, reads) if c.reads else None
           for c in res.contigs]
    covered, end = 0, 0
    for lo, hi, _ in sorted(iv for iv in ivs if iv):
        covered += max(0, hi - max(lo, end))
        end = max(end, hi)
    band = max(64, int(8 * 0.05 * 1400))

    def window_identity(contigs):
        num = den = 0.0
        for c, iv in zip(contigs, ivs):
            if iv is None or len(c.reads) < 2 or iv[0] >= window:
                continue
            lo, hi, o = iv
            cut = min(hi, window)
            m = round(len(c.codes) * (cut - lo) / (hi - lo))
            codes = c.codes[len(c.codes) - m:] if o else c.codes[:m]
            ref = genome[lo:cut]
            if o:
                ref = (3 - ref)[::-1]
            num += identity(codes, ref, band=band) * m
            den += m
        return (num / den if den else float("nan")), int(den)

    draft_id, nb = window_identity(res.contigs)
    pol_id, nb_pol = window_identity(res.polished_contigs)
    cs = res.stats["contigs"]
    return {"n_contigs": cs["n_contigs"], "n50": cs["n50"],
            "longest": cs["longest"], "total_length": cs["total_length"],
            "genome_fraction": covered / len(genome),
            "identity_window_bp": window,
            "identity_bases": [nb, nb_pol],
            "draft_identity": draft_id, "polished_identity": pol_id}


def bacterial_phase(args, check, records, device: str = "cuda") -> dict:
    """Phase 6b (module docstring): ``assemble()`` on the reads of a
    ``BACTERIAL_KB`` genome with ``assembly_config``, gspmd and shard_map
    on a 1×1 grid, both traced; each kernel of the path against its plain
    version on the run's own inputs, its numbers added to its record in
    ``records`` under ``"bacterial"``.  Only ``"cuda"`` is a measurement;
    ``"cpu"`` rehearses the control flow (with ``BACTERIAL_KB`` patched
    small; the ``cuda`` backend's plain versions, a gloo group, no launch
    counts and no timing of kernels).  Returns the phase's record."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.assembly import simulate as sim
    from repro_torch.assembly.pipeline import assemble
    from repro_torch.core import backend as B
    from repro_torch.core.grid import release_grids
    from repro_torch.core.semiring import MP
    from repro_torch.core.semiring import minplus_orient_semiring as SR
    from repro_torch.core.spgemm import spgemm_masked
    from repro_torch.core.spmat import EllMatrix, ell_equal
    from repro_torch.core.transitive_reduction import TR_DENSE_MAX_ROWS

    cuda = device == "cuda"
    t_phase = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    reads = simulate(sim, BACTERIAL_KB, args.seed)
    n = reads.n_reads
    # traced on the card for the stage peaks (on the CPU a span boundary
    # scans the live tensors, and the memory columns measure nothing)
    cfg = dataclasses.replace(assembly_config(BACTERIAL_KB, device=device),
                              backend="cuda", trace=cuda)
    print(f"[bacterial] genome {len(reads.genome)} bp, {n} reads, depth "
          f"{reads.depth:.2f}, max read {reads.codes.shape[1]}; simulated in "
          f"{time.perf_counter() - t0:.1f} s on the host; m_capacity "
          f"{cfg.m_capacity}", flush=True)

    # the first and the last x-drop call, the consensus call and the
    # shard_map run's overlap launch, each kept as the run made it
    kept, calls = {}, {}
    ops = {"xdrop_extend": K.xdrop_extend_batch,
           "consensus": K.pileup_vote,
           "spgemm_ring_stages": K.spgemm_ring_stages,
           "spgemm_masked": K.spgemm_masked_minplus}
    gspmd_ops = ("xdrop_extend", "consensus", "spgemm_masked")

    def keep(op, fn):
        def wrapped(*a, **kw):
            call = (a, kw)
            kept[op] = [kept.get(op, [call])[0], call]
            calls[op] = calls.get(op, 0) + 1
            return fn(*a, **kw)
        return wrapped

    def stage_peaks(res):
        return {sp.name: sp.attrs.get("peak_hbm_bytes")
                for sp in (res.trace.roots if res.trace else ())}

    for op in gspmd_ops:
        B.register_op(op, "cuda", keep(op, ops[op]))
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = assemble(reads.codes, reads.lengths, cfg)
        sync()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
    finally:
        for op in gspmd_ops:
            B.register_op(op, "cuda", ops[op])
    st = res.stats
    dense_tr = n <= TR_DENSE_MAX_ROWS
    keys = ("overflow_A", "overflow_C", "overflow_R", "tr_overflow",
            "m_reliable", "nnz_A", "nnz_C", "n_aligned", "align_bucket",
            "n_passed", "nnz_R", "nnz_S", "n_contained", "tr_iterations",
            "tr_backend", "peak_hbm_bytes", "hbm_source")
    print(f"[bacterial] gspmd assemble {wall:.2f} s (traced: {cfg.trace}); "
          "stages (s): "
          + json.dumps(res.timings), flush=True)
    print("[bacterial] gspmd " + json.dumps({k: st[k] for k in keys})
          + "; stage peaks (bytes): " + json.dumps(stage_peaks(res))
          + f"; launches {json.dumps(launches)}", flush=True)
    check(st["tr_backend"] == ("cuda" if dense_tr else "cuda_masked"),
          f"bacterial: tr_backend {st['tr_backend']!r} at {n} reads")
    # the TR squares once an iteration: the dense kernel up to
    # TR_DENSE_MAX_ROWS, the sampled kernel above it
    tr_launches = {"minplus": st["tr_iterations"] if dense_tr else 0,
                   "spgemm_masked": 0 if dense_tr else st["tr_iterations"]}
    live_chunks = -(-max(st["n_aligned"], 1) // cfg.align_chunk)
    if cuda:
        check(launches["xdrop"] == live_chunks,
              f"bacterial: {launches['xdrop']} xdrop launches for "
              f"{st['n_aligned']} live pairs in {live_chunks} chunks")
        check(launches["pileup"] == 3,
              f"bacterial: {launches['pileup']} pileup launches")
        check(launches["kmer_pack"] == 1,
              f"bacterial: {launches['kmer_pack']} kmer_pack launches")
        check(launches["spgemm"] == 0 and all(
                  launches[k] == v for k, v in tr_launches.items()),
              f"bacterial: launches {launches} (the TR's dense kernel runs "
              f"only at n <= {TR_DENSE_MAX_ROWS}, the sampled one above, "
              f"once in each of {st['tr_iterations']} iterations)")
    check(st["n_passed"] > 0 and res.consensus is not None
          and res.consensus.n_contigs > 0, "bacterial: no contigs")
    check(int(res.consensus.codes.max()) <= 3,
          "bacterial: polished bases outside 0..3")
    cap_x, cap_p = kept.pop("xdrop_extend"), kept.pop("consensus")
    cap_m = kept.pop("spgemm_masked", None)
    check(calls == {"xdrop_extend": live_chunks, "consensus": 1,
                    **({} if dense_tr else
                       {"spgemm_masked": st["tr_iterations"]})},
          f"bacterial: op calls {calls}")

    # --- the shard_map path on a 1-rank group (phase 3b's kind) ---
    if cuda:
        torch.cuda.empty_cache()
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    B.register_op("spgemm_ring_stages", "cuda",
                  keep("spgemm_ring_stages", ops["spgemm_ring_stages"]))
    try:
        sm_cfg = dataclasses.replace(cfg, distribution="shard_map")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res_sm = assemble(reads.codes, reads.lengths, sm_cfg)
        sync()
        wall_sm = time.perf_counter() - t0
        sm_launches = K.launch_counts()
    finally:
        B.register_op("spgemm_ring_stages", "cuda",
                      ops["spgemm_ring_stages"])
        dist.destroy_process_group()
        release_grids()
    ss = res_sm.stats
    print(f"[bacterial] shard_map (1x1) assemble {wall_sm:.2f} s (traced: "
          f"{cfg.trace}); stages (s): " + json.dumps(res_sm.timings),
          flush=True)
    print("[bacterial] shard_map " + json.dumps({k: ss[k] for k in keys})
          + "; stage peaks (bytes): " + json.dumps(stage_peaks(res_sm))
          + f"; launches {json.dumps(sm_launches)}", flush=True)
    if cuda:
        check(sm_launches["spgemm"] == 1 and sm_launches["xdrop"] == 1
              and sm_launches["pileup"] == 3 and sm_launches["kmer_pack"] == 1
              and all(sm_launches[k] == v for k, v in tr_launches.items()),
              f"bacterial shard_map: launches {sm_launches}")
        check(ss["summa_backend"] == "cuda",
              f"summa_backend {ss['summa_backend']!r}")
    check(ell_equal(res.r_graph, res_sm.r_graph),
          "bacterial: R differs, shard_map vs gspmd")
    check(ell_equal(res.s_graph, res_sm.s_graph),
          "bacterial: S differs, shard_map vs gspmd")
    skip = set(PATH_KEYS) | set(SHARD_MAP_KEYS)
    diff = [k for k in st if k not in skip and not k.startswith("exchange_")
            and st[k] != ss.get(k)]
    check(not diff, f"bacterial: stats differ, shard_map vs gspmd: {diff}")
    a, b = res.polished_contigs, res_sm.polished_contigs
    check(len(a) == len(b) and all(
        x.reads == y.reads and np.array_equal(x.codes, y.codes)
        for x, y in zip(a, b)), "bacterial: polished contigs differ")
    print(f"[bacterial] shard_map == gspmd: R, S, "
          f"{len([k for k in st if k not in skip and not k.startswith('exchange_')])}"
          f" stats keys, {len(a)} polished contigs", flush=True)
    cap_s = kept.pop("spgemm_ring_stages")[0]
    check(calls["spgemm_ring_stages"] == 1,
          f"bacterial shard_map: {calls['spgemm_ring_stages']} spgemm calls")
    del res_sm

    # --- the kernels against their plain versions, on this run's inputs ---
    out = {}

    def plain_once(fn):
        sync()
        t0 = time.perf_counter()
        want = fn()
        sync()
        return want, (time.perf_counter() - t0) * 1e3

    def exact(name, got, want):
        for g, w in zip(got, want):
            check(g.shape == w.shape and torch.equal(g, w),
                  f"bacterial {name}: the kernel differs from its plain "
                  "version")

    def entry(name, label, n_launches, ms, plain_ms, t_bytes, t_ops):
        """One kernel's 6b record; ``t_bytes``, ``t_ops`` in seconds."""
        rec = {"input": label, "launches": n_launches, "max_abs_err": 0,
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out.setdefault(name, []).append(rec)
        print(f"[bacterial] {name} {json.dumps(rec)}", flush=True)

    chunks = (("first", cap_x[0]), ("last", cap_x[1]))
    if cap_x[0] is cap_x[1]:  # one chunk
        chunks = (("first and last", cap_x[0]),)
    for which, (xa, xkw) in chunks:
        got = K.xdrop_extend_batch(*xa, **xkw)
        (*want, cells), plain_ms = plain_once(
            lambda: K.xdrop_extend_batch_ref(*xa, **xkw, with_cells=True))
        exact("xdrop", list(got), want)
        ms = time_ms(lambda: K.xdrop_extend_batch(*xa, **xkw), 5) \
            if cuda else None
        entry("xdrop", f"gspmd {which} chunk, {xa[0].shape[0]} pairs x 2 "
              "directions", launches["xdrop"], ms, plain_ms,
              xdrop_bytes(xa) / HBM_BYTES_S,
              8 * int(cells.sum(dtype=torch.int64)) / I32_OPS_S)
    del cap_x, got, want

    sa, skw = cap_s
    got = K.spgemm_ring_stages(*sa, **skw)
    n_rows = sa[1].shape[1]

    def plain_spgemm():
        """The plain version in blocks of rows (each row is its own)."""
        offsets, a_cols, a_vals, b_cols, b_vals = sa
        parts = []
        for r0 in range(0, n_rows, SPGEMM_PLAIN_ROWS):
            rows = slice(r0, r0 + SPGEMM_PLAIN_ROWS)
            parts.append(K.spgemm_ring_stages_ref(
                offsets, a_cols[:, rows],
                {k: v[:, rows] for k, v in a_vals.items()}, b_cols, b_vals,
                **skw))
        return (torch.cat([p[0] for p in parts], 1),
                {k: torch.cat([p[1][k] for p in parts], 1) for k in got[1]},
                sum(p[2] for p in parts))

    want, plain_ms = plain_once(plain_spgemm)
    exact("spgemm", [got[0], *got[1].values(), got[2]],
          [want[0], *(want[1][k] for k in got[1]), want[2]])
    work = spgemm_work(sa, skw, got)
    ms = time_ms(lambda: K.spgemm_ring_stages(*sa, **skw), 3) if cuda else None
    entry("spgemm", f"shard_map overlap launch, 1x1 grid, {n_rows} rows, "
          f"{work['candidates']} candidates (plain version in blocks of "
          f"{SPGEMM_PLAIN_ROWS} rows)", sm_launches["spgemm"], ms, plain_ms,
          work["t_bytes"], work["t_ops"])
    del cap_s, sa, got, want

    (pd, pp, ps, pl), pkw = cap_p[0]
    got = K.pileup_vote(pd, pp, ps, pl, **pkw)
    want, plain_ms = plain_once(lambda: K.pileup_vote_ref(pd, pp, ps, pl,
                                                          **pkw))
    exact("pileup", got, want)
    bytes_, ops_, votes, _, _ = pileup_work(pd, pp, ps, pl)
    ms = time_ms(lambda: K.pileup_vote(pd, pp, ps, pl, **pkw), 5) \
        if cuda else None
    entry("pileup", f"the consensus call: {pd.shape[0]} contigs x "
          f"{pd.shape[1]} columns, {pp.shape[1]} pieces of {pp.shape[2]}, "
          f"{votes} votes", launches["pileup"], ms, plain_ms,
          bytes_ / HBM_BYTES_S, ops_ / I32_OPS_S)
    del cap_p, got, want
    out["minplus"] = [{"input": f"n = {n} reads: " + (
        "the dense TR" if dense_tr else
        f"over TR_DENSE_MAX_ROWS = {TR_DENSE_MAX_ROWS}, the sampled square"),
        "launches": launches["minplus"]}]
    # the TR's first and last sampled squares of this run, against the
    # plain version and the torch square (the reference backend's)
    for which, (ma, _) in (() if cap_m is None else
                           (("first", cap_m[0]), ("last", cap_m[1]))):
        got = K.spgemm_masked_minplus(*ma)
        want, plain_ms = plain_once(lambda: K.spgemm_masked_minplus_ref(*ma))
        r = EllMatrix(cols=ma[0], vals={MP: ma[1]}, n_cols=ma[0].shape[0])
        core = spgemm_masked(r, r, r, semiring=SR).vals[MP]
        exact("spgemm_masked", [got, want], [want, core])
        mw = masked_work(*ma)
        ms = time_ms(lambda: K.spgemm_masked_minplus(*ma), 20) \
            if cuda else None
        entry("spgemm_masked", f"gspmd TR, {which} iteration's R: "
              f"{r.n_rows} rows x {r.capacity} slots, nnz {int(r.nnz())}, "
              f"{mw['products']} products", launches["spgemm_masked"], ms,
              plain_ms, mw["t_bytes"], mw["t_ops"])
        del got, want, core
    del cap_m
    for rec in records:
        if rec["name"] in out:
            rec["bacterial"] = out[rec["name"]]

    # --- against the truth ---
    t0 = time.perf_counter()
    q = truth_quality(res, reads)
    print(f"[bacterial] vs truth ({time.perf_counter() - t0:.1f} s on the "
          f"host): " + json.dumps(q), flush=True)
    check(0.5 < q["draft_identity"] <= q["polished_identity"] <= 1.0,
          f"bacterial identity vs truth: draft {q['draft_identity']}, "
          f"polished {q['polished_identity']}")
    check(0 < q["genome_fraction"] <= 1, "bacterial genome fraction")
    phase = {"n_reads": n, "wall_s": wall, "shard_map_wall_s": wall_sm,
             "peak_hbm_bytes": st["peak_hbm_bytes"],
             "shard_map_peak_hbm_bytes": ss["peak_hbm_bytes"], **q,
             "seconds": time.perf_counter() - t_phase}
    print(f"[bacterial] phase 6b in {phase['seconds']:.1f} s", flush=True)
    return phase


# --- phase 7: the language-model serving path ------------------------------

BF16_TFLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
SERVE_ARGV = ["--arch", "qwen3-4b", "--batch", "8", "--prompt-len", "512",
              "--gen", "64"]
# past gemma3's and hymba's window; 8 rows, so that row 0 of an MoE arch
# stays inside the capacity in both runs (capacity scales with the call's
# tokens, and row 0 comes first in the dispatch order)
DECODE_CHECK = dict(batch=8, seq=1040)
CARD_CPU = dict(batch=2, seq=40, decode=4)


def lm_bounds(cfg, params, batch: int, prompt_len: int, max_len: int):
    """Least times of qwen3-4b's prefill (bf16 FLOPs at 989 TFLOP/s: the
    matmul weights once a token, the causal attention products, one logits
    row a sequence) and of one decode step (HBM bytes at 3.35 TB/s: every
    parameter read once but the embedding, of which the batch's rows; the
    whole ``max_len`` KV cache that ``decode_attention`` reads; the new
    keys and values and the f32 logits written)."""
    import torch

    named = dict(params.named_parameters())
    mm = sum(p.numel() for n, p in named.items()
             if p.ndim >= 2 and n not in ("embed", "unembed"))
    L, hq, hkv, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    toks = batch * prompt_len
    attn = 2 * 2 * batch * hq * dh * L * prompt_len * (prompt_len + 1) // 2
    flops = 2 * mm * toks + attn + 2 * batch * cfg.d_model * cfg.vocab_padded
    w_bytes = sum(p.numel() * p.element_size() for n, p in named.items()
                  if n != "embed")
    emb_bytes = batch * cfg.d_model * named["unembed"].element_size()
    elt = torch.finfo(cfg.torch_dtype).bits // 8
    kv_read = 2 * L * batch * max_len * hkv * dh * elt
    kv_write = 2 * L * batch * hkv * dh * elt
    logits = batch * cfg.vocab_padded * 4
    step_bytes = w_bytes + emb_bytes + kv_read + kv_write + logits
    return {"prefill_flops": flops,
            "prefill_bound_ms": flops / BF16_TFLOPS * 1e3,
            "decode_step_bytes": step_bytes, "weight_bytes": w_bytes,
            "kv_read_bytes": kv_read,
            "decode_step_bound_ms": step_bytes / HBM_BYTES_S * 1e3}


class RouteLog:
    """Every MoE layer's routing in the order the forward visits them: the
    port's own top-k (and, when ``forced`` holds another run's log, that
    run's top-k is used instead, with the port's softmax weights at it)."""

    def __init__(self, moe_mod, forced=None):
        self.mod, self.forced, self.records = moe_mod, forced, []
        self._orig = moe_mod.router_topk

    def __enter__(self):
        import torch

        queue = list(self.forced.records) if self.forced else None

        def topk(x, w_router, n_real, top_k):
            w, idx = self._orig(x, w_router, n_real, top_k)
            logits = torch.matmul(x.float(), w_router.float())
            self.records.append((idx.cpu(), logits[:, :n_real].cpu()))
            if queue is not None:
                idx = queue.pop(0)[0].to(x.device)
                w = torch.softmax(torch.gather(logits, 1, idx), dim=-1)
            return w, idx

        self.mod.router_topk = topk
        return self

    def __exit__(self, *exc):
        self.mod.router_topk = self._orig


def flips_are_ties(own: "RouteLog", ref: "RouteLog", top_k: int):
    """Where ``own``'s top-k differs from ``ref``'s: (gap, logit difference)
    of each token, and whether every gap is at most twice the difference
    (the two runs' router inputs differ enough to reorder the experts)."""
    import torch

    out = []
    for (i_a, l_a), (i_b, l_b) in zip(own.records, ref.records):
        diff = (i_a != i_b).any(-1)
        for t in torch.nonzero(diff).flatten().tolist():
            top = torch.sort(l_b[t].double(), descending=True).values[:top_k + 1]
            gap = float((top[:-1] - top[1:]).min())
            out.append((gap, float((l_a[t] - l_b[t]).abs().max())))
    return out, all(g <= 2 * d for g, d in out)


def serve_phase(args, check, device: str = "cuda") -> None:
    """Phase 7: qwen3-4b served at full size (7a), the decode check of every
    arch at full width (7b), and ``device`` against the CPU (7c).  Only
    ``"cuda"`` is a measurement; another device rehearses the control flow."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import ARCH_NAMES, get_config, reduced_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as TM
    from repro_torch.models import moe as TMoe
    from repro_torch.models.layers import param_count

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    # --- 7a. qwen3-4b at full size ---
    sargs = SV.parse_args(SERVE_ARGV + ["--seed", str(args.seed),
                                        "--device", device])
    base = 0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # earlier phases' live tensors
    t0 = time.perf_counter()
    cfg, params, prompt = SV.setup(sargs)
    if cuda:
        torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_stored = param_count(params)
    check(cfg.param_count() == 4_411_228_160 and (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.d_ff, cfg.vocab_padded) == (36, 2560, 32, 8, 128, 9728, 152064),
        "qwen3-4b is not at its published widths")
    warm = SV.serve(cfg, params, prompt, gen=4)  # cuBLAS handles, allocator
    res = SV.serve(cfg, params, prompt, gen=sargs.gen)
    toks = res.tokens
    check(toks.shape == (sargs.batch, sargs.gen)
          and bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()),
          f"serve tokens {tuple(toks.shape)} out of range")
    check(torch.equal(warm.tokens, toks[:, :4]),
          "serve is not deterministic: the warm-up's tokens differ")
    max_len = sargs.prompt_len + sargs.gen
    bd = lm_bounds(cfg, params, sargs.batch, sargs.prompt_len, max_len)
    step_ms = res.decode_ms / res.decode_steps
    rec = {
        "arch": cfg.name, "batch": sargs.batch, "prompt_len": sargs.prompt_len,
        "gen": sargs.gen, "param_count": cfg.param_count(),
        "stored_params": n_stored, "init_s": t_init,
        "prefill_ms": res.prefill_ms,
        "prefill_bound_ms": bd["prefill_bound_ms"],
        "prefill_flops": bd["prefill_flops"],
        "decode_step_ms": step_ms,
        "decode_step_bound_ms": bd["decode_step_bound_ms"],
        "decode_step_bytes": bd["decode_step_bytes"],
        "weight_bytes": bd["weight_bytes"], "kv_read_bytes": bd["kv_read_bytes"],
        "tokens_per_s": res.tokens_per_s, "peak_bytes": res.peak_bytes,
        "peak_above_start_bytes": (None if res.peak_bytes is None
                                   else res.peak_bytes - base),
        "first_tokens": toks[0, :16].tolist()}
    print(f"[serve] 7a {json.dumps(rec)}", flush=True)
    ref = {"tokens": toks, "prefill_ms": res.prefill_ms,
           "decode_step_ms": step_ms}
    del params, prompt, warm, res
    if cuda:
        torch.cuda.empty_cache()

    # --- 7b. prefill(S) + decode(1) against forward(S + 1) ---
    b, s = DECODE_CHECK["batch"], DECODE_CHECK["seq"]
    for arch in ARCH_NAMES:
        full = get_config(arch)
        cfg = full if arch == "qwen3-4b" else dataclasses.replace(
            full, n_layers=6 if arch == "gemma3-4b" else 2)
        t0 = time.perf_counter()
        params = TM.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed))
        rng = np.random.default_rng(args.seed + 1)
        if cfg.frontend == "token":
            seq = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, s + 1))
                                   .astype(np.int32)).to(dev)
            whole, pre, last = ({"tokens": seq}, {"tokens": seq[:, :s]},
                                {"tokens": seq[:, s:]})
        else:
            seq = torch.from_numpy(rng.normal(0, 1, (b, s + 1, cfg.d_model))
                                   ).to(torch.bfloat16).to(dev)
            whole, pre, last = ({"embeddings": seq}, {"embeddings": seq[:, :s]},
                                {"embeddings": seq[:, s:]})
        with RouteLog(TMoe) as r_full:
            x_full, _ = TM.forward(params, whole, cfg)
            l_full = TM.unembed_logits(x_full[:, -1], params.unembed)
        caches = TM.init_cache(cfg, b, s + 4, device=dev)
        with RouteLog(TMoe) as r_inc:
            _, caches = TM.make_prefill_step(cfg)(params, caches, pre)
            l_dec, _ = TM.make_serve_step(cfg)(params, caches, last, s)
        l_full, l_dec = l_full.cpu(), l_dec.cpu()
        check(bool(torch.isfinite(l_full).all() and torch.isfinite(l_dec).all()),
              f"7b {arch}: non-finite logits")
        rows = torch.ones(b, dtype=torch.bool)
        routing = ""
        if cfg.family == "moe":
            # capacity depends on the tokens of a call, so routing may
            # differ between the runs; compare the rows whose last token
            # is routed alike
            rows, earlier = routed_alike_rows(r_full, r_inc, cfg, b, s)
            routing = (f", last token routed alike {rows.tolist()}, earlier "
                       f"(token, layer) pairs routed otherwise "
                       f"{earlier.tolist()}")
        check(bool(rows.any()), f"7b {arch}: no row routed alike")
        err = (l_dec - l_full).abs()
        ok = bool((err <= 0.15 + 0.15 * l_full.abs())[rows].all())
        top2 = torch.topk(l_full, 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        agree = l_dec.argmax(-1) == l_full.argmax(-1)
        bad = [(r, float(margin[r])) for r in range(b)
               if rows[r] and not agree[r] and margin[r] > 0.3]
        for r in range(b):
            if rows[r] and not agree[r]:
                print(f"[serve] 7b {arch} row {r}: argmax differs, top-2 "
                      f"margin {float(margin[r]):.4f}", flush=True)
        print(f"[serve] 7b {arch}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, batch {b}, S {s}: max |decode - forward| "
              f"{float(err[rows].max()):.4f} on rows {rows.tolist()}, argmax "
              f"agree {agree.tolist()}{routing}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(ok, f"7b {arch}: decode logits outside rtol = atol = 0.15")
        check(not bad, f"7b {arch}: argmax differs on rows with margin > 0.3: {bad}")
        del params, caches, x_full
        if cuda:
            torch.cuda.empty_cache()

    # --- 7c. the card against the CPU, reduced configs ---
    b, s, nd = CARD_CPU["batch"], CARD_CPU["seq"], CARD_CPU["decode"]
    for arch in ARCH_NAMES:
        line = {}
        for dtype, tol in (("float32", 1e-3), ("bfloat16", 0.15)):
            cfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
            cpu = TM.init_params(cfg, torch.Generator().manual_seed(args.seed))
            card = copy.deepcopy(cpu).to(dev)
            rng = np.random.default_rng(args.seed + 2)
            toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, s + nd))
                                    .astype(np.int32))
            emb = torch.from_numpy(rng.normal(0, 1, (b, s, cfg.d_model))
                                   ).to(torch.bfloat16)
            runs = {}
            ref_log = None
            for where, model in (("cpu", cpu), ("card", card)):
                d = torch.device("cpu") if where == "cpu" else dev
                forced = ref_log if dtype == "bfloat16" else None
                with RouteLog(TMoe, forced) as log:
                    runs[where] = teacher_forced(TM, SV, cfg, model, toks, emb,
                                                 s, nd, d)
                if where == "cpu":
                    ref_log = log
            a, c = runs["cpu"], runs["card"]
            diff = max(float((x - y).abs().max()) for x, y in zip(a, c))
            greedy = all(torch.equal(x.argmax(-1), y.argmax(-1))
                         for x, y in zip(a, c))
            line[dtype] = {"max_abs_diff": diff, "greedy_equal": greedy}
            if dtype == "float32":
                check(diff <= tol and greedy,
                      f"7c {arch} f32: card vs CPU max |diff| {diff}, greedy "
                      f"equal {greedy}")
            else:
                if cfg.family == "moe":
                    flips, ties = flips_are_ties(log, ref_log, cfg.top_k)
                    line[dtype]["routing_flips"] = flips
                    check(ties, f"7c {arch} bf16: a routing flip that is "
                          f"no near tie: {flips}")
                check(all(bool((y - x).abs().le(tol + tol * x.abs()).all())
                          for x, y in zip(a, c)),
                      f"7c {arch} bf16: card vs CPU outside 0.15 ({diff})")
        print(f"[serve] 7c {arch}: {json.dumps(line)}", flush=True)
    return ref


def routed_alike_rows(r_full, r_inc, cfg, b: int, s: int):
    """Rows whose last token forward(S + 1) and prefill(S) + decode(1)
    route alike in every MoE layer (the same top-k, and the same of them
    kept by the capacity, which depends on the call's token count), and per
    row the count of earlier (token, layer) pairs routed otherwise (they
    reach the last token only through attention)."""
    import torch

    from repro_torch.models import moe as TMoe

    n = len(r_full.records)
    check(len(r_inc.records) == 2 * n, "7b: MoE layer count differs")
    e = cfg.n_experts_padded

    def keep(idx, t):
        return TMoe.dispatch_slots(idx, e, TMoe.moe_capacity(
            idx.shape[0], cfg.top_k, e)).keep.reshape(b, t, -1)

    rows = torch.ones(b, dtype=torch.bool)
    earlier = torch.zeros(b, dtype=torch.long)
    for li in range(n):
        i_f = r_full.records[li][0]
        i_p, i_d = r_inc.records[li][0], r_inc.records[n + li][0]
        idx_inc = torch.cat([i_p.reshape(b, s, -1), i_d.reshape(b, 1, -1)], 1)
        keep_inc = torch.cat([keep(i_p, s), keep(i_d, 1)], 1)
        same = ((idx_inc == i_f.reshape(b, s + 1, -1)).all(-1)
                & (keep_inc == keep(i_f, s + 1)).all(-1))  # (b, s + 1)
        rows &= same[:, -1]
        earlier += (~same[:, :-1]).sum(-1)
    return rows, earlier

def teacher_forced(TM, SV, cfg, model, toks, emb, s: int, nd: int, dev):
    """Logits of prefill(S) and ``nd`` teacher-forced decode steps."""
    import torch

    b = toks.shape[0]
    caches = TM.init_cache(cfg, b, s + nd + 2, device=dev)
    toks = toks.to(dev)
    prompt = ({"tokens": toks[:, :s]} if cfg.frontend == "token"
              else {"embeddings": emb.to(dev)})
    logits, caches = TM.make_prefill_step(cfg)(model, caches, prompt)
    out = [logits.cpu()]
    step = TM.make_serve_step(cfg)
    for i in range(nd):
        logits, caches = step(model, caches,
                              SV.step_input(cfg, model, toks[:, s + i:s + i + 1]),
                              s + i)
        out.append(logits.cpu())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


# --- phase 8: the language-model training path ---------------------------

TRAIN_SEQ = 4096  # configs/shapes.py train_4k: one row of its global batch
TRAIN_SEQ_CUT = 2048  # the cut if the card cannot hold 1 x 4096
TRAIN_STEPS = 4  # timed, after one warm-up step (lr 0 at step 0)
CARD_CPU_TRAIN = dict(layers=2, seq=256, steps=2)  # 8b
REDUCED_TRAIN = dict(batch=2, seq=32, steps=3)  # 8c
# 8b / 8c: card against CPU in f32 with TF32 off: loss rtol, grad_norm
# rtol; μ and ν (linear and quadratic in the gradients) each leaf within
# MOMENT_TOL of its max |x|; the parameters each leaf within PARAM_TOL in
# relative L2.  Not the parameters' max: Adam's update has the same size
# for every element, so where an element's gradient is near eps (1e-8) or
# cancels to noise its update follows the noise (a 1e-7 perturbation of a
# CPU run moves the embedding's largest element by 4.4e-3 of the leaf's max
# and the leaf by 1.5e-4 in L2; its μ and ν by 1.7e-6 and 2.3e-6)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-5, 1e-4
MOMENT_TOL, PARAM_TOL = 1e-4, 1e-3
RESUME_RTOL = 1e-4  # JAX's own bound (tests/test_launch.py)


def train_plan(cfg, n_stored: int, seq: int):
    """The memory plan of one qwen3-4b train step on one card, in bytes:
    f32 parameters, gradients, μ and ν; one CE chunk's f32 logits with
    their masked copy, softmax and gradient; the unembed rounded to bf16
    and upcast (the CE's operand) and that copy's gradient; one recomputed
    layer (its bf16 weight casts, attention carries and MLP activations,
    reckoned at ~1 GB at 4096 tokens); the residual stream kept between
    period groups; the optimizer's two leaf-sized temporaries (not at the
    same time as activations)."""
    f32 = 4
    params = n_stored * f32
    cs = min(cfg.ce_chunk, seq)
    plan = {
        "f32_parameters": params, "f32_gradients": params,
        "f32_mu_nu": 2 * params,
        "ce_chunk": 4 * cs * cfg.vocab_padded * f32,
        "unembed_operand_and_grad": 2 * cfg.d_model * cfg.vocab_padded * f32,
        "recomputed_layer": int(1e9 * seq / 4096),
        "residual_stream": cfg.n_layers * seq * cfg.d_model * 2,
        "optimizer_temporaries": 2 * cfg.d_model * cfg.vocab_padded * f32,
    }
    state = 4 * params
    act = sum(plan[k] for k in ("ce_chunk", "unembed_operand_and_grad",
                                "recomputed_layer", "residual_stream"))
    plan["subtotal_state"] = state
    plan["reckoned_peak"] = state + max(act, plan["optimizer_temporaries"])
    return plan


def train_bound(cfg, n_stored: int, tokens: int, seq: int):
    """Least time of one train step: 6·N·T model FLOPs plus the causal
    attention products (forward QKᵀ and PV, twice that in the backward) at
    989 TFLOP/s bf16, plus the optimizer's bytes (read p, g, μ, ν; write
    p, μ, ν: 28 B a stored f32 parameter) at 3.35 TB/s."""
    batch = tokens // seq
    attn = 3 * 2 * 2 * batch * cfg.n_heads * cfg.head_dim * cfg.n_layers \
        * seq * (seq + 1) // 2
    flops = 6 * cfg.param_count() * tokens + attn
    opt_bytes = 28 * n_stored
    return {"model_flops": 6 * cfg.param_count() * tokens,
            "attention_flops": attn, "optimizer_bytes": opt_bytes,
            "bound_ms": (flops / BF16_TFLOPS + opt_bytes / HBM_BYTES_S) * 1e3}


def _state_err(a, b):
    """How far train state ``a`` is from ``b`` (on the CPU): the largest
    relative L2 difference of a parameter leaf, and the largest |a − b|
    over a moment leaf's max |b|."""
    (ma, sa, _), (mb, sb, _) = a, b

    def rel(x, y, norm):
        x, y = x.detach().cpu().double(), y.detach().double()
        den = float(norm(y))
        return float(norm(x - y)) / den if den else (
            float("inf") if bool(x.any()) else 0.0)

    l2 = lambda t: t.norm()  # noqa: E731
    amax = lambda t: t.abs().max()  # noqa: E731
    params = max(rel(p, q, l2) for (_, p), (_, q) in zip(
        ma.named_parameters(), mb.named_parameters()))
    moments = max(max(rel(sa.mu[n], sb.mu[n], amax),
                      rel(sa.nu[n], sb.nu[n], amax)) for n in sb.mu)
    return {"params_l2": params, "moments_max": moments}


def _to_device(state, dev):
    """A train state copied to ``dev``."""
    import copy

    from repro_torch.optim import OptState

    model, st, step = state
    return (copy.deepcopy(model).to(dev),
            OptState(mu={n: t.to(dev, copy=True) for n, t in st.mu.items()},
                     nu={n: t.to(dev, copy=True) for n, t in st.nu.items()}),
            step)


def card_vs_cpu_steps(cfg, seed: int, batch: int, seq: int, steps: int, dev):
    """``steps`` f32 train steps from one state (drawn on the CPU) on the
    CPU and on ``dev``: the per-step losses and grad norms of both, and
    ``_state_err`` after the last step."""
    import torch

    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamW, cosine_schedule

    opt = AdamW(learning_rate=cosine_schedule(3e-3, 1, steps))
    model = TM.init_params(cfg, torch.Generator().manual_seed(seed), train=True)
    cpu = (model, opt.init(dict(model.named_parameters())), 0)
    card = _to_device(cpu, dev)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=batch,
                           seq_len=seq, seed=seed, frontend=cfg.frontend,
                           d_model=cfg.d_model)
    step_fn = TM.make_train_step(cfg, opt)
    out = {"cpu": [], "card": []}
    for step in range(steps):
        b = data.batch_at(step)
        for where in ("cpu", "card"):
            d = torch.device("cpu") if where == "cpu" else dev
            state = cpu if where == "cpu" else card
            state, m = step_fn(state, as_tensors(b, d))
            out[where].append((float(m["loss"]), float(m["grad_norm"])))
            if where == "cpu":
                cpu = state
            else:
                card = state
    return out, _state_err(card, cpu)


def train_phase(args, check, device: str = "cuda") -> None:
    """Phase 8: qwen3-4b trained at full width and depth (8a), card against
    CPU at full width with 2 layers (8b), and every arch at ``reduced()``
    (8c: train steps card against CPU, and ``launch.train.main`` straight
    against resumed).  Only ``"cuda"`` is a measurement; another device
    rehearses the control flow (with ``configs.get_config`` patched)."""
    import math
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs as TC
    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.launch import train as TT
    from repro_torch.models import model as TM
    from repro_torch.models.layers import param_count
    from repro_torch.optim import AdamW, cosine_schedule

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # --- 8a. qwen3-4b, full width and depth ---
    cfg = TC.get_config("qwen3-4b")
    if cuda:
        check(cfg.param_count() == 4_411_228_160 and (
            cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_padded) == (
                36, 2560, 32, 8, 128, 9728, 152064),
            "qwen3-4b is not at its published widths")
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 1, TRAIN_STEPS + 1))
    t0 = time.perf_counter()
    state = TT.make_state(cfg, opt, torch.Generator(device=dev).manual_seed(
        args.seed))
    if cuda:
        torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_stored = param_count(state[0])
    step_fn = TM.make_train_step(cfg, opt)
    seq, cut = TRAIN_SEQ, None
    plan = train_plan(cfg, n_stored, seq)
    print(f"[train] 8a memory plan, bytes (1 x {seq} tokens, f32 master "
          f"parameters and moments, bf16 compute): {json.dumps(plan)}",
          flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    while True:
        data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=1,
                               seq_len=seq, seed=0)
        try:
            state, m = step_fn(state, as_tensors(data.batch_at(0), dev))
            break
        except torch.OutOfMemoryError:
            check(seq != TRAIN_SEQ_CUT, "8a: 1 x 2048 does not fit either")
        # out of the handler, so that the failed step's frames are freed
        cut = f"sequence {seq} -> {TRAIN_SEQ_CUT}: 1 x {seq} ran out of memory"
        seq = TRAIN_SEQ_CUT
        gc.collect()
        torch.cuda.empty_cache()
        plan = train_plan(cfg, n_stored, seq)
        print(f"[train] 8a CUT: {cut}; plan at 1 x {seq}: {json.dumps(plan)}",
              flush=True)
    first = float(m["loss"])
    check(abs(first - math.log(cfg.vocab_size)) <= 1.5 and math.isfinite(
        float(m["grad_norm"])), f"8a: first loss {first} not within 1.5 of "
        f"ln({cfg.vocab_size}) = {math.log(cfg.vocab_size):.2f}")
    # every parameter must change in the first step with lr > 0 (step 1)
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in state[0].named_parameters()}
    times, losses, gnorms = [], [first], [float(m["grad_norm"])]
    for step in range(1, TRAIN_STEPS + 1):
        batch = as_tensors(data.batch_at(step), dev)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if step == 1:
            same = [n for n, p in state[0].named_parameters()
                    if torch.equal(p.detach().to("cpu"), before[n])]
            check(not same, f"8a: parameters unchanged by step 1: {same[:5]}")
            del before
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"8a: non-finite loss or grad norm: {losses}, {gnorms}")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    bd = train_bound(cfg, n_stored, seq, seq)
    step_ms = float(np.median(times))
    rec = {"arch": cfg.name, "batch": 1, "seq": seq, "cut": cut,
           "param_count": cfg.param_count(), "stored_params": n_stored,
           "init_s": t_init, "step_ms": times, "step_ms_median": step_ms,
           "tokens_per_s": seq / step_ms * 1e3, **bd,
           "x_bound": step_ms / bd["bound_ms"], "losses": losses,
           "grad_norms": gnorms, "peak_bytes": peak,
           "reckoned_peak_bytes": plan["reckoned_peak"]}
    print(f"[train] 8a {json.dumps(rec)}", flush=True)
    ref = {"seq": seq, "loss": losses[0], "grad_norm": gnorms[0],
           "step_ms_median": step_ms, "peak_bytes": peak}
    del state, step_fn, m, batch
    if cuda:
        torch.cuda.empty_cache()

    # --- 8b. the card against the CPU at full width, 2 layers, f32 ---
    c8b = CARD_CPU_TRAIN
    cfg = dataclasses.replace(TC.get_config("qwen3-4b"), n_layers=c8b["layers"],
                              dtype="float32")
    t0 = time.perf_counter()
    runs, err = card_vs_cpu_steps(cfg, args.seed, 1, c8b["seq"], c8b["steps"], dev)
    _check_card_cpu("8b", runs, err, check)
    print(f"[train] 8b qwen3-4b d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"f32, 1 x {c8b['seq']}: (loss, grad_norm) cpu {runs['cpu']} card "
          f"{runs['card']}; state difference {json.dumps(err)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if cuda:
        torch.cuda.empty_cache()

    # --- 8c. every arch at reduced(): card vs CPU, and resume ---
    r = REDUCED_TRAIN
    for arch in TC.ARCH_NAMES:
        cfg = dataclasses.replace(TC.reduced_config(arch), dtype="float32")
        runs, err = card_vs_cpu_steps(cfg, args.seed, r["batch"], r["seq"],
                                      r["steps"], dev)
        _check_card_cpu(f"8c {arch}", runs, err, check)
        argv = ["--arch", arch, "--reduced", "--batch", "4", "--seq", "32",
                "--log-every", "100", "--device", device]
        with tempfile.TemporaryDirectory() as ckpt, \
                contextlib.redirect_stdout(io.StringIO()):
            full = TT.main(argv + ["--steps", "8"])
            TT.main(argv + ["--steps", "5", "--ckpt-dir", ckpt,
                            "--ckpt-every", "5"])
            resumed = TT.main(argv + ["--steps", "8", "--ckpt-dir", ckpt,
                                      "--resume"])
        ok = abs(resumed[-1] - full[-1]) <= RESUME_RTOL * abs(full[-1])
        print(f"[train] 8c {arch}: f32 card vs CPU (loss, grad_norm) "
              f"{runs['card'][-1]} / {runs['cpu'][-1]}, state difference "
              f"{json.dumps(err)}; main bf16 final loss straight {full[-1]:.6f}, "
              f"resumed {resumed[-1]:.6f}", flush=True)
        check(ok, f"8c {arch}: resume final loss {resumed[-1]} vs {full[-1]}")
    return ref


# 8d: the SSM archs at full width and depth, (layers, d_model, state) as
# published; a warm-up step on batch 0 (lr 0), then two timed steps on
# batch 1, so that the second must lower the first's loss on its own batch
SSM_TRAIN = {"mamba2-1.3b": (48, 2048, 128), "hymba-1.5b": (32, 1600, 16)}
SSM_FIRST_LOSS = 0.5  # at full width, the first loss within this of ln V


def ssm_train_phase(args, check, device: str = "cuda") -> None:
    """Phase 8d: mamba2-1.3b and hymba-1.5b trained at full width and depth
    on 1 × 4096 tokens, bf16 compute on f32 master parameters and moments,
    as 8a trains qwen3-4b.  Only ``"cuda"`` is a measurement; another
    device rehearses the control flow (with ``configs.get_config``
    patched)."""
    import math

    import numpy as np
    import torch

    from repro_torch import configs as TC
    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.launch import train as TT
    from repro_torch.models import model as TM
    from repro_torch.models.layers import param_count
    from repro_torch.optim import AdamW, cosine_schedule

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    for arch, widths in SSM_TRAIN.items():
        cfg = TC.get_config(arch)
        if cuda:
            check((cfg.n_layers, cfg.d_model, cfg.ssm_state) == widths,
                  f"8d: {arch} is not at its published widths")
        opt = AdamW(learning_rate=cosine_schedule(3e-3, 1, 3))
        state = TT.make_state(cfg, opt, torch.Generator(device=dev)
                              .manual_seed(args.seed))
        n_stored = param_count(state[0])
        seq = TRAIN_SEQ
        plan = train_plan(cfg, n_stored, seq)
        step_fn = TM.make_train_step(cfg, opt)
        data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=1,
                               seq_len=seq, seed=0)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, gnorms, times = [], [], []
        for step, b in enumerate((0, 1, 1)):
            batch = as_tensors(data.batch_at(b), dev)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            if cuda:
                torch.cuda.synchronize()
            if step:
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated() if cuda else None
        step_ms = float(np.median(times))
        # 6·N·T at the bf16 peak and the optimizer's 28 B a parameter (the
        # SSD scan's and the attention's products left out)
        bound = (6 * cfg.param_count() * seq / BF16_TFLOPS
                 + 28 * n_stored / HBM_BYTES_S) * 1e3
        rec = {"arch": cfg.name, "batch": 1, "seq": seq,
               "param_count": cfg.param_count(), "stored_params": n_stored,
               "step_ms": times, "step_ms_median": step_ms,
               "tokens_per_s": seq / step_ms * 1e3, "bound_ms": bound,
               "x_bound": step_ms / bound, "losses": losses,
               "grad_norms": gnorms,
               "losses_hex": [x.hex() for x in losses],
               "grad_norms_hex": [x.hex() for x in gnorms],
               "peak_bytes": peak, "plan": plan,
               "reckoned_peak_bytes": plan["reckoned_peak"]}
        print(f"[train] 8d {json.dumps(rec)}", flush=True)
        check(all(math.isfinite(x) for x in losses + gnorms),
              f"8d {arch}: non-finite loss or grad norm: {losses}, {gnorms}")
        check(not cuda or abs(losses[0] - math.log(cfg.vocab_size))
              <= SSM_FIRST_LOSS, f"8d {arch}: first loss {losses[0]} not "
              f"within {SSM_FIRST_LOSS} of ln({cfg.vocab_size})")
        check(losses[2] < losses[1], f"8d {arch}: the step did not lower "
              f"its batch's loss: {losses[1]} -> {losses[2]}")
        del state, step_fn, m, batch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


def _check_card_cpu(what, runs, err, check):
    for (lc, gc_), (ld, gd) in zip(runs["cpu"], runs["card"]):
        check(abs(ld - lc) <= TRAIN_LOSS_RTOL * abs(lc)
              and abs(gd - gc_) <= TRAIN_GNORM_RTOL * abs(gc_),
              f"{what}: card (loss, grad_norm) {runs['card']} vs CPU "
              f"{runs['cpu']}")
    check(err["params_l2"] <= PARAM_TOL and err["moments_max"] <= MOMENT_TOL,
          f"{what}: state difference {err} (bounds: parameters {PARAM_TOL} "
          f"in L2, moments {MOMENT_TOL} of a leaf's max)")


MESH_CHECK = dict(batch=4, seq=256, train_seq=256)  # 9b
MESH_TRAIN_STEPS = 2  # 9a
DRYRUN_ARGV = ["--arch", "qwen3-4b", "--shape", "decode_32k", "--batch", "8"]
# 9d: the production grid's rows a rank (32 / 16 = 2); the prompt cut from
# 32,768 to the longest that keeps the phase near a minute (the whole
# 32,768: `scripts/serve_profile.py --long-prefill`, three ~60 s calls)
PREFILL_ARGV = ["--arch", "qwen3-4b", "--shape", "prefill_32k"]
PREFILL_SEQ = 16384
PREFIX = 512  # 7a's prompt length


def mesh_phase(args, check, serve_ref, train_ref, device: str = "cuda"):
    """Phase 9: the language models' mesh paths (``mesh=`` a 1×1
    ``ProcessGrid`` over a 1-rank process group): qwen3-4b served and
    trained at full size (9a), the other nine archs at full width (9b), and
    the LM dry runs of qwen3-4b ``decode_32k`` (9c) and ``prefill_32k``
    (9d).  Only ``"cuda"`` is a
    measurement; another device rehearses the control flow (with
    ``configs.get_config`` patched and a gloo group)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs as TC
    from repro_torch.core.grid import ProcessGrid, release_grids
    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TT
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamW, cosine_schedule, global_norm
    from repro_torch.runtime.sharding import shard_model

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    own = not (dist.is_available() and dist.is_initialized())
    if own:
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    try:
        grid = ProcessGrid(1, 1)

        # --- 9a. qwen3-4b served and trained through the mesh entry points
        sargs = SV.parse_args(SERVE_ARGV + ["--seed", str(args.seed),
                                            "--device", device])
        cfg, params, prompt = SV.setup(sargs)
        max_len = sargs.prompt_len + sargs.gen
        caches = TM.init_cache(cfg, sargs.batch, max_len, device=dev)
        plain, _ = TM.make_prefill_step(cfg)(params, caches, prompt)
        del caches
        params = shard_model(params, grid)
        caches = TM.init_cache(cfg, sargs.batch, max_len, device=dev,
                               mesh=grid, seq_sharded=True)
        logits, _ = TM.make_prefill_step(cfg, mesh=grid)(params, caches, prompt)
        del caches
        plain, logits = plain.cpu(), logits.cpu()
        err = float((logits - plain).abs().max())
        check(bool(torch.isfinite(logits).all()) and bool(
            (logits - plain).abs().le(0.15 + 0.15 * plain.abs()).all())
            and torch.equal(logits.argmax(-1), plain.argmax(-1)),
            f"9a: mesh prefill logits off the plain path's (max |diff| {err})")
        SV.serve(cfg, params, prompt, gen=4, mesh=grid)  # warm-up
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res = SV.serve(cfg, params, prompt, gen=sargs.gen, mesh=grid)
        same = torch.equal(res.tokens, serve_ref["tokens"])
        step_ms = res.decode_ms / res.decode_steps
        rec = {"arch": cfg.name, "grid": list(grid.sizes),
               "batch": sargs.batch, "prompt_len": sargs.prompt_len,
               "gen": sargs.gen, "prefill_logits_max_abs_diff": err,
               "tokens_equal_7a": same, "prefill_ms": res.prefill_ms,
               "prefill_ms_7a": serve_ref["prefill_ms"],
               "decode_step_ms": step_ms,
               "decode_step_ms_7a": serve_ref["decode_step_ms"],
               "tokens_per_s": res.tokens_per_s, "peak_bytes": res.peak_bytes,
               "collective_bytes": grid.reset_collective_bytes()}
        print(f"[mesh] 9a serve {json.dumps(rec)}", flush=True)
        check(same, "9a: the mesh path's greedy tokens differ from 7a's")
        del params, prompt, res, plain, logits
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        opt = AdamW(learning_rate=cosine_schedule(3e-3, 1, TRAIN_STEPS + 1))
        state = TT.make_state(cfg, opt, torch.Generator(device=dev).manual_seed(
            args.seed), mesh=grid, fsdp=True)
        step_fn = TM.make_train_step(cfg, opt, mesh=grid)
        seq = train_ref["seq"]
        data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=1,
                               seq_len=seq, seed=0)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        losses, gnorms, times = [], [], []
        for step in range(MESH_TRAIN_STEPS):
            batch = as_tensors(TT.rank_batch(data, step, grid), dev)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        rel_l = abs(losses[0] - train_ref["loss"]) / abs(train_ref["loss"])
        rel_g = abs(gnorms[0] - train_ref["grad_norm"]) / abs(
            train_ref["grad_norm"])
        rec = {"arch": cfg.name, "grid": list(grid.sizes), "batch": 1,
               "seq": seq, "losses": losses, "grad_norms": gnorms,
               "loss_8a": train_ref["loss"],
               "grad_norm_8a": train_ref["grad_norm"],
               "loss_rel_diff": rel_l, "grad_norm_rel_diff": rel_g,
               "step_ms": times, "step_ms_8a_median": train_ref["step_ms_median"],
               "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
               "peak_bytes_8a": train_ref["peak_bytes"],
               "collective_bytes": grid.reset_collective_bytes()}
        print(f"[mesh] 9a train {json.dumps(rec)}", flush=True)
        check(rel_l <= 1e-5 and rel_g <= 1e-5,
              f"9a: first step (loss, grad_norm) ({losses[0]}, {gnorms[0]}) vs "
              f"8a's ({train_ref['loss']}, {train_ref['grad_norm']})")
        del state, step_fn, m, batch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # --- 9b. the other nine archs at full width, mesh against plain ---
        b, s, ts = MESH_CHECK["batch"], MESH_CHECK["seq"], MESH_CHECK["train_seq"]
        for arch in TC.ARCH_NAMES:
            if arch == "qwen3-4b":
                continue
            t0 = time.perf_counter()
            full = TC.get_config(arch)
            cfg = dataclasses.replace(
                full, n_layers=6 if arch == "gemma3-4b" else 2)
            params = TM.init_params(
                cfg, torch.Generator(device=dev).manual_seed(args.seed))
            rng = np.random.default_rng(args.seed + 3)
            toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, s + 1))
                                    .astype(np.int32)).to(dev)
            if cfg.frontend == "token":
                pre, last = {"tokens": toks[:, :s]}, {"tokens": toks[:, s:]}
            else:
                emb = torch.from_numpy(rng.normal(0, 1, (b, s, cfg.d_model))
                                       ).to(torch.bfloat16).to(dev)
                pre = {"embeddings": emb}
                last = SV.step_input(cfg, params, toks[:, s:])
            outs = []
            for mesh in (None, grid):
                if mesh is not None:
                    params = shard_model(params, grid)
                caches = TM.init_cache(cfg, b, s + 4, device=dev, mesh=mesh,
                                       seq_sharded=mesh is not None)
                lp, _ = TM.make_prefill_step(cfg, mesh=mesh)(params, caches, pre)
                ld, _ = TM.make_serve_step(cfg, mesh=mesh)(params, caches, last, s)
                outs.append((lp.cpu(), ld.cpu()))
                del caches
            serve_err = max(float((x - y).abs().max())
                            for x, y in zip(*outs))
            serve_ok = all(bool(torch.isfinite(y).all()) and bool(
                (y - x).abs().le(0.15 + 0.15 * x.abs()).all()) and torch.equal(
                x.argmax(-1), y.argmax(-1)) for x, y in zip(*outs))
            del params
            model = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(
                args.seed), train=True)
            data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=1,
                                   seq_len=ts, seed=1, frontend=cfg.frontend,
                                   d_model=cfg.d_model)
            batch = as_tensors(data.batch_at(0), dev)
            l0, g0 = TM.loss_and_grads(model, batch, cfg)
            n0 = float(global_norm(g0))
            del g0
            model = shard_model(model, grid, fsdp=True)
            l1, g1 = TM.loss_and_grads(model, batch, cfg, mesh=grid)
            n1 = float(global_norm(g1, grid=grid, specs=model.sharding.specs))
            del g1, model
            rel_l = abs(float(l1) - float(l0)) / abs(float(l0))
            rel_g = abs(n1 - n0) / abs(n0)
            print(f"[mesh] 9b {arch}: {cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}: serve (batch {b}, S {s}, one decode step) "
                  f"max |mesh - plain| {serve_err:.3e}; train (1 x {ts}) loss "
                  f"{float(l1):.6f} vs {float(l0):.6f} (rel {rel_l:.2e}), grad "
                  f"norm {n1:.6f} vs {n0:.6f} (rel {rel_g:.2e}); "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            check(serve_ok, f"9b {arch}: mesh serve logits off the plain "
                  f"path's (max |diff| {serve_err})")
            check(rel_l <= 1e-5 and rel_g <= 1e-5,
                  f"9b {arch}: mesh train loss/grad norm off the plain path's")
            if cuda:
                torch.cuda.empty_cache()

        # --- 9c. the LM dry run of qwen3-4b decode_32k ---
        if cuda:
            t0 = time.perf_counter()
            os.makedirs(os.path.join("build", "chip_smoke"), exist_ok=True)
            with contextlib.redirect_stdout(io.StringIO()):
                rec = DR.main(DRYRUN_ARGV + ["--out", os.path.join(
                    "build", "chip_smoke", "dryrun_qwen3-4b_decode_32k.json")])
            meas = rec["measured"]
            check(meas["finite"] and meas["ms"] > 0,
                  "9c: the dry run's decode step is not finite")
            print(f"[mesh] 9c {json.dumps(rec)} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

            long_prefill_phase(args, check, grid, dev, seq=PREFILL_SEQ)
    finally:
        if own:
            dist.destroy_process_group()
            release_grids()


def long_prefill_phase(args, check, grid, dev, seq=None) -> dict:
    """Phase 9d: the LM dry run's measured ``prefill_32k`` step of qwen3-4b
    at the production grid's rows a rank (``launch/dryrun.py``, as 9c),
    with its prompt cut to ``seq`` tokens if given, its time and peak
    beside its bf16 FLOP bound, then causality: the logits of each row's
    first ``PREFIX`` positions in the long prefill against a
    ``PREFIX``-token prefill of the same tokens, within phase 7's prefill
    tolerance, and all finite.  Returns the dry run's record."""
    import torch

    from repro_torch import configs as TC
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as TM
    from repro_torch.runtime.sharding import shard_model

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rec = DR.main(PREFILL_ARGV + ["--device", dev.type, "--out", os.path.join(
            "build", "chip_smoke", "dryrun_qwen3-4b_prefill_32k.json")]
            + (["--seq", str(seq)] if seq else []))
    meas = rec["measured"]
    flops = meas["roofline"]["flops_per_device"]
    meas["flop_bound_ms"] = flops / BF16_TFLOPS * 1e3
    check(meas["finite"] and meas["ms"] > 0,
          "9d: the dry run's prefill step is not finite")
    # causality: the first PREFIX positions of each row equal a
    # PREFIX-token prefill of the row's first tokens
    cfg = TC.get_config("qwen3-4b")
    rows = meas["rows_per_rank"]
    seq = seq or DR.SHAPES["prefill_32k"].seq_len
    params = shard_model(TM.init_params(cfg, torch.Generator(
        device=dev).manual_seed(args.seed)), grid, fsdp=False)
    toks = SV.make_prompt(cfg, rows, seq, args.seed, dev)["tokens"]
    heads = []
    for s in (seq, PREFIX):
        caches = TM.init_cache(cfg, rows, s, device=dev, mesh=grid,
                               seq_sharded=True)
        x, _ = TM.forward(params, {"tokens": toks[:, :s]}, cfg,
                          mesh=grid, caches=caches, pos=0)
        heads.append(TM.unembed_logits(x[:, :PREFIX],
                                       params.unembed).cpu())
        del x, caches
    long, short = heads
    err = float((long - short).abs().max())
    del params, toks, heads
    print(f"[mesh] 9d {json.dumps(rec)}; logits of positions "
          f"0-{PREFIX - 1} against a {PREFIX}-token prefill: max "
          f"|diff| {err:.4e}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(bool(torch.isfinite(long).all()) and bool(
        (long - short).abs().le(0.15 + 0.15 * short.abs()).all()),
        f"9d: the {seq}-token prefill's first {PREFIX} positions are "
        f"off a {PREFIX}-token prefill's (max |diff| {err})")
    rec["prefix_logits_max_abs_diff"] = err
    return rec


def main() -> None:
    args = parse_args()
    records = kernel_phases(args)
    import torch

    from repro_torch import kernels as K

    # --- 6b. assemble() at bacterial scale ---
    # phases 1-6 returned: their tensors are garbage now
    gc.collect()
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    print(f"[bacterial] {live} bytes allocated before phase 6b", flush=True)
    check(live < 1e9, f"{live} bytes still allocated after phases 1-6")
    bacterial_phase(args, check, records)

    # --- 7. serve ---
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    K.reset_launch_counts()
    serve_ref = serve_phase(args, check)
    check(sum(K.launch_counts().values()) == 0,
          "the language-model path launched a hand kernel")
    print(f"[serve] phase 7 in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 8. train ---
    # phase 7's tensors are garbage now
    gc.collect()
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    print(f"[train] {live} bytes allocated before phase 8", flush=True)
    check(live < 1e9, f"{live} bytes still allocated after phases 1-7")
    t0 = time.perf_counter()
    K.reset_launch_counts()
    train_ref = train_phase(args, check)
    check(sum(K.launch_counts().values()) == 0,
          "the training path launched a hand kernel")
    print(f"[train] phase 8 in {time.perf_counter() - t0:.1f} s (no hand "
          "kernel: JAX's training path reaches no pallas_call)", flush=True)

    # --- 8d. the SSM archs trained at full size ---
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    K.reset_launch_counts()
    ssm_train_phase(args, check)
    check(sum(K.launch_counts().values()) == 0,
          "the SSM training path launched a hand kernel")
    print(f"[train] phase 8d in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 9. the mesh paths on a 1x1 grid ---
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    K.reset_launch_counts()
    mesh_phase(args, check, serve_ref, train_ref)
    check(sum(K.launch_counts().values()) == 0,
          "the mesh paths launched a hand kernel")
    print(f"[mesh] phase 9 in {time.perf_counter() - t0:.1f} s (no hand "
          "kernel: JAX's LM mesh paths reach no pallas_call)", flush=True)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def kernel_phases(args):
    """Phases 1-6; returns the kernels' records."""
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
        from repro_torch.assembly.pipeline import assemble
        from repro_torch.core import backend as B
        from repro_torch.core import summa as SU
        from repro_torch.core.components import (
            connected_components,
            expand_states,
        )
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.core.grid import POD_AXES, ProcessGrid
        from repro_torch.core.spgemm import spgemm, spgemm_masked
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
    cfg = assembly_config(args.genome_kb)
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
    small = simulate(sim, min(20, args.genome_kb), args.seed)
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
    check(launches["kmer_pack"] == 1,
          f"{launches['kmer_pack']} kmer_pack launches for one assembly")
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
        bytes_ = xdrop_bytes(a)
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

    # spgemm_masked: the sampled square of the same R (the TR's square above
    # TR_DENSE_MAX_ROWS; phase 3 stays below it, so phase 6b launches it in
    # the pipeline), held to its plain version and to the torch square
    r = res.r_graph
    m_args = (r.cols, r.vals[MP], r.cols, r.vals[MP], r.cols)
    got = K.spgemm_masked_minplus(*m_args)
    want = K.spgemm_masked_minplus_ref(*m_args)
    core = spgemm_masked(r, r, r, semiring=minplus_orient_semiring).vals[MP]
    check(torch.equal(want, core),
          "spgemm_masked: the plain version differs from the torch square")
    mw = masked_work(*m_args)
    record("spgemm_masked", [got], [want],
           lambda: K.spgemm_masked_minplus(*m_args),
           lambda: K.spgemm_masked_minplus_ref(*m_args),
           mw["t_bytes"] * HBM_BYTES_S, 16 * mw["products"], F32_OPS_S,
           reps=50)
    records[-1]["input"] = (f"phase 3's R: {r.n_rows} rows x {r.capacity} "
                            f"slots, {mw['products']} products")
    del got, want, core, m_args

    # kmer_pack: CountKmer's extraction at the benchmark's one-card cell
    # (its reads from --seed: 14,863 x 13,216 columns, k 15), and on phase
    # 3's reads (a variant).  Bound: the codes read once, 13 bytes written
    # an instance (three int32 words and a bool)
    from portbench.harness import load_cell
    from portbench.readgen import make_reads

    _, _, cell_cfg, cell_traffic = load_cell("hsapiens-gspmd.pb-d10-l7401")
    cell = make_reads(cell_cfg["genome_length"], cell_traffic, args.seed,
                      device="cuda")
    km_cases = [("the one-card cell's reads", cell.codes,
                 cell.lengths.to(torch.int32)),
                ("phase 3's reads", torch.as_tensor(reads.codes).cuda(),
                 torch.as_tensor(reads.lengths).to(torch.int32).cuda())]
    km_recs = []
    for label, kc, kl in km_cases:
        kc, kl = kc.contiguous(), kl.contiguous()
        got = K.kmer_pack(kc, kl, k=cfg.k)
        want = K.kmer_pack_ref(kc, kl, k=cfg.k)
        n_k, w_k = kc.shape
        p_k = w_k - cfg.k + 1
        record("kmer_pack", list(got), list(want),
               lambda: K.kmer_pack(kc, kl, k=cfg.k),
               lambda: K.kmer_pack_ref(kc, kl, k=cfg.k),
               n_k * w_k + 13 * n_k * p_k, 0, I32_OPS_S, reps=20)
        records[-1]["input"] = (f"{label}: {n_k} reads x {w_k} columns, "
                                f"k {cfg.k}, {n_k * p_k} instances")
        km_recs.append(records.pop())
        del got, want
    rec_k = km_recs[0]
    rec_k["variants"] = [{key: km_recs[1][key] for key in (
        "input", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}]
    records.append(rec_k)
    print(f"[kernels] kmer_pack at the cell's shape: {rec_k['ms']:.4f} ms, "
          f"{rec_k['bound_ms'] / rec_k['ms'] * 100:.1f} % of its byte bound",
          flush=True)
    del cell, km_cases, kc, kl

    # pileup: the real consensus call, in three launches: the bin passes
    # (count, device cumsum, fill) and the vote launch
    (draft, pieces, start, plen), kw = captured["consensus"][0]
    mdep = kw["min_depth"]
    got = K.pileup_vote(draft, pieces, start, plen, min_depth=mdep)
    want = K.pileup_vote_ref(draft, pieces, start, plen, min_depth=mdep)
    c, l = draft.shape
    m, lr = pieces.shape[1], pieces.shape[2]
    bytes_, ops, votes, entries, tiles = pileup_work(draft, pieces, start,
                                                     plen)
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
        _, a_cols, _, b_cols, _ = args
        stages, n_a, ka = a_cols.shape
        work = spgemm_work(args, kw, got)
        v = work["per_row"]
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
            "k_b": b_cols.shape[2], "candidates": work["candidates"],
            "b_rows_read": work["b_rows_read"],
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
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
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
    return records


if __name__ == "__main__":
    main()
