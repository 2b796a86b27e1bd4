"""diBELLA 2D pipeline — the paper's Algorithm 1, end to end, in PyTorch.

    reads → k-mer count/select → A, Aᵀ → C = A·Aᵀ (overlap semiring)
          → x-drop alignment on nnz(C) → prune by score → R
          → transitive reduction (Algorithm 2) → S → contigs
          → consensus (pileup polish)

The PyTorch counterpart of ``repro.assembly.pipeline.assemble``.  It runs
on ``PipelineConfig.device``, the card by default; ``device="cpu"`` runs
the plain-torch path on the CPU.  With ``backend="cuda"`` (what ``"auto"``
gives on a card) the x-drop, min-plus, ring-SUMMA stage and pileup hot
loops are the hand-written kernels of ``repro_torch.kernels`` and the
Contigs stage is the device path.  The stats dict carries the keys of the
JAX run, with ``"cuda"`` where JAX reports ``"pallas"``.

``distribution="gspmd"`` is the single-device path.
``distribution="shard_map"`` runs SpGEMM on the ring SUMMA
(``core/summa.py``), Alignment on the block-split bucket
(``core/align_dist.py``) and the Contigs chain stage over the grid rows
(``core/components_dist.py``), on a ``torch.distributed`` process grid:
``cfg.mesh`` (a ``core.grid.ProcessGrid`` on ``("data", "model")`` or
``("pod", "data", "model")``) or, without one, the square grid for SpGEMM
and the P×1 grid for the other two, as JAX's default meshes.  The grid rows
of all three lie on ``cfg.row_axes``: by default the grid's ``("pod",
"data")`` axes, as JAX's ``infer_row_axes`` (on both axes the ring SUMMA
takes its recorded all-gather fallback, as in JAX); ``("data",)`` on a
pod grid leaves the pods as replicas.  Every rank calls ``assemble`` on
the same reads and gets the same result; without a process group the grid
is 1×1.  On a grid of more than one rank TrReduction runs Algorithm 2 on
the grid too (``core/summa.transitive_reduction_shard_map``: R in blocks,
the N = R² square on the ring, the row max over the grid row, the prune
local), with the same S as the local TR; on one rank it stays local, as
in JAX.

Each stage is an ``obs.span``: ``AssemblyResult.timings`` holds the stage
spans' durations, and ``trace=True`` keeps the span tree (stages → steps
and shard_map phases → ``op:<name>`` dispatches → kernel launches, each
with its device interval and device-memory columns) on
``AssemblyResult.trace``.  The steps (``<Stage>.<step>``, kind ``"step"``)
split CountKmer (extract, sort, runs, select), Alignment (candidates,
xdrop, scatter), TrReduction (square and prune, once an iteration),
Contigs (chains, layout, gather on the device path; materialize) and
Consensus (gather, refine, vote).  The SpGEMM and BuildR stage spans carry
``overflow_C`` and ``overflow_R``, the candidates and edges their row
capacities dropped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.align_dist import align_bucket_shard_map
from ..core.backend import resolve_backend, resolve_device, resolve_distribution
from ..core.grid import resolve_grid, resolve_row_axes
from ..core.semiring import overlap_semiring
from ..core.spgemm import spgemm
from ..core.spmat import fill_pad_rows, map_row_blocks, next_pow2
from ..core.summa import (
    overlap_spgemm_shard_map,
    transitive_reduction_shard_map,
)
from ..core.string_graph import (
    build_overlap_graph,
    classify_overlaps,
    drop_contained,
)
from ..core.transitive_reduction import (
    transitive_reduction,
    transitive_reduction_fused,
)
from ..obs import Metrics, Tracer, span, tracing, validated, watermark
from . import alignment as al
from .consensus import polish_contig_set
from .contig_gen import generate_contigs
from .contigs import contig_stats
from .counter import build_matrices, count_and_select, first_semiring
from .kmers import extract_kmers, revcomp

_I32 = torch.int32


@dataclasses.dataclass
class PipelineConfig:
    """Knobs of ``assemble`` — those of the JAX ``PipelineConfig`` the
    port reads, plus ``device``.  ``mesh`` takes a
    ``core.grid.ProcessGrid`` or ``None``."""

    k: int = 15
    lower: int = 2  # reliable k-mer frequency window [lower, upper]
    upper: int = 8
    read_capacity: int = 128  # K_A: reliable k-mers kept per read
    m_capacity: int = 1 << 16  # static bound on reliable-unique k-mers
    overlap_capacity: int = 64  # K_C: candidate overlaps per read
    r_capacity: int = 48  # K_R: overlap-graph row capacity
    min_shared_kmers: int = 2
    # alignment
    xdrop: int = 20
    match: int = 1
    mismatch: int = -1
    gap: int = -1
    band: int = 65
    max_steps: int = 4096
    score_frac: float = 0.35  # accept if score ≥ frac · overlap span
    min_overlap: int = 100
    end_fuzz: int = 40
    # transitive reduction
    tr_fuzz: float = 150.0
    tr_max_iters: int = 8
    fused_tr: bool = True
    align_chunk: int = 4096
    # consensus polishing of the contig tensor
    polish: bool = True
    min_depth: int = 2
    junction_radius: int = 12
    # "reference" (plain torch), "cuda" (hand kernels + device contig
    # path) or "auto" (cuda on a CUDA device, reference on the CPU)
    backend: str = "auto"
    # "gspmd" (one device) or "shard_map" (explicit exchanges on a
    # torch.distributed process grid)
    distribution: str = "gspmd"
    mesh: Any = None
    # grid-row axes of the shard_map stages (None: the grid's ("pod",
    # "data") axes, JAX's infer_row_axes)
    row_axes: Optional[Tuple[str, ...]] = None
    # collect a hierarchical span trace (stage → step or shard_map phase →
    # op → kernel launch) on AssemblyResult.trace; spans also open
    # torch.profiler.record_function ranges named by their labels
    trace: bool = False
    # where the pipeline runs; a CUDA device that is absent raises
    device: str = "cuda"


@dataclasses.dataclass
class AssemblyResult:
    """Graphs, contigs, stats and stage timings of one ``assemble`` run."""

    r_graph: Any  # overlap matrix R (EllMatrix)
    s_graph: Any  # string matrix S (EllMatrix)
    contigs: list  # draft contigs
    stats: Dict[str, Any]
    timings: Dict[str, float]
    contained: Any = None  # (n,) bool
    consensus: Any = None  # ConsensusResult when cfg.polish
    trace: Any = None  # obs.Tracer with the span tree when cfg.trace

    @functools.cached_property
    def polished_contigs(self) -> list:
        """Consensus-polished contigs (the draft when polish is off)."""
        return self.consensus.to_contigs() if self.consensus else self.contigs


def _grid_ranks(cfg: PipelineConfig) -> int:
    """The ranks of the grid the shard_map stages run on."""
    return math.prod(resolve_grid(cfg.mesh, "square").sizes)


def _check_supported(cfg: PipelineConfig) -> None:
    resolve_distribution(cfg.distribution)
    if cfg.mesh is not None:
        resolve_grid(cfg.mesh, "square")  # a ProcessGrid, or raise
    if cfg.row_axes is not None:
        resolve_row_axes(resolve_grid(cfg.mesh, "square"), cfg.row_axes)


@contextlib.contextmanager
def _tic(timings, key):
    """Stage timing as a thin wrapper over :func:`repro_torch.obs.span` —
    the one timing path.  The span synchronises the device of whatever
    the body passes to ``sp.set_output``, so the recorded time covers the
    stage's kernels, and the stage appears in the active tracer's tree."""
    with span(key, kind="stage") as sp:
        yield sp
    timings[key] = timings.get(key, 0.0) + sp.duration_s


def assemble(codes, lengths, cfg: PipelineConfig = PipelineConfig()
             ) -> AssemblyResult:
    """Run the whole pipeline on ``cfg.device``: ``codes`` (n, L) uint8 and
    ``lengths`` (n,) int32 (numpy arrays or tensors).

    The run executes under a device-memory watermark (``obs.memory``), so
    the stats carry the ``peak_hbm_bytes`` family; on a CUDA device the
    allocator's peak is reset first, so the peak is this run's, and an
    untraced call resets it nowhere else.  A traced call (``cfg.trace``)
    resets it as each span opens, to give each span its own peak: after a
    traced call ``torch.cuda.max_memory_allocated`` is the peak since the
    last span opened, while ``stats["peak_hbm_bytes"]`` stays the whole
    run's.  The traced call resolves its tracer (``Tracer.resolve``) once
    the last stage has synchronised."""
    _check_supported(cfg)
    device = resolve_device(cfg.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(annotate=True, device=device) if cfg.trace else None
    with watermark(device) as wm, tracing(tracer):
        res = _assemble(codes, lengths, cfg, device)
    if tracer is not None:
        tracer.resolve()
    res.trace = tracer
    res.stats.update(validated({
        "peak_hbm_bytes": wm.peak_hbm_bytes,
        "hbm_bytes_in_use": wm.hbm_bytes_in_use,
        "hbm_source": wm.source,
    }, context="assemble"))
    return res


def _align_candidates(codes, lengths, c_mat, n, cfg, backend, device):
    """The Alignment stage: compact the live candidates of C into a pow-2
    bucket, extend each pair both ways, scatter back to slot order."""
    kq = c_mat.capacity
    e_total = n * kq
    with span("Alignment.candidates", kind="step", candidates=e_total) as sp:
        pair_i = torch.arange(n, dtype=_I32, device=device)[:, None]
        pair_i = pair_i.expand(n, kq).reshape(-1)
        pair_j = c_mat.cols.reshape(-1)
        cnt = c_mat.vals["cnt"].reshape(-1)
        apos = c_mat.vals["apos"][..., 0].reshape(-1)
        bpos = c_mat.vals["bpos"][..., 0].reshape(-1)
        pv = (pair_j > pair_i) & (cnt >= cfg.min_shared_kmers)

        pa = torch.div(apos, 2, rounding_mode="floor")
        ca = torch.remainder(apos, 2)
        pb = torch.div(bpos, 2, rounding_mode="floor")
        cb = torch.remainder(bpos, 2)
        strand = torch.where(pv, ca ^ cb, 0)
        li = lengths[torch.where(pv, pair_i, 0).to(torch.int64)]
        lj = lengths[torch.where(pv, pair_j, 0).to(torch.int64)]
        pb_or = torch.where(strand == 1, lj - cfg.k - pb, pb)

        # candidate compaction: align only the live slots, padded to the
        # next power of two of their count, then scatter back to slot order
        n_live = int(torch.sum(pv))
        bucket = next_pow2(n_live)
        idx = torch.zeros(bucket, dtype=torch.int64, device=device)
        idx[:n_live] = torch.nonzero(pv).reshape(-1)
        live = torch.arange(bucket, device=device) < n_live
        cand = {
            "i": pair_i[idx],
            "j": pair_j[idx],
            "li": li[idx],
            "lj": lj[idx],
            "pa": torch.clamp(pa[idx], min=0),
            "pb": torch.clamp(pb_or[idx], min=0),
            "strand": strand[idx],
        }
        sp.annotate(n_live=n_live, bucket=bucket)

    with span("Alignment.xdrop", kind="step", n_live=n_live):
        if cfg.distribution == "shard_map":
            res_b, align_stats = align_bucket_shard_map(
                codes, cand, k=cfg.k, mesh=cfg.mesh, row_axes=cfg.row_axes,
                backend=backend, xdrop=cfg.xdrop, match=cfg.match,
                mismatch=cfg.mismatch, gap=cfg.gap, band=cfg.band,
                max_steps=cfg.max_steps, n_live=n_live)
        else:
            res_b = _align_local(codes, cand, bucket, n_live, cfg, backend)
            align_stats = {}

    with span("Alignment.scatter", kind="step", n_live=n_live):
        slots = idx[live]

        def _scatter(x):
            buf = torch.zeros((e_total,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=device)
            buf[slots] = x[live]
            return buf

        res = al.PairAlignment(*(_scatter(x) for x in res_b))
    return (pair_i, pair_j, pv, strand, li, lj, res, n_live, e_total, bucket,
            align_stats)


def _align_local(codes, cand, bucket, n_live, cfg, backend):
    """The single-device x-drop of the bucket, in ``align_chunk`` blocks.

    Only rows ``[0, max(n_live, 1))`` are extended (the last block's fill
    rows have zero lengths and stop at step 0); the pad rows ``>= n_live``
    are copies of row 0's inputs, so they take row 0's result."""
    def _align_block(blk):
        ai = codes[blk["i"].to(torch.int64)]
        bj = codes[blk["j"].to(torch.int64)]
        bj = torch.where((blk["strand"] == 1)[:, None],
                         revcomp(bj, blk["lj"]), bj)
        out = al.batch_extend(
            ai, blk["li"], bj, blk["lj"], blk["pa"], blk["pb"],
            k=cfg.k, backend=backend, xdrop=cfg.xdrop, match=cfg.match,
            mismatch=cfg.mismatch, gap=cfg.gap, band=cfg.band,
            max_steps=cfg.max_steps,
        )
        return tuple(out), None

    n_rows = max(n_live, 1)
    head = {key: x[:n_rows] for key, x in cand.items()}
    res_b, _ = map_row_blocks(_align_block, head, n_rows=n_rows,
                              row_chunk=min(cfg.align_chunk, bucket))
    return tuple(fill_pad_rows(x, n_rows, bucket) for x in res_b)


def _assemble(codes, lengths, cfg: PipelineConfig, device) -> AssemblyResult:
    codes = torch.as_tensor(codes).to(device=device, dtype=torch.uint8)
    lengths = torch.as_tensor(lengths).to(device=device, dtype=_I32)
    n = codes.shape[0]
    backend = resolve_backend(cfg.backend, device)
    timings: Dict[str, float] = {}
    metrics = Metrics(context="assemble")
    metrics.emit("n_reads", int(n))
    metrics.emit("backend", backend)

    # --- CountKmer ---
    with _tic(timings, "CountKmer") as sp:
        kmers = extract_kmers(codes, lengths, k=cfg.k, backend=backend)
        kc = sp.set_output(
            count_and_select(kmers, lower=cfg.lower, upper=cfg.upper))
        del kmers
    metrics.emit_many({
        "m_reliable": int(kc.m_reliable),
        "n_unique_kmers": int(kc.n_unique),
        "n_singletons": int(kc.n_singleton),
    })
    if int(kc.m_reliable) > cfg.m_capacity:
        raise ValueError(
            f"m_capacity too small: {int(kc.m_reliable)} > {cfg.m_capacity}")

    # --- CreateSpMat: A and Aᵀ ---
    with _tic(timings, "CreateSpMat") as sp:
        a, at, ovf_a, _ = build_matrices(
            kc, n_reads=int(n), m_capacity=cfg.m_capacity,
            read_capacity=cfg.read_capacity, kmer_capacity=cfg.upper,
        )
        sp.set_output((a.cols, at.cols))
        del kc
    metrics.emit("overflow_A", int(ovf_a))
    metrics.emit("nnz_A", int(a.nnz()))

    # --- SpGEMM: C = A·Aᵀ under the overlap semiring ---
    shard_map = cfg.distribution == "shard_map"
    with _tic(timings, "SpGEMM") as sp:
        if shard_map:
            c_mat, ovf_c, summa_stats = overlap_spgemm_shard_map(
                a, at, semiring=overlap_semiring,
                operand_semiring=first_semiring,
                capacity=cfg.overlap_capacity, mesh=cfg.mesh,
                row_axes=cfg.row_axes, backend=backend)
        else:
            c_mat, ovf_c = spgemm(a, at, semiring=overlap_semiring,
                                  capacity=cfg.overlap_capacity)
        sp.set_output(c_mat.cols)
        del a, at
    if shard_map:
        metrics.emit("overlap_distribution", "shard_map")
        metrics.emit_many(summa_stats)
    else:
        metrics.emit("overlap_distribution", "gspmd")
    metrics.seed_zero("summa_exchange")
    metrics.emit("overflow_C", int(ovf_c))
    sp.annotate(overflow_C=metrics["overflow_C"])
    metrics.emit("nnz_C", int(c_mat.nnz()))
    metrics.emit("c_density", metrics["nnz_C"] / max(1, int(n)))

    # --- Pairwise alignment on nnz(C) (upper triangle; each pair once) ---
    with _tic(timings, "Alignment") as sp:
        (pair_i, pair_j, pv, strand, li, lj, res, n_live, e_total, bucket,
         align_stats) = _align_candidates(codes, lengths, c_mat, n, cfg,
                                          backend, device)
        sp.set_output(res.score)
    if shard_map:
        metrics.emit("align_distribution", "shard_map")
        metrics.emit_many(align_stats)
    else:
        metrics.emit("align_distribution", "gspmd")
    ospan = torch.minimum(res.ei - res.bi, res.ej - res.bj)
    frac = torch.tensor(cfg.score_frac, dtype=torch.float32, device=device)
    passed = (pv & (res.score.to(torch.float32) >= frac * ospan.to(torch.float32))
              & (ospan >= cfg.min_overlap))
    metrics.seed_zero("align_exchange")
    metrics.emit_many({
        "n_aligned": n_live,
        "align_candidates": e_total,
        "align_bucket": int(bucket),
        "n_passed": int(torch.sum(passed)),
    })

    # --- Build R: classify overlaps, drop contained ---
    with _tic(timings, "BuildR") as sp:
        cls = classify_overlaps(res.bi, res.ei, li, res.bj, res.ej, lj, strand,
                                end_fuzz=cfg.end_fuzz)
        r_mat, contained, ovf_r = build_overlap_graph(
            pair_i, pair_j, cls, passed, n_reads=int(n),
            capacity=cfg.r_capacity,
        )
        r_mat = sp.set_output(drop_contained(r_mat, contained))
    metrics.emit("overflow_R", int(ovf_r))
    sp.annotate(overflow_R=metrics["overflow_R"])
    metrics.emit("nnz_R", int(r_mat.nnz()))
    metrics.emit("r_density", metrics["nnz_R"] / max(1, int(n)))
    metrics.emit("n_contained", int(torch.sum(contained)))

    # --- TrReduction: Algorithm 2 (on the grid where it has several ranks)
    with _tic(timings, "TrReduction") as sp:
        tr_exchange = {}
        if shard_map and _grid_ranks(cfg) > 1:
            s_mat, tr_stats, tr_exchange = transitive_reduction_shard_map(
                r_mat, fuzz=cfg.tr_fuzz, max_iters=cfg.tr_max_iters,
                mesh=cfg.mesh, row_axes=cfg.row_axes, backend=backend)
        else:
            tr = (transitive_reduction_fused if cfg.fused_tr
                  else transitive_reduction)
            s_mat, tr_stats = tr(r_mat, fuzz=cfg.tr_fuzz,
                                 max_iters=cfg.tr_max_iters, backend=backend)
        sp.set_output(s_mat.cols)
    metrics.emit("tr_iterations", int(tr_stats.iterations))
    # the square that ran, as named where it is chosen: one card's in
    # core/transitive_reduction._square_for, the grid's in
    # core/summa.transitive_reduction_shard_map
    metrics.emit("tr_backend", tr_stats.backend)
    metrics.emit("tr_overflow", int(tr_stats.n_overflow))
    metrics.emit_many(tr_exchange)
    metrics.emit("nnz_S", int(s_mat.nnz()))
    metrics.emit("s_density", metrics["nnz_S"] / max(1, int(n)))

    # --- Contigs (host walk or device path) ---
    with _tic(timings, "Contigs") as sp:
        cset = generate_contigs(s_mat, codes, lengths, contained,
                                backend=backend, distribution=cfg.distribution,
                                mesh=cfg.mesh, row_axes=cfg.row_axes)
        with span("Contigs.materialize", kind="step",
                  n_contigs=cset.n_contigs):
            contigs = cset.to_contigs()
            cs = contig_stats(contigs)
        sp.set_output(cset.codes)
    metrics.emit("contigs", dataclasses.asdict(cs))
    metrics.emit("n_branch_cut", cset.stats["n_branch_cut"])
    metrics.emit("cc_iterations", cset.stats["cc_iterations"])
    metrics.emit("distribution", cset.stats["distribution"])
    metrics.emit_many({
        key: val for key, val in cset.stats.items()
        if key.startswith("exchange_")
    })
    metrics.seed_zero("contig_exchange")

    # --- Consensus: pileup polishing of the contig tensor ---
    cres = None
    if cfg.polish:
        with _tic(timings, "Consensus") as sp:
            cres = polish_contig_set(
                cset, codes, lengths, backend=backend,
                min_depth=cfg.min_depth, junction_radius=cfg.junction_radius,
            )
            sp.set_output(cres.codes)
        metrics.emit_many({
            "consensus_depth_mean": cres.stats["consensus_depth_mean"],
            "identity_estimate": cres.stats["identity_estimate"],
            "qv_estimate": cres.stats["qv_estimate"],
            "consensus_changed": cres.stats["n_changed"],
            "n_junction_shifted": cres.stats["n_junction_shifted"],
        })

    return AssemblyResult(
        r_graph=r_mat, s_graph=s_mat, contigs=contigs,
        stats=metrics.as_dict(), timings=timings, contained=contained,
        consensus=cres,
    )
