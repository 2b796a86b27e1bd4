"""Declared metric schema for the pipeline's stats surface.

This is the port's own copy of ``repro.obs.schema``: the registry, the
zero groups and the validators are the same, key for key, but for the
port's own keys :data:`PORT_ONLY`, so a stats dict of the PyTorch pipeline
validates exactly where the JAX one does (``tests/test_torch_foundation.py``
holds the two registries equal outside :data:`PORT_ONLY`).

Every key the assembly pipeline emits into ``AssemblyResult.stats`` — and
every key the distributed sub-stages feed it through (``ContigSet.stats``,
``summa_ring``'s stats dict, ``TRStats``'s flattened ``tr_*`` fields) — is
registered here as a :class:`MetricSpec` with a kind, a unit and, where the
paper's accounting contract demands it, a *present-and-zero* guarantee:
exchange counters exist on **every** path and are zero where no explicit
exchange runs (gspmd auto-sharding, host walk), so distribution-axis
benchmark rows compare without key-existence checks (DESIGN.md §2.10).

The zero contracts used to be scattered: a hardcoded dict in
``assembly/contig_gen.py``, inline literals in ``core/summa.py`` and
``assembly/pipeline.py``, and per-test key tuples in ``tests/test_contigs``
/ ``tests/test_summa_dist``.  They are now derived from this registry in
one place (:func:`zero_defaults`) and validated in one place
(:func:`validate_stats`); ``tests/test_obs.py`` parametrizes over the
gspmd / shard_map / host emission paths.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Dict, List, Mapping, Optional, Tuple

#: kinds a metric can declare: monotone event/volume counts, point-in-time
#: measurements, categorical strings, and nested stat dicts.
KINDS = ("counter", "gauge", "label", "group")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One registered metric: its kind, unit and contract.

    ``zero_group`` names the present-and-zero contract the key belongs to
    (``"contig_exchange"``, ``"summa_exchange"``, ``"align_exchange"``) —
    every key of a group is
    emitted on every path, zero where the phase did not run — or ``None``
    for keys without a presence guarantee."""

    name: str
    kind: str
    unit: str
    description: str
    zero_group: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"{self.name}: unknown metric kind {self.kind!r}")


def _c(name, unit, desc, zero_group=None):
    return MetricSpec(name, "counter", unit, desc, zero_group)


def _g(name, unit, desc):
    return MetricSpec(name, "gauge", unit, desc)


def _l(name, desc):
    return MetricSpec(name, "label", "label", desc)


_SPECS: Tuple[MetricSpec, ...] = (
    # --- pipeline-wide ---
    _c("n_reads", "reads", "input reads"),
    _l("backend", "resolved kernel backend (reference|cuda)"),
    # --- device-memory watermark (obs/memory.py) ---
    _c("peak_hbm_bytes", "bytes",
       "device-memory high-water mark over the assemble window "
       "(allocator peak_bytes_in_use, or the sampled live-buffer peak on "
       "backends without memory_stats)"),
    _c("hbm_bytes_in_use", "bytes",
       "device memory in use when the assemble window closed"),
    _l("hbm_source", "memory sampling path that produced the watermark "
       "(device_stats|live_buffers)"),
    # --- CountKmer ---
    _c("m_reliable", "kmers", "reliable k-mers kept (paper's |M|)"),
    _c("n_unique_kmers", "kmers", "distinct k-mers seen"),
    _c("n_singletons", "kmers", "k-mers seen exactly once"),
    # --- CreateSpMat ---
    _c("overflow_A", "entries", "A entries dropped by K_A row capacity"),
    _c("nnz_A", "entries", "nonzeros of the reads x kmers matrix A"),
    # --- SpGEMM / ring SUMMA (core/summa.py) ---
    _l("overlap_distribution", "overlap-stage distribution (gspmd|shard_map)"),
    _l("summa_algorithm", "SUMMA variant that ran (ring|allgather_fallback)"),
    _l("summa_fallback_reason", "why the ring routed to all-gather"),
    _l("summa_backend", "ring-stage op backend that ran (reference|cuda)"),
    _c("summa_stages", "stages", "ring pipeline stages (pc = sqrt(P))"),
    _c("exchange_words_summa", "words",
       "4-byte words per device moved by the ring SUMMA ppermutes "
       "(paper Table I W = am/sqrt(P))", "summa_exchange"),
    _c("exchange_rounds_summa", "rounds",
       "ppermute rotations issued by the ring SUMMA", "summa_exchange"),
    _c("spgemm_hbm_round_trips", "trips",
       "device-memory round trips of what ran "
       "(the cuda kernel: ceil(pc/stages_per_call))"),
    _c("spgemm_hbm_round_trips_reference", "trips",
       "HBM round trips of the per-stage reference path (= pc)"),
    _c("overflow_C", "entries", "candidate entries dropped by K_C capacity"),
    _c("nnz_C", "entries", "nonzeros of the candidate matrix C = A*At"),
    _g("c_density", "entries/read", "nnz_C per read"),
    # --- Alignment (core/align_dist.py distributed x-drop) ---
    _c("n_aligned", "pairs", "live candidate pairs aligned"),
    _c("align_candidates", "slots", "candidate slots (n * K_C)"),
    _c("align_bucket", "slots", "pow-2 compacted alignment bucket size"),
    _c("n_passed", "pairs", "pairs passing the score/length gates"),
    _l("align_distribution",
       "alignment-stage distribution (gspmd|shard_map)"),
    _c("exchange_words_align", "words",
       "per-device words of the alignment stage's explicit exchanges "
       "(read-row ring gather + score-scatter allreduce, "
       "bench_comm_model.words_align)", "align_exchange"),
    _c("exchange_rounds_align", "rounds",
       "explicit exchange rounds of the alignment stage (ring hops + the "
       "scatter allreduce)", "align_exchange"),
    # --- BuildR ---
    _c("overflow_R", "entries", "overlap entries dropped by K_R capacity"),
    _c("nnz_R", "entries", "nonzeros of the overlap graph R"),
    _g("r_density", "entries/read", "nnz_R per read"),
    _c("n_contained", "reads", "reads dropped as contained"),
    # --- TrReduction (TRStats flattened) ---
    _c("tr_iterations", "iterations", "Algorithm 2 passes to fixed point"),
    _l("tr_backend", "TR path that actually ran (cuda: the dense min-plus "
       "kernel, n <= TR_DENSE_MAX_ROWS; cuda_masked: the sampled min-plus "
       "kernel above it; reference: the torch-ops ELL square; "
       "ring_cuda|ring_reference|allgather on a grid of several ranks)"),
    _c("tr_overflow", "rows", "rows overflowing the sampled-square capacity"),
    # the port's own: Algorithm 2 on the grid (core/summa.py)
    _c("tr_exchange_words", "words",
       "words a rank sent in the ring rotations of the distributed TR"),
    _c("tr_exchange_rounds", "rounds",
       "ring rotations of the distributed TR, summed over its passes"),
    _c("nnz_S", "entries", "nonzeros of the string matrix S"),
    _g("s_density", "entries/read", "nnz_S per read"),
    # --- Contigs (ContigSet.stats) ---
    MetricSpec("contigs", "group", "dict",
               "contig_stats summary (nested dict)"),
    _c("n_branch_cut", "edges", "state-graph edges removed by the branch cut"),
    _c("cc_iterations", "iterations", "pointer-doubling rounds to converge"),
    _l("distribution", "contig-stage partitioning that ran "
       "(gspmd|shard_map|host)"),
    _c("exchange_words", "words",
       "total per-device words of the contig stage's explicit exchanges",
       "contig_exchange"),
    _c("exchange_rounds", "rounds",
       "total explicit exchange rounds of the contig stage",
       "contig_exchange"),
    _c("exchange_words_cut", "words",
       "branch-cut allreduce words (CUT_ALLREDUCES ring allreduces)",
       "contig_exchange"),
    _c("exchange_words_doubling", "words",
       "doubling-middle ring all-gather words", "contig_exchange"),
    _c("exchange_words_sort", "words",
       "ring-bitonic chain-sort merge-split words", "contig_exchange"),
    _c("exchange_rounds_doubling", "rounds",
       "doubling-middle exchange rounds", "contig_exchange"),
    _c("exchange_rounds_sort", "rounds",
       "chain-sort exchange stages (+1 eligibility gather)",
       "contig_exchange"),
    # --- Consensus ---
    _g("consensus_depth_mean", "votes", "mean pileup depth over re-called "
       "columns"),
    _g("identity_estimate", "ratio", "estimated per-base identity of the "
       "polished contigs"),
    _g("qv_estimate", "phred", "Phred-scaled identity estimate"),
    _c("consensus_changed", "columns", "contig columns changed by polishing"),
    _c("n_junction_shifted", "junctions",
       "chain junctions re-anchored by the shift search"),
)

#: name -> spec for every registered metric.
SCHEMA: Dict[str, MetricSpec] = {s.name: s for s in _SPECS}

#: the keys only the port emits (the JAX package keeps TrReduction local):
#: emitted where TrReduction runs on a grid of several ranks, absent elsewhere
PORT_ONLY: Tuple[str, ...] = ("tr_exchange_words", "tr_exchange_rounds")

#: the declared present-and-zero groups (see :class:`MetricSpec`).
ZERO_GROUPS: Tuple[str, ...] = tuple(sorted(
    {s.zero_group for s in _SPECS if s.zero_group}
))


def spec(name: str) -> MetricSpec:
    """The :class:`MetricSpec` registered for ``name`` (KeyError if none)."""
    return SCHEMA[name]


def is_registered(name: str) -> bool:
    """Whether ``name`` is a registered metric."""
    return name in SCHEMA


def group_keys(zero_group: str) -> Tuple[str, ...]:
    """Keys bound to a present-and-zero group, in registration order."""
    keys = tuple(s.name for s in _SPECS if s.zero_group == zero_group)
    if not keys:
        raise KeyError(f"unknown zero group {zero_group!r}; "
                       f"known: {ZERO_GROUPS}")
    return keys


def zero_defaults(zero_group: str) -> Dict[str, int]:
    """The present-and-zero seed dict for a group — the single source the
    emitters start from (``assembly/contig_gen.ZERO_EXCHANGE_STATS`` and the
    pipeline's summa seeding are both derived from this)."""
    return {k: 0 for k in group_keys(zero_group)}


def _kind_ok(kind: str, value: Any) -> bool:
    if kind == "counter":
        return (isinstance(value, numbers.Integral)
                and not isinstance(value, bool))
    if kind == "gauge":
        return (isinstance(value, numbers.Real)
                and not isinstance(value, bool))
    if kind == "label":
        return value is None or isinstance(value, str)
    if kind == "group":
        return isinstance(value, Mapping)
    return False  # pragma: no cover - KINDS is closed


def validate_stats(
    stats: Mapping[str, Any],
    *,
    context: str = "stats",
    require_groups: Tuple[str, ...] = (),
) -> List[str]:
    """Validate a stats dict against the registry; return violations.

    Checks: every key is registered; every value matches its declared kind
    (counters integral, gauges real, labels str-or-None, groups mappings);
    and every key of each group in ``require_groups`` is present (the
    present-and-zero contract).  An empty list means clean."""
    out = []
    for key, val in stats.items():
        s = SCHEMA.get(key)
        if s is None:
            out.append(f"{context}: unregistered stats key {key!r}")
        elif not _kind_ok(s.kind, val):
            out.append(
                f"{context}: {key} = {val!r} is not a valid {s.kind} "
                f"({s.unit})"
            )
    for grp in require_groups:
        for key in group_keys(grp):
            if key not in stats:
                out.append(
                    f"{context}: missing {grp} present-and-zero key {key!r}"
                )
    return out
