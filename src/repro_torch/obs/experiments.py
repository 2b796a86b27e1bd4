"""Declarative experiment engine: cached runs + append-only perf trajectory.

The port's own copy of ``repro.obs.experiments`` (the JAX module imports no
JAX, but the port imports nothing of ``repro``), with the same contract:

* an :class:`Experiment` is a declarative spec — a runner module key, its
  kwargs, and the backend/distribution axis labels it covers;
* its :func:`experiment_id` is a stable hash of that spec **plus a code
  fingerprint** (:func:`code_fingerprint` over the source files the result
  depends on), so editing the benchmark or the library invalidates exactly
  the affected cache entries and an untouched tree re-runs for free;
* the :class:`ExperimentEngine` keeps one JSON result file per experiment
  id under ``.bench_cache/`` and appends every *new* ``(experiment_id,
  row)`` pair to a trajectory store (``bench/trajectory.jsonl`` by
  default) — append-only, one record per experiment row per code snapshot;
  :func:`load_bench_snapshots` reads the older one-file-per-PR
  ``BENCH_<n>.json`` snapshots as history.

Every record carries :data:`REQUIRED_RECORD_FIELDS`.  In the port
:func:`measure` makes such a record for a callable on a device: ``ms`` is
the steady call's time, ``compile_ms`` the first call's extra time over the
steady one (a kernel's build and load included), ``peak_hbm_bytes`` the
highest reading of :mod:`repro_torch.obs.memory` over the calls (the CUDA
allocator's peak on a card, live tensor bytes on the CPU).
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import torch

#: record fields every trajectory row must carry (the engine fails loudly on
#: a runner that drops one — a silently thinner record must not cache).
REQUIRED_RECORD_FIELDS = ("name", "ms", "compile_ms", "peak_hbm_bytes")


def _canonical(obj: Any) -> str:
    """Deterministic JSON for hashing (sorted keys, no whitespace)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=repr)


def code_fingerprint(paths: Iterable[str],
                     root: Optional[str] = None) -> str:
    """Stable hex digest of the contents of every file under ``paths``.

    Directories are walked recursively (``.py`` files only, sorted), plain
    files are hashed as-is; missing paths contribute their name so a
    deleted dependency still changes the fingerprint.  File names enter
    the digest *relative to* ``root`` (default: the common parent of
    ``paths``) with ``/`` separators, so two checkouts of the same tree —
    different machines, different absolute paths — agree on the
    fingerprint and can share ``.bench_cache/`` entries and trajectory
    dedup keys."""
    h = hashlib.sha256()
    abs_paths = sorted(os.path.abspath(p) for p in paths)
    if root is None and abs_paths:
        root = os.path.commonpath(abs_paths)
        if not os.path.isdir(root):
            root = os.path.dirname(root)
    for path in abs_paths:
        if os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, "**", "*.py"),
                                     recursive=True))
        else:
            files = [path]
        for f in files:
            rel = os.path.relpath(f, root) if root else f
            h.update(rel.replace(os.sep, "/").encode())
            try:
                with open(f, "rb") as fh:
                    h.update(fh.read())
            except OSError:
                h.update(b"<missing>")
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One declarative experiment: runner key, kwargs, and axis labels.

    ``module`` names the runner (a key of the caller's registry of
    benchmark runners); ``kwargs`` are passed to it
    verbatim; ``axes`` are the backend/distribution labels the experiment
    pins, folded into the id so the same module under a different axis is a
    different cache entry."""

    module: str
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    axes: Mapping[str, str] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        """Human-readable ``module[axis=value,...]`` tag for reports."""
        ax = ",".join(f"{k}={v}" for k, v in sorted(self.axes.items()))
        return f"{self.module}[{ax}]" if ax else self.module

    def spec(self) -> Dict[str, Any]:
        """The experiment as a plain JSON-able dict (hashed for the id)."""
        return {
            "module": self.module,
            "kwargs": dict(self.kwargs),
            "axes": dict(self.axes),
        }


def experiment_id(exp: Experiment, fingerprint: str) -> str:
    """Stable id: hash of the experiment spec + the code fingerprint."""
    h = hashlib.sha256()
    h.update(_canonical(exp.spec()).encode())
    h.update(fingerprint.encode())
    return h.hexdigest()[:16]


def validate_records(records: List[Mapping[str, Any]],
                     context: str) -> List[str]:
    """Check every record carries :data:`REQUIRED_RECORD_FIELDS`."""
    problems = []
    for rec in records:
        for field in REQUIRED_RECORD_FIELDS:
            if field not in rec:
                problems.append(
                    f"{context}: record {rec.get('name', '?')!r} "
                    f"missing required field {field!r}")
    return problems


def load_bench_snapshots(root: str) -> List[Dict[str, Any]]:
    """Legacy history: every committed ``BENCH_<n>.json`` as trajectory rows.

    Each file becomes one snapshot (labelled by its basename); its records
    are passed through unchanged, so pre-memory/pre-split rows simply lack
    the newer fields — consumers gate on field presence."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "BENCH_*.json"))):
        try:
            with open(path) as f:
                records = json.load(f)
        except (OSError, ValueError):
            continue
        snap = os.path.splitext(os.path.basename(path))[0]
        for rec in records:
            if isinstance(rec, dict) and "name" in rec:
                out.append({"snapshot": snap, **rec})
    return out


class ExperimentEngine:
    """Cached experiment runs + the append-only perf trajectory.

    ``runner(experiment)`` must return a list of record dicts (one per
    benchmark row, each carrying :data:`REQUIRED_RECORD_FIELDS`).  Results
    are cached under ``cache_dir/<experiment_id>.json``; because the id
    folds in the code fingerprint, a cache hit means *this exact code and
    spec already ran* — ``run()`` then serves the cached records without
    executing anything, and ``todo()`` reports only fingerprint-fresh
    pending experiments."""

    def __init__(
        self,
        experiments: Iterable[Experiment],
        runner: Callable[[Experiment], List[Dict[str, Any]]],
        *,
        cache_dir: str = ".bench_cache",
        trajectory_path: str = os.path.join("bench", "trajectory.jsonl"),
        fingerprint: str = "",
    ):
        self.experiments = list(experiments)
        self.runner = runner
        self.cache_dir = cache_dir
        self.trajectory_path = trajectory_path
        self.fingerprint = fingerprint

    # -- cache ------------------------------------------------------------

    def id_of(self, exp: Experiment) -> str:
        """The content-addressed id of ``exp`` under the engine's
        fingerprint."""
        return experiment_id(exp, self.fingerprint)

    def _cache_path(self, exp: Experiment) -> str:
        return os.path.join(self.cache_dir, self.id_of(exp) + ".json")

    def cached(self, exp: Experiment) -> Optional[Dict[str, Any]]:
        """The cached result document for ``exp``, or None on a miss."""
        try:
            with open(self._cache_path(exp)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def todo(self) -> List[Experiment]:
        """Experiments with no cached result at the current fingerprint."""
        return [e for e in self.experiments if self.cached(e) is None]

    # -- run --------------------------------------------------------------

    def run(
        self,
        only: Optional[Iterable[str]] = None,
        force: bool = False,
        log: Callable[[str], None] = lambda msg: None,
    ) -> Dict[str, Any]:
        """Run pending experiments (cache hits are served, not re-run).

        ``only`` restricts to the given module keys; ``force`` re-runs even
        on a hit.  Returns ``{"records", "fresh_records", "ran", "hits",
        "wall_s"}`` (``fresh_records`` = rows produced by this invocation,
        the trajectory delta); every fresh result is written to the cache
        and its rows appended to the trajectory store (deduplicated on
        ``(experiment_id, name)``)."""
        t_start = time.perf_counter()
        selected = [e for e in self.experiments
                    if only is None or e.module in set(only)]
        ran, hits, all_records, fresh_records = [], [], [], []
        for exp in selected:
            eid = self.id_of(exp)
            doc = None if force else self.cached(exp)
            if doc is not None:
                hits.append(exp)
                log(f"# cache hit {exp.label} ({eid})")
                all_records.extend(doc["records"])
                continue
            log(f"# running {exp.label} ({eid})")
            t0 = time.perf_counter()
            records = self.runner(exp)
            wall_s = time.perf_counter() - t0
            problems = validate_records(records, exp.label)
            if problems:
                raise ValueError("; ".join(problems))
            # stamp provenance into the records themselves (not only the
            # trajectory rows): the regression gate uses the fingerprint to
            # exclude a fresh run's own rows from its baseline
            for rec in records:
                rec.setdefault("experiment_id", eid)
                rec.setdefault("fingerprint", self.fingerprint)
            doc = {
                "experiment_id": eid,
                "spec": exp.spec(),
                "fingerprint": self.fingerprint,
                "created": time.time(),
                "wall_s": wall_s,
                "records": records,
            }
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(self._cache_path(exp), "w") as f:
                json.dump(doc, f, indent=1)
            self._append_trajectory(eid, records)
            ran.append(exp)
            all_records.extend(records)
            fresh_records.extend(records)
        return {
            "records": all_records,
            "fresh_records": fresh_records,
            "ran": [e.label for e in ran],
            "hits": [e.label for e in hits],
            "wall_s": time.perf_counter() - t_start,
        }

    # -- trajectory -------------------------------------------------------

    def load_trajectory(self) -> List[Dict[str, Any]]:
        """Every record of the trajectory store (empty when absent)."""
        out = []
        try:
            with open(self.trajectory_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except OSError:
            pass
        return out

    def _append_trajectory(self, eid: str,
                           records: List[Dict[str, Any]]) -> int:
        seen = {(r.get("experiment_id"), r.get("name"))
                for r in self.load_trajectory()}
        fresh = [r for r in records if (eid, r.get("name")) not in seen]
        if not fresh:
            return 0
        os.makedirs(os.path.dirname(self.trajectory_path) or ".",
                    exist_ok=True)
        with open(self.trajectory_path, "a") as f:
            for rec in fresh:
                row = {
                    "experiment_id": eid,
                    "fingerprint": self.fingerprint,
                    "ts": round(time.time(), 3),
                    **rec,
                }
                f.write(json.dumps(row, sort_keys=True) + "\n")
        return len(fresh)

    # -- report / csv -----------------------------------------------------

    def report_rows(self) -> List[Dict[str, Any]]:
        """One summary row per experiment: cache state + record count."""
        rows = []
        for exp in self.experiments:
            doc = self.cached(exp)
            rows.append({
                "experiment": exp.label,
                "id": self.id_of(exp),
                "state": "cached" if doc else "pending",
                "records": len(doc["records"]) if doc else 0,
                "wall_s": round(doc["wall_s"], 2) if doc else None,
            })
        return rows

    def csv_rows(self) -> List[List[Any]]:
        """Header + one CSV row per cached benchmark record."""
        header = ["experiment", "name", "ms", "compile_ms",
                  "peak_hbm_bytes", "hbm_source", "derived"]
        rows: List[List[Any]] = [header]
        for exp in self.experiments:
            doc = self.cached(exp)
            if doc is None:
                continue
            for rec in doc["records"]:
                rows.append([
                    exp.label, rec.get("name"), rec.get("ms"),
                    rec.get("compile_ms"), rec.get("peak_hbm_bytes"),
                    rec.get("hbm_source"), rec.get("derived"),
                ])
        return rows


def measure(name: str, fn: Callable[[], Any], *, device=None, reps: int = 3,
            **fields: Any) -> Dict[str, Any]:
    """One trajectory record of ``fn()`` on ``device``: the first call and
    ``reps`` steady calls, each timed to the end of the device work it
    produced (``obs.sync`` on its output).  ``ms`` is the mean steady call,
    ``compile_ms`` the first call's time less ``ms`` (at least 0),
    ``peak_hbm_bytes`` / ``hbm_source`` the watermark over all calls (on
    the CPU, sampled at its ends and once after the first call, while that
    output is live);
    ``fields`` are added to the record."""
    from .memory import sample, watermark
    from .trace import sync

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with watermark(device) as w:
        t0 = time.perf_counter()
        out = sync(fn())
        first = time.perf_counter() - t0
        sample(device)  # while the output is live
        del out
        t0 = time.perf_counter()
        for _ in range(reps):
            sync(fn())
        steady = (time.perf_counter() - t0) / max(reps, 1)
    return {"name": name, "ms": steady * 1e3,
            "compile_ms": max(0.0, first - steady) * 1e3,
            "peak_hbm_bytes": w.peak_hbm_bytes, "hbm_source": w.source,
            **fields}
