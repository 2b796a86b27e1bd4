"""The port's experiment engine (``repro_torch.obs.experiments``): each case
of ``tests/test_experiments.py`` on the port's copy — content-addressed
ids, cached runs, the append-only trajectory store, and legacy snapshot
history — plus ``measure``, which makes a record on a device.

The engine is exercised against a stub runner (no benchmarks executed) so
the tests pin the *caching contract*: same code + spec never re-runs, any
fingerprint or spec change invalidates exactly the affected entries, a
record that drops a required field fails loudly instead of caching thin,
and trajectory rows deduplicate on ``(experiment_id, name)``."""

import json
import os

import pytest
import torch

from repro_torch.obs.experiments import (
    REQUIRED_RECORD_FIELDS,
    Experiment,
    ExperimentEngine,
    code_fingerprint,
    experiment_id,
    load_bench_snapshots,
    measure,
    validate_records,
)


def _rec(name, ms=1.0, peak=1024):
    return {"name": name, "ms": ms, "compile_ms": 2.0,
            "peak_hbm_bytes": peak, "derived": ""}


def _engine(tmp_path, runner, fingerprint="fp0", experiments=None):
    if experiments is None:
        experiments = [Experiment("alpha", {"n": 1}, {"backend": "ref"}),
                       Experiment("beta", {}, {})]
    return ExperimentEngine(
        experiments, runner,
        cache_dir=str(tmp_path / "cache"),
        trajectory_path=str(tmp_path / "traj.jsonl"),
        fingerprint=fingerprint,
    )


# ---------------------------------------------------------------------------
# ids + fingerprint
# ---------------------------------------------------------------------------


def test_experiment_id_stable_and_spec_sensitive():
    a = Experiment("tr", {"sweep": (256,)}, {"backend": "ref"})
    b = Experiment("tr", {"sweep": (256,)}, {"backend": "ref"})
    assert experiment_id(a, "fp") == experiment_id(b, "fp")
    assert experiment_id(a, "fp") != experiment_id(a, "fp2")
    c = Experiment("tr", {"sweep": (512,)}, {"backend": "ref"})
    d = Experiment("tr", {"sweep": (256,)}, {"backend": "pallas"})
    ids = {experiment_id(e, "fp") for e in (a, c, d)}
    assert len(ids) == 3


def test_experiment_label():
    assert Experiment("tr").label == "tr"
    e = Experiment("contigs", {}, {"distribution": "shard_map"})
    assert e.label == "contigs[distribution=shard_map]"


def test_code_fingerprint_tracks_py_edits(tmp_path):
    (tmp_path / "a.py").write_text("x = 1\n")
    (tmp_path / "notes.txt").write_text("ignored\n")
    fp1 = code_fingerprint([str(tmp_path)])
    assert fp1 == code_fingerprint([str(tmp_path)])  # deterministic
    (tmp_path / "notes.txt").write_text("still ignored\n")
    assert code_fingerprint([str(tmp_path)]) == fp1  # non-.py files inert
    (tmp_path / "a.py").write_text("x = 2\n")
    assert code_fingerprint([str(tmp_path)]) != fp1


def test_code_fingerprint_checkout_location_invariant(tmp_path):
    """Two checkouts of the same tree at different absolute paths agree on
    the fingerprint (paths hash relative to the tree root), so cache
    entries and trajectory dedup keys survive across machines."""
    for co in ("checkout_a", "deeper/checkout_b"):
        d = tmp_path / co
        d.mkdir(parents=True)
        (d / "a.py").write_text("x = 1\n")
        (d / "sub").mkdir()
        (d / "sub" / "b.py").write_text("y = 2\n")
    fp_a = code_fingerprint([str(tmp_path / "checkout_a")])
    fp_b = code_fingerprint([str(tmp_path / "deeper" / "checkout_b")])
    assert fp_a == fp_b
    # an explicit root (the engine passes the repo root) matches the
    # default common-parent behaviour for a single-tree path list
    assert code_fingerprint([str(tmp_path / "checkout_a")],
                            root=str(tmp_path / "checkout_a")) == fp_a
    # ... but file *names* still matter: renaming changes the fingerprint
    os.rename(str(tmp_path / "checkout_a" / "a.py"),
              str(tmp_path / "checkout_a" / "a2.py"))
    assert code_fingerprint([str(tmp_path / "checkout_a")]) != fp_a


def test_validate_records_reports_each_missing_field():
    rec = {"name": "r"}
    problems = validate_records([rec], "ctx")
    assert len(problems) == len(REQUIRED_RECORD_FIELDS) - 1
    assert all("ctx" in p for p in problems)
    assert validate_records([_rec("ok")], "ctx") == []


# ---------------------------------------------------------------------------
# cached runs
# ---------------------------------------------------------------------------


def test_run_caches_and_todo_empties(tmp_path):
    calls = []

    def runner(exp):
        calls.append(exp.module)
        return [_rec(f"{exp.module}/row")]

    eng = _engine(tmp_path, runner)
    assert len(eng.todo()) == 2
    out = eng.run()
    assert sorted(calls) == ["alpha", "beta"]
    assert len(out["records"]) == 2
    ids = {eng.id_of(e) for e in eng.experiments}
    for rec in out["records"]:  # provenance stamped into the records
        assert rec["fingerprint"] == "fp0"
        assert rec["experiment_id"] in ids
    assert out["fresh_records"] == out["records"]
    assert out["hits"] == []
    assert eng.todo() == []  # the CI cache-hit gate
    # second run: pure cache reads, runner untouched
    out2 = eng.run()
    assert sorted(calls) == ["alpha", "beta"]
    assert len(out2["records"]) == 2
    assert out2["fresh_records"] == []
    assert len(out2["hits"]) == 2 and out2["ran"] == []


def test_force_and_only_filters(tmp_path):
    calls = []

    def runner(exp):
        calls.append(exp.module)
        return [_rec(f"{exp.module}/row")]

    eng = _engine(tmp_path, runner)
    eng.run(only={"alpha"})
    assert calls == ["alpha"]
    assert [e.module for e in eng.todo()] == ["beta"]
    eng.run(only={"alpha"}, force=True)
    assert calls == ["alpha", "alpha"]


def test_fingerprint_change_invalidates_cache(tmp_path):
    runner = lambda exp: [_rec(f"{exp.module}/row")]  # noqa: E731
    _engine(tmp_path, runner, fingerprint="fp0").run()
    stale = _engine(tmp_path, runner, fingerprint="fp1")
    assert len(stale.todo()) == 2  # every entry is fingerprint-fresh


def test_thin_record_fails_loudly_and_does_not_cache(tmp_path):
    def runner(exp):
        return [{"name": f"{exp.module}/row", "ms": 1.0}]  # no compile/peak

    eng = _engine(tmp_path, runner)
    with pytest.raises(ValueError, match="compile_ms"):
        eng.run(only={"alpha"})
    assert any(e.module == "alpha" for e in eng.todo())  # still pending


# ---------------------------------------------------------------------------
# trajectory store
# ---------------------------------------------------------------------------


def test_trajectory_rows_annotated_and_deduplicated(tmp_path):
    runner = lambda exp: [_rec(f"{exp.module}/row")]  # noqa: E731
    eng = _engine(tmp_path, runner)
    eng.run()
    rows = eng.load_trajectory()
    assert len(rows) == 2
    for row in rows:
        assert row["experiment_id"] in {eng.id_of(e) for e in eng.experiments}
        assert row["fingerprint"] == "fp0"
        assert "ts" in row
        for field in REQUIRED_RECORD_FIELDS:
            assert field in row
    # force re-run at the same fingerprint: same (id, name) pairs, no growth
    eng.run(force=True)
    assert len(eng.load_trajectory()) == 2
    # a new fingerprint is a new snapshot: rows append, history preserved
    _engine(tmp_path, runner, fingerprint="fp1").run()
    assert len(eng.load_trajectory()) == 4


def test_report_and_csv_rows(tmp_path):
    runner = lambda exp: [_rec(f"{exp.module}/row")]  # noqa: E731
    eng = _engine(tmp_path, runner)
    eng.run(only={"alpha"})
    states = {r["experiment"]: r["state"] for r in eng.report_rows()}
    assert states == {"alpha[backend=ref]": "cached", "beta": "pending"}
    rows = eng.csv_rows()
    assert rows[0][:4] == ["experiment", "name", "ms", "compile_ms"]
    assert [r[1] for r in rows[1:]] == ["alpha/row"]


def test_load_bench_snapshots_reads_legacy_history(tmp_path):
    (tmp_path / "BENCH_1.json").write_text(json.dumps(
        [{"name": "a", "ms": 1.0}]))
    (tmp_path / "BENCH_2.json").write_text(json.dumps(
        [{"name": "a", "ms": 2.0, "compile_ms": 1.0}, {"no_name": True}]))
    (tmp_path / "BENCH_bad.json").write_text("not json")
    rows = load_bench_snapshots(str(tmp_path))
    assert [(r["snapshot"], r["ms"]) for r in rows] == [
        ("BENCH_1", 1.0), ("BENCH_2", 2.0)]
    assert load_bench_snapshots(str(tmp_path / "nowhere")) == []


# ---------------------------------------------------------------------------
# measure: a record of a callable on a device
# ---------------------------------------------------------------------------


def test_measure_makes_a_complete_record(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(1 << 16, dtype=torch.float32) * len(calls)

    rec = measure("ones", fn, device="cpu", reps=2, backend="reference")
    assert validate_records([rec], "measure") == []
    assert len(calls) == 3  # the first call and two steady ones
    assert rec["ms"] >= 0 and rec["compile_ms"] >= 0
    assert rec["hbm_source"] == "live_buffers"
    assert rec["peak_hbm_bytes"] >= 4 << 16  # the output was live
    assert rec["backend"] == "reference"
    eng = _engine(tmp_path, lambda exp: [rec])
    assert len(eng.run()["records"]) == 2
