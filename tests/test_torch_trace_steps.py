"""The port's step spans, span clock and own memory peaks
(``repro_torch.obs.trace``), and the benchmark's two readers of them
(``portbench/metrics/step_s.py``, ``portbench/metrics/own_peak_gib.py``),
on the CPU.

A traced ``assemble(device="cpu")`` on the ``cuda`` backend (the device
contig path, each kernel's plain version) is profiled with
``torch.profiler`` as the benchmark profiles it: the steps nest under their
stages with their labels and host counts, every stage and step range of
the profile lies on the span's own interval on the shared clock, no span
keeps its output, and the result and stats equal an untraced run's.  The
allocator side of the own peaks (a reset as each span opens) and the
device events are held on a fake allocator and fake events, since the CPU
has neither.
"""

import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro.assembly.simulate import simulate_genome, simulate_reads
from repro_torch.assembly.counter import count_and_select
from repro_torch.assembly.kmers import extract_kmers
from repro_torch.assembly.pipeline import PipelineConfig, assemble
from repro_torch.core.spmat import ell_equal
from repro_torch.obs import (
    Span,
    Tracer,
    last_summary,
    memory,
    span,
    to_chrome_trace,
    tracing,
    watermark,
)

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402
from portbench.metrics import own_peak_gib, step_s  # noqa: E402

STAGES = ["CountKmer", "CreateSpMat", "SpGEMM", "Alignment", "BuildR",
          "TrReduction", "Contigs", "Consensus"]
STEPS = {
    "CountKmer": ["CountKmer.extract", "CountKmer.sort", "CountKmer.runs",
                  "CountKmer.select"],
    "Alignment": ["Alignment.candidates", "Alignment.xdrop",
                  "Alignment.scatter"],
    "TrReduction": ["TrReduction.square", "TrReduction.prune"],
    "Contigs": ["Contigs.chains", "Contigs.layout", "Contigs.gather",
                "Contigs.materialize"],
}
MEMORY_KEYS = ("peak_hbm_bytes", "hbm_bytes_in_use", "hbm_source")
WINDOW = "test.assembly"


def _reads():
    g = simulate_genome(np.random.default_rng(7), 1500)
    return simulate_reads(g, depth=6, mean_len=300, std_len=30, min_len=200,
                          seed=8)


@contextlib.contextmanager
def _one_thread():
    """Small ops: a thread pool only contends (with the other test
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An untraced and a profiled traced run of the same reads, with the
    labels of every span whose ``set_output`` was called."""
    rs = _reads()
    cfg = PipelineConfig(backend="cuda", device="cpu")
    outputs = []
    real = Span.set_output

    def recording(self, out):
        outputs.append(self.label)
        return real(self, out)

    with _one_thread(), pytest.MonkeyPatch.context() as mp:
        plain = assemble(rs.codes, rs.lengths, cfg)
        mp.setattr(Span, "set_output", recording)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(WINDOW):
                traced = assemble(rs.codes, rs.lengths,
                                  dataclasses.replace(cfg, trace=True))
    path = tmp_path_factory.mktemp("profile") / "profile.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    return {"reads": rs, "plain": plain, "traced": traced, "profile": doc,
            "outputs": outputs, "summary": last_summary()}


def _stage_of(tracer, sp):
    return next(r for r in tracer.roots if any(x is sp for x in r.walk()))


# --- step spans in a traced assemble() -----------------------------------------


@pytest.mark.parametrize("stage", sorted(STEPS))
def test_step_spans_nest_under_their_stage(runs, stage):
    tr = runs["traced"].trace
    assert [r.name for r in tr.roots] == STAGES
    steps = [sp for sp in tr.spans() if sp.attrs.get("kind") == "step"
             and sp.name.startswith(stage + ".")]
    labels = [sp.label for sp in steps]
    if stage == "TrReduction":
        iters = runs["traced"].stats["tr_iterations"]
        assert labels == STEPS[stage] * iters
        assert [sp.attrs["iter"] for sp in steps] == [
            i for i in range(iters) for _ in range(2)]
        path = {"cuda": "minplus", "cuda_masked": "masked",
                "reference": "ell"}[runs["traced"].stats["tr_backend"]]
        assert {sp.attrs["path"] for sp in steps} == {path}
    else:
        assert labels == STEPS[stage]
    for sp in steps:
        assert sp.name == sp.label  # a step's label is its name
        assert _stage_of(tr, sp).name == stage
        assert sp.t0 >= _stage_of(tr, sp).t0 and sp.t1 <= _stage_of(tr, sp).t1


def test_step_attributes_are_the_host_counts(runs):
    res, rs = runs["traced"], runs["reads"]
    tr = res.trace
    (ext,) = tr.find("CountKmer.extract")
    width = np.asarray(rs.codes).shape[1]
    assert ext.attrs["instances"] == len(rs.lengths) * (width - 15 + 1)
    assert ext.attrs["kind"] == "step"
    assert ext.attrs["path"] == "torch"  # the plain version: a CPU run
    for name in STEPS["CountKmer"][1:]:
        assert tr.find(name)[0].attrs["instances"] == ext.attrs["instances"]
    (cand,) = tr.find("Alignment.candidates")
    assert cand.attrs["n_live"] == res.stats["n_aligned"]
    assert cand.attrs["candidates"] == res.stats["align_candidates"]
    assert cand.attrs["bucket"] == res.stats["align_bucket"]
    prunes = tr.find("TrReduction.prune")
    squares = tr.find("TrReduction.square")
    assert prunes[-1].attrs["nnz"] == res.stats["nnz_S"]
    assert [sq.attrs["nnz"] for sq in squares[1:]] == [
        p.attrs["nnz"] for p in prunes[:-1]]
    (mat,) = tr.find("Contigs.materialize")
    (gat,) = tr.find("Contigs.gather")
    assert mat.attrs["n_contigs"] == gat.attrs["n_contigs"] == len(res.contigs)


@pytest.mark.parametrize("source", ["assemble", "all_valid", "some_invalid"])
def test_runs_step_counts_the_runs(runs, source):
    """``CountKmer.runs`` carries ``runs``, the number of runs of the
    sorted instances: one a distinct valid k-mer, and one more for the
    invalid instances' sentinel when there are any."""
    if source == "assemble":
        rs = runs["reads"]
        (sp,) = runs["traced"].trace.find("CountKmer.runs")
        n_unique = runs["traced"].stats["n_unique_kmers"]
        cfg = PipelineConfig(device="cpu")
        valid = extract_kmers(torch.from_numpy(np.asarray(rs.codes)),
                              torch.from_numpy(np.asarray(rs.lengths)),
                              k=cfg.k)["valid"]
        assert not bool(valid.all())  # the reads' lengths differ
    else:
        rng = np.random.default_rng(11)
        keys = torch.from_numpy(rng.integers(0, 40, (6, 9)).astype(np.int32))
        valid = torch.ones(6, 9, dtype=torch.bool)
        if source == "some_invalid":
            valid[:, 7:] = False
        kmers = {"hi": keys, "lo": keys * 3, "strand": torch.zeros_like(keys),
                 "pos": torch.zeros_like(keys), "valid": valid}
        with tracing(Tracer(device="cpu", memory=False)) as tr:
            kc = count_and_select(kmers)
        (sp,) = tr.find("CountKmer.runs")
        n_unique = int(kc.n_unique)
        assert n_unique == len(set(keys[valid].tolist()))
    assert sp.attrs["runs"] == n_unique + int(not bool(valid.all()))
    assert type(sp.attrs["runs"]) is int


def test_benchmark_names_every_step_span(runs):
    """The benchmark's ``step_s.*`` metrics of the four stages are the step
    labels a traced run opens, no more and no fewer."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    named = {m["name"][len("step_s."):] for m in bench["per_layer"]
             if m["name"].startswith("step_s.")
             and m["layer"] == "Stage steps (step spans)"}
    opened = {sp.label for sp in runs["traced"].trace.spans()
              if sp.attrs.get("kind") == "step"}
    assert named == opened == {x for v in STEPS.values() for x in v}


# --- TrReduction on a 2x2 grid of four gloo ranks -----------------------------

GRID_CELL = "hsapiens-summa-2x2.pb-d10-l7401"
TR_STEPS = {"TrReduction.square", "TrReduction.prune"}
TR_PHASES = {"TrReduction.distribute", "TrReduction.collect"}


@pytest.fixture(scope="module")
def tr_grid(tmp_path_factory):
    """A traced ``assemble(distribution="shard_map")`` on every rank of a
    2x2 grid (``tests/_torch_dist.job_tr_grid``)."""
    from _torch_dist import run_ranks

    rs = _reads()
    return rs, run_ranks(4, "job_tr_grid",
                         {"codes": rs.codes, "lengths": rs.lengths,
                          "cfg": {"backend": "cuda"}, "small_capacity": 1,
                          "fault_fuzz": 150.0},
                         tmp_path_factory.mktemp("tr_grid_spans"))


@pytest.mark.dist
def test_grid_tr_opens_its_phases_and_the_local_steps(tr_grid):
    """The distributed TR opens ``TrReduction.distribute``, then a
    ``square`` and a ``prune`` step a pass (the local TR's labels, with
    ``path="ring"``; the ring's own phases nest in ``square``), then
    ``TrReduction.collect``."""
    for out in tr_grid[1]:
        iters = out["stats"]["tr_iterations"]
        assert iters >= 2
        top = [s for s in out["spans"] if s[0] in TR_STEPS | TR_PHASES]
        assert [s[0] for s in top] == (
            ["TrReduction.distribute"]
            + ["TrReduction.square", "TrReduction.prune"] * iters
            + ["TrReduction.collect"])
        assert [s[1] for s in top] == ["phase"] + ["step"] * 2 * iters + [
            "phase"]
        assert [s[2] for s in top[1:-1]] == [
            i for i in range(iters) for _ in range(2)]
        assert {s[3] for s in top[1:-1]} == {"ring"}
        assert sum(s[0] == "TrReduction.ring" for s in out["spans"]) == iters
        # the ring's phases take the stage's name, not SpGEMM's
        assert not any(s[0].startswith("SpGEMM") for s in out["spans"])


@pytest.mark.dist
def test_grid_tr_counts_the_words_its_rings_rotate(tr_grid):
    """``tr_exchange_words`` / ``_rounds``: one rotation a pass on 2x2,
    each shipping the rank's whole R block twice (as A panel and as B
    panel; a slot is a column id and four min-plus values), as
    ``bench_comm_model.words_summa`` counts a ring SUMMA."""
    from benchmarks.bench_comm_model import words_summa

    rs, outs = tr_grid
    n_pad = -(-rs.codes.shape[0] // 2) * 2
    k = PipelineConfig().r_capacity
    for out in outs:
        st = out["stats"]
        iters = st["tr_iterations"]
        assert st["tr_exchange_rounds"] == iters
        assert st["tr_exchange_words"] == iters * words_summa(
            n_rows=n_pad, a_block_slots=k, a_words_per_slot=5, m_rows=n_pad,
            b_block_slots=k, b_words_per_slot=5, pr=2, pc=2)
        assert st["tr_overflow"] == 0 and st["tr_backend"] == "ring_reference"


@pytest.mark.dist
def test_benchmark_names_spans_the_grid_opens(tr_grid):
    """Every ``step_s.*`` metric of the 2x2 cell names a label that the
    traced grid run opens."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    named = {m["name"][len("step_s."):] for m in bench["per_layer"]
             if m["name"].startswith("step_s.")
             and GRID_CELL in m.get("workloads", [])}
    assert TR_PHASES | TR_STEPS <= named
    for out in tr_grid[1]:
        assert named <= set(out["labels"])


def test_spans_keep_no_output_and_steps_never_synchronise(runs):
    tr = runs["traced"].trace
    assert all(sp._out is None for sp in tr.spans())
    assert set(runs["outputs"]) == set(STAGES)  # only the stage spans
    assert not any(sp.attrs.get("kind") == "step" and sp.label in
                   runs["outputs"] for sp in tr.spans())


def test_traced_and_untraced_results_and_stats_agree(runs):
    plain, traced = runs["plain"], runs["traced"]
    assert ell_equal(plain.r_graph, traced.r_graph)
    assert ell_equal(plain.s_graph, traced.s_graph)
    assert bool(torch.equal(plain.contained, traced.contained))
    assert [(c.reads, c.codes.tobytes()) for c in plain.polished_contigs] == [
        (c.reads, c.codes.tobytes()) for c in traced.polished_contigs]
    assert list(plain.stats) == list(traced.stats)
    for key, val in plain.stats.items():
        if key not in MEMORY_KEYS:
            assert traced.stats[key] == val, key
    # the stats carry no timing, so the benchmark's digests of a window's
    # assemblies compare equal
    assert not [k for k in traced.stats if k.endswith(("_s", "_ms"))
                or "time" in k]
    assert list(traced.timings) == list(plain.timings) == STAGES


def test_untraced_assemble_opens_no_event_and_resets_no_peak(monkeypatch, runs):
    def refuse(*args, **kwargs):
        raise AssertionError("an untraced run touched the device telemetry")

    for name in ("Event", "reset_peak_memory_stats", "memory_stats",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    rs = runs["reads"]
    with _one_thread():
        res = assemble(rs.codes, rs.lengths,
                       PipelineConfig(backend="cuda", device="cpu"))
    assert res.trace is None
    assert ell_equal(res.s_graph, runs["plain"].s_graph)


def test_profile_ranges_lie_on_the_span_intervals(runs):
    """Every stage and step span's ``record_function`` range lies within
    0.2 ms of the span's own interval, both put on the profiler's clock
    (``ts`` + ``baseTimeNanoseconds``, ``CLOCK_REALTIME``)."""
    doc, tr = runs["profile"], runs["traced"].trace
    base = doc["baseTimeNanoseconds"]
    ranges = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = e["ts"] * 1e3 + base
            ranges.setdefault(e["name"], []).append((a, a + e["dur"] * 1e3))
    spans = {}
    for sp in tr.spans():
        if sp.attrs.get("kind") in ("stage", "step"):
            spans.setdefault(sp.label, []).append(sp)
    assert set(spans) <= set(ranges)
    worst = 0.0
    for label, sps in spans.items():
        got = sorted(ranges[label])
        assert len(got) == len(sps), label
        for sp, (a, b) in zip(sps, got):
            worst = max(worst, abs(a - tr.clock_ns(sp.t0)),
                        abs(b - tr.clock_ns(sp.t1)))
    assert worst < 0.2e6, f"{worst / 1e3:.1f} us"


def test_summary_sums_repeated_labels(runs):
    tr = runs["traced"].trace
    summary = tr.summary()
    assert runs["summary"] == summary  # what the benchmark reads
    iters = runs["traced"].stats["tr_iterations"]
    for label in STEPS["TrReduction"]:
        sps = [sp for sp in tr.spans() if sp.label == label]
        row = summary[label]
        assert row["count"] == iters == len(sps)
        assert row["host_s"] == pytest.approx(sum(sp.duration_s for sp in sps),
                                              abs=1e-12)
        # on the CPU the device interval is the host interval, and a step
        # takes no memory sample (the live-tensor scan is costly)
        assert row["device_s"] == pytest.approx(row["host_s"], abs=1e-12)
        assert row["own_peak_hbm_bytes"] is None
        assert not any("own_peak_hbm_bytes" in sp.attrs for sp in sps)
    stages = [sp for sp in tr.spans() if sp.attrs.get("kind") == "stage"]
    assert {sp.label for sp in stages} == set(STAGES)
    for sp in stages:
        assert summary[sp.label]["own_peak_hbm_bytes"] == sp.attrs[
            "own_peak_hbm_bytes"] <= sp.attrs["peak_hbm_bytes"]
    for row in summary.values():
        assert all(v is None or type(v) in (int, float) for v in row.values())


def test_phase_spans_take_their_label_in_the_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing(Tracer(annotate=True, memory=False)) as tr:
            with span("SpGEMM", kind="stage"):
                with span("SpGEMM", kind="phase", phase="distribute") as sp:
                    torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"SpGEMM", "SpGEMM.distribute", "trace.anchor"} <= names
    assert sp.name == "SpGEMM" and sp.label == "SpGEMM.distribute"
    assert set(tr.summary()) == {"SpGEMM", "SpGEMM.distribute"}


# --- own peaks, events and the clock --------------------------------------------


def test_own_and_running_peaks_on_the_cpu_path():
    """A parent with two children: the first child allocates more than the
    second and frees it.  Each span's own peak is its window's, the
    running ``peak_hbm_bytes`` keeps the first child's peak."""
    big, small = 1 << 22, 1 << 20
    tr = Tracer(device="cpu")
    with tracing(tr):
        with span("Parent") as parent:
            with span("A") as a:
                x = torch.ones(big, dtype=torch.uint8)
            del x
            with span("B") as b:
                y = torch.ones(small, dtype=torch.uint8)
    del y
    pa, aa, ba = parent.attrs, a.attrs, b.attrs

    def enter(attrs):
        return attrs["hbm_bytes_in_use"] - attrs["hbm_delta_bytes"]

    assert aa["own_peak_hbm_bytes"] - enter(aa) >= big
    assert ba["own_peak_hbm_bytes"] - enter(ba) >= small
    assert ba["own_peak_hbm_bytes"] < aa["own_peak_hbm_bytes"]
    assert pa["own_peak_hbm_bytes"] == max(aa["own_peak_hbm_bytes"],
                                           ba["own_peak_hbm_bytes"])
    assert ba["peak_hbm_bytes"] == aa["peak_hbm_bytes"] == aa["own_peak_hbm_bytes"]
    assert pa["peak_hbm_bytes"] == tr.peak_hbm_bytes == aa["own_peak_hbm_bytes"]


class _FakeCard:
    """An allocator and a stream clock for ``torch.cuda``'s telemetry."""

    def __init__(self, current, peak):
        self.current, self.peak, self.resets = current, peak, 0

    def alloc(self, n):
        self.current += n
        self.peak = max(self.peak, self.current)

    def stats(self, device=None):
        return {"allocated_bytes.all.current": self.current,
                "allocated_bytes.all.peak": self.peak}

    def reset(self, device=None):
        self.peak, self.resets = self.current, self.resets + 1


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    card = _FakeCard(current=1000, peak=5000)
    monkeypatch.setattr(torch.cuda, "memory_stats", card.stats)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", card.reset)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    return card


@pytest.mark.parametrize("stale", [5000, 1000])
def test_own_peaks_on_a_planned_allocation_pattern(fake_card, stale):
    """Parent → A (allocates 3000 and frees it) → B (allocates 2000 and
    keeps it).  The allocator's peak before the parent opened is
    ``stale``; each span resets the peak after folding its enter sample
    into every open window, so own peaks are the windows' and the running
    peak keeps the stale one."""
    fake_card.peak = stale
    tr = Tracer(device="cuda:0")
    with watermark("cuda:0") as whole, tracing(tr):
        with span("Parent") as parent:
            with span("A") as a:
                fake_card.alloc(3000)
                fake_card.alloc(-3000)
            with span("Parent.b", kind="step") as b:  # a step samples here
                fake_card.alloc(2000)
    assert fake_card.resets == 3
    own = [sp.attrs["own_peak_hbm_bytes"] for sp in (parent, a, b)]
    assert own == [4000, 4000, 3000]
    running = max(stale, 4000)
    assert [sp.attrs["peak_hbm_bytes"] for sp in (a, b, parent)] == [running] * 3
    assert {sp.attrs["hbm_source"] for sp in (parent, a, b)} == {"device_stats"}
    assert whole.peak_hbm_bytes == running
    assert _FakeEvent.made == 1 + 2 * 3  # the anchor, then two a span


def test_resolve_places_device_intervals_on_the_host_clock(fake_card):
    tr = Tracer(device="cuda:0", memory=False)
    with tracing(tr):
        with span("Stage", kind="stage") as st:
            with span("Stage.step", kind="step") as sp:
                time.sleep(0.002)
    assert st.device_s is None and len(tr._events) == 2
    tr.resolve()
    assert tr._events == []
    for s in (st, sp):
        # the fake events are stamped on perf_counter: the device interval
        # must come out on the span's own clock
        assert abs(s.device_t0 - s.t0) < 1e-3 and abs(s.device_t1 - s.t1) < 1e-3
    assert sp.device_s >= 0.002
    assert last_summary() == tr.summary()
    assert last_summary()["Stage.step"]["device_s"] == sp.device_s


def test_chrome_export_puts_host_and_device_on_the_shared_clock():
    tr = Tracer(memory=False)
    with tracing(tr):
        with span("Stage", kind="stage") as st:
            with span("Stage.step", kind="step"):
                pass
    doc = to_chrome_trace(tr)
    assert not [e for e in doc["traceEvents"] if e.get("tid") == 1]
    tr.resolve()
    doc = to_chrome_trace(tr)
    base = doc["baseTimeNanoseconds"]
    host = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["tid"] == 0]
    device = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["tid"] == 1]
    assert [e["name"] for e in host] == [e["name"] for e in device] == [
        "Stage", "Stage.step"]
    assert abs(host[0]["ts"] * 1e3 + base - tr.clock_ns(st.t0)) < 1e3
    # the clock is CLOCK_REALTIME, as torch.profiler's
    assert abs(tr.clock_ns(time.perf_counter()) - time.time_ns()) < 5e6
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert names == {"host", "device"}


def test_clock_follows_a_wall_clock_stepped_between_its_anchors(monkeypatch):
    """The wall clock is stepped 5 ms forward while a traced region runs.
    The profiler maps its clock by the line through its start and its
    stop; ``clock_ns`` takes the line through its anchor pairs of
    activation and resolve, so host times fall on the profiler's line and
    not up to the step off it."""
    real = time.time_ns
    step = [0]
    monkeypatch.setattr(time, "time_ns", lambda: real() + step[0])
    tr = Tracer(memory=False)
    with tracing(tr):
        with span("Stage", kind="stage"):
            time.sleep(0.002)
            step[0] = 5_000_000
            time.sleep(0.002)
    (pc0, w0) = tr.anchor
    assert tr.end_anchor is None
    tr.resolve()
    (pc1, w1) = tr.end_anchor
    assert abs(w1 - w0 - (pc1 - pc0) * 1e9 - 5e6) < 0.5e6  # the step
    assert tr.clock_ns(pc0) == w0 and abs(tr.clock_ns(pc1) - w1) <= 1
    assert abs(tr.clock_ns(0.5 * (pc0 + pc1)) - 0.5 * (w0 + w1)) <= 1


def test_span_failing_enter_sample_resets_nothing(monkeypatch, fake_card):
    def boom(device=None):
        raise RuntimeError("sampling failed")

    monkeypatch.setattr(memory, "sample", boom)
    tr = Tracer(device="cuda:0")
    with tracing(tr):
        with span("Stage", kind="stage") as sp:
            pass
    assert fake_card.resets == 0 and memory._open_watermarks() == []
    assert "own_peak_hbm_bytes" not in sp.attrs


# --- the benchmark's readers ------------------------------------------------------


@pytest.mark.parametrize("reader,name", [(step_s, "step_s.CountKmer.sort"),
                                         (own_peak_gib, "own_peak_gib.SpGEMM")])
def test_readers_give_none_without_a_trace(reader, name):
    run = harness.RunRecord(timings=[{"CountKmer": 1.0}])
    assert reader.reads(name)
    assert reader.read(name, run) is None


def test_readers_read_the_last_traced_summary(monkeypatch):
    tr = Tracer(device="cpu")
    with tracing(tr):
        with span("SpGEMM", kind="stage"):
            with span("SpGEMM", kind="phase", phase="ring"):
                pass
    tr.resolve()
    run = harness.RunRecord(timings=[], trace=object())
    row = tr.summary()
    assert step_s.read("step_s.SpGEMM.ring", run) == row["SpGEMM.ring"]["device_s"]
    assert own_peak_gib.read("own_peak_gib.SpGEMM", run) == (
        row["SpGEMM"]["own_peak_hbm_bytes"] / 2**30)
    assert step_s.read("step_s.Contigs.gather", run) is None
    # a program without the summary (the parent of this change) gives none
    import repro_torch.obs as obs

    monkeypatch.delattr(obs, "last_summary")
    assert step_s.read("step_s.SpGEMM.ring", run) is None
    assert own_peak_gib.read("own_peak_gib.SpGEMM", run) is None


def test_each_new_metric_has_exactly_one_reader():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    mods = harness.readers()
    new = [m["name"] for m in bench["per_layer"]
           if m["name"].startswith(("step_s.", "own_peak_gib."))]
    assert len(new) == 13 + 3 + 2 + 8
    for name in new:
        rd = harness.reader_for(name, mods)
        assert rd is (step_s if name.startswith("step_s.") else own_peak_gib)
    assert {m["name"][len("own_peak_gib."):] for m in bench["per_layer"]
            if m["name"].startswith("own_peak_gib.")} == set(STAGES)
