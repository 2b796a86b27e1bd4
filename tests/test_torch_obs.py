"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

Replays ``tests/test_obs.py`` — span nesting, spans without a tracer,
tracer restore, ``sync`` through dataclasses, watermark nesting, thread
locality, windows closing on error, a failed enter sample, span memory
attributes, the memory opt-out and the Chrome export — against the port,
and drives the traced pipeline: a traced port ``assemble(device="cpu")``
has JAX's eight stage roots in order, ``timings[stage] ==
span.duration_s``, memory attributes on every stage span, and the R, S and
stats of the untraced run; its kernel-launch and phase spans carry the
names the JAX package's spans carry (read from the JAX sources).  All
comparisons are exact; the memory numbers of the CPU fallback are only
checked for their relations (peak ≥ the bytes a test allocated).
"""

import ast
import dataclasses
import gc
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.assembly.pipeline import PipelineConfig as JConfig
from repro.assembly.pipeline import assemble as j_assemble
from repro.assembly.simulate import simulate_genome, simulate_reads
from repro_torch.assembly.pipeline import PipelineConfig, assemble
from repro_torch.core.spmat import ell_equal
from repro_torch.obs import (
    Tracer,
    memory,
    sample,
    schema,
    span,
    span_tree,
    sync,
    to_chrome_trace,
    tracing,
    watermark,
    write_chrome_trace,
)

REPO = Path(__file__).resolve().parent.parent
STAGES = ["CountKmer", "CreateSpMat", "SpGEMM", "Alignment", "BuildR",
          "TrReduction", "Contigs", "Consensus"]
MEM_ATTRS = ("peak_hbm_bytes", "hbm_bytes_in_use", "hbm_delta_bytes",
             "hbm_source")


def _jax_span_names(rel_paths, first_arg, package="repro"):
    """``(first positional arg, kernel= or phase= keyword)`` of every
    ``span(...)`` call in the sources of ``package`` (the JAX package by
    default) whose first argument is ``first_arg`` (or any constant if
    None)."""
    out = set()
    for rel in rel_paths:
        tree = ast.parse((REPO / "src" / package / rel).read_text())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                continue
            name = node.args[0].value
            if first_arg is not None and name != first_arg:
                continue
            kw = {k.arg: k.value.value for k in node.keywords
                  if isinstance(k.value, ast.Constant)}
            out.add((name, kw.get("kernel", kw.get("phase"))))
    return out


# --- spans + tracer -----------------------------------------------------------


def test_span_nesting_builds_tree():
    tr = Tracer()
    with tracing(tr):
        with span("Stage", kind="stage"):
            with span("Phase", kind="phase", phase="ring_stage"):
                with span("kernel_launch", kind="kernel"):
                    pass
            with span("Phase", kind="phase", phase="merge"):
                pass
        with span("Other", kind="stage"):
            pass
    assert [r.name for r in tr.roots] == ["Stage", "Other"]
    stage = tr.roots[0]
    assert [c.attrs["phase"] for c in stage.children] == ["ring_stage", "merge"]
    assert stage.children[0].children[0].name == "kernel_launch"
    assert all(sp.duration_s >= 0 for sp in tr.spans())
    assert len(tr.find("Phase")) == 2


def test_span_works_without_tracer():
    with span("lonely") as sp:
        sp.set_output(torch.arange(4))
    assert sp.duration_s >= 0 and sp.t1 is not None


def test_tracing_restores_previous_tracer():
    outer, inner = Tracer(), Tracer()
    with tracing(outer):
        with tracing(inner):
            with span("in-inner"):
                pass
        with span("in-outer"):
            pass
    assert [r.name for r in inner.roots] == ["in-inner"]
    assert [r.name for r in outer.roots] == ["in-outer"]


def test_sync_descends_plain_dataclasses():
    @dataclasses.dataclass
    class Box:
        arr: object
        nested: object = None

    b = Box(arr=torch.arange(8), nested=Box(arr=torch.ones(3)))
    out = sync([b, {"k": torch.zeros(2)}, (5, "s")])
    assert out[0] is b  # returns its argument


def test_annotate_opens_profiler_ranges():
    """``Tracer(annotate=True)`` mirrors every span into a
    ``torch.profiler.record_function`` range of the same name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing(Tracer(annotate=True, memory=False)):
            with span("Stage", kind="stage"):
                with span("kernel_launch", kind="kernel"):
                    torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"Stage", "kernel_launch"} <= names


# --- watermarks ---------------------------------------------------------------


def test_watermark_measures_allocations():
    with watermark() as wm:
        x = torch.ones((256, 256), dtype=torch.float32)
        sample()
    assert wm.source == "live_buffers"
    assert wm.peak_hbm_bytes >= 256 * 256 * 4
    assert wm.hbm_bytes_in_use >= 0
    del x


def test_watermark_outer_absorbs_nested_samples():
    with watermark() as outer:
        with watermark() as inner:
            x = torch.ones((128, 128), dtype=torch.float32)
            sample()
            del x
    assert inner.peak_hbm_bytes >= 128 * 128 * 4
    assert outer.peak_hbm_bytes >= inner.peak_hbm_bytes
    assert outer.delta_bytes == outer.exit.bytes_in_use - outer.enter.bytes_in_use


def test_live_buffers_count_a_storage_once():
    gc.collect()
    base = memory._live_buffer_bytes()
    x = torch.zeros(1 << 16, dtype=torch.float32)
    views = [x[:10], x.view(256, 256), x[1:]]
    assert memory._live_buffer_bytes() - base == (1 << 16) * 4
    del x, views


def test_watermark_window_closes_on_error():
    with pytest.raises(RuntimeError):
        with watermark():
            raise RuntimeError("boom")
    assert memory._open_watermarks() == []


def test_watermark_windows_are_thread_local():
    with watermark() as wm:
        before = wm.peak_hbm_bytes
        keep = torch.ones(1 << 20)  # noqa: F841 — seen by the other thread
        t = threading.Thread(target=memory.sample)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert wm.peak_hbm_bytes == before


def test_span_survives_enter_sample_failure(monkeypatch):
    def boom(device=None):
        raise RuntimeError("sampling failed")

    monkeypatch.setattr(memory, "sample", boom)
    tr = Tracer()
    with tracing(tr):
        with span("Stage", kind="stage") as sp:
            pass
    assert memory._open_watermarks() == []
    assert tr.roots == [sp]
    assert "peak_hbm_bytes" not in sp.attrs


def test_sample_follows_the_named_device_not_process_state(monkeypatch):
    """The source is chosen by the device the caller names: a CPU window in
    a process whose CUDA allocator is live still counts live tensors, and a
    CUDA device reads that device's allocator stats."""
    asked = []

    def stats(device=None):
        asked.append(device)
        return {"allocated_bytes.all.current": 100,
                "allocated_bytes.all.peak": 300}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", stats)
    for dev in (None, "cpu", torch.device("cpu")):
        with watermark(dev) as wm:
            assert sample(dev).source == "live_buffers"
        assert wm.source == "live_buffers"
    assert asked == []
    s = sample("cuda:1")
    assert (s.bytes_in_use, s.peak_bytes, s.source) == (100, 300,
                                                        "device_stats")
    assert asked == ["cuda:1"]
    tr = Tracer(device="cpu")
    with tracing(tr):
        with span("Stage", kind="stage"):
            pass
    assert tr.roots[0].attrs["hbm_source"] == "live_buffers"
    assert asked == ["cuda:1"]


def test_span_memory_attribution():
    tr = Tracer()
    with tracing(tr):
        with span("Stage", kind="stage"):
            x = torch.ones((64, 64), dtype=torch.float32)
    sp = tr.roots[0]
    for key in MEM_ATTRS:
        assert key in sp.attrs, key
    assert sp.attrs["hbm_source"] == "live_buffers"
    assert sp.attrs["peak_hbm_bytes"] >= sp.attrs["hbm_delta_bytes"] >= 64 * 64 * 4
    del x


def test_tracer_memory_opt_out():
    tr = Tracer(memory=False)
    with tracing(tr):
        with span("Stage", kind="stage"):
            pass
    assert "peak_hbm_bytes" not in tr.roots[0].attrs


# --- export -------------------------------------------------------------------


def test_chrome_trace_export(tmp_path):
    tr = Tracer()
    with tracing(tr):
        with span("Stage", kind="stage"):
            with span("Phase", kind="phase", phase="ring_stage", s=0,
                      t=torch.tensor(3)):
                pass
    path = write_chrome_trace(tr, str(tmp_path / "t.json"))
    doc = json.loads(open(path).read())
    events = doc["traceEvents"]
    assert [e["name"] for e in events] == ["Stage", "Phase"]
    outer, inner = events
    assert outer["ph"] == "X" and inner["ph"] == "X"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert inner["args"]["phase"] == "ring_stage" and inner["args"]["t"] == 3
    assert outer["cat"] == "stage"
    tree = doc["spanTree"]
    assert tree[0]["name"] == "Stage"
    assert tree[0]["children"][0]["attrs"]["phase"] == "ring_stage"
    assert doc == to_chrome_trace(tr)
    assert span_tree(tr.roots[0]) == tree[0]


# --- the traced pipeline ------------------------------------------------------


def _reads():
    """``test_obs.py::test_pipeline_stats_validate_and_trace_tree``'s input."""
    g = simulate_genome(np.random.default_rng(7), 1500)
    return simulate_reads(g, depth=6, mean_len=300, std_len=30, min_len=200,
                          seed=8)


@pytest.fixture(scope="module")
def traced_runs():
    rs = _reads()
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: a thread pool only contends
    try:
        for b in ("reference", "cuda"):
            cfg = PipelineConfig(backend=b, device="cpu")
            out[b] = (assemble(rs.codes, rs.lengths, cfg),
                      assemble(rs.codes, rs.lengths,
                               dataclasses.replace(cfg, trace=True)))
    finally:
        torch.set_num_threads(threads)
    jres = j_assemble(rs.codes, rs.lengths, JConfig(backend="reference",
                                                    trace=True))
    return out, jres


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_traced_assemble_stage_roots_and_timings(traced_runs, backend):
    runs, jres = traced_runs
    plain, traced = runs[backend]
    assert plain.trace is None
    roots = [sp.name for sp in traced.trace.roots]
    assert roots == [sp.name for sp in jres.trace.roots] == STAGES
    for name in roots:
        (sp,) = traced.trace.find(name)
        assert traced.timings[name] == sp.duration_s
        assert sp.attrs["kind"] == "stage"
        for key in MEM_ATTRS:
            assert key in sp.attrs, (name, key)
        assert sp.attrs["hbm_source"] == "live_buffers"
    problems = schema.validate_stats(
        traced.stats, context="assemble",
        require_groups=("contig_exchange", "summa_exchange"))
    assert problems == []


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_traced_assemble_equals_untraced(traced_runs, backend):
    runs, _ = traced_runs
    plain, traced = runs[backend]
    assert ell_equal(plain.r_graph, traced.r_graph)
    assert ell_equal(plain.s_graph, traced.s_graph)
    assert list(plain.stats) == list(traced.stats)
    for key, val in plain.stats.items():
        if key not in ("peak_hbm_bytes", "hbm_bytes_in_use"):
            assert traced.stats[key] == val, key
    assert [(c.reads, c.codes.tobytes()) for c in plain.polished_contigs] == [
        (c.reads, c.codes.tobytes()) for c in traced.polished_contigs]


def test_traced_assemble_op_and_kernel_spans(traced_runs):
    """Each kernel wrapper names its ``kernel_launch`` span as JAX's wrapper
    of the same kernel does; the span opens around a launch only, so a CPU
    run (the plain versions) records none on either backend, while every
    dispatched op still gets its ``op:<name>`` span with its backend."""
    runs, _ = traced_runs
    for k in ("xdrop", "minplus", "pileup", "spgemm", "cc"):
        rel = [f"kernels/{k}/ops.py"]
        port = _jax_span_names(rel, "kernel_launch", package="repro_torch")
        assert port == _jax_span_names(rel, "kernel_launch") != set(), k
    # the fused TR dispatches minplus_dense on the cuda backend only
    for b, extra in (("reference", set()), ("cuda", {"op:minplus_dense"})):
        tr = runs[b][1].trace
        assert tr.find("kernel_launch") == []
        ops = [sp for sp in tr.spans() if sp.name.startswith("op:")]
        assert {sp.name for sp in ops} >= {
            "op:xdrop_extend", "op:contig_gen", "op:consensus"} | extra
        assert {sp.attrs["backend"] for sp in ops} == {b}


def test_chrome_trace_of_a_traced_run_loads(traced_runs, tmp_path):
    tr = traced_runs[0]["cuda"][1].trace
    doc = json.loads(open(write_chrome_trace(tr, str(tmp_path / "run.json"))).read())
    assert [n["name"] for n in doc["spanTree"]] == STAGES
    # one host event a span on tid 0; a resolved span (on the CPU, every
    # one) has its device interval on tid 1 besides
    host = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["tid"] == 0]
    assert len(host) == len(list(tr.spans()))
    device = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["tid"] == 1]
    assert len(device) == sum(sp.device_s is not None for sp in tr.spans())
    assert all(e["dur"] > 0 for e in host + device)


def test_shard_map_phase_spans_carry_jax_phase_names():
    """The shard_map path (one process: a 1×1 grid) opens the phase spans
    JAX's ``core/summa.py``, ``core/align_dist.py`` and
    ``core/components_dist.py`` open, with the same names and ``phase``
    values; their labels are ``<name>.<phase>``, and they run inside their
    stage's steps."""
    jax_phases = _jax_span_names(["core/summa.py", "core/align_dist.py",
                                  "core/components_dist.py"], None)
    jax_phases = {p for p in jax_phases if p[0] != "kernel_launch"}
    rs = _reads()
    cfg = PipelineConfig(backend="cuda", device="cpu",
                         distribution="shard_map", trace=True, polish=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: a thread pool only contends
    try:
        res = assemble(rs.codes, rs.lengths, cfg)
    finally:
        torch.set_num_threads(threads)
    got = {(sp.name, sp.attrs["phase"]) for sp in res.trace.spans()
           if sp.attrs.get("kind") == "phase"}
    assert got == jax_phases
    for sp in res.trace.spans():
        if sp.attrs.get("kind") in ("phase", "step"):
            stage = next(r for r in res.trace.roots if sp in list(r.walk()))
            assert sp.label.split(".")[0] == stage.name
        if sp.attrs.get("kind") == "phase":
            assert stage.name == sp.name
            assert sp.label == f"{sp.name}.{sp.attrs['phase']}"
    # the phases run inside the steps, and SpGEMM's give the labels the
    # benchmark reads (step_s.SpGEMM.*)
    labels = set(res.trace.summary())
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    spgemm = {m["name"][len("step_s."):] for m in bench["per_layer"]
              if m["name"].startswith("step_s.SpGEMM.")}
    assert spgemm == {"SpGEMM.distribute", "SpGEMM.ring",
                      "SpGEMM.collect_merge"} and spgemm <= labels
    (xdrop,) = res.trace.find("Alignment.xdrop")
    assert {sp.label for sp in xdrop.walk()} >= {"Alignment.pair_exchange",
                                                 "Alignment.extend"}
    (chains,) = res.trace.find("Contigs.chains")
    assert "Contigs.chain_stage" in {sp.label for sp in chains.walk()}
