"""The benchmark's ``<Stage>_roofline_grid`` reader
(``portbench/metrics/roofline_grid.py``) on the CPU: on one rank it reads
``<Stage>_roofline``; in a four-rank world (``torch.distributed``
stubbed) a quarter of it; nothing without a trace; and each of its names
has exactly one reader."""

import json
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402
from portbench.devtrace import Summary  # noqa: E402
from portbench.metrics import roofline, roofline_grid  # noqa: E402

STAGES = ("SpGEMM", "Alignment", "TrReduction")
WORK = {
    "SpGEMM": {"ops": 2.0e9, "op_type": "int32", "bytes": 4.0e8},
    "Alignment": {"ops": 8.0e11, "op_type": "int32", "bytes": 1.0e9},
    "TrReduction": {"ops": 1.6e8, "op_type": "f32", "bytes": 3.0e9},
}


def _run(trace=True):
    summary = Summary(window_s=1.0, busy_s=0.9,
                      stage_device_s={"SpGEMM": 0.05, "Alignment": 0.125,
                                      "TrReduction": 0.0625},
                      span_peaks={}, device_ops=[], idle_gaps=[])
    return harness.RunRecord(timings=[], trace=summary if trace else None,
                             work=WORK)


@pytest.fixture
def four_ranks(monkeypatch):
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)


@pytest.mark.parametrize("stage", STAGES)
def test_on_one_rank_it_reads_the_stage_roofline(stage):
    run = _run()
    want = roofline.read(f"{stage}_roofline", run)
    assert want is not None and 0 < want < 100
    assert roofline_grid.cards() == 1
    assert roofline_grid.read(f"{stage}_roofline_grid", run) == want


@pytest.mark.parametrize("stage", STAGES)
def test_on_four_ranks_it_reads_a_quarter(four_ranks, stage):
    run = _run()
    assert roofline_grid.cards() == 4
    assert roofline_grid.read(f"{stage}_roofline_grid", run) == pytest.approx(
        roofline.read(f"{stage}_roofline", run) / 4, rel=1e-12)
    assert "over 4 card(s)" in roofline_grid.note(f"{stage}_roofline_grid",
                                                  run)


def test_nothing_to_read_without_a_trace_or_work():
    name = "SpGEMM_roofline_grid"
    assert roofline_grid.read(name, _run(trace=False)) is None
    run = _run()
    run.work = None
    assert roofline_grid.read(name, run) is None


def test_each_grid_share_has_exactly_one_reader():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    mods = harness.readers()
    names = [m["name"] for m in bench["per_layer"]
             if m["name"].endswith("_roofline_grid")]
    assert sorted(names) == sorted(f"{s}_roofline_grid" for s in STAGES)
    for name in names:
        assert harness.reader_for(name, mods) is roofline_grid
    for stage in STAGES:
        assert harness.reader_for(f"{stage}_roofline", mods) is roofline
