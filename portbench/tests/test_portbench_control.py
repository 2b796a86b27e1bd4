"""The control of ``correct`` comes out not correct on the card: the
program with its alignment band cut from 65 to 33 diagonals (the step
that would tempt a faster x-drop), judged against the configuration as
stated, while the program as stated comes out correct on the same seeds.
Through the harness's own run (``run.py --set band=33``), at a 2 Mb genome
with the cell's read model, so that a test run holds it; the cell's own
size is measured by ``run.py --set band=33`` on the card (PERF.md)."""

import json

import pytest

from portbench import harness
from portbench.tests.tiny import REPO, TRAFFIC, make_root

SEEDS = (71, 72, 73)


@pytest.mark.cuda
@pytest.mark.parametrize("changes,correct", [({}, True), ({"band": 33}, False)])
def test_the_band_control_fails_and_the_program_passes(card, tmp_path, changes,
                                                       correct):
    traffic = json.loads((REPO / "portbench" / "traffic" / TRAFFIC).read_text())
    traffic["name"] = "tiny"
    root = make_root(tmp_path, genome=2_000_000, sample_reads=1024,
                     traffic=traffic)
    for seed in SEEDS:
        line = harness.run_rank("gspmd", seed, 0.5, False, t_start=0.0,
                                device="cuda", root=root, overrides=changes)
        assert line["correct"] is correct
        if not correct:
            assert line["checks"]["r_rows"]["value"] > 0
