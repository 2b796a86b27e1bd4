"""``BENCHMARK.json`` keeps to the contract, and a run's output is well
formed: the result line, the checks last on both streams, no result
without a card or without the program."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
RUN = REPO / "portbench" / "run.py"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        # the file states the same deployment as its entry
        f = json.loads((REPO / c["file"]).read_text())
        assert (f["name"], f["source"], f["reduced"]) == (
            c["name"], c["source"], c["reduced"])
    assert len({c["file"] for c in b["configs"]}) == len(configs)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200
    assert {w["config"] for w in b["workloads"]} == configs
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    every = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(every)) == len(every)
    assert all(NAME.match(x) for x in every + list(cells) + list(configs))
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in b["end_to_end"] + b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_per_layer_metric_has_one_reader():
    from portbench import harness

    mods = harness.readers()
    for m in _bench()["per_layer"]:
        assert harness.reader_for(m["name"], mods) is not None


def _run(args, env=None, cwd=REPO):
    return subprocess.run([sys.executable, str(args[0]), *map(str, args[1:])],
                          capture_output=True, text=True, timeout=600,
                          env=env or dict(os.environ), cwd=str(cwd))


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_is_well_formed(tiny_root, trace):
    p = _run([RUN, "--workload", "gspmd", "--seed", 2**31 + 11, "--seconds", 1,
              "--trace", trace, "--device", "cpu", "--root", tiny_root])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    names = {m["name"] for m in (_bench()["per_layer"] if trace
                                 else _bench()["end_to_end"])}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(c["limit"] == 0 and c["value"] == 0
               for c in line["checks"].values())


def test_no_result_without_a_card(tiny_root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run([RUN, "--workload", "gspmd", "--seed", 1, "--seconds", 1,
              "--trace", 0, "--root", tiny_root], env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_with_the_benchmark_alone(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run([tmp_path / "portbench" / "run.py", "--workload",
              _bench()["workloads"][0]["name"], "--seed", 1, "--seconds", 1,
              "--trace", 0, "--device", "cpu"], cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
