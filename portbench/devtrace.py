"""Reduction of one profiled assembly to the numbers the per-layer readers
take: device busy time, each stage's kernel time, span memory peaks and the
breakdown the result line carries.

The profile is ``torch.profiler``'s Chrome trace of one ``assemble()``
call (CPU and CUDA activities) with the program's stage spans as
``record_function`` ranges (``PipelineConfig(trace=True)``), inside a
range named :data:`WINDOW`.  A device operation is an event of category
``kernel``, ``gpu_memcpy`` or ``gpu_memset``.  A stage span synchronises
the device before it closes, so a kernel that starts inside a stage's
(outermost) range on the trace's clock is that stage's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

WINDOW = "portbench.assembly"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGES = ("CountKmer", "CreateSpMat", "SpGEMM", "Alignment", "BuildR",
          "TrReduction", "Contigs", "Consensus")


@dataclasses.dataclass
class Summary:
    """One traced assembly, reduced."""

    window_s: float
    busy_s: float
    stage_device_s: Dict[str, float]
    span_peaks: Dict[str, int]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def reduce_trace(path: str, span_peaks: Dict[str, int]) -> Summary:
    """Read the Chrome trace at ``path`` (times in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"profile has no {WINDOW} range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in spans if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) >= w0 and float(e["ts"]) < w1]
    busy = [(max(a, w0), min(b, w1)) for a, b, _ in dev]
    # a stage's range is the outermost of its name: the 2D path opens its
    # phases as ranges of the stage's name inside it
    stages: Dict[str, Tuple[float, float]] = {}
    for e in spans:
        if e.get("cat") == "user_annotation" and e.get("name") in STAGES:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            old = stages.get(e["name"])
            if old is None or b - a > old[1] - old[0]:
                stages[e["name"]] = (a, b)
    stage_dev = {}
    for name, (a, b) in stages.items():
        stage_dev[name] = sum(d1 - d0 for d0, d1, _ in dev if a <= d0 < b) * 1e-6
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps on the device, named by the innermost host range open at
    # their middle on the thread that ran the assembly (its ranges nest)
    tid = win[0].get("tid")
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in spans if e.get("tid") == tid and e.get("cat") in (
                      "cpu_op", "user_annotation", "cuda_runtime",
                      "cuda_driver") and e.get("name") != WINDOW)
    gaps: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    nxt, end = 0, w0
    for a, b in sorted(busy) + [(w1, w1)]:
        if a > end:
            mid = 0.5 * (a + end)
            while nxt < len(host) and host[nxt][0] <= mid:
                while stack and stack[-1][1] <= host[nxt][0]:
                    stack.pop()
                stack.append(host[nxt])
                nxt += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            names = [h[2] for h in stack]
            stage = [x for x in names if x in STAGES]
            what = names[-1] if names else "host"
            key = f"{stage[-1]}/{what}" if stage and stage[-1] != what else what
            gaps[key] = gaps.get(key, 0.0) + (a - end) * 1e-6
        end = max(end, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=_union(busy) * 1e-6,
                   stage_device_s=stage_dev, span_peaks=dict(span_peaks),
                   device_ops=ops, idle_gaps=idle)
