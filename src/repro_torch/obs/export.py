"""Trace-artifact export: Chrome trace-event / Perfetto JSON.

The port's copy of ``repro.obs.export``: one ``"X"`` complete event per
span on ``tid`` 0 (the host), with microsecond ``ts``/``dur`` and the span
attributes in ``args``.  The host spans share that one track — the tracer
is host-sequential, so nesting is exactly ts/dur containment.  A span with
a device interval (``Tracer.resolve``) has a second event on ``tid`` 1,
the ``device`` track.  Times are on ``torch.profiler``'s clock as its own
export writes them: ``ts`` plus the file's ``baseTimeNanoseconds`` is
``CLOCK_REALTIME``, so the file lines up with a profile of the same run.
Beside ``traceEvents`` the file carries a ``spanTree`` key (ignored by
trace viewers) with the explicit nesting.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from .trace import Span, Tracer


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return int(v)  # 0-d tensors and numpy scalars
    except (TypeError, ValueError, RuntimeError):
        return repr(v)


def span_tree(sp: Span) -> Dict[str, Any]:
    """One span (and its subtree) as a plain nested dict."""
    return {
        "name": sp.name,
        "ms": round(sp.duration_ms, 4),
        "attrs": {k: _jsonable(v) for k, v in sp.attrs.items()},
        "children": [span_tree(c) for c in sp.children],
    }


def to_chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    """The tracer's span forest as a Chrome trace-event JSON object."""
    base = tracer.anchor[1] // 1000 * 1000  # whole microseconds

    def us(t: float) -> float:
        return (tracer.clock_ns(t) - base) * 1e-3

    events, device = [], []
    for sp in tracer.spans():
        t1 = sp.t1 if sp.t1 is not None else sp.t0
        ev = {
            "name": sp.name,
            "ph": "X",
            "ts": us(sp.t0),
            "dur": max((t1 - sp.t0) * 1e6, 0.001),
            "pid": 0,
            "tid": 0,
            "cat": str(sp.attrs.get("kind", "span")),
            "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
        }
        events.append(ev)
        if sp.device_s is not None:
            device.append(dict(ev, ts=us(sp.device_t0),
                               dur=max(sp.device_s * 1e6, 0.001), tid=1))
    if device:
        events += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                    "args": {"name": name}}
                   for tid, name in ((0, "host"), (1, "device"))] + device
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "baseTimeNanoseconds": base,
        "spanTree": [span_tree(r) for r in tracer.roots],
    }


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    """Write the Chrome trace JSON for ``tracer`` to ``path``; returns
    ``path``.  Open the file at https://ui.perfetto.dev (or
    ``chrome://tracing``) for the timeline view."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f, indent=1)
    return path
