"""The program's own span summary of the profiled assembly, for the
per-layer readers of ``step_s.*`` and ``own_peak_gib.*``.

A traced ``assemble()`` resolves its tracer, which publishes its summary
(``repro_torch.obs.last_summary()``: by span label, ``count``, ``host_s``,
``device_s`` and the largest ``own_peak_hbm_bytes``).  The profiled assembly
is the run's only traced one, so after it the summary is that assembly's.
A program without the summary gives None, and so does a run without a
profiled assembly."""

from __future__ import annotations

from typing import Any, Dict, Optional


def span_row(label: str, run) -> Optional[Dict[str, Any]]:
    """The summary's row of ``label``, or None."""
    if run.trace is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    get = getattr(obs, "last_summary", None)
    summary = get() if get is not None else None
    return None if not summary else summary.get(label)
