"""Observability of the port: the same names as ``repro.obs``.

* ``obs.trace`` — hierarchical :func:`span` timing with a device
  synchronise on exit: the one timing path of stages, their steps,
  shard_map phases, dispatched ops and kernel launches; under a tracer on a
  CUDA device each span's device interval and own memory peak;
* ``obs.schema`` / ``obs.metrics`` — the declared metric registry and the
  validating :class:`Metrics` accumulator;
* ``obs.export`` — Chrome trace-event / Perfetto JSON;
* ``obs.memory`` — device-memory watermarks (the CUDA allocator's stats,
  or live-tensor bytes on the CPU), carried by spans and by the stats.
"""

from . import schema
from .export import span_tree, to_chrome_trace, write_chrome_trace
from .memory import MemorySample, Watermark, sample, watermark
from .metrics import Metrics, MetricsError, validated
from .trace import (
    Span,
    Tracer,
    current_tracer,
    last_summary,
    span,
    sync,
    tracing,
)

__all__ = [
    "Span",
    "Tracer",
    "current_tracer",
    "last_summary",
    "span",
    "sync",
    "tracing",
    "Metrics",
    "MetricsError",
    "validated",
    "schema",
    "span_tree",
    "to_chrome_trace",
    "write_chrome_trace",
    "MemorySample",
    "Watermark",
    "sample",
    "watermark",
]
