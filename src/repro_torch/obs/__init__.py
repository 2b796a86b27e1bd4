"""Observability of the port: the stats schema, the validating metrics
accumulator, a device-synchronised stage timer and the memory watermark."""

from .metrics import (  # noqa: F401
    Metrics,
    MetricsError,
    Watermark,
    stage_timer,
    validated,
)
