"""``peak_gib.<Stage>``: the allocator's high-water mark of the traced
assembly as the stage's span closes (the span's device-memory column), in
GiB: the peak of the assembly up to and including that stage."""

PREFIX = "peak_gib."


def reads(name: str) -> bool:
    """Whether this reader gives ``name``."""
    return name.startswith(PREFIX)


def read(name: str, run):
    """The span's peak, or None without a traced assembly or span."""
    if run.trace is None:
        return None
    got = run.trace.span_peaks.get(name[len(PREFIX):])
    return None if got is None else got / 2**30
