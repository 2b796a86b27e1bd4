"""``own_peak_gib.<Stage>``: the allocator's peak between the stage span's
open and close in the profiled assembly, its steps included, in GiB.  The
span resets the allocator's peak as it opens, so the number is the stage's
own, where ``peak_gib.<Stage>`` is the assembly's peak so far."""

from portbench.spans import span_row

PREFIX = "own_peak_gib."


def reads(name: str) -> bool:
    """Whether this reader gives ``name``."""
    return name.startswith(PREFIX)


def read(name: str, run):
    """The peak, or None without a traced assembly or the stage's span."""
    row = span_row(name[len(PREFIX):], run)
    if row is None or row.get("own_peak_hbm_bytes") is None:
        return None
    return row["own_peak_hbm_bytes"] / 2**30
