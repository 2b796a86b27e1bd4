"""``device_idle_pct``: the share of the traced assembly's wall time in
which no operation ran on the card (1 − the union of device operation
intervals over the window), in percent."""


def reads(name: str) -> bool:
    """Whether this reader gives ``name``."""
    return name == "device_idle_pct"


def read(name: str, run):
    """The idle share, or None without a traced assembly."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
