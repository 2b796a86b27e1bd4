"""``<Stage>_roofline``: the stage's least time on the card over the device
time of the kernels inside the stage's profiler range, in percent.

The least time is the larger of the stage's operations over the peak rate
of their type and its bytes over the memory bandwidth, with the work
counted by ``reference.work`` from the reference's own intermediates, so
the same work is counted whatever implements the stage."""

from portbench.reference.work import least_time

SUFFIX = "_roofline"


def reads(name: str) -> bool:
    """Whether this reader gives ``name``."""
    return name.endswith(SUFFIX)


def read(name: str, run):
    """The share, or None without a traced assembly, its kernels or the
    stage's work."""
    stage = name[:-len(SUFFIX)]
    if run.trace is None or run.work is None or stage not in run.work:
        return None
    device_s = run.trace.stage_device_s.get(stage, 0.0)
    if device_s <= 0:
        return None
    return 100.0 * least_time(run.work[stage])[0] / device_s


def note(name: str, run) -> str:
    """Which bound set the share."""
    stage = name[:-len(SUFFIX)]
    if run.work is None or stage not in run.work:
        return "no work counted"
    t, bound = least_time(run.work[stage])
    return f"least {t:.9f} s, set by {bound}"
