"""``stage_s.<Stage>``: a stage's wall seconds in an assembly, the mean
over the measured window's assemblies (the program's stage spans, which
synchronise the stage's outputs before they close:
``AssemblyResult.timings``)."""

PREFIX = "stage_s."


def reads(name: str) -> bool:
    """Whether this reader gives ``name``."""
    return name.startswith(PREFIX)


def read(name: str, run):
    """The mean over the window, or None where no assembly ran the stage."""
    stage = name[len(PREFIX):]
    got = [t[stage] for t in run.timings if stage in t]
    return sum(got) / len(got) if got else None
