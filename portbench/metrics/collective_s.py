"""``collective_s``: the seconds the traced assembly spent inside the
process grid's collectives (``core/grid.py``: permute, all-reduce,
all-gather, reduce-scatter), each bracketed by a device synchronise, on the
slowest rank.  Host time; the synchronises perturb the run, so it is read
in the traced run only."""


def reads(name: str) -> bool:
    """Whether this reader gives ``name``."""
    return name == "collective_s"


def read(name: str, run):
    """The time, or None where no grid of several ranks ran."""
    return run.collective_s
