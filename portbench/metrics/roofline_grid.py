"""``<Stage>_roofline_grid``: the share of its roofline that a stage run
over the grid reaches on one card, in percent: the stage's least time
(``reference.work``, the same work whatever implements the stage) split
over the grid's cards, over rank 0's device time of the kernels inside
the stage's profiler range.

The grid's cards are ``torch.distributed.get_world_size()`` while the
process group is up, else 1; on one card the share is
``<Stage>_roofline``'s.  Where the stage's work is split over the ranks,
each rank's least time is its share of the whole, which ``_roofline``
(the whole stage's work over one rank's time) does not see."""

from portbench.metrics import roofline

SUFFIX = "_roofline_grid"


def reads(name: str) -> bool:
    """Whether this reader gives ``name``."""
    return name.endswith(SUFFIX)


def cards() -> int:
    """The ranks of the process group, or 1 without one."""
    try:
        import torch.distributed as dist
    except ImportError:
        return 1
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def read(name: str, run):
    """The share, or None where ``<Stage>_roofline`` has none."""
    share = roofline.read(name[:-len(SUFFIX)] + roofline.SUFFIX, run)
    return None if share is None else share / cards()


def note(name: str, run) -> str:
    """Which bound set the share, and over how many cards."""
    stage = name[:-len(SUFFIX)] + roofline.SUFFIX
    return f"{roofline.note(stage, run)}, over {cards()} card(s)"
