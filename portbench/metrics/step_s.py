"""``step_s.<label>``: the device seconds of the program's spans of one
label in the profiled assembly, summed over its spans (a stage's steps, as
``CountKmer.extract`` or ``TrReduction.square`` once an iteration, and the
2D path's phases, as ``SpGEMM.distribute``).  Each span records a CUDA
event on the stream at its open and its close, so the time is the device's
between them, on the card's clock."""

from portbench.spans import span_row

PREFIX = "step_s."


def reads(name: str) -> bool:
    """Whether this reader gives ``name``."""
    return name.startswith(PREFIX)


def read(name: str, run):
    """The seconds, or None without a traced assembly or such a span."""
    row = span_row(name[len(PREFIX):], run)
    if row is None or row.get("device_s") is None:
        return None
    return float(row["device_s"])
