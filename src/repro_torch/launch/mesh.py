"""Process grids for launches, and the card's published peaks.

The port's counterpart of ``repro.launch.mesh``: a grid is a
:class:`~repro_torch.core.grid.ProcessGrid` over the ``torch.distributed``
process group that exists (one rank a card), so building one never starts
processes.  ``make_production_grid`` gives JAX's production shapes,
``(16, 16)`` on ``("data", "model")`` or ``(2, 16, 16)`` on ``("pod",
"data", "model")``; it needs a process group of 256 or 512 ranks, and
:data:`PRODUCTION_SHAPES` lets a caller size a cell for one without it.

The constants are the H100 SXM5's published peaks (NVIDIA's H100 data
sheet), per card, and the two rates of the genome path's own arithmetic.
"""

from __future__ import annotations

from typing import Sequence

from ..core.grid import AXES, POD_AXES, ProcessGrid

#: grid shape and axes of each production grid, by ``--mesh`` name
PRODUCTION_SHAPES = {
    "single": ((16, 16), AXES),
    "multi": ((2, 16, 16), POD_AXES),
}

# H100 SXM5 (per card, NVIDIA data sheet)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense BF16 tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_LINKS = 18  # NVLink 4 links per card
NVLINK_BW_PER_LINK = 900e9 / NVLINK_LINKS  # B/s; 900 GB/s per card
# the genome path's arithmetic: f32 add/min instructions (67 TFLOP/s of
# f32 FMA counted as two) and int32 operations (half the f32 lanes)
F32_ADD_MIN_OPS = 67e12 / 2  # 33.5 T/s
INT32_OPS = 67e12 / 4  # 16.75 T/s


def make_production_grid(*, multi_pod: bool = False) -> ProcessGrid:
    """JAX's production grid over the existing process group (raises
    ``ValueError`` unless it has 256, or 512 with ``multi_pod``, ranks)."""
    shape, axes = PRODUCTION_SHAPES["multi" if multi_pod else "single"]
    return ProcessGrid.of_shape(shape, axes)


def make_test_grid(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = AXES) -> ProcessGrid:
    """A small grid for tests and scripts over the existing process group
    (1×1 without one)."""
    return ProcessGrid.of_shape(shape, axes)
