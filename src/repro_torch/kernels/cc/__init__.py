"""Connected-components hook/shortcut rounds: CUDA kernel wrapper, its
plain version and the ``cc_labels`` op's chunk driver."""

from .ops import (  # noqa: F401
    KERNEL,
    cc_labels_cuda,
    cc_rounds,
    hbm_round_trips,
    transpose_ell,
)
from .ref import cc_labels_ref, cc_rounds_ref  # noqa: F401
