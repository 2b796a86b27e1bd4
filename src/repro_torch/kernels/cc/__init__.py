"""Connected-components hook/shortcut rounds: the CUDA kernel's wrapper (a
whole ``cc_labels`` call in one launch), its plain versions and the chunk
rule."""

from .ops import (  # noqa: F401
    KERNEL,
    cc_components,
    cc_labels_cuda,
    cc_path,
    cc_rounds,
    edge_list,
    hbm_round_trips,
    transpose_ell,
)
from .ref import cc_labels_ref, cc_rounds_ref  # noqa: F401
