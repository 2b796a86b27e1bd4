"""Hand-written CUDA kernels of the port, each beside its plain version:

  xdrop/   — banded x-drop alignment wavefront (Alignment)
  minplus/ — dense orientation-resolved min-plus product (TrReduction)
  pileup/  — banded pileup + majority vote (Consensus)
  spgemm/  — ring-SUMMA local SpGEMM stages (SpGEMM and the distributed
             transitive reduction under ``distribution="shard_map"``)
  spgemm_masked/ — sampled min-plus product at R's pattern (TrReduction
             above ``TR_DENSE_MAX_ROWS``)
  cc/      — hook/shortcut connected-components rounds, a whole
             ``core.components.connected_components`` call in one launch
  kmer_pack/ — canonical packed k-mers from the read codes (CountKmer's
             extract step)

Sources are ``repro_torch/csrc/<name>.cu``; ``build.py`` compiles and binds
them.  Importing this package registers every kernel and its plain version
with the dispatch seam in ``core/backend.py``.  Each wrapper's
``KERNEL.launches`` counts the launches it made.
"""

from typing import Dict

from .cc import KERNEL as _CC
from .cc import cc_labels_cuda, cc_labels_ref, cc_rounds, cc_rounds_ref  # noqa: F401
from .kmer_pack import KERNEL as _KMER_PACK
from .kmer_pack import kmer_pack, kmer_pack_ref  # noqa: F401
from .minplus import KERNEL as _MINPLUS
from .minplus import minplus_matmul, minplus_matmul_ref  # noqa: F401
from .pileup import KERNEL as _PILEUP
from .pileup import pileup_vote, pileup_vote_ref  # noqa: F401
from .spgemm import KERNEL as _SPGEMM
from .spgemm import spgemm_ring_stages, spgemm_ring_stages_ref  # noqa: F401
from .spgemm_masked import KERNEL as _SPGEMM_MASKED
from .spgemm_masked import (  # noqa: F401
    spgemm_masked_minplus,
    spgemm_masked_minplus_ref,
)
from .xdrop import KERNEL as _XDROP
from .xdrop import xdrop_extend_batch, xdrop_extend_batch_ref  # noqa: F401

#: every kernel of the port, by name
KERNELS = {k.name: k for k in (_XDROP, _MINPLUS, _PILEUP, _SPGEMM,
                                _SPGEMM_MASKED, _CC, _KMER_PACK)}


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0
