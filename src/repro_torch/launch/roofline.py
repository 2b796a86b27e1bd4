"""Roofline terms of a cell, on the H100's published peaks.

The port's counterpart of ``repro.launch.roofline``'s terms:

    compute    = ops per card / peak rate   (PEAK_FLOPS_BF16 by default)
    memory     = bytes per card / HBM_BW
    collective = collective bytes per card / (NVLINK_BW_PER_LINK × links)

``links`` counts NVLink links (18 on an H100 SXM5: 900 GB/s).  The genome
path's semiring arithmetic is f32 add/min and int32, not tensor-core BF16,
so its cells pass ``peak_flops=F32_ADD_MIN_OPS``; the value used is kept
in the record.  MODEL_FLOPS = 6·N·D for training, 2·N_active·D for a
forward pass.  The analytic language-model cost model of the JAX module
needs the models, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .mesh import HBM_BW, NVLINK_BW_PER_LINK, NVLINK_LINKS, PEAK_FLOPS_BF16


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    peak_memory_bytes: float = 0.0
    loop_flagged: bool = False
    peak_flops: float = PEAK_FLOPS_BF16

    def finalize(self, links: int = NVLINK_LINKS,
                 peak_flops: float = PEAK_FLOPS_BF16):
        self.peak_flops = peak_flops
        self.compute_s = self.flops_per_device / peak_flops
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes_per_device / (
            NVLINK_BW_PER_LINK * links)
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bottleneck = max(terms, key=terms.get)
        total_flops = self.flops_per_device * self.chips
        self.useful_ratio = (
            self.model_flops_global / total_flops if total_flops else 0.0)
        return self

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """6·N·D train / 2·N_active·D decode-or-prefill forward."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * global_batch  # decode: one token a sequence


def roofline_fraction(t: RooflineTerms) -> float:
    """Fraction of the dominant-term-bound runtime that is useful compute:
    (MODEL_FLOPS / chips / peak) / max(term).  1.0 = at the roofline."""
    ideal = (t.model_flops_global / t.chips) / t.peak_flops
    dom = max(t.compute_s, t.memory_s, t.collective_s)
    return ideal / dom if dom > 0 else 0.0
