"""The assigned input shapes (one set shared by all ten LM archs) and
their ``meta``-device specs (the port of ``repro.configs.shapes``).

``decode_*`` / ``long_*`` are one new token against a cache of
``seq_len``.  ``long_500k`` needs sub-quadratic attention, so only the
SSM, hybrid and mostly-local archs run it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input shape: its kind, sequence length and global batch."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs that can run the 524k-token decode cell (sub-quadratic / mostly-local)
LONG_CONTEXT_ARCHS = {"mamba2-1.3b", "hymba-1.5b", "gemma3-4b"}


def runs_cell(arch_name: str, shape_name: str) -> bool:
    """Whether arch ``arch_name`` runs shape ``shape_name``."""
    if shape_name == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True


def batch_specs(cfg, shape: ShapeSpec):
    """``meta`` tensors for the step inputs (no memory).

    train:   {tokens|embeddings, labels}
    prefill: {tokens|embeddings}
    decode:  {tokens|embeddings} for ONE token (+ ``cache_specs``)."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    meta = torch.device("meta")
    if cfg.frontend == "token":
        batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=meta)}
    else:
        batch = {"embeddings": torch.empty((b, s, cfg.d_model),
                                           dtype=getattr(torch, cfg.dtype),
                                           device=meta)}
    if shape.kind == "train":
        batch["labels"] = torch.empty((b, s), dtype=torch.int32, device=meta)
    return batch


def cache_specs(cfg, shape: ShapeSpec):
    """``meta`` tensors for the decode cache: ``init_cache`` on ``meta``."""
    from ..models.model import init_cache

    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
