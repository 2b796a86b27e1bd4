"""Carrying data and config across from the JAX package.

The system has no weights: what crosses from ``repro`` to the port is data
(ELL matrices, read tensors) and the pipeline config.  These helpers take
plain numpy arrays and dicts, so this module imports nothing of JAX — the
caller applies ``np.asarray`` (and ``dataclasses.asdict``) on its side.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .assembly.pipeline import PipelineConfig
from .core.semiring import MP
from .core.spmat import EllMatrix


def ell_from_numpy(cols, vals, n_cols: int, device="cpu") -> EllMatrix:
    """An ``EllMatrix`` from numpy ``cols`` and ``vals``: a dict of arrays,
    or one array (the JAX min-plus value, stored under ``MP``)."""
    if not isinstance(vals, Mapping):
        vals = {MP: vals}
    cols_t = torch.from_numpy(np.array(cols, np.int32)).to(device)
    vals_t = {k: torch.from_numpy(np.array(v)).to(device)
              for k, v in vals.items()}
    return EllMatrix(cols=cols_t, vals=vals_t, n_cols=int(n_cols))


def ell_to_numpy(mat: EllMatrix) -> Tuple[np.ndarray, Dict[str, np.ndarray], int]:
    """``(cols, vals, n_cols)`` of an ``EllMatrix`` as numpy arrays."""
    vals = {k: v.detach().cpu().numpy() for k, v in mat.vals.items()}
    return mat.cols.detach().cpu().numpy(), vals, mat.n_cols


# JAX config fields the port has no counterpart for, with their JAX
# defaults: the TPU pileup kernel's column band and the shard_map SUMMA's
# stages per launch (the port's is the constant core.summa.STAGES_PER_CALL)
JAX_ONLY_DEFAULTS = {"pileup_band": 512, "summa_stages_per_call": 4}


def config_from_dict(d: Mapping[str, Any], **overrides) -> PipelineConfig:
    """The port's ``PipelineConfig`` from ``dataclasses.asdict`` of the JAX
    one; ``backend="pallas"`` becomes ``"cuda"``, and ``overrides`` (e.g.
    ``device="cpu"``) apply last.  The JAX-only fields are dropped at
    their defaults and raise at any other value."""
    kw = dict(d)
    for key, default in JAX_ONLY_DEFAULTS.items():
        if key in kw and kw.pop(key) != default:
            raise ValueError(f"{key} has no counterpart in the port; only "
                             f"its JAX default {default} is accepted")
    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"unknown PipelineConfig fields: {sorted(unknown)}")
    if kw.get("backend") == "pallas":
        kw["backend"] = "cuda"
    kw.update(overrides)
    return PipelineConfig(**kw)
