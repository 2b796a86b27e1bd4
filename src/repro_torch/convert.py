"""Carrying data, config and language-model parameters across from the
JAX package.

What crosses from ``repro`` to the port is data (ELL matrices, read
tensors), the pipeline config, and for the language models their config,
parameter tree and train state.  These helpers take plain numpy arrays and dicts, so
this module imports nothing of JAX — the caller applies ``np.asarray``
(``jax.tree.map(np.asarray, params)``) and ``dataclasses.asdict`` on its
side.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .assembly.pipeline import PipelineConfig
from .core.semiring import MP
from .core.spmat import EllMatrix
from .models.model import LanguageModel, ModelConfig, build_model
from .optim import OptState
from .runtime.sharding import shard_model, shard_tensor


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


def lm_config_from_dict(d: Mapping[str, Any]) -> ModelConfig:
    """The port's ``ModelConfig`` from ``dataclasses.asdict`` of the JAX
    one (every field has its twin)."""
    return ModelConfig(**d)


def _jax_leaf(tree, key: str):
    """The JAX leaf of the port's parameter ``key``: ``slots.{s}.{i}.<path>``
    is ``tree["slots"][s][<path>][i]`` (JAX stacks a slot's layers on a
    leading ``n_periods`` axis); any other key is ``tree[<path>]``."""
    parts = key.split(".")
    if parts[0] == "slots":
        node, layer, parts = tree["slots"][int(parts[1])], int(parts[2]), parts[3:]
    else:
        node, layer = tree, None
    for name in parts:
        node = node[name]
    return node if layer is None else node[layer]


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                         device="cpu", *, train: bool = False, mesh=None,
                         fsdp: bool = False) -> LanguageModel:
    """The port's model holding JAX's parameter pytree ``tree`` (numpy
    arrays): each ``slots[s]`` leaf is unstacked along ``n_periods`` into
    layer ``i``'s parameter, and each leaf is cast to the dtype the port
    stores it in (``train``: f32 for every leaf, with gradients, as
    ``build_model(train=True)``).  The layout stays JAX's ``(d_in,
    d_out)``: no transpose.  Every leaf of ``tree`` must land on one
    parameter of the model.  With ``mesh`` (a ``ProcessGrid``) the result
    is the rank's sharded model: each leaf's block by the sharding rules
    (``fsdp`` as JAX's ``apply_sharding_rules``)."""
    model = build_model(cfg, device, train=train)
    _fill_from_tree(model.named_parameters(), tree)
    if mesh is not None:
        model = shard_model(model, mesh, fsdp=fsdp)
    return model.eval()


def _fill_from_tree(named, tree) -> Dict[str, torch.Tensor]:
    """Copy JAX's leaf of each ``(key, tensor)`` of ``named`` into the
    tensor; raises unless every element of ``tree`` is used."""
    n_used = 0
    out = {}
    with torch.no_grad():
        for key, p in named:
            leaf = np.asarray(_jax_leaf(tree, key))
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{key}: JAX leaf {leaf.shape}, port {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(leaf, np.float32)).to(p.dtype))
            n_used += leaf.size
            out[key] = p
    n_tree = _tree_size(tree)
    if n_used != n_tree:
        raise ValueError(f"{n_tree - n_used} elements of the JAX tree have no "
                         "parameter in the port")
    return out


def lm_train_state_from_numpy(params_tree: Mapping[str, Any], opt_state_tree,
                              step: int, cfg: ModelConfig, device="cpu", *,
                              mesh=None, fsdp: bool = True):
    """The port's train state ``(model, OptState(mu, nu), step)`` from JAX's
    ``(params, OptState(mu, nu), step)`` as numpy trees: the f32 trainable
    model, and the moments by the port's parameter names.  With ``mesh``
    the rank's blocks, the moments placed like their parameters."""
    model = lm_params_from_numpy(params_tree, cfg, device, train=True)

    def moments(tree):
        return _fill_from_tree(
            ((n, torch.zeros(p.shape, dtype=torch.float32, device=p.device))
             for n, p in model.named_parameters()), tree)

    mu, nu = opt_state_tree
    mu, nu = moments(mu), moments(nu)
    if mesh is not None:
        model = shard_model(model, mesh, fsdp=fsdp)
        specs = model.sharding.specs
        mu = {n: shard_tensor(t, specs[n], mesh) for n, t in mu.items()}
        nu = {n: shard_tensor(t, specs[n], mesh) for n, t in nu.items()}
    return model, OptState(mu=mu, nu=nu), int(step)


def _tree_size(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_tree_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_size(v) for v in tree)
    return int(np.asarray(tree).size)
