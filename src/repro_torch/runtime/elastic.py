"""Elastic scaling: a training state resharded onto another grid over the
same process group (the port of ``repro.runtime.elastic``).

Checkpoints store logical arrays (``checkpoint.py``), so growing or
shrinking an allocation is: form the new grid, recompute the sharding
rules, take each rank's block.  ``reshard_state`` is the in-memory path:
each leaf is gathered to its logical tensor on the old grid (the model's
``sharding``), then the new grid's block is kept.  Adam's moments shard
exactly like their parameters, and the step is kept.
"""

from __future__ import annotations

from typing import Any

import torch

from ..optim import OptState
from .sharding import (
    ModelSharding,
    apply_sharding_rules,
    gather_tensor,
    set_module_specs,
    shard_tensor,
)


def _reshard_model(model, new_grid, fsdp: bool):
    """The model's parameters moved, in place, from its grid onto
    ``new_grid``; returns (model, old specs, new specs)."""
    old = model.sharding
    logical = {n: gather_tensor(p.detach(), old.specs[n], old.grid)
               for n, p in model.named_parameters()}
    new_specs = apply_sharding_rules(logical, new_grid, fsdp=fsdp)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            blk = shard_tensor(logical.pop(name), new_specs[name], new_grid)
            setattr(mod, leaf, torch.nn.Parameter(
                blk, requires_grad=p.requires_grad))
    set_module_specs(model, new_specs)
    model.sharding = ModelSharding(new_grid, new_specs, fsdp)
    return model, old, new_specs


def reshard_state(state: Any, new_grid, *, fsdp: bool = False,
                  params_only: bool = False) -> Any:
    """``state`` = ``(model, OptState, step)`` (or, with ``params_only``, a
    sharded model) on ``new_grid``.  Every rank of the process group calls
    it (gathering is a collective); the model is changed in place and the
    moments are new tensors."""
    if params_only:
        return _reshard_model(state, new_grid, fsdp)[0]
    model, opt_state, step = state
    model, old, new_specs = _reshard_model(model, new_grid, fsdp)

    def move(moments):
        return {n: shard_tensor(gather_tensor(m, old.specs[n], old.grid),
                                new_specs[n], new_grid)
                for n, m in moments.items()}

    return model, OptState(mu=move(opt_state.mu), nu=move(opt_state.nu)), step
