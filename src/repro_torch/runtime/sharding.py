"""Parameter, batch and cache placement on a :class:`ProcessGrid` (the port
of ``repro.runtime.sharding``): JAX's t5x-style path rules, and the slices
they give a rank.

Training layout: data parallelism over ``("pod", "data")``, tensor
parallelism over ``"model"``, and with ``fsdp`` the big matrices' non-TP
axis sharded over ``"data"`` as well.  A spec is a tuple with one entry a
dimension, as a ``PartitionSpec``: ``None`` (whole), an axis name, or a
tuple of names (a one-name tuple is written as the name, as JAX prints
it).  An axis whose size does not divide its dimension is dropped, as
JAX's ``apply_sharding_rules`` drops it.

Rules match JAX's path form of a parameter: the port's
``slots.{s}.{i}.attn.wq`` is JAX's ``slots/{s}/attn/wq`` (JAX stacks a
slot's layers on a leading axis and prefixes its spec with ``None``; the
port's layers are separate, so the spec has no such entry).  First match
wins: ``.*embed$`` comes before ``.*unembed$`` and so takes ``unembed``
too, which is JAX's placement (``unembed`` sharded over ``"model"`` on
``d_model``).

A rank holds exactly the block that JAX's ``NamedSharding`` gives the
device at its coordinates: along a dimension sharded over axes ``A`` it
holds block ``axis_index(A)`` of ``size(A)`` (``shard_tensor``);
``gather_tensor`` puts the logical tensor back together.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.grid import ProcessGrid

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def _entry(axes) -> Entry:
    """An entry in JAX's printed form: a one-axis tuple is the name."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec shards over, in entry order."""
    return tuple(a for e in spec for a in entry_axes(e))


def dp_axes(grid) -> Tuple[str, ...]:
    """The grid's data-parallel axes, ``("pod", "data")`` where present."""
    return tuple(a for a in ("pod", "data") if a in grid.axis_names)


def _axes_size(grid, axes: Sequence[str]) -> int:
    """The ranks along ``axes``; 0 when the grid lacks one of them."""
    size = 1
    for a in axes:
        if a not in grid.axis_names:
            return 0
        size *= grid.shape[a]
    return size


def clean_spec(spec: Sequence[Entry], shape: Sequence[int], grid) -> Spec:
    """``spec`` with each entry whose axes do not divide its dimension (or
    that lies past the tensor's rank) dropped: JAX's rule in ``_csc`` and
    ``apply_sharding_rules``."""
    out: List[Entry] = []
    for i, e in enumerate(spec):
        axes = entry_axes(e)
        size = _axes_size(grid, axes) if axes else 0
        keep = axes and i < len(shape) and size and shape[i] % size == 0
        out.append(_entry(axes) if keep else None)
    return tuple(out)


def param_sharding_rules(grid, *, fsdp: bool = False) -> List[Tuple[str, Spec]]:
    """JAX's rule list, regex for regex and spec for spec."""
    dp = "data" if "data" in grid.axis_names else None
    f = dp if fsdp else None
    return [
        (r".*embed$", ("model", None)),  # (V, D) vocab-sharded
        (r".*unembed$", (None, "model")),  # (D, V)
        (r".*attn/wq$", (f, "model")),
        # kv heads < tp for most GQA archs: the kv projections are
        # replicated over "model" (JAX's kv replication)
        (r".*attn/wk$", (f, None)),
        (r".*attn/wv$", (f, None)),
        (r".*attn/wo$", ("model", f)),
        (r".*q_norm$|.*k_norm$", ()),
        (r".*(mlp|shared)/w_gate$", (f, "model")),
        (r".*(mlp|shared)/w_up$", (f, "model")),
        (r".*(mlp|shared)/w_down$", ("model", f)),
        (r".*(mlp|shared)/w_in$", (f, "model")),
        (r".*(mlp|shared)/w_out$", ("model", f)),
        (r".*moe/router$", (f, None)),
        (r".*moe/w_gate$", ("model", f, None)),  # (E, D, F) expert-sharded
        (r".*moe/w_up$", ("model", f, None)),
        (r".*moe/w_down$", ("model", f, None)),
        (r".*ssm/in_proj$", (f, "model")),
        (r".*ssm/out_proj$", ("model", f)),
        (r".*ssm/conv_w$", (None, "model")),
        (r".*ssm/conv_b$", ("model",)),
        (r".*ssm/norm$", ("model",)),
        (r".*", ()),  # norms, scalars: replicated
    ]


def jax_path(name: str) -> str:
    """JAX's tree path of the port's parameter ``name``:
    ``slots.{s}.{i}.<path>`` → ``slots/{s}/<path>``."""
    parts = name.split(".")
    if parts[0] == "slots":
        parts = parts[:2] + parts[3:]
    return "/".join(parts)


def spec_for(name: str, rules) -> Spec:
    """The first rule's spec whose pattern matches ``name``'s JAX path."""
    path = jax_path(name)
    for pat, spec in rules:
        if re.match(pat, path):
            return tuple(spec)
    return ()


def apply_sharding_rules(model, grid, *, fsdp: bool = False) -> Dict[str, Spec]:
    """The spec of every parameter of ``model`` (an ``nn.Module`` or a dict
    of tensors, logical shapes), by name, axes that do not divide dropped."""
    rules = param_sharding_rules(grid, fsdp=fsdp)
    named = (model.items() if isinstance(model, dict)
             else model.named_parameters())
    return {n: clean_spec(spec_for(n, rules), tuple(p.shape), grid)
            for n, p in named}


def batch_sharding(grid, batch_size: Optional[int] = None) -> Spec:
    """The batch over the data axes, or replicated when ``batch_size``
    does not divide by them (``long_500k``'s batch of 1)."""
    dp = dp_axes(grid)
    if batch_size is not None and batch_size % max(1, _axes_size(grid, dp)):
        return ()
    return (_entry(dp),)


def cache_sharding(grid, caches: Any, *, seq_sharded: bool) -> Any:
    """Specs of the caches' leaves ``(period, B, S, H, D)`` (same
    structure): batch over the data axes where it divides, and with
    ``seq_sharded`` the third dimension over ``"model"`` where it divides
    (the KV sequence, an SSM state's heads)."""
    dp = dp_axes(grid)
    n_dp = max(1, _axes_size(grid, dp))
    tp = grid.shape.get("model", 1)

    def spec(leaf):
        bdim = leaf.shape[1] if leaf.dim() > 1 else 1
        bspec = _entry(dp) if bdim % n_dp == 0 else None
        if leaf.dim() >= 3 and seq_sharded and leaf.shape[2] % tp == 0:
            return (None, bspec, "model")
        return (None, bspec)

    return tree_map(spec, caches)


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v) for v in tree]
        return type(tree)(out) if not hasattr(tree, "_fields") else type(tree)(*out)
    return fn(tree)


def tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map2(fn, v, o) for v, o in zip(tree, other)]
        return type(tree)(out) if not hasattr(tree, "_fields") else type(tree)(*out)
    return fn(tree, other)


def shard_shape(shape: Sequence[int], spec: Spec, grid) -> Tuple[int, ...]:
    """A rank's block shape of a logical ``shape`` (JAX's
    ``NamedSharding.shard_shape``)."""
    out = list(shape)
    for d, e in enumerate(spec):
        if entry_axes(e):
            out[d] //= _axes_size(grid, entry_axes(e))
    return tuple(out)


def shard_tensor(x: torch.Tensor, spec: Spec, grid) -> torch.Tensor:
    """This rank's block of the logical tensor ``x`` (a copy)."""
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if axes:
            n = grid.size(axes)
            step = x.shape[d] // n
            x = x.narrow(d, grid.axis_index(axes) * step, step)
    return x.clone()


def gather_tensor(x: torch.Tensor, spec: Spec, grid) -> torch.Tensor:
    """The logical tensor from every rank's block (a collective: every
    rank of the grid calls it and gets the whole tensor)."""
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if axes:
            x = grid.all_gather(x.contiguous(), axes, dim=d)
    return x


@dataclasses.dataclass(frozen=True)
class GridShape:
    """A grid's axis names and sizes without a process group: enough to
    compute specs and per-rank shapes for a grid no host forms (the
    production grids), and the rank at ``coords``."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Tuple[int, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        coords = self.coords or (0,) * len(self.sizes)
        idx = 0
        for a in axes:
            k = self.axis_names.index(a)
            idx = idx * self.sizes[k] + coords[k]
        return idx


@dataclasses.dataclass
class ModelSharding:
    """How a model's parameters lie on a grid: the grid, each parameter's
    spec by name, and whether FSDP placed them."""

    grid: ProcessGrid
    specs: Dict[str, Spec]
    fsdp: bool


def shard_model(model, grid: ProcessGrid, *, fsdp: bool = False):
    """``model`` (logical parameters) turned into this rank's sharded model,
    in place: every parameter replaced by its block (``requires_grad``
    kept), ``model.sharding`` set, and each submodule given the specs of
    its own parameters (``module._spec``) for the grid forward."""
    specs = apply_sharding_rules(model, grid, fsdp=fsdp)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            blk = shard_tensor(p.detach(), specs[name], grid)
            setattr(mod, leaf, torch.nn.Parameter(blk, requires_grad=p.requires_grad))
    set_module_specs(model, specs)
    model.sharding = ModelSharding(grid, specs, fsdp)
    return model


def set_module_specs(model, specs: Dict[str, Spec]) -> None:
    """Give each submodule the specs of its direct parameters."""
    for mod_name, mod in model.named_modules():
        pre = mod_name + "." if mod_name else ""
        mod._spec = {leaf: specs[pre + leaf]
                     for leaf, _ in mod.named_parameters(recurse=False)}


def gather_model(model) -> Dict[str, torch.Tensor]:
    """Every parameter of a sharded ``model`` as its logical tensor, by
    name (a collective)."""
    sh = model.sharding
    return {n: gather_tensor(p.detach(), sh.specs[n], sh.grid)
            for n, p in model.named_parameters()}


class GridCaches(list):
    """A rank's caches on a grid: JAX's structure (a list per period slot)
    holding the rank's blocks by ``cache_sharding``, with the layout the
    forward needs: whether the batch and the KV sequence are sharded."""

    def __init__(self, slots, *, grid, specs, batch_sharded: bool,
                 kv_seq_sharded: bool):
        super().__init__(slots)
        self.grid, self.specs = grid, specs
        self.batch_sharded, self.kv_seq_sharded = batch_sharded, kv_seq_sharded
