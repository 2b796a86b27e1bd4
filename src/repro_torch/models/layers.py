"""Shared transformer layers on torch tensors (the port of
``repro.models.layers``).

A serving model stores each parameter in the dtype the forward uses it in
(the config's compute dtype, or f32 for norm scales), a training model
every parameter in f32 as JAX does; compute keeps JAX's f32 normalization
and rotation statistics.  ``apply_rope`` carries JAX's ``custom_vjp``: its
backward is the inverse rotation, computed in f32 and rounded once.

On a :class:`~repro_torch.core.grid.ProcessGrid` the blocks run through
the helpers at the end of this module: ``GridCtx`` is the residual
stream's layout (JAX's ``_csc`` constraint with its divisibility rule
applied), and a ``Region`` is one block's mixer or MLP, run

* ``"tp"``: tensor-parallel over ``"model"`` — the stream is gathered
  (sequence parallelism) or entered, each rank computes its heads or
  columns with its own weight blocks, and the partial sums leave by
  ``psum_scatter`` (or ``psum``), Megatron-style;
* ``"rep"``: replicated — when the heads or columns do not divide by the
  model axis (JAX drops the axis), every rank computes the whole block
  with gathered weights;
* ``"dp"``: the stream's batch is sharded over ``"model"`` too
  (``batch_over_model``), so each rank computes its rows with gathered
  weights.

FSDP blocks (over ``"data"``) are gathered before use and their gradients
reduce-scattered; a weight replicated over ``"model"`` that varying work
uses goes through ``enter``, so its gradient is summed over the axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch
from torch import nn

from ..core.grid import (
    all_gather,
    all_gather_replicated,
    enter,
    psum,
    psum_scatter,
    split,
)
from ..runtime.sharding import entry_axes


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · (1 + scale)`` in f32, cast back to
    ``x``'s dtype (not ``nn.RMSNorm``, whose weight is not ``1 + scale``)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope_freqs(positions: torch.Tensor, d_head: int,
               theta: Union[float, torch.Tensor]) -> tuple:
    """positions (...,) -> cos/sin (..., d_head//2), f32."""
    half = d_head // 2
    expo = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (theta ** expo)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 sign: float) -> torch.Tensor:
    """Rotate-half by ``sign``·angle in f32 (the angles' dtype), cast back
    to ``x``'s dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[..., None, :]  # broadcast over heads
    s = sign * sin[..., None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


class _Rope(torch.autograd.Function):
    """JAX's ``apply_rope`` ``custom_vjp``: the transpose of a rotation is
    the inverse rotation, applied to the cotangent in f32 and rounded once
    to its dtype (plain autograd would round each of the two products of
    ``x1``/``x2`` to bf16 and add them in bf16)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rope_rotate(x, cos, sin, 1.0)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return _rope_rotate(g, cos, sin, -1.0), None, None


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D//2). Rotate-half convention, in
    f32 (the angles' dtype), cast back to ``x``'s dtype.  The angles get no
    gradient (JAX's rule returns zeros for them)."""
    return _Rope.apply(x, cos, sin)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` in JAX's ``(d_in, d_out)`` layout, in ``x``'s
    dtype (a bf16 product returns bf16, as JAX's ``dense`` does)."""
    return torch.matmul(x, w.to(x.dtype))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``dense(silu(x·w_gate) · (x·w_up), w_down)``."""
    return dense(torch.nn.functional.silu(dense(x, w_gate)) * dense(x, w_up),
                 w_down)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` as ``logaddexp(x, 0)``, with
    no threshold (``F.softplus`` returns ``x`` above 20, which differs by at
    most e⁻²⁰)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """An f32 ``(d_in, d_out)`` normal draw from ``gen`` (on its device),
    times ``scale`` (default ``1/√d_in``)."""
    scale = scale if scale is not None else d_in ** -0.5
    return torch.randn(d_in, d_out, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def param_count(params: nn.Module) -> int:
    """Number of stored parameter elements (padded vocab and experts)."""
    return sum(int(p.numel()) for p in params.parameters())


# ---------------------------------------------------------------------------
# Grid helpers (see the module docstring)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridCtx:
    """Where a forward runs on a grid: the residual stream's batch axes
    and sequence axis (``"model"`` under sequence parallelism), and the
    caches' layout."""

    grid: Any
    batch: Tuple[str, ...]  # axes the residual's batch is sharded over
    seq: Optional[str]  # "model" when the residual's sequence is sharded
    cache_seq: bool = False  # the KV caches' sequence is sharded
    seq_shards: int = 1  # split-KV decode over this many model ranks

    @property
    def tp(self) -> int:
        """The model axis's size."""
        return self.grid.shape["model"]

    @property
    def varying(self) -> bool:
        """Whether the stream differs along ``"model"`` (each rank holds a
        share of it)."""
        return self.seq == "model" or "model" in self.batch


def spec_of(mod: nn.Module, name: str) -> tuple:
    """The spec of ``mod``'s parameter ``name`` (``()`` when unsharded)."""
    return getattr(mod, "_spec", {}).get(name, ())


def model_dim(mod: nn.Module, name: str) -> Optional[int]:
    """The dimension of ``mod.<name>`` sharded over ``"model"``, if any."""
    for d, e in enumerate(spec_of(mod, name)):
        if "model" in entry_axes(e):
            return d
    return None


def fsdp_gather(grid, mod: nn.Module, name: str) -> torch.Tensor:
    """``mod.<name>`` gathered over every non-model axis of its spec
    (FSDP's ``"data"``); the gradient is reduce-scattered back."""
    p = getattr(mod, name)
    for d, e in enumerate(spec_of(mod, name)):
        axes = tuple(a for a in entry_axes(e) if a != "model")
        if axes:
            p = all_gather(grid, p, axes, d)
    return p


def stream_weight(ctx: GridCtx, mod: nn.Module, name: str) -> torch.Tensor:
    """A replicated weight applied on the residual stream (a norm scale):
    entered when the stream varies along ``"model"``."""
    p = fsdp_gather(ctx.grid, mod, name)
    return enter(ctx.grid, p, "model") if ctx.varying else p


class Region:
    """One block's mixer or MLP on a grid, in ``mode`` ``"tp"``, ``"rep"``
    or ``"dp"`` (see the module docstring)."""

    def __init__(self, ctx: GridCtx, mode: str):
        self.ctx, self.mode, self.grid = ctx, mode, ctx.grid
        self.tp = ctx.tp if mode == "tp" else 1
        self.j = ctx.grid.axis_index("model") if mode == "tp" else 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The stream as this region's input: the whole sequence."""
        g, seq = self.grid, self.ctx.seq
        if self.mode == "tp":
            return all_gather(g, x, "model", 1) if seq else enter(g, x, "model")
        if self.mode == "rep" and seq:
            return all_gather_replicated(g, x, "model", 1)
        return x

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """The region's output back in the stream's layout (``"tp"``: the
        partial sums reduce-scattered over the sequence, or summed)."""
        g, seq = self.grid, self.ctx.seq
        if self.mode == "tp":
            return psum_scatter(g, y, "model", 1) if seq else psum(g, y, "model")
        if self.mode == "rep" and seq:
            return split(g, y, "model", 1)
        return y

    def w(self, mod: nn.Module, name: str) -> torch.Tensor:
        """``mod.<name>`` as this region uses it: ``"tp"`` keeps the rank's
        model block (a replicated weight is entered); the other modes use
        the whole weight."""
        if self.mode != "tp":
            return self.w_full(mod, name)
        p = fsdp_gather(self.grid, mod, name)
        return p if model_dim(mod, name) is not None else enter(self.grid, p, "model")

    def w_full(self, mod: nn.Module, name: str) -> torch.Tensor:
        """The whole of ``mod.<name>``: gathered over ``"model"`` (for
        varying work, gradient reduce-scattered; for replicated work,
        gradient kept to the rank's block) or entered when replicated."""
        p = fsdp_gather(self.grid, mod, name)
        d = model_dim(mod, name)
        varying = self.mode != "rep"
        if d is not None:
            gather = all_gather if varying else all_gather_replicated
            return gather(self.grid, p, "model", d)
        return enter(self.grid, p, "model") if varying else p
