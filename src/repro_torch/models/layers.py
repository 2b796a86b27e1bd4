"""Shared transformer layers on torch tensors (the port of
``repro.models.layers``).

A serving model stores each parameter in the dtype the forward uses it in
(the config's compute dtype, or f32 for norm scales), a training model
every parameter in f32 as JAX does; compute keeps JAX's f32 normalization
and rotation statistics.  ``apply_rope`` carries JAX's ``custom_vjp``: its
backward is the inverse rotation, computed in f32 and rounded once.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn


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
