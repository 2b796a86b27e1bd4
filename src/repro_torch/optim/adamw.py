"""AdamW with decoupled weight decay, global-norm clipping and f32 moments
(the port of ``repro.optim.adamw``), applied in place.

JAX's algebra, term for term: gradients in f32, scaled by ``min(1, clip /
max(‖g‖, 1e-12))``; ``μ ← b1·μ + (1 − b1)·g``, ``ν ← b2·ν + (1 − b2)·g·g``;
bias corrections with ``t = step + 1``; ``u = −lr·(μ̂ / (√ν̂ + eps) + wd·p)``
on **every** parameter (norm scales and embeddings too); ``p ← p + u``.
The scalars (``lr``, the corrections, the clip scale) are f32, as JAX's
traced scalars are.  The update runs one parameter at a time with
in-place ops, so the extra memory is a few copies of the largest leaf,
not of the whole model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Union

import torch


class OptState(NamedTuple):
    """First and second moments by parameter name, f32."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def global_norm(tensors, *, grid=None, specs=None) -> torch.Tensor:
    """f32 L2 norm over every tensor (JAX's ``sqrt(Σ Σ g²)``).  On a grid
    ``tensors`` maps parameter names to the rank's blocks and ``specs``
    gives each one's spec: a leaf's squared sum is summed over the axes it
    is sharded on, so a replicated leaf counts once, and every rank gets
    the global norm."""
    if grid is None:
        if isinstance(tensors, Mapping):
            tensors = tensors.values()
        return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in tensors))
    groups: Dict[tuple, torch.Tensor] = {}
    for name, g in tensors.items():
        axes = tuple(a for e in (specs or {}).get(name, ())
                     for a in ((e,) if isinstance(e, str) else (e or ()))
                     if grid.shape[a] > 1)
        sq = torch.sum(g.float() * g.float())
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = None
    for axes in sorted(groups):
        part = grid.psum(groups[axes], axes) if axes else groups[axes]
        total = part if total is None else total + part
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """JAX's ``AdamW`` (the same fields and defaults)."""

    learning_rate: Union[Callable[[int], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Union[float, None] = 1.0

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        """Zero f32 moments beside each parameter."""
        def z():
            return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for n, p in params.items()}
        return OptState(mu=z(), nu=z())

    def _lr(self, step: int) -> torch.Tensor:
        if callable(self.learning_rate):
            return _f32(self.learning_rate(step))
        return _f32(self.learning_rate)

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: OptState,
                params: Mapping[str, torch.Tensor], step: int, *,
                grid=None, specs=None) -> None:
        """Apply one step to ``params`` and ``state`` in place.  ``grads``
        (by parameter name) are consumed: f32 gradients are scaled in
        place.  On a grid (the rank's blocks, placed by ``specs``) the
        clipping norm is the global one, so every rank scales alike."""
        g32 = {n: g.float() for n, g in grads.items()}
        if self.clip_norm is not None:
            gn = global_norm(g32, grid=grid, specs=specs)
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
            for g in g32.values():
                g.mul_(scale)
        t = _f32(step) + 1.0
        bc1 = float(1.0 - _f32(self.b1) ** t)
        bc2 = float(1.0 - _f32(self.b2) ** t)
        neg_lr = float(-self._lr(step))
        for name, p in params.items():
            g, m, v = g32[name], state.mu[name], state.nu[name]
            m.mul_(self.b1).add_(g * (1 - self.b1))
            gg = g * (1 - self.b2)
            v.mul_(self.b2).add_(gg.mul_(g))
            del gg
            denom = torch.sqrt(v / bc2).add_(self.eps)
            u = (m / bc1).div_(denom)
            del denom
            u.add_(p.float() * self.weight_decay).mul_(neg_lr)
            p.add_(u.to(p.dtype))
            del u
            g32[name] = None
