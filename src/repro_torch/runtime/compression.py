"""Gradient compression with error feedback (the port of
``repro.runtime.compression``).

``CompressedAllReduce`` wraps the data-parallel gradient reduction:
gradients are compressed (bf16, or int8 with a per-tensor scale), reduced
in the compressed domain over a ``ProcessGrid`` axis, and the quantization
error is fed back into the next step's gradients (error feedback makes the
compression unbiased over time — Seide et al. '14, Karimireddy et al. '19).
Gradient trees are dicts of tensors by parameter name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

Grads = Dict[str, torch.Tensor]


def bf16_compress(g: torch.Tensor) -> torch.Tensor:
    """Round to bf16."""
    return g.to(torch.bfloat16)


def bf16_decompress(c: torch.Tensor) -> torch.Tensor:
    """Back to f32."""
    return c.float()


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``(q, scale)`` with ``scale = (max|g| +
    1e-12) / 127`` and ``q = clip(round(g / scale), −127, 127)`` (round
    half to even, as ``jnp.round``)."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q · scale`` in f32."""
    return q.float() * scale


@dataclasses.dataclass(frozen=True)
class CompressedAllReduce:
    """mode: ``"none"`` | ``"bf16"`` | ``"int8"``.  ``reduce(grads, grid,
    axes)`` is the compressed mean over grid axes; ``compress_ef`` is the
    error-feedback compression on one process."""

    mode: str = "bf16"

    def init_error(self, params: Mapping[str, torch.Tensor]) -> Optional[Grads]:
        """Zero f32 residuals beside each parameter (None for ``"none"``)."""
        if self.mode == "none":
            return None
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    def compress_ef(self, grads: Grads, error: Optional[Grads]):
        """Error-feedback compression: returns (the decompressed compressed
        gradients, the new residuals).  The compressed form is what an
        all-reduce would carry."""
        if self.mode == "none":
            return grads, error
        dec, err = {}, {}
        for n, g in grads.items():
            g32 = g.float() + error[n]
            if self.mode == "bf16":
                d = bf16_decompress(bf16_compress(g32))
            else:
                d = int8_decompress(*int8_compress(g32))
            dec[n], err[n] = d, g32 - d
        return dec, err

    def reduce(self, grads: Grads, grid, axes) -> Grads:
        """The mean over ``axes`` of ``grid`` (a ``ProcessGrid``) of the
        compressed gradients: a psum / n of f32 (``"none"``) or bf16
        gradients, or for int8 the int32 psum of the codes times the
        largest scale over n."""
        n = grid.size(axes)
        if self.mode == "none":
            return {k: grid.psum(g, axes) / n for k, g in grads.items()}
        if self.mode == "bf16":
            return {k: bf16_decompress(grid.psum(bf16_compress(g), axes) / n)
                    for k, g in grads.items()}
        out = {}
        for k, g in grads.items():
            q, s = int8_compress(g)
            qsum = grid.psum(q.to(torch.int32), axes)
            smax = grid.pmax(s, axes)
            out[k] = qsum.float() * smax / n
        return out

    def wire_bytes(self, params: Mapping[str, torch.Tensor]) -> int:
        """Bytes one reduction carries for ``params``."""
        per = {"none": 4, "bf16": 2, "int8": 1}[self.mode]
        return sum(int(p.numel()) * per for p in params.values())
