"""Seed-and-extend x-drop pairwise alignment (paper §IV-D), in torch.

The PyTorch counterpart of ``repro.assembly.alignment``: every candidate
pair is extended forward from the end of its shared k-mer seed and backward
from its start by the banded x-drop wavefront (see
``kernels/xdrop/ref.py``); ``batch_extend`` runs both directions as one
batched ``xdrop_extend`` op call on the selected backend and combines them
into the alignment coordinates the overlap classifier consumes;
``extend_pair`` is the single-pair form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.backend import dispatch
from ..kernels.xdrop.ref import xdrop_extend_batch_ref


class Extension(NamedTuple):
    """One direction's result: best score and characters consumed."""

    score: torch.Tensor
    ai: torch.Tensor
    bj: torch.Tensor


def xdrop_extend(a, base_a, step_a, len_a, b, base_b, step_b, len_b, *,
                 xdrop: int = 15, match: int = 1, mismatch: int = -1,
                 gap: int = -1, band: int = 33, max_steps: int = 512
                 ) -> Extension:
    """Single-pair x-drop extension: ``a[base_a + step_a·t]`` for
    t ∈ [0, len_a) is the extension text of a (step −1 walks backwards
    from a seed), likewise for b."""
    def one(x):
        return torch.as_tensor(x, dtype=torch.int32, device=a.device).reshape(1)

    s, i, j = xdrop_extend_batch_ref(
        a[None], one(base_a), one(step_a), one(len_a), b[None], one(base_b),
        one(step_b), one(len_b), xdrop=xdrop, match=match, mismatch=mismatch,
        gap=gap, band=band, max_steps=max_steps,
    )
    return Extension(score=s[0], ai=i[0], bj=j[0])


class PairAlignment(NamedTuple):
    """Alignment of a read pair: score and spans [bi, ei) on read i
    (forward frame) and [bj, ej) on read j (oriented frame)."""

    score: torch.Tensor
    bi: torch.Tensor
    ei: torch.Tensor
    bj: torch.Tensor
    ej: torch.Tensor


def extend_pair(a, la, b_oriented, lb, pa, pb, *, k: int, xdrop: int = 15,
                match: int = 1, mismatch: int = -1, gap: int = -1,
                band: int = 33, max_steps: int = 512) -> PairAlignment:
    """Seed-and-extend of one pair around an exact k-mer seed at ``pa`` on
    ``a`` and ``pb`` on the oriented ``b``: forward from the seed's end,
    backward from its start."""
    kw = dict(xdrop=xdrop, match=match, mismatch=mismatch, gap=gap,
              band=band, max_steps=max_steps)
    fwd = xdrop_extend(a, pa + k, 1, la - pa - k, b_oriented, pb + k, 1,
                       lb - pb - k, **kw)
    bwd = xdrop_extend(a, pa - 1, -1, pa, b_oriented, pb - 1, -1, pb, **kw)
    return PairAlignment(
        score=k * match + fwd.score + bwd.score,
        bi=pa - bwd.ai,
        ei=pa + k + fwd.ai,
        bj=pb - bwd.bj,
        ej=pb + k + fwd.bj,
    )


def batch_extend(a_codes, a_len, b_codes_oriented, b_len, pa, pb, *, k,
                 backend: str = "reference", match: int = 1,
                 **kw) -> PairAlignment:
    """Batched seed-and-extend through the dispatch seam: the forward and
    the backward extension run as one batched ``xdrop_extend`` op call,
    with (2, E) walks over the same rows."""
    fn = dispatch("xdrop_extend", backend, a_codes.device)
    i32 = torch.int32
    pa, pb, a_len, b_len = (x.to(i32) for x in (pa, pb, a_len, b_len))
    step = torch.ones(pa.shape, dtype=i32, device=pa.device)
    steps = torch.stack([step, -step])
    (fs, bs), (fa, ba), (fb, bb) = fn(
        a_codes.contiguous(), torch.stack([pa + k, pa - 1]), steps,
        torch.stack([a_len - pa - k, pa]), b_codes_oriented.contiguous(),
        torch.stack([pb + k, pb - 1]), steps, torch.stack([b_len - pb - k, pb]),
        match=match, **kw)
    return PairAlignment(
        score=k * match + fs + bs,
        bi=pa - ba,
        ei=pa + k + fa,
        bj=pb - bb,
        ej=pb + k + fb,
    )
