"""Mixture-of-Experts FFN on torch tensors (the port of
``repro.models.moe``): top-k routing and GShard-style capacity-bounded
dispatch.

Each expert takes at most ``capacity = max(1, int(T·K·1.25/E_padded))``
assignments; slots go by a running count in flat ``(token, k)`` order, k
in ``top_k``'s descending order, and the assignments past an expert's
capacity are dropped, exactly as JAX drops them.  Padded experts (60 → 64
for qwen2-moe) get −1e30 router logits and zero weights.  The combine adds
each token's K contributions in k order in the compute dtype, a fixed
order (no atomics).

``moe_ffn_shardmap`` (expert parallelism on a mesh) waits for the model's
grid port (ROADMAP queue 1, item 14b.3); without a mesh JAX always takes
``moe_ffn_gspmd``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def router_topk(x, w_router, n_experts_real: int, top_k: int):
    """Returns (weights (T, K) f32, idx (T, K) int64), k in descending
    logit order."""
    logits = torch.matmul(x.float(), w_router.float())
    e_pad = w_router.shape[1]
    if e_pad > n_experts_real:
        pad_mask = torch.arange(e_pad, device=x.device) >= n_experts_real
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    topv, topi = torch.topk(logits, top_k, dim=-1, sorted=True)
    w = torch.softmax(topv, dim=-1)
    return w, topi


def expert_ffn(xe, w_gate, w_up, w_down):
    """xe (E, C, D); weights (E, D, F)/(E, F, D); SwiGLU per expert in
    ``xe``'s dtype."""
    dt = xe.dtype
    g = torch.bmm(xe, w_gate.to(dt))
    u = torch.bmm(xe, w_up.to(dt))
    return torch.bmm(F.silu(g) * u, w_down.to(dt))


class Routing(NamedTuple):
    """Where each of the T·K assignments goes, in flat (token, k) order."""

    expert: torch.Tensor  # (T·K,) expert id
    slot: torch.Tensor  # (T·K,) position in the expert's buffer
    keep: torch.Tensor  # (T·K,) bool: inside the expert's capacity
    capacity: int  # slots per expert


def dispatch_slots(idx: torch.Tensor, n_experts: int, capacity: int) -> Routing:
    """Each assignment's slot: the count of earlier assignments (flat
    ``(token, k)`` order) to the same expert, kept below ``capacity``."""
    flat_e = idx.reshape(-1).long()
    oh = F.one_hot(flat_e, n_experts).to(torch.int32)  # (T·K, E)
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1
    flat_pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    return Routing(flat_e, flat_pos, flat_pos < capacity, capacity)


def moe_capacity(t: int, top_k: int, n_experts_padded: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert for ``t`` tokens."""
    return max(1, int(t * top_k * capacity_factor / n_experts_padded))


def route(x, p, *, n_experts_real: int, top_k: int,
          capacity_factor: float = 1.25):
    """The routing of (T, D) tokens: (weights (T, K) f32, ``Routing``)."""
    e = p.w_gate.shape[0]
    w, idx = router_topk(x, p.router, n_experts_real, top_k)
    return w, dispatch_slots(idx, e, moe_capacity(x.shape[0], top_k, e,
                                                  capacity_factor))


def _dispatch_combine(x, w, r: Routing, p):
    """Dispatch → expert FFN → combine; ``p`` has ``w_gate``, ``w_up``,
    ``w_down`` as attributes."""
    t, d = x.shape
    k = w.shape[1]
    e = p.w_gate.shape[0]
    capacity = int(r.capacity)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    # kept assignments have distinct (expert, slot) places: a plain write
    buf = x.new_zeros((e, capacity, d))
    buf[r.expert[r.keep], r.slot[r.keep]] = x[tok[r.keep]]
    y_e = expert_ffn(buf, p.w_gate, p.w_up, p.w_down)
    safe_p = torch.where(r.keep, r.slot, 0)
    y_tok = y_e[r.expert, safe_p] * (w.reshape(-1) * r.keep)[:, None].to(y_e.dtype)
    y_tok = y_tok.reshape(t, k, d)
    out = y_tok[:, 0]
    for j in range(1, k):
        out = out + y_tok[:, j]
    return out


def moe_ffn_gspmd(
    x,  # (T, D) token-major
    p,  # router (D, E); w_gate/w_up (E, D, F); w_down (E, F, D)
    *,
    n_experts_real: int,
    top_k: int,
    capacity_factor: float = 1.25,
):
    """Routed experts of one MoE layer on (T, D) tokens."""
    w, r = route(x, p, n_experts_real=n_experts_real, top_k=top_k,
                 capacity_factor=capacity_factor)
    return _dispatch_combine(x, w, r, p)
