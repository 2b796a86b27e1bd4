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

``moe_ffn_shardmap`` is JAX's explicit expert parallelism on a
:class:`~repro_torch.core.grid.ProcessGrid`: each rank of the expert axis
holds ``E/tp`` experts and routes its own token block (replicated over the
expert axis) to them; capacity comes from that local block, assignments
to other ranks' experts go to the drop slot, and the combine is a ``psum``
over the expert axis.  ``moe_ffn_gspmd_grid`` keeps JAX's global dispatch
under a grid (capacity from every token).  Without a mesh JAX always takes
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
    safe_e = torch.where(r.keep, r.expert, 0)
    safe_p = torch.where(r.keep, r.slot, 0)
    y_tok = y_e[safe_e, safe_p] * (w.reshape(-1) * r.keep)[:, None].to(y_e.dtype)
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


class ExpertShard(NamedTuple):
    """A rank's MoE weights: the whole router and its experts' weights."""

    router: torch.Tensor  # (D, E)
    w_gate: torch.Tensor  # (E/tp, D, F)
    w_up: torch.Tensor
    w_down: torch.Tensor  # (E/tp, F, D)


def _local_routing(idx, w, lo: int, e_loc: int, capacity: int):
    """``(weights, Routing)`` of (T, K) routing restricted to experts
    ``[lo, lo + e_loc)``: others go to the drop slot ``e_loc`` with weight
    0 and are never kept."""
    local = (idx >= lo) & (idx < lo + e_loc)
    idx_l = torch.where(local, idx - lo, e_loc)
    w_l = torch.where(local, w, 0.0)
    r = dispatch_slots(idx_l, e_loc + 1, capacity)
    return w_l, r._replace(keep=r.keep & (r.expert < e_loc))


def moe_ffn_shardmap(x, p, *, mesh, n_experts_real: int, top_k: int,
                     capacity_factor: float = 1.25, token_axes=("data",),
                     expert_axis: str = "model"):
    """JAX's shard_map MoE on a ``ProcessGrid``, op for op: ``x`` (T, D) is
    this rank's token block (the block of ``token_axes``, replicated over
    ``expert_axis``), ``p`` an ``ExpertShard`` (or a module with those
    attributes) holding this rank's ``E/tp`` experts.  Returns the block's
    (T, D) output, summed over ``expert_axis``."""
    from ..core.grid import psum

    tp = mesh.size(expert_axis)
    e_loc = p.w_gate.shape[0]
    e = e_loc * tp
    t = x.shape[0]
    my = mesh.axis_index(expert_axis)
    w, idx = router_topk(x, p.router, n_experts_real, top_k)
    w_l, r = _local_routing(idx, w, my * e_loc, e_loc,
                            moe_capacity(t, top_k, e, capacity_factor))
    y = _dispatch_combine(x, w_l, r, p)
    return psum(mesh, y, expert_axis)


def moe_ffn_gspmd_grid(x, p, *, mesh, n_experts_real: int, top_k: int,
                       capacity_factor: float = 1.25, expert_axis: str = "model"):
    """JAX's global dispatch (``moe_ffn_gspmd``) with the experts sharded
    over ``expert_axis``: ``x`` (T, D) holds every token (capacity comes
    from all ``T``); returns this rank's experts' share of the output, to
    be summed over ``expert_axis`` by the caller."""
    tp = mesh.size(expert_axis)
    e_loc = p.w_gate.shape[0]
    e = e_loc * tp
    w, idx = router_topk(x, p.router, n_experts_real, top_k)
    r = dispatch_slots(idx, e, moe_capacity(x.shape[0], top_k, e,
                                            capacity_factor))
    lo = mesh.axis_index(expert_axis) * e_loc
    local = (r.expert >= lo) & (r.expert < lo + e_loc)
    r = r._replace(expert=torch.where(local, r.expert - lo, 0),
                   keep=r.keep & local)
    return _dispatch_combine(x, w, r, p)
