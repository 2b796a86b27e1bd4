"""Attention on torch tensors (the port of ``repro.models.attention``):
the block-wise online-softmax prefill path and the one-token decode path
over a KV cache.

* ``flash_attention`` walks query blocks and, inside each, KV blocks with
  the running (max, sum, accumulator) of JAX's ``lax.scan``, so the S×S
  score matrix is never held (a 32k prefill would need 4 GB a head).
  Scores and the P·V product are f32 products of the upcast operands, as
  JAX's ``preferred_element_type=jnp.float32`` gives on bf16 operands.
* ``decode_attention`` is one token against the whole cache, masked to
  the valid length (and window).
* ``cache_update`` writes the new keys and values into the cache in place,
  with ``dynamic_update_slice``'s clamp of the start.

With gradients on, each query block step, and inside it each KV block
step, is recomputed in the backward (JAX's ``jax.checkpoint`` of
``q_step`` and of ``kv_step``): only each query block's output is kept.

On a :class:`~repro_torch.core.grid.ProcessGrid` whose ``"model"`` axis
shards the cache's sequence, ``decode_attention_sharded`` is JAX's
shard_map body (the FlashDecoding split-KV merge): each rank scores its
KV slice, and the merge is a ``pmax`` and two ``psum`` calls.
``cache_update_sharded`` is the owner-writes decode update, and
``cache_update_owned`` the GSPMD ``dynamic_update_slice`` of a longer
write (a prefill) into a sequence-sharded cache: each rank writes the part
of the clamped range it holds.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _scale(d: int, device) -> torch.Tensor:
    """``1 / sqrt(d)`` in f32, as JAX computes it."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                         device=device))


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,  # global position of q[0] (for cached prefill)
    q_block: int = 512,
    kv_block: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over ``q_block`` × ``kv_block`` tiles.

    Query head ``h`` reads KV head ``h // (Hq/Hkv)``.  A KV block that every
    query row of the block masks out is skipped where that is exact: with
    ``q_offset == 0``, ``Sq <= Skv`` and a causal mask every real row has
    its own key, so a skipped block would only have added zeros (or
    garbage that the first unmasked block multiplies by exactly 0)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qb = min(q_block, sq)
    kb = min(kv_block, skv)
    n_qb = -(-sq // qb)
    n_kb = -(-skv // kb)
    # pad (B, S, H, D) to block multiples along S
    q = F.pad(q, (0, 0, 0, 0, 0, n_qb * qb - sq))
    k = F.pad(k, (0, 0, 0, 0, 0, n_kb * kb - skv))
    v = F.pad(v, (0, 0, 0, 0, 0, n_kb * kb - skv))
    dev = q.device
    # (n_qb, B, Hkv, G·qb, D) and (n_kb, B, Hkv, kb, D)
    qr = q.reshape(b, n_qb, qb, hkv, g, d).permute(1, 0, 3, 4, 2, 5)
    qr = qr.reshape(n_qb, b, hkv, g * qb, d)
    kr = k.reshape(b, n_kb, kb, hkv, d).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, n_kb, kb, hkv, d).permute(1, 0, 3, 2, 4)
    scale = _scale(d, dev)
    skip_ok = (causal and q_offset == 0 and sq <= skv
               and (window is None or window > 0))
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    outs = []
    for qi in range(n_qb):
        args = (qr[qi], kr, vr, g, q_offset + qi * qb, skv, scale, causal,
                window, skip_ok, remat)
        if remat:  # JAX's jax.checkpoint of q_step: only the output kept
            outs.append(checkpoint(_q_step, *args, use_reentrant=False))
        else:
            outs.append(_q_step(*args))
    # (n_qb, B, Hkv, G, qb, D) -> (B, n_qb·qb, Hq, D)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, n_qb * qb, hq, d)
    return out[:, :sq]


def _q_step(qsrc, kr, vr, g: int, q_lo: int, skv: int, scale, causal: bool,
            window, skip_ok: bool, remat: bool):
    """One query block against the KV blocks: qsrc (B, Hkv, G·qb, D), kr /
    vr (n_kb, B, Hkv, kb, D); returns the block's output (B, Hkv, G, qb,
    D) in ``qsrc``'s dtype."""
    b, hkv, gq, d = qsrc.shape
    qb, kb = gq // g, kr.shape[3]
    dev = qsrc.device
    qblk = qsrc.float()
    m = torch.full((b, hkv, g, qb), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, qb), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, qb, d), dtype=torch.float32, device=dev)
    for ki in range(kr.shape[0]):
        k_lo = ki * kb
        if skip_ok and (k_lo > q_lo + qb - 1 or (
                window is not None and k_lo + kb - 1 <= q_lo - window)):
            continue
        args = (qblk, kr[ki], vr[ki], m, l, acc, q_lo, k_lo, skv, scale,
                causal, window)
        if remat:  # JAX's jax.checkpoint of kv_step: no S² scores kept
            m, l, acc = checkpoint(_kv_step, *args, use_reentrant=False)
        else:
            m, l, acc = _kv_step(*args)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(qsrc.dtype)


def _kv_step(qblk, kblk, vblk, m, l, acc, q_lo: int, k_lo: int, skv: int,
             scale, causal: bool, window):
    """One KV block of the online softmax: qblk (B, Hkv, G·qb, D) f32, kblk
    / vblk (B, Hkv, kb, D); returns the new running (max, sum, acc)."""
    b, hkv, _, d = qblk.shape
    g, qb = m.shape[2], m.shape[3]
    kb = kblk.shape[2]
    dev = qblk.device
    qpos = q_lo + torch.arange(qb, device=dev)
    kpos = k_lo + torch.arange(kb, device=dev)
    s_ = torch.matmul(qblk, kblk.float().transpose(-1, -2))
    s_ = s_.reshape(b, hkv, g, qb, kb) * scale
    mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask &= (kpos < skv)[None, :]
    s_ = torch.where(mask, s_, NEG_INF)
    m2 = torch.maximum(m, s_.amax(dim=-1))
    p = torch.exp(s_ - m2[..., None])
    corr = torch.exp(m - m2)
    l = l * corr + p.sum(dim=-1)
    pv = torch.matmul(p.to(vblk.dtype).float().reshape(b, hkv, g * qb, kb),
                      vblk.float())
    acc = acc * corr[..., None] + pv.reshape(b, hkv, g, qb, d)
    return m2, l, acc


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,
    cur_len: Union[int, torch.Tensor],  # (B,) or scalar: valid cache length
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention over the whole cache, masked to positions
    below ``cur_len`` (and at or above ``cur_len - window``)."""
    b, s, hkv, d = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    dev = q.device
    qr = q.reshape(b, hkv, g, d).float()
    s_ = torch.matmul(qr, k_cache.float().permute(0, 2, 3, 1)) * _scale(d, dev)
    pos = torch.arange(s, device=dev)
    cur = torch.as_tensor(cur_len, device=dev)
    cur = cur[:, None] if cur.ndim == 1 else cur
    mask = pos[None, :] < cur
    if window is not None:
        mask = mask & (pos[None, :] >= cur - window)
    s_ = torch.where(mask[:, None, None, :], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.matmul(p.to(v_cache.dtype).float(),
                       v_cache.float().permute(0, 2, 1, 3))
    return out.reshape(b, 1, hq, d).to(q.dtype)


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: int):
    """Write ``k/v_new`` (B, S_new, Hkv, D) into the caches at ``pos``, in
    place, and return the caches.  The start is clamped to
    ``[0, S - S_new]`` as ``lax.dynamic_update_slice`` clamps it."""
    s_new = k_new.shape[1]
    start = max(0, min(int(pos), k_cache.shape[1] - s_new))
    k_cache[:, start:start + s_new] = k_new.to(k_cache.dtype)
    v_cache[:, start:start + s_new] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def decode_attention_sharded(q, k_cache, v_cache, cur_len, *, mesh,
                             seq_axis: str = "model", window=None):
    """FlashDecoding split-KV decode (JAX's shard_map body, op for op):
    ``k_cache``/``v_cache`` are this rank's (B, S/n, Hkv, D) slice of a
    cache whose sequence is sharded over ``seq_axis`` of ``mesh`` (a
    ``ProcessGrid``); ``q`` (B, 1, Hq, D) holds every head.  Positions of
    the slice are ``idx·s_loc + arange(s_loc)``; the local masked scores
    are merged by ``pmax`` of the maxima and ``psum`` of the sums and of
    the P·V products."""
    from ..core.grid import ProcessGrid

    if not isinstance(mesh, ProcessGrid):
        raise TypeError(f"mesh must be a ProcessGrid, got {type(mesh).__name__}")
    b, s_loc, hkv, d = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    dev = q.device
    idx = mesh.axis_index(seq_axis)
    qr = q.reshape(b, hkv, g, d).float()
    s_ = torch.matmul(qr, k_cache.float().permute(0, 2, 3, 1)) * _scale(d, dev)
    pos = idx * s_loc + torch.arange(s_loc, device=dev)
    cur = torch.as_tensor(cur_len, device=dev).reshape(-1, 1)
    mask = pos[None, :] < cur
    if window is not None:
        mask = mask & (pos[None, :] >= cur - window)
    s_ = torch.where(mask[:, None, None, :], s_, NEG_INF)
    m = mesh.pmax(s_.amax(dim=-1), seq_axis)
    p = torch.exp(s_ - m[..., None])
    l = mesh.psum(p.sum(dim=-1), seq_axis)
    o = mesh.psum(torch.matmul(p.to(v_cache.dtype).float(),
                               v_cache.float().permute(0, 2, 1, 3)), seq_axis)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def cache_update_sharded(k_cache, v_cache, k_new, v_new, pos, *, mesh,
                         seq_axis: str = "model"):
    """Owner-writes one-token update of this rank's (B, S/n, Hkv, D) slice
    of a sequence-sharded cache, in place (JAX's shard_map body): the rank
    whose slice holds ``pos`` writes at ``pos − idx·s_loc``; a ``pos``
    outside the cache is written by no rank."""
    s_loc = k_cache.shape[1]
    local = int(pos) - mesh.axis_index(seq_axis) * s_loc
    if 0 <= local < s_loc:
        k_cache[:, local:local + 1] = k_new.to(k_cache.dtype)
        v_cache[:, local:local + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def cache_update_owned(k_cache, v_cache, k_new, v_new, pos, *, mesh,
                       seq_axis: str = "model"):
    """``cache_update`` of the logical cache on this rank's sequence slice,
    in place: the start is clamped to ``[0, S - S_new]`` of the logical
    length ``S``, as ``lax.dynamic_update_slice`` clamps it, and each rank
    writes the part of ``[start, start + S_new)`` that its slice holds."""
    s_loc = k_cache.shape[1]
    s_tot = s_loc * mesh.size(seq_axis)
    s_new = k_new.shape[1]
    start = max(0, min(int(pos), s_tot - s_new))
    lo = mesh.axis_index(seq_axis) * s_loc
    a, b = max(start, lo), min(start + s_new, lo + s_loc)
    if a < b:
        k_cache[:, a - lo:b - lo] = k_new[:, a - start:b - start].to(k_cache.dtype)
        v_cache[:, a - lo:b - lo] = v_new[:, a - start:b - start].to(v_cache.dtype)
    return k_cache, v_cache
