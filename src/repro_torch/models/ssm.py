"""Mamba-2 SSD (state-space duality) layer on torch tensors (the port of
``repro.models.ssm``).

Prefill uses the chunked SSD form: inside a chunk of Q tokens the
recurrence is a decay-masked quadratic form, and a (B, H, N, P) state is
carried from chunk to chunk (JAX's ``lax.scan`` is a loop here).  With
gradients on, each chunk step is recomputed in the backward (JAX's
``jax.checkpoint`` of ``chunk_step``): only the carried state is kept.  Decode
keeps the recurrent state and costs O(1) a token.  Products that JAX asks
for in f32 (``preferred_element_type``) are f32 products of the upcast
operands.

Shapes: d_inner = expand·d_model, H = d_inner/headdim heads, state N,
B/C shared across heads, per-step decay a_t = exp(Δ_t·A).

On a grid (``mesh=``) the SSD heads are sharded over ``"model"`` (JAX's
constraint on ``xh``) when H divides by it: the input projection, whose
column shard cuts across the ``[z | xBC | dt]`` concatenation, is
gathered whole, the convolution runs on every channel (its tail stays
whole on every rank), and each rank runs the scan, the gated norm (its
mean of squares summed over the axis) and its rows of ``out_proj`` for its
own heads; the partial outputs are summed over ``"model"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import dense, rms_norm, softplus


class SSMState(NamedTuple):
    """A Mamba-2 layer's decode state."""

    h: torch.Tensor  # (B, H, N, P) inter-chunk state
    conv: torch.Tensor  # (B, W-1, conv_dim) conv tail


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv1d. x (B, S, C), w (W, C), b (C,).
    Returns (silu(y), new_tail)."""
    bsz, s, c = x.shape
    wlen = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((bsz, wlen - 1, c))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = torch.zeros_like(x)
    for t in range(wlen):
        y = y + xp[:, t: t + s, :] * w[t].to(x.dtype)
    y = y + b.to(x.dtype)
    return F.silu(y), (xp[:, -(wlen - 1):, :] if wlen > 1 else pad)


def ssd_chunked(xh, dt, a_log, bmat, cmat, *, chunk: int = 128,
                compute_bf16: bool = False):
    """SSD forward.

    xh (B, S, H, P); dt (B, S, H) post-softplus; a_log (H,) (A = −exp(a_log));
    bmat/cmat (B, S, N).  Returns y (B, S, H, P) in ``xh``'s dtype and the
    final state (B, H, N, P) in f32.  ``compute_bf16`` keeps the Δ-scaled
    inputs and chunk buffers in bf16 (the state stays f32)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    dev = xh.device
    a = -torch.exp(a_log.float())  # (H,) negative
    loga = dt.float() * a  # (B, S', H) log decay per step
    cdt = torch.bfloat16 if compute_bf16 else torch.float32
    xc = (xh * dt[..., None]).to(cdt)  # Δ-scaled input

    xs = xc.reshape(b, nc, q, h, p)
    ls = loga.reshape(b, nc, q, h)
    bs = bmat.reshape(b, nc, q, n).to(cdt)
    cs = cmat.reshape(b, nc, q, n).to(cdt)
    tri = (torch.arange(q, device=dev)[:, None]
           >= torch.arange(q, device=dev)[None, :])[None, :, :, None]

    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xh, dt, a_log, bmat, cmat))
    hstate = torch.zeros((b, h, n, p), dtype=torch.float32, device=dev)
    ys = []
    for ci in range(nc):
        args = (hstate, xs[:, ci], ls[:, ci], bs[:, ci], cs[:, ci], tri, cdt)
        if remat:  # JAX's jax.checkpoint of chunk_step: only the carry kept
            hstate, yc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            hstate, yc = _chunk_step(*args)
        ys.append(yc)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, h, p)[:, :s]
    return y.to(xh.dtype), hstate


def _chunk_step(hstate, xq, lq, bq, cq, tri, cdt):
    """One SSD chunk: the carried state (B, H, N, P) f32 and the chunk's
    xq (B, Q, H, P), lq (B, Q, H), bq/cq (B, Q, N); returns the next state
    and the chunk's y (B, Q, H, P) f32."""
    cum = torch.cumsum(lq, dim=1)  # L_t inclusive
    # intra-chunk: scores[t, s] = (C_t·B_s) exp(L_t − L_s) for s ≤ t
    cb = torch.matmul(cq.float(), bq.float().transpose(1, 2))  # (B,Q,Q)
    gap = cum[:, :, None, :] - cum[:, None, :, :]  # (B,t,s,H)
    # masked before the exp: above the diagonal the gap is positive and
    # can pass exp's f32 range (88.7), and an inf there, though masked out
    # of the value, makes the backward 0 · inf = NaN (JAX's where does)
    w = (torch.exp(gap.masked_fill(~tri, float("-inf")))
         * cb[..., None]).to(cdt)
    y_intra = torch.einsum("btsh,bshp->bthp", w.float(), xq.float())
    # contribution of the carried state: Y_t += C_t · h · exp(L_t)
    y_inter = torch.einsum("btn,bhnp->bthp", cq.float(),
                           hstate) * torch.exp(cum)[..., None]
    # new state: h' = exp(L_end) h + Σ_s exp(L_end − L_s) B_s ⊗ x_s
    lend = cum[:, -1, :]  # (B,H)
    decay_s = torch.exp(lend[:, None, :] - cum).to(cdt)  # (B,Q,H)
    s_chunk = torch.einsum("bsn,bsh,bshp->bhnp", bq.float(),
                           decay_s.float(), xq.float())
    hstate = torch.exp(lend)[:, :, None, None] * hstate + s_chunk
    return hstate, y_intra + y_inter


def ssd_decode_step(hstate, x1, dt1, a_log, b1, c1):
    """One-token recurrent update. x1 (B, H, P), dt1 (B, H), b1/c1 (B, N).
    Returns the new state (f32) and y (B, H, P) in ``x1``'s dtype."""
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt1.float() * a)  # (B, H)
    upd = torch.einsum("bn,bhp->bhnp", b1.float(),
                       (x1 * dt1[..., None]).float())
    h2 = decay[:, :, None, None] * hstate + upd
    y = torch.einsum("bn,bhnp->bhp", c1.float(), h2)
    return h2, y.to(x1.dtype)


def mamba2_params_shapes(d_model: int, *, expand: int, headdim: int, state: int,
                         conv_width: int):
    """Derived sizes of a Mamba-2 mixer."""
    d_inner = expand * d_model
    h = d_inner // headdim
    conv_dim = d_inner + 2 * state
    return {
        "d_inner": d_inner,
        "n_heads": h,
        "conv_dim": conv_dim,
        "in_features": 2 * d_inner + 2 * state + h,
        "conv_width": conv_width,
    }


def mamba2_forward(x, p, cfg, *, state: Optional[SSMState] = None,
                   chunk: int = 128, mesh=None):
    """Full Mamba-2 mixer. x (B, S, D); ``p`` has the parameters as
    attributes (``in_proj``, ``out_proj``, ``conv_w``, ``conv_b``,
    ``dt_bias``, ``a_log``, ``d_skip``, ``norm``).  Returns (y (B, S, D),
    SSMState).  ``mesh`` (a ``ProcessGrid``; ``p`` then holds the rank's
    blocks, ``shard_model``'s, and ``x`` the rank's rows, replicated over
    ``"model"``) runs it with the SSD heads over ``"model"``."""
    if mesh is not None:
        from ..runtime.sharding import dp_axes
        from .layers import GridCtx

        ctx = GridCtx(mesh, batch=dp_axes(mesh), seq=None)
        return mamba2_grid(x, p, cfg, ctx, state=state, chunk=chunk)
    bsz, s, _ = x.shape
    dims = mamba2_params_shapes(
        x.shape[-1], expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
        state=cfg.ssm_state, conv_width=cfg.conv_width,
    )
    di, h, n = dims["d_inner"], dims["n_heads"], cfg.ssm_state
    proj = dense(x, p.in_proj)  # (B,S, 2di+2n+h)
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    xconv, new_tail = _causal_conv(
        xbc, p.conv_w, p.conv_b, None if state is None else state.conv,
    )
    xh = xconv[..., :di].reshape(bsz, s, h, di // h)
    bmat = xconv[..., di: di + n]
    cmat = xconv[..., di + n:]
    dt = softplus(dt.float() + p.dt_bias)
    if s == 1 and state is not None:
        h2, y1 = ssd_decode_step(
            state.h, xh[:, 0], dt[:, 0], p.a_log, bmat[:, 0], cmat[:, 0]
        )
        y = y1[:, None]
        hfin = h2
    else:
        y, hfin = ssd_chunked(xh, dt, p.a_log, bmat, cmat, chunk=chunk,
                              compute_bf16=getattr(cfg, "ssd_bf16", False))
    y = y + xh * p.d_skip.to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p.norm)
    out = dense(y, p.out_proj)
    return out, SSMState(h=hfin, conv=new_tail)


def ssm_mode(cfg, ctx) -> str:
    """The region mode of a Mamba-2 mixer on ``ctx``'s grid: heads over
    ``"model"`` when they divide by it."""
    if "model" in ctx.batch:
        return "dp"
    h = mamba2_params_shapes(cfg.d_model, expand=cfg.ssm_expand,
                             headdim=cfg.ssm_headdim, state=cfg.ssm_state,
                             conv_width=cfg.conv_width)["n_heads"]
    return "tp" if h % ctx.tp == 0 else "rep"


def mamba2_grid(x, p, cfg, ctx, *, state: Optional[SSMState] = None,
                chunk: int = 128):
    """``mamba2_forward`` on ``ctx``'s grid (see the module docstring).
    ``x`` is in the stream's layout (replicated over ``"model"``, or its
    rows in ``"dp"`` mode).  ``state.h`` may hold every head or the rank's
    heads; the returned state has the same layout, and a whole conv
    tail."""
    from ..core.grid import enter, psum
    from .layers import Region

    mode = ssm_mode(cfg, ctx)
    reg = Region(ctx, mode)
    grid = ctx.grid
    bsz, s, d = x.shape
    dims = mamba2_params_shapes(d, expand=cfg.ssm_expand,
                                headdim=cfg.ssm_headdim, state=cfg.ssm_state,
                                conv_width=cfg.conv_width)
    di, h, n = dims["d_inner"], dims["n_heads"], cfg.ssm_state
    hp = di // h
    hl, lo = h // reg.tp, reg.j * (h // reg.tp)
    xin = reg.enter(x)
    proj = dense(xin, reg.w_full(p, "in_proj"))  # every column
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    xconv, new_tail = _causal_conv(
        xbc, reg.w_full(p, "conv_w"), reg.w_full(p, "conv_b"),
        None if state is None else state.conv)
    xh = xconv[..., :di].reshape(bsz, s, h, hp)[:, :, lo:lo + hl]
    bmat = xconv[..., di: di + n]
    cmat = xconv[..., di + n:]
    dt = softplus(dt.float() + reg.w_full(p, "dt_bias"))[..., lo:lo + hl]
    a_log = reg.w_full(p, "a_log")[lo:lo + hl]
    h_state = None
    if state is not None:
        h_state = state.h if state.h.shape[1] == hl else state.h[:, lo:lo + hl]
    if s == 1 and state is not None:
        hfin, y1 = ssd_decode_step(h_state, xh[:, 0], dt[:, 0], a_log,
                                   bmat[:, 0], cmat[:, 0])
        y = y1[:, None]
    else:
        y, hfin = ssd_chunked(xh, dt, a_log, bmat, cmat, chunk=chunk,
                              compute_bf16=getattr(cfg, "ssd_bf16", False))
    d_skip = reg.w_full(p, "d_skip")[lo:lo + hl]
    y = y + xh * d_skip.to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, hl * hp)
    cols = slice(lo * hp, (lo + hl) * hp)
    gated = y * F.silu(z[..., cols].float()).to(y.dtype)
    norm = reg.w_full(p, "norm")[cols]
    if reg.tp == 1:
        y = rms_norm(gated, norm)
    else:  # the mean of squares over every head: summed over "model"
        gf = gated.float()
        ss = enter(grid, psum(grid, torch.sum(gf * gf, dim=-1, keepdim=True),
                              "model"), "model")
        y = ((gf * torch.rsqrt(ss / di + 1e-6)) * (1.0 + norm.float())
             ).to(gated.dtype)
    out = reg.leave(dense(y, reg.w_full(p, "out_proj")[cols]))
    if state is not None and state.h.shape[1] != hfin.shape[1]:
        hfin = grid.all_gather(hfin.contiguous(), "model", dim=1)
    return out, SSMState(h=hfin, conv=new_tail)
