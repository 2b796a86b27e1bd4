"""``ModelConfig``, the model's blocks, and the serving and training step
factories for the ten language-model archs (the port of
``repro.models.model``), on one device or on a grid.

* The blocks are ``nn.Module``s whose parameter names follow JAX's tree
  paths one to one: JAX's ``params["slots"][s]["attn"]["wq"][i]`` (leaf
  stacked over the ``n_periods`` periods) is the port's
  ``slots.{s}.{i}.attn.wq``.  Weights keep JAX's ``(d_in, d_out)`` layout.
* A serving model (``init_params(cfg, gen)``) stores each parameter in the
  dtype JAX's forward uses it in: the config's compute dtype for the
  matmul weights, ``embed``, ``unembed``, the expert weights, ``conv_w``,
  ``conv_b`` and ``d_skip``; f32 for the norm scales, ``router``,
  ``dt_bias`` and ``a_log``.  JAX keeps f32 and casts at every use; a cast
  gives the same bits once or every time.  A training model
  (``init_params(cfg, gen, train=True)``) stores every parameter in f32
  with gradients, as JAX's ``init_params`` does: the optimizer updates the
  f32 master and the forward casts at use.
* gemma3's 5:1 local:global pattern is a per-layer switch of window and
  rope θ (``layer_attn``); hymba's global layers switch the window only.
* Caches are JAX's structure (a list per period slot of tensors stacked
  over periods) and are updated in place, as JAX's serve donates them.
* Training: ``forward`` without caches, with gradients, recomputes each
  period group in the backward (JAX's ``jax.checkpoint`` of the scan
  body), so only the residual stream is kept between groups; the loss is
  JAX's sequence-chunked cross entropy, each chunk recomputed too.

On a grid (``mesh=`` a :class:`~repro_torch.core.grid.ProcessGrid`, one
rank a card) the model holds the rank's blocks of its parameters
(``runtime.sharding.shard_model``), the batch is the rank's rows
(``batch_sharding``) and the caches its blocks (``init_cache(mesh=)``).
Where JAX leaves partitioning to GSPMD the result equals JAX's without a
mesh, and each tensor lies as JAX's constraint places it: the residual
stream is sequence-parallel over ``"model"`` for the attention archs and
replicated over it for SSM/hybrid (batch-sharded over it with
``batch_over_model``, without caches); attention, MLP and the SSD heads
are tensor-parallel (``layers.Region``); the vocab-sharded embedding looks
up its own ids and reduce-scatters.  Where JAX fixes the computation by
``shard_map`` the port follows it collective for collective:
``moe_ffn_shardmap``, split-KV decode, owner-writes cache updates, and
the vocab-parallel cross entropy.  Gradients come out as the rank's blocks
of the single-device gradients: replicated weights used by varying work
are summed over ``"model"`` by ``enter``, FSDP blocks are reduce-scattered
over ``"data"``, and every other data axis is summed in
``loss_and_grads``.

``decode_unroll`` only shapes JAX's lowering and changes nothing here;
``moe_impl``, ``batch_over_model`` and ``sharded_cache_update`` act on a
grid; ``ssd_bf16``, ``ce_chunk`` and ``bf16_grad_activations`` are
honoured everywhere.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.grid import (
    ProcessGrid,
    all_gather,
    all_gather_replicated,
    as_grid,
    enter,
    pmax_nograd,
    psum,
    psum_scatter,
    split,
)
from ..optim import global_norm
from ..runtime.sharding import (
    GridCaches,
    cache_sharding,
    dp_axes,
    shard_shape,
    spec_axes,
    tree_map2,
)
from .attention import (
    cache_update,
    cache_update_owned,
    cache_update_sharded,
    decode_attention,
    decode_attention_sharded,
    flash_attention,
)
from .layers import (
    GridCtx,
    Region,
    apply_rope,
    dense,
    fsdp_gather,
    init_dense,
    model_dim,
    rms_norm,
    rope_freqs,
    stream_weight,
)
from .moe import ExpertShard, moe_ffn_gspmd, moe_ffn_gspmd_grid, moe_ffn_shardmap
from .ssm import SSMState, mamba2_forward, mamba2_grid, mamba2_params_shapes

GLOBAL_WINDOW = 2 ** 30  # the window JAX gives a global layer


def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """An LM arch's config, field for field JAX's ``ModelConfig``."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None  # window for local layers
    local_global_period: int = 1  # period-slot grouping
    local_global_every: int = 0  # gemma3: every 6th layer is global (5:1)
    rope_theta_local: float = 1e4  # gemma3: local layers use 10k theta
    mlp_type: str = "swiglu"  # swiglu | gelu | geglu | none
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    # ssm
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    conv_width: int = 4
    # hybrid (hymba): attn ∥ ssm in every block; these layers are global attn
    hybrid_global_layers: tuple = ()
    frontend: str = "token"  # token | embed (audio/vlm stub)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    moe_impl: str = "shardmap"  # shardmap | gspmd (one path without a mesh)
    ce_chunk: int = 1024  # training: tokens a cross-entropy chunk
    ssd_chunk: int = 128
    ssd_bf16: bool = False  # bf16 SSD intra-chunk buffers
    bf16_grad_activations: bool = False  # training: bf16 residual cotangents
    batch_over_model: bool = False  # mesh layout only
    sharded_cache_update: bool = False  # mesh layout only
    decode_unroll: bool = False  # JAX lowering only

    @property
    def head_dim(self) -> int:
        """Per-head width."""
        return self.d_head or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256."""
        return _pad_to(self.vocab_size, 256)

    @property
    def n_experts_padded(self) -> int:
        """Experts padded to a multiple of 16."""
        return _pad_to(self.n_experts, 16) if self.n_experts else 0

    @property
    def period(self) -> int:
        """Period slots (scan body width in JAX)."""
        return self.local_global_period

    @property
    def n_periods(self) -> int:
        """Layers per period slot."""
        assert self.n_layers % self.period == 0
        return self.n_layers // self.period

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype as a ``torch.dtype``."""
        return getattr(torch, self.dtype)

    def slot_kind(self, slot: int) -> str:
        """Layer kind for period slot (gemma3: slots 0-4 local, 5 global)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "hybrid"
        if self.period > 1:
            return "attn_local" if slot < self.period - 1 else "attn"
        if self.sliding_window is not None and self.period == 1:
            return "attn_local"
        return "attn"

    def param_count(self) -> int:
        """Analytic parameter count (true vocab)."""
        d, f = self.d_model, self.d_ff
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        per = 0
        if self.family in ("dense", "moe", "audio", "vlm", "hybrid"):
            per += d * (hq * dh) + 2 * d * (hkv * dh) + (hq * dh) * d
        if self.family == "ssm" or self.family == "hybrid":
            dims = mamba2_params_shapes(
                d, expand=self.ssm_expand, headdim=self.ssm_headdim,
                state=self.ssm_state, conv_width=self.conv_width,
            )
            per += d * dims["in_features"] + dims["d_inner"] * d
            per += dims["conv_width"] * dims["conv_dim"]
        if self.family == "moe":
            per += d * self.n_experts  # router
            per += self.n_experts * 3 * d * self.d_ff_expert
            if self.d_ff_shared:
                per += 3 * d * self.d_ff_shared
        elif self.mlp_type == "gelu" and f:
            per += 2 * d * f
        elif f:
            per += 3 * d * f
        return self.n_layers * per + 2 * self.vocab_size * d

    def active_param_count(self) -> int:
        """Activated params per token (= param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        per_moe_full = self.n_experts * 3 * d * self.d_ff_expert
        per_moe_act = self.top_k * 3 * d * self.d_ff_expert
        return self.param_count() - self.n_layers * (per_moe_full - per_moe_act)


def layer_attn(cfg: ModelConfig, kind: str, layer_idx: int):
    """``(window, rope θ)`` of attention in layer ``layer_idx`` of kind
    ``kind``: gemma3's every ``local_global_every``-th layer is global
    (window 2³⁰, ``rope_theta``), the others local (``sliding_window``,
    ``rope_theta_local``); hymba's ``hybrid_global_layers`` get window 2³⁰
    and keep ``rope_theta``."""
    if kind == "hybrid":
        window = cfg.sliding_window
        if window is not None and layer_idx in cfg.hybrid_global_layers:
            window = GLOBAL_WINDOW
        return window, cfg.rope_theta
    window = cfg.sliding_window if kind == "attn_local" else None
    theta = cfg.rope_theta
    if cfg.local_global_every and window is not None:
        every = cfg.local_global_every
        if layer_idx % every == every - 1:
            window = GLOBAL_WINDOW
        else:
            theta = cfg.rope_theta_local
    return window, theta


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (and ``q_norm``, ``k_norm``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.torch_dtype
        self.wq = _param((d, hq * dh), dt, device)
        self.wk = _param((d, hkv * dh), dt, device)
        self.wv = _param((d, hkv * dh), dt, device)
        self.wo = _param((hq * dh, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = _param((dh,), torch.float32, device)
            self.k_norm = _param((dh,), torch.float32, device)

    def init(self, gen: torch.Generator):
        """Fill from ``gen`` as JAX's ``_init_attn`` draws."""
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(init_dense(gen, *w.shape))
        if hasattr(self, "q_norm"):
            self.q_norm.zero_()
            self.k_norm.zero_()

    def forward(self, x, cfg: ModelConfig, *, window, positions, cache=None,
                pos=None, theta=None, ctx: Optional[GridCtx] = None):
        """x (B, S, D). Returns the block output; a ``cache`` (this layer's
        ``{"k", "v"}`` views) takes the new keys and values in place.
        ``ctx``: on a grid (``x`` in the stream's layout, ``positions`` of
        the whole sequence)."""
        if ctx is not None:
            return self._forward_grid(x, cfg, ctx, window=window,
                                      positions=positions, cache=cache,
                                      pos=pos, theta=theta)
        b, s, _ = x.shape
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = dense(x, self.wq).reshape(b, s, hq, dh)
        k = dense(x, self.wk).reshape(b, s, hkv, dh)
        v = dense(x, self.wv).reshape(b, s, hkv, dh)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        cos, sin = rope_freqs(positions, dh,
                              cfg.rope_theta if theta is None else theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        g = hq // hkv
        if cache is not None:
            kc, vc = cache_update(cache["k"], cache["v"], k, v, pos)
        if cache is not None and s == 1:
            out = decode_attention(q, kc, vc, int(pos) + s, window=window)
        else:
            # GQA as jnp.repeat: query head h reads KV head h // g
            kf = k.repeat_interleave(g, dim=2) if g > 1 else k
            vf = v.repeat_interleave(g, dim=2) if g > 1 else v
            out = flash_attention(q, kf, vf, causal=True, window=window,
                                  q_offset=0 if cache is None else int(pos))
        return dense(out.reshape(b, s, hq * dh), self.wo)

    def _forward_grid(self, x, cfg: ModelConfig, ctx: GridCtx, *, window,
                      positions, cache, pos, theta):
        """Heads over ``"model"`` (``"tp"``: column-parallel ``wq``,
        replicated ``wk``/``wv``, row-parallel ``wo``); every head on every
        rank where the heads do not divide (``"rep"``)."""
        grid = ctx.grid
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if "model" in ctx.batch:
            mode = "dp"
        elif (hq % ctx.tp == 0 and model_dim(self, "wq") == 1
              and model_dim(self, "wo") == 0):
            mode = "tp"
        else:
            mode = "rep"
        reg = Region(ctx, mode)
        hl = hq // reg.tp
        lo = reg.j * hl
        h = reg.enter(x)
        b, s, _ = h.shape
        q = dense(h, reg.w(self, "wq")).reshape(b, s, hl, dh)
        k = dense(h, reg.w(self, "wk")).reshape(b, s, hkv, dh)
        v = dense(h, reg.w(self, "wv")).reshape(b, s, hkv, dh)
        if cfg.qk_norm:
            q = rms_norm(q, reg.w(self, "q_norm"), cfg.norm_eps)
            k = rms_norm(k, reg.w(self, "k_norm"), cfg.norm_eps)
        cos, sin = rope_freqs(positions, dh,
                              cfg.rope_theta if theta is None else theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        g = hq // hkv
        if cache is not None:
            if not ctx.cache_seq:
                kc, vc = cache_update(cache["k"], cache["v"], k, v, pos)
            elif s == 1 and ctx.seq_shards > 1 and cfg.sharded_cache_update:
                kc, vc = cache_update_sharded(cache["k"], cache["v"], k, v,
                                              pos, mesh=grid)
            else:
                kc, vc = cache_update_owned(cache["k"], cache["v"], k, v,
                                            pos, mesh=grid)
        if cache is not None and s == 1:
            cur = int(pos) + s
            if ctx.cache_seq and ctx.seq_shards > 1:  # split-KV decode
                qf = grid.all_gather(q, "model", dim=2) if reg.tp > 1 else q
                cur_t = torch.full((b,), cur, device=q.device)
                out = decode_attention_sharded(qf, kc, vc, cur_t, mesh=grid,
                                               window=window)[:, :, lo:lo + hl]
            else:
                if ctx.cache_seq:  # a sequence-sharded cache read whole
                    kc = grid.all_gather(kc, "model", dim=1)
                    vc = grid.all_gather(vc, "model", dim=1)
                out = decode_attention(q, _local_kv(kc, hq, hkv, hl, lo),
                                       _local_kv(vc, hq, hkv, hl, lo), cur,
                                       window=window)
        else:
            # GQA as jnp.repeat: query head h reads KV head h // g
            kf = k.repeat_interleave(g, dim=2) if g > 1 else k
            vf = v.repeat_interleave(g, dim=2) if g > 1 else v
            if hl != hq:
                kf, vf = kf[:, :, lo:lo + hl], vf[:, :, lo:lo + hl]
            out = flash_attention(q, kf, vf, causal=True, window=window,
                                  q_offset=0 if cache is None else int(pos))
        return reg.leave(dense(out.reshape(b, s, hl * dh), reg.w(self, "wo")))


def _local_kv(c: torch.Tensor, hq: int, hkv: int, hl: int, lo: int
              ) -> torch.Tensor:
    """The KV heads that query heads ``[lo, lo + hl)`` read (head ``h``
    reads ``h // (hq/hkv)``), as a (B, S, H', D) cache whose grouping gives
    each of those query heads its own KV head."""
    g = hq // hkv
    if hl == hq:
        return c
    if hl % g == 0:
        return c[:, :, lo // g:(lo + hl) // g]
    if g % hl == 0:
        return c[:, :, lo // g:lo // g + 1]
    idx = (lo + torch.arange(hl, device=c.device)) // g
    return c.index_select(2, idx)


class Mlp(nn.Module):
    """``w_in``/``w_out`` (gelu) or ``w_gate``/``w_up``/``w_down``."""

    def __init__(self, cfg: ModelConfig, d_ff: int, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype
        if cfg.mlp_type == "gelu":
            self.w_in = _param((d, d_ff), dt, device)
            self.w_out = _param((d_ff, d), dt, device)
        else:
            self.w_gate = _param((d, d_ff), dt, device)
            self.w_up = _param((d, d_ff), dt, device)
            self.w_down = _param((d_ff, d), dt, device)

    def init(self, gen: torch.Generator):
        """Fill from ``gen`` as JAX's ``_init_mlp`` draws."""
        for w in self.parameters():
            w.copy_(init_dense(gen, *w.shape))

    def forward(self, x, cfg: ModelConfig, ctx: Optional[GridCtx] = None):
        """gelu: ``dense(gelu(x·w_in), w_out)``; swiglu / geglu: gated by
        silu / gelu.  ``jax.nn.gelu`` is the tanh form.  ``ctx``: on a
        grid, column-parallel then row-parallel over ``"model"``."""
        if ctx is not None:
            return self._forward_grid(x, cfg, ctx)
        if cfg.mlp_type == "gelu":
            return dense(F.gelu(dense(x, self.w_in), approximate="tanh"),
                         self.w_out)
        g = dense(x, self.w_gate)
        g = (F.gelu(g, approximate="tanh") if cfg.mlp_type == "geglu"
             else F.silu(g))
        return dense(g * dense(x, self.w_up), self.w_down)

    def _forward_grid(self, x, cfg: ModelConfig, ctx: GridCtx):
        cols, rows = (("w_in", "w_out") if cfg.mlp_type == "gelu"
                      else ("w_up", "w_down"))
        if "model" in ctx.batch:
            mode = "dp"
        elif model_dim(self, cols) == 1 and model_dim(self, rows) == 0:
            mode = "tp"
        else:
            mode = "rep"
        reg = Region(ctx, mode)
        h = reg.enter(x)
        if cfg.mlp_type == "gelu":
            y = dense(F.gelu(dense(h, reg.w(self, "w_in")), approximate="tanh"),
                      reg.w(self, "w_out"))
        else:
            g = dense(h, reg.w(self, "w_gate"))
            g = (F.gelu(g, approximate="tanh") if cfg.mlp_type == "geglu"
                 else F.silu(g))
            y = dense(g * dense(h, reg.w(self, "w_up")), reg.w(self, "w_down"))
        return reg.leave(y)


class Moe(nn.Module):
    """``router`` (f32), ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F,
    D), and a ``shared`` Mlp where the config has one."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        e, fe, d, dt = (cfg.n_experts_padded, cfg.d_ff_expert, cfg.d_model,
                        cfg.torch_dtype)
        self.router = _param((d, e), torch.float32, device)
        self.w_gate = _param((e, d, fe), dt, device)
        self.w_up = _param((e, d, fe), dt, device)
        self.w_down = _param((e, fe, d), dt, device)
        if cfg.d_ff_shared:
            self.shared = Mlp(cfg, cfg.d_ff_shared, device)
        self.n_real = cfg.n_experts

    def init(self, gen: torch.Generator):
        """Fill from ``gen`` as JAX's ``_init_moe`` draws (padded experts
        zero)."""
        self.router.copy_(init_dense(gen, *self.router.shape))
        for w in (self.w_gate, self.w_up, self.w_down):
            sh = w.shape
            x = torch.randn(sh, generator=gen, device=gen.device) / sh[1] ** 0.5
            x[self.n_real:] = 0.0
            w.copy_(x)
        if hasattr(self, "shared"):
            self.shared.init(gen)

    def forward(self, x, cfg: ModelConfig, ctx: Optional[GridCtx] = None):
        """x (B, S, D): routed experts plus the shared MLP.  ``ctx``: on a
        grid, the experts sharded over ``"model"`` (``cfg.moe_impl``:
        ``moe_ffn_shardmap``, or JAX's global dispatch)."""
        if ctx is not None:
            return self._forward_grid(x, cfg, ctx)
        b, s, d = x.shape
        y = moe_ffn_gspmd(x.reshape(b * s, d), self, n_experts_real=cfg.n_experts,
                          top_k=cfg.top_k).reshape(b, s, d)
        if hasattr(self, "shared"):
            y = y + self.shared(x, cfg)
        return y

    def _forward_grid(self, x, cfg: ModelConfig, ctx: GridCtx):
        grid = ctx.grid
        tp_ok = model_dim(self, "w_gate") == 0
        reg = Region(ctx, "tp" if tp_ok else "rep")
        h = reg.enter(x)
        b, s, d = h.shape
        xt = h.reshape(b * s, d)
        kw = {"n_experts_real": cfg.n_experts, "top_k": cfg.top_k}
        experts = [fsdp_gather(grid, self, n) if tp_ok else reg.w_full(self, n)
                   for n in ("w_gate", "w_up", "w_down")]
        p = ExpertShard(reg.w(self, "router"), *experts)
        dp = dp_axes(grid)
        n_dp = grid.size(dp) if dp else 1
        rows_sharded = n_dp == 1 or set(dp) <= set(ctx.batch)
        if not tp_ok:  # experts replicated: JAX's global dispatch, whole
            y = reg.leave(moe_ffn_gspmd(xt, p, **kw).reshape(b, s, d))
        elif cfg.moe_impl == "shardmap":
            # the token block P(token_axes) gives: the contiguous 1/n_dp
            # block of the flattened (B·S) tokens
            blk = xt
            if not rows_sharded:
                t = xt.shape[0] // n_dp
                blk = xt.narrow(0, grid.axis_index(dp) * t, t)
            y = moe_ffn_shardmap(blk, p, mesh=grid, token_axes=dp, **kw)
            if not rows_sharded:
                y = all_gather_replicated(grid, y, dp, 0)
            y = y.reshape(b, s, d)
            y = split(grid, y, "model", 1) if ctx.seq else y
        else:  # gspmd under a grid: capacity from every token
            xa = all_gather(grid, xt, dp, 0) if rows_sharded else xt
            y = moe_ffn_gspmd_grid(xa, p, mesh=grid, **kw)
            if rows_sharded and n_dp > 1:
                y = y.narrow(0, grid.axis_index(dp) * xt.shape[0], xt.shape[0])
            y = reg.leave(y.reshape(b, s, d))
        if hasattr(self, "shared"):
            y = y + self.shared(x, cfg, ctx=ctx)
        return y


class Mamba2(nn.Module):
    """``in_proj``, ``out_proj``, ``conv_w``, ``conv_b``, ``d_skip``
    (compute dtype); ``dt_bias``, ``a_log``, ``norm`` (f32)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dims = mamba2_params_shapes(
            cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
            state=cfg.ssm_state, conv_width=cfg.conv_width,
        )
        dt, f32, h = cfg.torch_dtype, torch.float32, dims["n_heads"]
        self.in_proj = _param((cfg.d_model, dims["in_features"]), dt, device)
        self.out_proj = _param((dims["d_inner"], cfg.d_model), dt, device)
        self.conv_w = _param((dims["conv_width"], dims["conv_dim"]), dt, device)
        self.conv_b = _param((dims["conv_dim"],), dt, device)
        self.dt_bias = _param((h,), f32, device)
        self.a_log = _param((h,), f32, device)
        self.d_skip = _param((h,), dt, device)
        self.norm = _param((dims["d_inner"],), f32, device)

    def init(self, gen: torch.Generator):
        """Fill from ``gen`` as JAX's ``_init_ssm`` draws."""
        self.in_proj.copy_(init_dense(gen, *self.in_proj.shape))
        self.out_proj.copy_(init_dense(gen, *self.out_proj.shape))
        self.conv_w.copy_(torch.randn(self.conv_w.shape, generator=gen,
                                      device=gen.device) * 0.2)
        self.conv_b.zero_()
        self.dt_bias.fill_(-2.0)
        self.a_log.zero_()
        self.d_skip.fill_(1.0)
        self.norm.zero_()

    def forward(self, x, cfg: ModelConfig, state: Optional[SSMState] = None,
                ctx: Optional[GridCtx] = None):
        """x (B, S, D). Returns (y, SSMState); ``ctx``: on a grid."""
        if ctx is not None:
            return mamba2_grid(x, self, cfg, ctx, state=state,
                               chunk=cfg.ssd_chunk)
        return mamba2_forward(x, self, cfg, state=state, chunk=cfg.ssd_chunk)


class SlotBlock(nn.Module):
    """One layer of period slot ``slot``: ``ln1`` and its mixer (``attn``,
    ``ssm``, or both with ``bnorm_a``/``bnorm_s``), then ``ln2`` and an
    ``mlp`` or ``moe`` where the config has one."""

    def __init__(self, cfg: ModelConfig, slot: int, device=None):
        super().__init__()
        self.kind = kind = cfg.slot_kind(slot)
        d, f32 = cfg.d_model, torch.float32
        self.ln1 = _param((d,), f32, device)
        if kind in ("attn", "attn_local", "hybrid"):
            self.attn = Attention(cfg, device)
        if kind in ("ssm", "hybrid"):
            self.ssm = Mamba2(cfg, device)
        if kind == "hybrid":
            self.bnorm_a = _param((d,), f32, device)
            self.bnorm_s = _param((d,), f32, device)
        if cfg.family == "moe":
            self.ln2 = _param((d,), f32, device)
            self.moe = Moe(cfg, device)
        elif cfg.d_ff and cfg.mlp_type != "none" and cfg.family != "ssm":
            self.ln2 = _param((d,), f32, device)
            self.mlp = Mlp(cfg, cfg.d_ff, device)

    def init(self, gen: torch.Generator):
        """Fill from ``gen`` as JAX's ``_init_slot`` draws."""
        for name in ("ln1", "ln2", "bnorm_a", "bnorm_s"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        for name in ("attn", "ssm", "moe", "mlp"):
            if hasattr(self, name):
                getattr(self, name).init(gen)

    def forward(self, x, cfg: ModelConfig, *, positions, layer_idx: int,
                cache=None, pos=None, ctx: Optional[GridCtx] = None):
        """x (B, S, D). Returns the new x; a ``cache`` (this layer's views of
        the stacked caches) is updated in place.  ``ctx``: on a grid, ``x``
        in the stream's layout and ``positions`` of the whole sequence."""
        kind = self.kind

        def nw(name):  # a norm scale on the stream
            return getattr(self, name) if ctx is None else stream_weight(
                ctx, self, name)

        h = rms_norm(x, nw("ln1"), cfg.norm_eps)
        if kind in ("attn", "attn_local"):
            window, theta = layer_attn(cfg, kind, layer_idx)
            x = x + self.attn(h, cfg, window=window, positions=positions,
                              cache=cache, pos=pos, theta=theta, ctx=ctx)
        elif kind == "ssm":
            x = x + self._ssm(h, cfg, cache, ctx)
        else:  # hybrid: parallel attn + ssm heads
            window, _ = layer_attn(cfg, kind, layer_idx)
            a = self.attn(h, cfg, window=window, positions=positions,
                          cache=None if cache is None else cache["attn"], pos=pos,
                          ctx=ctx)
            m = self._ssm(h, cfg, None if cache is None else cache["ssm"], ctx)
            x = x + 0.5 * (rms_norm(a, nw("bnorm_a"), cfg.norm_eps)
                           + rms_norm(m, nw("bnorm_s"), cfg.norm_eps))
        if hasattr(self, "mlp") or hasattr(self, "moe"):
            h2 = rms_norm(x, nw("ln2"), cfg.norm_eps)
            ffn = self.mlp if hasattr(self, "mlp") else self.moe
            x = x + ffn(h2, cfg, ctx=ctx)
        if cfg.bf16_grad_activations:
            x = bf16_grad_barrier(x)
        return x

    def _ssm(self, h, cfg: ModelConfig, cache, ctx=None):
        """The Mamba-2 mixer; its new state goes into ``cache`` in place."""
        state = None if cache is None else SSMState(cache["h"], cache["conv"])
        y, st = self.ssm(h, cfg, state, ctx=ctx)
        if cache is not None:
            cache["h"].copy_(st.h)
            cache["conv"].copy_(st.conv)
        return y


class LanguageModel(nn.Module):
    """The whole model: ``embed`` (token frontend), ``unembed``,
    ``final_norm`` and ``slots[s][i]``, layer ``i·period + s``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.final_norm = _param((cfg.d_model,), torch.float32, device)
        if cfg.frontend == "token":
            self.embed = _param((cfg.vocab_padded, cfg.d_model), dt, device)
        self.unembed = _param((cfg.d_model, cfg.vocab_padded), dt, device)
        self.slots = nn.ModuleList(
            nn.ModuleList(SlotBlock(cfg, s, device) for _ in range(cfg.n_periods))
            for s in range(cfg.period))

    def init(self, gen: torch.Generator):
        """Fill every parameter from ``gen``."""
        self.final_norm.zero_()
        if hasattr(self, "embed"):
            self.embed.copy_(torch.randn(self.embed.shape, generator=gen,
                                         device=gen.device) * 0.02)
        self.unembed.copy_(init_dense(gen, *self.unembed.shape))
        for i in range(self.cfg.n_periods):
            for s in range(self.cfg.period):
                self.slots[s][i].init(gen)

    def forward(self, batch, cfg: ModelConfig, *, caches=None, pos=None,
                ctx: Optional[GridCtx] = None):
        """batch: ``{"tokens": (B, S)}`` or ``{"embeddings": (B, S, D)}``.
        Returns (hidden (B, S, D) after ``final_norm``, caches).  Without
        caches, with gradients on, each period group is recomputed in the
        backward (JAX's ``jax.checkpoint`` of the layer scan body).
        ``ctx``: on a grid; the hidden state is in the stream's layout."""
        dt = cfg.torch_dtype
        if ctx is not None:
            x = self._embed_grid(batch, cfg, ctx)
        elif cfg.frontend == "token":
            x = self.embed[batch["tokens"].long()].to(dt)
        else:
            x = batch["embeddings"].to(dt)
        s = next(iter(batch.values())).shape[1]
        base = 0 if pos is None else int(pos)
        positions = base + torch.arange(s, device=x.device)
        remat = (caches is None and torch.is_grad_enabled()
                 and any(p.requires_grad for p in self.parameters()))
        for i in range(cfg.n_periods):
            if remat:
                x = self._remat_group(x, cfg, i, positions, ctx)
                continue
            for slot in range(cfg.period):
                sc = None if caches is None else _layer_cache(caches[slot], i)
                x = self.slots[slot][i](
                    x, cfg, positions=positions, layer_idx=i * cfg.period + slot,
                    cache=sc, pos=pos, ctx=ctx)
        fin = (self.final_norm if ctx is None
               else stream_weight(ctx, self, "final_norm"))
        return rms_norm(x, fin, cfg.norm_eps), caches

    def _embed_grid(self, batch, cfg: ModelConfig, ctx: GridCtx):
        """The stream's first value in its layout: the vocab-sharded lookup
        gives each rank its own ids' rows (zeros elsewhere), summed over
        ``"model"`` into the layout (a reduce-scatter under sequence
        parallelism)."""
        grid, dt = ctx.grid, cfg.torch_dtype
        partial = False
        if cfg.frontend != "token":
            x = batch["embeddings"].to(dt)
        elif model_dim(self, "embed") == 0:
            ids = batch["tokens"].long()
            emb = fsdp_gather(grid, self, "embed")
            v_loc = emb.shape[0]
            loc = ids - grid.axis_index("model") * v_loc
            ok = (loc >= 0) & (loc < v_loc)
            rows = emb[loc.clamp(0, v_loc - 1)]
            x = torch.where(ok[..., None], rows, torch.zeros_like(rows)).to(dt)
            partial = True
        else:
            x = fsdp_gather(grid, self, "embed")[batch["tokens"].long()].to(dt)
        if ctx.seq:
            dim = 1
        elif "model" in ctx.batch:
            dim = 0
        else:
            return psum(grid, x, "model") if partial else x
        return (psum_scatter if partial else split)(grid, x, "model", dim)

    def _remat_group(self, x, cfg: ModelConfig, i: int, positions, ctx=None):
        """Period group ``i`` (layer ``i`` of every slot) under
        ``torch.utils.checkpoint``: only ``x`` and the group's parameters
        are kept, and the backward runs the group again.  The parameters
        are passed in, so the recompute uses the tensors the forward used
        (a mixed-precision step's bf16 casts)."""
        blocks = [self.slots[s][i] for s in range(cfg.period)]
        named = [list(b.named_parameters()) for b in blocks]

        def run(x, *flat):
            it = iter(flat)
            for slot, (blk, nm) in enumerate(zip(blocks, named)):
                x = torch.func.functional_call(
                    blk, {n: next(it) for n, _ in nm}, (x, cfg),
                    {"positions": positions,
                     "layer_idx": i * cfg.period + slot, "ctx": ctx})
            return x

        return checkpoint(run, x, *(p for nm in named for _, p in nm),
                          use_reentrant=False)


def _layer_cache(c, i: int):
    """Layer ``i``'s views of a slot's stacked cache tree."""
    if isinstance(c, dict):
        return {k: _layer_cache(v, i) for k, v in c.items()}
    return c[i]


# ---------------------------------------------------------------------------
# Functional API (JAX's names)
# ---------------------------------------------------------------------------


def build_model(cfg: ModelConfig, device=None, *, train: bool = False
                ) -> LanguageModel:
    """An uninitialised model of ``cfg``: serving storage (see the module
    docstring), or with ``train`` every parameter in f32 with gradients,
    as JAX's ``init_params`` stores them."""
    if not train:
        return LanguageModel(cfg, device=device)
    model = LanguageModel(cfg, device="meta").float()
    return model.to_empty(device=device or "cpu").requires_grad_(True)


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                train: bool = False) -> LanguageModel:
    """A model of ``cfg`` on ``gen``'s device, every parameter drawn from
    ``gen`` (JAX's distributions; not JAX's numbers); ``train`` gives the
    f32 trainable model of ``build_model``."""
    with torch.no_grad():
        model = build_model(cfg, gen.device, train=train)
        model.init(gen)
    return model.eval()


def grid_ctx(cfg: ModelConfig, grid: ProcessGrid, batch, caches=None,
             seq_shards: int = 1) -> GridCtx:
    """The stream's layout for ``batch`` (the rank's rows unless the
    caches say the batch is replicated): JAX's ``_csc`` specs
    ``(resid batch axes, resid seq axis, None)`` with axes that do not
    divide dropped."""
    first = next(iter(batch.values()))
    b, s = first.shape[0], first.shape[1]
    tp = grid.shape["model"]
    gc = isinstance(caches, GridCaches)
    batch_axes = dp_axes(grid) if (not gc or caches.batch_sharded) else ()
    if (cfg.batch_over_model and cfg.family in ("ssm", "hybrid")
            and caches is None and b % tp == 0
            and (batch_axes or not dp_axes(grid))):
        batch_axes = batch_axes + ("model",)
    seq = ("model" if cfg.family not in ("ssm", "hybrid") and s % tp == 0
           else None)
    return GridCtx(grid, batch=batch_axes, seq=seq,
                   cache_seq=gc and caches.kv_seq_sharded,
                   seq_shards=seq_shards)


def _forward(params, batch, cfg: ModelConfig, mesh, caches, pos,
             seq_shards: int):
    """``forward``'s body: (hidden, caches, the grid layout or None)."""
    ctx = None
    if mesh is not None:
        ctx = grid_ctx(cfg, as_grid(mesh), batch, caches, seq_shards)
    grad = torch.no_grad() if caches is not None else contextlib.nullcontext()
    with grad:
        x, caches = params(batch, cfg, caches=caches, pos=pos, ctx=ctx)
    return x, caches, ctx


def forward(params: LanguageModel, batch, cfg: ModelConfig, *, mesh=None,
            caches=None, pos=None, seq_shards: int = 1):
    """Full stack. Returns (hidden (B, S, D), caches updated in place).
    With caches it runs without gradients; without, it records them where
    a parameter wants one.  On a grid (``mesh``) the hidden state is the
    rank's block in the stream's layout, and ``seq_shards > 1`` with
    sequence-sharded caches decodes split-KV (as JAX, ``seq_shards`` only
    acts with a mesh)."""
    x, caches, _ = _forward(params, batch, cfg, mesh, caches, pos, seq_shards)
    return x, caches


def unembed_logits(x_last: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """(B, D) hidden → (B, V_padded) f32 logits: the f32 product of the
    upcast operands (JAX's ``preferred_element_type=jnp.float32``)."""
    return torch.matmul(x_last.float(), unembed.float())


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device=None, *, mesh=None, seq_sharded: bool = False
               ) -> List[Any]:
    """Per-period-slot stacked caches: ``{"k", "v"}`` (attention),
    ``{"h" (f32), "conv"}`` (SSM), both under ``"attn"``/``"ssm"``
    (hybrid).  ``device="meta"`` gives the shapes without memory.  With
    ``mesh`` (a ``ProcessGrid``): the rank's zero blocks of the caches of
    ``batch_size`` rows by ``cache_sharding(seq_sharded=)``, as a
    ``GridCaches``."""
    if mesh is not None:
        grid = as_grid(mesh)
        logical = init_cache(cfg, batch_size, max_len, dtype, device="meta")
        specs = cache_sharding(grid, logical, seq_sharded=seq_sharded)
        local = tree_map2(lambda c, sp: torch.zeros(
            shard_shape(c.shape, sp, grid), dtype=c.dtype, device=device),
            logical, specs)
        bsh = batch_size % max(1, grid.size(dp_axes(grid))) == 0
        kv = (seq_sharded and max_len % grid.shape["model"] == 0
              and cfg.family != "ssm")
        return GridCaches(local, grid=grid, specs=specs, batch_sharded=bsh,
                          kv_seq_sharded=kv)
    dt = dtype or cfg.torch_dtype
    if isinstance(dt, str):
        dt = getattr(torch, dt)
    npd = cfg.n_periods
    hkv, dh = cfg.n_kv_heads, cfg.head_dim

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def attn_cache():
        return {
            "k": zeros((npd, batch_size, max_len, hkv, dh), dt),
            "v": zeros((npd, batch_size, max_len, hkv, dh), dt),
        }

    def ssm_cache():
        dims = mamba2_params_shapes(
            cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
            state=cfg.ssm_state, conv_width=cfg.conv_width,
        )
        return {
            "h": zeros((npd, batch_size, dims["n_heads"], cfg.ssm_state,
                        dims["d_inner"] // dims["n_heads"]), torch.float32),
            "conv": zeros((npd, batch_size, cfg.conv_width - 1,
                           dims["conv_dim"]), dt),
        }

    caches = []
    for slot in range(cfg.period):
        kind = cfg.slot_kind(slot)
        if kind in ("attn", "attn_local"):
            caches.append(attn_cache())
        elif kind == "ssm":
            caches.append(ssm_cache())
        else:  # hybrid
            caches.append({"attn": attn_cache(), "ssm": ssm_cache()})
    return caches


def _last_logits(params: LanguageModel, x: torch.Tensor,
                 ctx: Optional[GridCtx]) -> torch.Tensor:
    """The last position's f32 logits (B, V_padded) of hidden ``x``; on a
    grid every model rank gets the rank's rows' whole logits (``unembed``
    sharded on ``d_model``: partial products summed over ``"model"``)."""
    if ctx is None:
        return unembed_logits(x[:, -1], params.unembed)
    grid = ctx.grid
    with torch.no_grad():
        last = x[:, -1:]
        if ctx.seq:  # the last position lives on the last model rank
            last = grid.all_gather(last.contiguous(), "model", dim=1)[:, -1:]
        last = last[:, 0]
        w = params.unembed
        md = model_dim(params, "unembed")
        if md == 0:
            lo = grid.axis_index("model") * w.shape[0]
            part = unembed_logits(last[:, lo:lo + w.shape[0]], w)
            return grid.psum(part, "model")
        if md == 1:
            return grid.all_gather(unembed_logits(last, w), "model", dim=1)
        return unembed_logits(last, w)


def make_serve_step(cfg: ModelConfig, *, mesh=None, seq_shards: int = 1):
    """Returns ``serve_step(params, caches, batch, pos) -> (logits, caches)``:
    one decode step at position ``pos``, f32 logits (B, V_padded).  On a
    grid: the rank's rows, split-KV decode over ``seq_shards`` model ranks
    when the caches' sequence is sharded."""

    def serve_step(params, caches, batch, pos):
        x, caches, ctx = _forward(params, batch, cfg, mesh, caches, pos,
                                  seq_shards)
        return _last_logits(params, x, ctx), caches

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, mesh=None):
    """Returns ``prefill(params, caches, batch) -> (logits, caches)``: the
    prompt into the caches at position 0, the last token's f32 logits."""

    def prefill(params, caches, batch):
        x, caches, ctx = _forward(params, batch, cfg, mesh, caches, 0, 1)
        return _last_logits(params, x, ctx), caches

    return prefill


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class _Bf16GradBarrier(torch.autograd.Function):
    """JAX's ``_bf16_grad_barrier``: identity forward; the cotangent is
    rounded to bf16 and cast back to ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(ctx.dtype)


def bf16_grad_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward carries a bf16 cotangent (placed after each
    block and before the loss when ``cfg.bf16_grad_activations``)."""
    return _Bf16GradBarrier.apply(x)


def _ce_chunk(xi, li, w, vocab_size: int):
    """One chunk's (Σ loss, Σ weight): f32 logits of ``xi`` (B, cs, D) and
    the f32 unembed ``w``, vocab ids ≥ ``vocab_size`` at −1e30, logsumexp
    minus the gold logit, weighted by ``li >= 0``."""
    logits = torch.matmul(xi.float(), w)
    vids = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(vids >= vocab_size, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    valid = li >= 0
    gold = torch.gather(logits, -1, torch.where(valid, li, 0).long()[..., None])
    wt = valid.float()
    return torch.sum((lse - gold[..., 0]) * wt), torch.sum(wt)


class _VocabLse(torch.autograd.Function):
    """logsumexp over the vocab sharded across ``"model"``: the
    stop-gradient local maxima all-gathered, ``psum`` of the exp-sums.
    The backward is logsumexp's own, ``g · exp(logits − lse)`` on the
    rank's vocab ids (no collective: the cotangent of the replicated
    ``lse`` is whole on every rank), so one rank computes exactly what
    ``torch.logsumexp`` computes."""

    @staticmethod
    def forward(ctx, logits, grid):
        m = pmax_nograd(grid, logits.amax(dim=-1), "model")
        se = grid.psum(torch.exp(logits - m[..., None]).sum(dim=-1), "model")
        lse = torch.log(se) + m
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(logits - lse[..., None]), None


def _ce_chunk_vp(xi, li, w, vocab_size: int, grid, dp, v_lo: int):
    """One chunk of the vocab-parallel CE (JAX's ``ce_local``): logits
    over the rank's vocab ids ``v_lo + arange(v_loc)``, masked at
    ``vocab_size``; the stop-gradient maximum all-gathered over
    ``"model"`` and ``psum`` of the exp-sums (``_VocabLse``); ``psum`` of
    the gold logit over ``"model"``; ``psum`` of the loss and count over
    the data axes."""
    logits = torch.matmul(xi.float(), w)
    vids = v_lo + torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(vids >= vocab_size, -1e30)
    lse = _VocabLse.apply(logits, grid)
    gold = psum(grid, torch.where(vids == li[..., None].long(), logits,
                                  0.0).sum(dim=-1), "model")
    wt = (li >= 0).float()
    loss = torch.sum((lse - gold) * wt)
    cnt = torch.sum(wt)
    if dp:
        loss, cnt = psum(grid, loss, dp), psum(grid, cnt, dp)
    return loss, cnt


def chunked_ce_loss(x, labels, w_unembed, cfg: ModelConfig, *, mesh=None):
    """Sequence-chunked cross entropy.  x (B, S, D); labels (B, S) int (−1
    = ignore).  Chunks of ``min(ce_chunk, S)`` tokens, the tail padded with
    label −1; logits are the f32 product of the upcast operands
    (``unembed`` cast to ``x``'s dtype first, as JAX's
    ``w.astype(xi.dtype)``), and each chunk is recomputed in the backward,
    so the (B·S, vocab) logits never exist.  Returns Σ loss / max(Σ
    weight, 1).

    On a grid (``mesh``) it is JAX's vocab-parallel branch: ``x`` and
    ``labels`` are the rank's rows, ``w_unembed`` the rank's block of the
    unembed (sharded on ``d_model`` as the rules place it, whole, or
    already the rank's vocab columns), each rank scores
    ``vocab_padded / tp`` vocab ids, and the loss is the global token
    mean, the same on every rank."""
    b, s, _ = x.shape
    cs = min(cfg.ce_chunk, s)
    n_chunks = -(-s // cs)
    pad = n_chunks * cs - s
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    w = w_unembed
    fn, extra = _ce_chunk, (cfg.vocab_size,)
    if mesh is not None:
        grid = as_grid(mesh)
        tp, d = grid.shape["model"], x.shape[-1]
        v_loc = cfg.vocab_padded // tp
        v_lo = grid.axis_index("model") * v_loc
        if w.shape[0] != d:  # sharded on d_model: the whole unembed
            w = all_gather(grid, w, "model", 0)
        elif w.shape[1] == cfg.vocab_padded:
            w = enter(grid, w, "model")
        if w.shape[1] == cfg.vocab_padded:
            w = w[:, v_lo:v_lo + v_loc]
        fn, extra = _ce_chunk_vp, (cfg.vocab_size, grid, dp_axes(grid), v_lo)
        # x is replicated over "model" and each rank scores its own vocab
        # ids: the shares of x's cotangent are summed
        x = enter(grid, x, "model")
    w = w.to(x.dtype).float()
    remat = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        xi, li = x[:, c * cs:(c + 1) * cs], labels[:, c * cs:(c + 1) * cs]
        if remat:
            loss, wt = checkpoint(fn, xi, li, w, *extra, use_reentrant=False)
        else:
            loss, wt = fn(xi, li, w, *extra)
        tot = tot + loss
        cnt = cnt + wt
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(params: LanguageModel, batch, cfg: ModelConfig, *, mesh=None):
    """Mean next-token cross entropy of ``batch`` (``labels`` beside the
    inputs) under ``params``; on a grid the stream leaves sequence
    parallelism (gathered over ``"model"``) before the vocab-parallel CE."""
    x, _, ctx = _forward(params, batch, cfg, mesh, None, None, 1)
    if ctx is not None:
        if ctx.seq:
            x = all_gather_replicated(ctx.grid, x, "model", 1)
        if "model" in ctx.batch:
            x = all_gather_replicated(ctx.grid, x, "model", 0)
    if cfg.bf16_grad_activations:
        x = bf16_grad_barrier(x)
    return chunked_ce_loss(x, batch["labels"], params.unembed, cfg, mesh=mesh)


class _Loss(nn.Module):
    """``loss_fn`` as a module over ``model``, for ``functional_call``."""

    def __init__(self, model: LanguageModel, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.model, self.cfg, self.mesh = model, cfg, mesh

    def forward(self, batch):
        return loss_fn(self.model, batch, self.cfg, mesh=self.mesh)


def param_specs(model: LanguageModel) -> Dict[str, tuple]:
    """Each parameter's spec on the model's grid (``{}`` unsharded)."""
    sh = getattr(model, "sharding", None)
    return sh.specs if sh is not None else {}


GRAD_BUCKET_BYTES = 1 << 28  # f32 gradient bytes reduced in one collective


def reduce_grads(grads: Dict[str, torch.Tensor], specs: Mapping[str, tuple],
                 grid: ProcessGrid) -> None:
    """Sum each gradient, in place, over the data axes its parameter is
    replicated on (the loss is the global token mean, so each rank's
    gradient is its rows' share).  Gradients of one axis set travel
    together in buckets of at most ``GRAD_BUCKET_BYTES``."""
    groups: Dict[tuple, List[str]] = {}
    for n in grads:
        axes = tuple(a for a in dp_axes(grid)
                     if a not in spec_axes(specs.get(n, ()))
                     and grid.shape[a] > 1)
        if axes:
            groups.setdefault(axes, []).append(n)
    for axes in sorted(groups):
        names = groups[axes]
        while names:
            take, size = [], 0
            while names and (not take or size + grads[names[0]].numel() * 4
                             <= GRAD_BUCKET_BYTES):
                size += grads[names[0]].numel() * 4
                take.append(names.pop(0))
            flat = grid.psum(torch.cat([grads[n].float().reshape(-1)
                                        for n in take]), axes)
            off = 0
            for n in take:
                k = grads[n].numel()
                grads[n].copy_(flat[off:off + k].view_as(grads[n]))
                off += k


def loss_and_grads(model: LanguageModel, batch, cfg: ModelConfig, *,
                   mixed_precision: bool = False, mesh=None):
    """``(loss, grads)``: the loss as a 0-dim f32 tensor and the gradient of
    every parameter by name (zeros where the loss does not reach it, as
    JAX's ``value_and_grad`` gives).  ``mixed_precision`` computes with
    bf16 casts of the f32 parameters, as JAX's ``make_train_step`` does;
    the gradients are those casts' transposes, in f32.  On a grid each
    gradient is the rank's block of the single-device gradient."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    if mixed_precision:
        cast = {"model." + n: (p.to(torch.bfloat16) if p.dtype == torch.float32
                               else p) for n, p in params.items()}
        loss = torch.func.functional_call(_Loss(model, cfg, mesh), cast,
                                          (batch,))
    else:
        loss = loss_fn(model, batch, cfg, mesh=mesh)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    if mesh is not None:
        reduce_grads(grads, param_specs(model), as_grid(mesh))
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, optimizer, *, mesh=None,
                    mixed_precision: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``state``
    is ``(model, opt_state, step)``, updated in place (the step is a new
    int), and ``metrics`` holds ``loss`` and ``grad_norm`` (the f32 norm of
    the unclipped gradients) as 0-dim tensors.  ``optimizer`` is a
    ``repro_torch.optim`` object with ``init``/``update_``.  On a grid the
    state is the rank's blocks, the batch its rows, and the norm (and the
    clipping) global."""
    grid = None if mesh is None else as_grid(mesh)

    def train_step(state, batch):
        model, opt_state, step = state
        loss, grads = loss_and_grads(model, batch, cfg,
                                     mixed_precision=mixed_precision,
                                     mesh=grid)
        specs = param_specs(model)
        gnorm = global_norm(grads, grid=grid, specs=specs)
        optimizer.update_(grads, opt_state, dict(model.named_parameters()),
                          step, grid=grid, specs=specs)
        return (model, opt_state, step + 1), {"loss": loss, "grad_norm": gnorm}

    return train_step
