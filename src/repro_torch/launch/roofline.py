"""Roofline terms of a cell, on the H100's published peaks.

The port's counterpart of ``repro.launch.roofline``'s terms:

    compute    = ops per card / peak rate   (PEAK_FLOPS_BF16 by default)
    memory     = bytes per card / HBM_BW
    collective = collective bytes per card / (NVLINK_BW_PER_LINK × links)

``links`` counts NVLink links (18 on an H100 SXM5: 900 GB/s).  The genome
path's semiring arithmetic is f32 add/min and int32, not tensor-core BF16,
so its cells pass ``peak_flops=F32_ADD_MIN_OPS``; the value used is kept
in the record.  MODEL_FLOPS = 6·N·D for training, 2·N_active·D for a
forward pass.

``analytic_costs`` and its four helpers are JAX's analytic per-cell cost
model of the language models, formula for formula (plain Python on the
config): the operations and HBM bytes of one step of a cell, per chip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .mesh import HBM_BW, NVLINK_BW_PER_LINK, NVLINK_LINKS, PEAK_FLOPS_BF16


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    peak_memory_bytes: float = 0.0
    loop_flagged: bool = False
    peak_flops: float = PEAK_FLOPS_BF16

    def finalize(self, links: int = NVLINK_LINKS,
                 peak_flops: float = PEAK_FLOPS_BF16):
        self.peak_flops = peak_flops
        self.compute_s = self.flops_per_device / peak_flops
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes_per_device / (
            NVLINK_BW_PER_LINK * links)
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bottleneck = max(terms, key=terms.get)
        total_flops = self.flops_per_device * self.chips
        self.useful_ratio = (
            self.model_flops_global / total_flops if total_flops else 0.0)
        return self

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """6·N·D train / 2·N_active·D decode-or-prefill forward."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * global_batch  # decode: one token a sequence


def roofline_fraction(t: RooflineTerms) -> float:
    """Fraction of the dominant-term-bound runtime that is useful compute:
    (MODEL_FLOPS / chips / peak) / max(term).  1.0 = at the roofline."""
    ideal = (t.model_flops_global / t.chips) / t.peak_flops
    dom = max(t.compute_s, t.memory_s, t.collective_s)
    return ideal / dom if dom > 0 else 0.0


# ---------------------------------------------------------------------------
# Analytic per-cell cost model of the language models (JAX's, formula for
# formula; counts the full S×S rectangle the block-wise attention computes
# before masking, and the GShard dispatch)
# ---------------------------------------------------------------------------


def _attn_flops(cfg, b, sq, skv, *, train):
    hq, dh = cfg.n_heads, cfg.head_dim
    d = cfg.d_model
    hkv = cfg.n_kv_heads
    proj = 2 * b * sq * d * (hq * dh) + 2 * 2 * b * sq * d * (hkv * dh) \
        + 2 * b * sq * (hq * dh) * d
    core = 2 * 2 * b * hq * sq * skv * dh
    return (proj + core) * (3 if train else 1)


def _mlp_flops(cfg, b, s, *, train):
    d = cfg.d_model
    if cfg.family == "moe":
        per_tok = 3 * 2 * d * cfg.d_ff_expert * cfg.top_k
        if cfg.d_ff_shared:
            per_tok += 3 * 2 * d * cfg.d_ff_shared
        per_tok += 2 * d * cfg.n_experts_padded  # router
    elif cfg.mlp_type == "gelu":
        per_tok = 2 * 2 * d * cfg.d_ff
    elif cfg.d_ff:
        per_tok = 3 * 2 * d * cfg.d_ff
    else:
        per_tok = 0
    return per_tok * b * s * (3 if train else 1)


def _ssd_flops(cfg, b, s, *, train, decode=False):
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    from ..models.ssm import mamba2_params_shapes

    dims = mamba2_params_shapes(
        cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
        state=cfg.ssm_state, conv_width=cfg.conv_width,
    )
    di, h, n = dims["d_inner"], dims["n_heads"], cfg.ssm_state
    p = di // h
    d = cfg.d_model
    proj = 2 * b * s * d * dims["in_features"] + 2 * b * s * di * d
    conv = 2 * b * s * dims["conv_dim"] * cfg.conv_width
    if decode:
        core = 2 * b * h * n * p * 2  # state update + readout
    else:
        q = min(cfg.ssd_chunk, s)
        nc = -(-s // q)
        intra = nc * (2 * b * q * q * n + 2 * b * q * q * h
                      + 2 * b * q * q * h * p)
        inter = nc * (2 * b * h * n * p * q * 2)
        core = intra + inter
    return (proj + conv + core) * (3 if train else 1)


def _ce_flops(cfg, b, s):
    return 3 * 2 * b * s * cfg.d_model * cfg.vocab_padded  # fwd+bwd


def analytic_costs(cfg, shape_kind: str, seq_len: int, global_batch: int,
                   chips: int):
    """(flops_per_chip, bytes_per_chip) for one step of this cell."""
    b = global_batch
    train = shape_kind == "train"
    if shape_kind == "decode":
        sq, skv = 1, seq_len
    else:
        sq = skv = seq_len

    per_layer = 0
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        per_layer = _attn_flops(cfg, b, sq, skv, train=train) \
            + _mlp_flops(cfg, b, sq, train=train)
    elif cfg.family == "ssm":
        per_layer = _ssd_flops(cfg, b, sq, train=train,
                               decode=shape_kind == "decode")
    elif cfg.family == "hybrid":
        # hymba: most layers sliding-window — cap skv at the window
        skv_eff = min(skv, cfg.sliding_window or skv)
        per_layer = _attn_flops(cfg, b, sq, skv_eff, train=train) \
            + _ssd_flops(cfg, b, sq, train=train,
                         decode=shape_kind == "decode") \
            + _mlp_flops(cfg, b, sq, train=train)
    if cfg.family == "dense" and cfg.local_global_every:
        # gemma3: 5/6 of layers see only the window
        skv_loc = min(skv, cfg.sliding_window or skv)
        loc = _attn_flops(cfg, b, sq, skv_loc, train=train) \
            + _mlp_flops(cfg, b, sq, train=train)
        n_glob = cfg.n_layers // cfg.local_global_every
        flops = (cfg.n_layers - n_glob) * loc + n_glob * per_layer
    else:
        flops = cfg.n_layers * per_layer
    if train:
        flops += _ce_flops(cfg, b, sq)
    else:
        flops += 2 * b * sq * cfg.d_model * cfg.vocab_padded  # head fwd

    # ---- bytes (HBM traffic model, per chip) ----
    n_params = cfg.param_count()
    dt = 2  # bf16 compute reads
    if train:
        # params: read fwd + read bwd (remat ⇒ ×2 fwd reads) + grad write
        # + AdamW (read p,m,v + write p,m,v) in fp32
        param_traffic = n_params * (3 * dt + 4 + 6 * 4)
        act = 2 * b * sq * cfg.d_model * dt  # residual stream w+r per layer
        act_traffic = cfg.n_layers * 6 * act  # qkv/mlp intermediates ~6×
        logits = 2 * b * sq * cfg.vocab_padded * 4 / max(1, 1)
        total_bytes = param_traffic + act_traffic + logits
    elif shape_kind == "prefill":
        param_traffic = n_params * dt
        act_traffic = cfg.n_layers * 6 * b * sq * cfg.d_model * dt
        cache_w = cfg.n_layers * 2 * b * sq * cfg.n_kv_heads * cfg.head_dim * dt
        total_bytes = param_traffic + act_traffic + cache_w
    else:  # decode: read all params + full KV cache once per token
        param_traffic = n_params * dt
        if cfg.family == "ssm":
            cache = 0  # O(1) state
        else:
            kv_len = skv
            if cfg.family == "hybrid":
                kv_len = min(skv, cfg.sliding_window or skv)
            cache = cfg.n_layers * 2 * b * kv_len * cfg.n_kv_heads \
                * cfg.head_dim * dt
            if cfg.local_global_every:
                n_glob = cfg.n_layers // cfg.local_global_every
                loc_len = min(skv, cfg.sliding_window or skv)
                cache = (cfg.n_layers - n_glob) * 2 * b * loc_len \
                    * cfg.n_kv_heads * cfg.head_dim * dt \
                    + n_glob * 2 * b * skv * cfg.n_kv_heads * cfg.head_dim * dt
        total_bytes = param_traffic + cache
    return flops / chips, total_bytes / chips
