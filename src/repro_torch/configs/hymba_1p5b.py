"""Hymba-1.5B [arXiv:2411.13676] — parallel attention + mamba heads.

32L d_model=1600 25H (kv=5, head_dim=64) d_ff=5504 vocab=32001 ssm_state=16;
sliding-window attention except 3 global layers (first/middle/last).  Runs
long_500k (hybrid)."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    sliding_window=1024,
    hybrid_global_layers=(0, 15, 31),
    rope_theta=1e4,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="hymba-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256, ssm_state=16,
        ssm_headdim=16, sliding_window=32, hybrid_global_layers=(0,),
    )
