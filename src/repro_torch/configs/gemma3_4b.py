"""Gemma-3 4B [hf:google/gemma-3-4b-pt family].

34L d_model=2560 8H (kv=4, head_dim=256) d_ff=10240 vocab=262144;
5:1 local:global sliding-window (window 1024, global every 6th layer,
local theta 10k / global 1M); qk-norm; GeGLU.  Runs long_500k (mostly-local
KV)."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab_size=262144,
    qk_norm=True,
    mlp_type="geglu",
    sliding_window=1024,
    local_global_every=6,
    rope_theta=1e6,
    rope_theta_local=1e4,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="gemma3-reduced", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256, sliding_window=32,
    )
