"""Granite 3.0 1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (kv=8) vocab=49155; MoE: 32 experts top-8, d_ff=512."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    d_ff_expert=512,
    d_ff_shared=0,
    rope_theta=1e4,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="granite-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, vocab_size=256, n_experts=8, top_k=4, d_ff_expert=32,
        d_ff=32,
    )
