"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) vocab=151936; MoE: 60 routed experts top-4
(d_ff=1408 each) + 4 shared experts (merged 4×1408 = 5632).  Experts padded
60→64 for the 16-wide model axis."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    top_k=4,
    d_ff_expert=1408,
    d_ff_shared=5632,
    rope_theta=1e6,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="qwen2moe-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, vocab_size=256, n_experts=8, top_k=2, d_ff_expert=32,
        d_ff_shared=64, d_ff=32,
    )
