"""Qwen3-4B [hf:Qwen/Qwen3-4B family].

36L d_model=2560 32H (kv=8, head_dim=128) d_ff=9728 vocab=151936; qk-norm."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="qwen3-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
    )
