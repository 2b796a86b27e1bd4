"""Phi-3-mini 3.8B [arXiv:2404.14219] — RoPE SwiGLU GQA (kv=32 ⇒ MHA).

32L d_model=3072 32H (kv=32, head_dim=96) d_ff=8192 vocab=32064."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="phi3-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256,
    )
