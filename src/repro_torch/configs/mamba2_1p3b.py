"""Mamba-2 1.3B — attention-free SSD [arXiv:2405.21060].

48L d_model=2048 vocab=50280 ssm_state=128 (expand 2, headdim 64)."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    mlp_type="none",
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    conv_width=4,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="mamba2-reduced", n_layers=2, d_model=64, vocab_size=256,
        ssm_state=16, ssm_headdim=16,
    )
