"""Yi-9B [arXiv:2403.04652] — llama-arch GQA.

48L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="yi-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256,
    )
