"""InternVL2-26B language backbone (InternLM2-20B) [arXiv:2404.16821].

48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553.  The InternViT frontend is
a STUB per the brief: input_specs provide precomputed patch embeddings."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="embed",
    rope_theta=1e6,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="internvl2-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256,
    )
