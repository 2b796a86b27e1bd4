"""MusicGen-large decoder backbone over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.  The EnCodec frontend is a
STUB per the brief: input_specs provide precomputed frame embeddings (B, S, D)
and the head predicts codebook tokens (vocab 2048)."""
import dataclasses

from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    frontend="embed",
    rope_theta=1e4,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="musicgen-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256,
    )
