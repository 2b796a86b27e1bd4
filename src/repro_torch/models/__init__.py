"""The language-model substrate of the port: the ten archs' single-device
serving path (dense / MoE / SSM / hybrid / audio / VLM backbones) on torch
tensors, the counterpart of ``repro.models``.  Training waits for ROADMAP
queue 1, item 14b."""

from .model import (  # noqa: F401
    LanguageModel,
    ModelConfig,
    forward,
    init_cache,
    init_params,
    make_prefill_step,
    make_serve_step,
)
