"""The language-model substrate of the port: the ten archs' single-device
serving and training paths (dense / MoE / SSM / hybrid / audio / VLM
backbones) on torch tensors, the counterpart of ``repro.models``.  The
mesh paths wait for ROADMAP queue 1, item 14b.3."""

from .model import (  # noqa: F401
    LanguageModel,
    ModelConfig,
    bf16_grad_barrier,
    build_model,
    chunked_ce_loss,
    forward,
    init_cache,
    init_params,
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
