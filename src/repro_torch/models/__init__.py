"""The language-model substrate of the port: the ten archs' serving and
training paths (dense / MoE / SSM / hybrid / audio / VLM backbones) on
torch tensors, on one device or on a ``ProcessGrid`` (``mesh=``), the
counterpart of ``repro.models``."""

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
