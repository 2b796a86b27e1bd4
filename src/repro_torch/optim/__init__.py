"""Optimizers of the port: JAX's ``AdamW`` and ``cosine_schedule``
(``repro.optim``), applied in place leaf by leaf."""

from .adamw import AdamW, OptState, global_norm  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
