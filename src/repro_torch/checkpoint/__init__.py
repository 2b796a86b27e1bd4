"""Fault-tolerant checkpointing of the port (``repro.checkpoint``'s
on-disk contract)."""

from .checkpoint import (  # noqa: F401
    CheckpointManager,
    load_pytree,
    restore_latest,
    save_pytree,
    tree_shardings,
)
