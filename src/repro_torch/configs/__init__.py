"""Architecture registry of the port: the ten language-model configs and
the paper's own pipeline (``"dibella"``), the same eleven names as
``repro.configs``.  ``get_config(name)`` returns a ``ModelConfig`` (LM
archs) or the ``DibellaConfig``; ``reduced_config(name)`` returns the
smoke-test reduction of the same family.  Each module is the port's copy
of its JAX twin, field for field.
"""

from __future__ import annotations

import importlib

from .shapes import SHAPES, ShapeSpec, batch_specs, cache_specs, runs_cell  # noqa: F401

_MODULES = {
    "musicgen-large": "musicgen_large",
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-4b": "qwen3_4b",
    "gemma3-4b": "gemma3_4b",
    "yi-9b": "yi_9b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "hymba-1.5b": "hymba_1p5b",
    "internvl2-26b": "internvl2_26b",
    "dibella": "dibella",
}

ARCH_NAMES = [k for k in _MODULES if k != "dibella"]
ALL_NAMES = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_NAMES}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str):
    """The full-size config of arch ``name``."""
    return _module(name).CONFIG


def reduced_config(name: str):
    """The smoke-test reduction of arch ``name``."""
    return _module(name).reduced()
