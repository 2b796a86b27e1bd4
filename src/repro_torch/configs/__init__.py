"""Architecture registry of the port: the paper's own pipeline
(``"dibella"``).  ``get_config(name)`` returns its :class:`DibellaConfig`,
``reduced_config(name)`` the smoke-test reduction.

The JAX registry also holds ten language-model configs and their shapes
(``repro.configs.shapes``); they need the models, which the port does not
have yet, so asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

_MODULES = {"dibella": "dibella"}

#: the JAX registry's language-model archs, not ported yet
LM_ARCH_NAMES = (
    "musicgen-large", "mamba2-1.3b", "qwen2-moe-a2.7b",
    "granite-moe-1b-a400m", "qwen3-4b", "gemma3-4b", "yi-9b",
    "phi3-mini-3.8b", "hymba-1.5b", "internvl2-26b",
)
ALL_NAMES = list(_MODULES)


def _module(name: str):
    if name in LM_ARCH_NAMES:
        raise NotImplementedError(
            f"arch {name!r}: the language-model configs, models and shapes "
            f"are not ported yet (ROADMAP.md queue 1, item 14)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_NAMES}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str):
    """The full-size config of arch ``name``."""
    return _module(name).CONFIG


def reduced_config(name: str):
    """The smoke-test reduction of arch ``name``."""
    return _module(name).reduced()
