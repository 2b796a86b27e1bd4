"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest -q portbench/tests`` from the repository root; the
tests marked ``cuda`` run only where a card is present)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A root with the tiny cells ``gspmd`` and ``summa`` (one rank)."""
    from portbench.tests.tiny import make_root

    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
