"""Kernel-backend dispatch seam of the port.

The pipeline's hot ops each exist twice: a plain PyTorch *reference*
(the oracle, runs on any device) and a hand-written CUDA kernel for Hopper.
This module decides, per op, which one runs:

  * ``"reference"`` — the plain torch ops.
  * ``"cuda"``      — the hand kernels (``repro_torch.kernels``) and the
    device contig path.  A kernel wrapper launches its kernel for CUDA
    tensors; given CPU tensors it runs its plain version, which is how the
    CPU tests drive this backend's code paths.
  * ``"auto"``      — ``"cuda"`` on a CUDA device, ``"reference"`` on the
    CPU.

The op names and signatures are those of the JAX package's seam
(``repro.core.backend``): ``xdrop_extend``, ``minplus_dense``,
``spgemm_ring_stages``, ``cc_labels``, ``contig_gen`` and ``consensus``.
Registered implementations of one op agree exactly, so either may stand
for the other.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch

from ..obs.trace import span

BACKENDS = ("auto", "reference", "cuda")

DISTRIBUTIONS = ("gspmd", "shard_map")

_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def resolve_device(device) -> torch.device:
    """``torch.device`` of a ``PipelineConfig.device`` value; raises when a
    CUDA device is asked for and none is present (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain-torch path on the CPU"
        )
    return dev


def resolve_backend(backend: str = "auto", device="cuda") -> str:
    """Resolve a ``PipelineConfig.backend`` value to a concrete backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "reference"
    return backend


def resolve_distribution(distribution: str = "gspmd") -> str:
    """Validate a ``PipelineConfig.distribution`` value: ``"gspmd"`` (the
    single-device path) or ``"shard_map"`` (the explicit-exchange stages on
    a ``torch.distributed`` process grid, ``core/grid.py``)."""
    if distribution not in DISTRIBUTIONS:
        raise ValueError(
            f"unknown distribution {distribution!r}; "
            f"expected one of {DISTRIBUTIONS}"
        )
    return distribution


def register_op(op: str, backend: str, fn: Callable) -> Callable:
    """Register ``fn`` as the ``backend`` implementation of ``op``, wrapped
    once in an ``obs.span`` named ``"op:<op>"`` (kind ``"op"``): the one
    place every dispatched call gets its span, so traces nest stage → phase
    → op → kernel launch.  Returns ``fn`` itself."""
    if backend not in BACKENDS or backend == "auto":
        raise ValueError(f"backend must be 'reference' or 'cuda', got {backend!r}")

    @functools.wraps(fn)
    def dispatched(*args, **kwargs):
        with span(f"op:{op}", kind="op", op=op, backend=backend):
            return fn(*args, **kwargs)

    _REGISTRY[(op, backend)] = dispatched
    return fn


def available_backends(op: str) -> Tuple[str, ...]:
    """Concrete backends registered for ``op`` (sorted; empty if unknown)."""
    _ensure_registered()
    return tuple(sorted(b for (o, b) in _REGISTRY if o == op))


def _ensure_registered() -> None:
    # the kernels package and the contig stage register their ops when
    # imported; lazy so core never imports them at module-import time
    from .. import kernels  # noqa: F401
    from ..assembly import contig_gen  # noqa: F401


def dispatch(op: str, backend: str = "auto", device="cuda") -> Callable:
    """The registered implementation of ``op`` for ``backend`` (``"auto"``
    resolved against ``device``) in its op span (:func:`register_op`)."""
    b = resolve_backend(backend, device)
    key = (op, b)
    if key not in _REGISTRY:
        _ensure_registered()
    if key not in _REGISTRY:
        known = sorted({o for (o, _) in _REGISTRY})
        raise KeyError(f"no {b!r} implementation registered for op {op!r}; "
                       f"known ops: {known}")
    return _REGISTRY[key]
