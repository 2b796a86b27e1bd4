"""Hierarchical span tracing for the assembly pipeline, in torch.

The port's copy of ``repro.obs.trace`` and its one timing code path: a
:func:`span` context manager that

* records host wall-clock on enter and exit (``time.perf_counter``);
* synchronises on exit the CUDA device of every tensor handed to
  :meth:`Span.set_output`, so a stage span measures execution and not only
  the enqueue of its kernels; :func:`sync` descends dataclasses (``EllMatrix``,
  ``ContigSet``, ``ConsensusResult``), lists, tuples and dicts;
* nests: spans opened while another is live become its children, so a
  pipeline run produces a tree — stages → shard_map phases → ``op:<name>``
  dispatches → kernel launches.  PyTorch runs eagerly, so every call opens
  its spans (JAX emits the spans inside a jitted function at trace time
  only);
* with ``Tracer(annotate=True)`` wraps every span in a
  ``torch.profiler.record_function`` range, so a ``torch.profiler``
  capture of the same region shows the same tree (and, under
  ``torch.autograd.profiler.emit_nvtx``, so does an Nsight capture).

Spans work with or without an active :class:`Tracer`: without one they
still time and synchronise, they are just not recorded.  Activate a tracer
for a region with :func:`tracing`; export the tree with ``obs.export``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional

import torch


def _cuda_devices(obj: Any, seen: set, out: set) -> None:
    """Add the device of every CUDA tensor reachable from ``obj`` to
    ``out``, descending dataclasses, dicts, lists and tuples."""
    if obj is None or id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name, None), seen, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, seen, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, seen, out)


def sync(out: Any) -> Any:
    """Wait until the work producing every CUDA tensor reachable from
    ``out`` is done: synchronise each of their devices once.  CPU tensors
    and other leaves need nothing.  Returns ``out``."""
    devices: set = set()
    _cuda_devices(out, set(), devices)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


@dataclasses.dataclass
class Span:
    """One timed region: name, free-form attributes, wall-clock interval and
    child spans (populated when a :class:`Tracer` is active)."""

    name: str
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    t0: float = 0.0
    t1: Optional[float] = None
    children: List["Span"] = dataclasses.field(default_factory=list)
    _out: Any = dataclasses.field(default=None, repr=False)

    def set_output(self, out: Any) -> Any:
        """Register ``out`` to be synchronised when the span closes.
        Returns ``out``."""
        self._out = out
        return out

    def annotate(self, **attrs: Any) -> None:
        """Attach extra attributes to the span after it was opened."""
        self.attrs.update(attrs)

    @property
    def duration_s(self) -> float:
        """Span wall-clock in seconds (0.0 while still open)."""
        return 0.0 if self.t1 is None else self.t1 - self.t0

    @property
    def duration_ms(self) -> float:
        """Span wall-clock in milliseconds (0.0 while still open)."""
        return self.duration_s * 1e3

    def walk(self) -> Iterator["Span"]:
        """Yield this span and every descendant, depth-first preorder."""
        yield self
        for child in self.children:
            yield from child.walk()


class Tracer:
    """Collects a forest of :class:`Span` trees for one traced region.

    ``annotate=True`` also wraps every span in a
    ``torch.profiler.record_function`` range.  ``memory=True`` (the
    default) samples the memory of ``device`` (``obs.memory.sample``: the
    allocator's stats of a CUDA device, the live tensors' bytes for the CPU
    or None) on every span boundary and attaches ``peak_hbm_bytes`` /
    ``hbm_bytes_in_use`` / ``hbm_delta_bytes`` / ``hbm_source`` to each
    span."""

    def __init__(self, annotate: bool = False, memory: bool = True,
                 device=None):
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        self.annotate = annotate
        self.memory = memory
        self.device = device
        self.epoch = time.perf_counter()

    def _push(self, sp: Span) -> None:
        (self._stack[-1].children if self._stack else self.roots).append(sp)
        self._stack.append(sp)

    def _pop(self, sp: Span) -> None:
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()

    def spans(self) -> Iterator[Span]:
        """Yield every recorded span, depth-first preorder across roots."""
        for root in self.roots:
            yield from root.walk()

    def find(self, name: str) -> List[Span]:
        """All recorded spans with the given name."""
        return [sp for sp in self.spans() if sp.name == name]


_ACTIVE: Optional[Tracer] = None


def current_tracer() -> Optional[Tracer]:
    """The tracer activated by the innermost :func:`tracing`, or None."""
    return _ACTIVE


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer]):
    """Activate ``tracer`` for the dynamic extent of the with-block (``None``
    runs untraced: spans still time and synchronise)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def span(name: str, **attrs: Any):
    """Open a span: ``with span("SpGEMM", kind="phase", phase="ring") as sp``.

    Yields the :class:`Span`; on exit the span synchronises whatever was
    handed to :meth:`Span.set_output`, closes its interval and — when a
    tracer is active — records itself under the enclosing span."""
    tracer = _ACTIVE
    sp = Span(name=name, attrs=dict(attrs))
    ann = None
    wm = None
    if tracer is not None:
        tracer._push(sp)
        if tracer.annotate:
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        if tracer.memory:
            from . import memory as _memory

            wm = _memory.Watermark()
            opened = _memory._open_watermarks()
            opened.append(wm)
            try:
                wm.enter = _memory.sample(tracer.device)
            except Exception:
                # telemetry must not kill the span, and a failed enter
                # sample must not leave the window registered (every later
                # sample would fold into it): run without memory attributes
                opened.remove(wm)
                wm = None
    sp.t0 = time.perf_counter()
    try:
        yield sp
    finally:
        sync(sp._out)
        sp.t1 = time.perf_counter()
        if wm is not None:
            from . import memory as _memory

            try:
                wm.exit = _memory.sample(tracer.device)
            except Exception:
                pass  # exit attributes degrade to the enter-side numbers
            finally:
                _memory._open_watermarks().remove(wm)
            sp.attrs.setdefault("peak_hbm_bytes", wm.peak_hbm_bytes)
            sp.attrs.setdefault("hbm_bytes_in_use", wm.hbm_bytes_in_use)
            sp.attrs.setdefault("hbm_delta_bytes", wm.delta_bytes)
            sp.attrs.setdefault("hbm_source", wm.source)
        if ann is not None:
            ann.__exit__(None, None, None)
        if tracer is not None:
            tracer._pop(sp)
