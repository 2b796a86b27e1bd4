"""Hierarchical span tracing for the assembly pipeline, in torch.

The port's copy of ``repro.obs.trace`` and its one timing code path: a
:func:`span` context manager that

* records host wall-clock on enter and exit (``time.perf_counter``);
* synchronises on exit the CUDA device of every tensor handed to
  :meth:`Span.set_output`, so a stage span measures execution and not only
  the enqueue of its kernels; :func:`sync` descends dataclasses (``EllMatrix``,
  ``ContigSet``, ``ConsensusResult``), lists, tuples and dicts.  The span
  drops the reference once it has synchronised, so a recorded span keeps
  no tensor alive;
* nests: spans opened while another is live become its children, so a
  pipeline run produces a tree — stages → steps (``kind="step"``, named
  ``<Stage>.<step>``, never synchronising) and shard_map phases →
  ``op:<name>`` dispatches → kernel launches.  PyTorch runs eagerly, so
  every call opens its spans (JAX emits the spans inside a jitted function
  at trace time only);
* with ``Tracer(annotate=True)`` wraps every span in a
  ``torch.profiler.record_function`` range named by :attr:`Span.label`
  (``<name>.<phase>`` for a phase span, else the name), so a
  ``torch.profiler`` capture of the same region shows the same tree (and,
  under ``torch.autograd.profiler.emit_nvtx``, so does an Nsight capture).

Under an active :class:`Tracer` on a CUDA device each span also records a
``torch.cuda.Event`` on the current stream at its open and its close, and
under a memory-enabled one it resets the allocator's peak on opening, so
the span knows its own peak (``own_peak_hbm_bytes``).
:meth:`Tracer.resolve` turns the events into each span's device interval
on the host clock; :meth:`Tracer.clock_ns` puts host times on the clock
``torch.profiler`` stamps its CPU events with (``CLOCK_REALTIME``: a
profile's ``ts`` plus its ``baseTimeNanoseconds``), by the line through
two anchor pairs, at activation and at resolve, as the profiler fits its
own clock between its start and stop.

Spans work with or without an active :class:`Tracer`: without one they
still time and synchronise, they are just not recorded, and they record
no event and reset no peak.  Activate a tracer for a region with
:func:`tracing`; export the tree with ``obs.export``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

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
    """One timed region: name, free-form attributes, wall-clock interval,
    device interval (set by :meth:`Tracer.resolve`) and child spans
    (populated when a :class:`Tracer` is active)."""

    name: str
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    t0: float = 0.0
    t1: Optional[float] = None
    children: List["Span"] = dataclasses.field(default_factory=list)
    # the device's interval on the ``perf_counter`` clock of t0/t1: the
    # work the device ran between the span's open and close (on the CPU,
    # the host interval)
    device_t0: Optional[float] = None
    device_t1: Optional[float] = None
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
    def label(self) -> str:
        """``<name>.<phase>`` for a phase span, else the name: the name of
        its profiler range and of its row in :meth:`Tracer.summary`."""
        phase = self.attrs.get("phase")
        if self.attrs.get("kind") == "phase" and phase is not None:
            return f"{self.name}.{phase}"
        return self.name

    @property
    def duration_s(self) -> float:
        """Span wall-clock in seconds (0.0 while still open)."""
        return 0.0 if self.t1 is None else self.t1 - self.t0

    @property
    def duration_ms(self) -> float:
        """Span wall-clock in milliseconds (0.0 while still open)."""
        return self.duration_s * 1e3

    @property
    def device_s(self) -> Optional[float]:
        """The device interval's seconds (None before it is resolved)."""
        if self.device_t0 is None or self.device_t1 is None:
            return None
        return self.device_t1 - self.device_t0

    def walk(self) -> Iterator["Span"]:
        """Yield this span and every descendant, depth-first preorder."""
        yield self
        for child in self.children:
            yield from child.walk()


def _anchor_pair() -> Tuple[float, int]:
    """``(perf_counter s, CLOCK_REALTIME ns)`` at one instant: of a few
    reads of the wall clock each bracketed by two ``perf_counter`` reads,
    the tightest, with the middle of its bracket."""
    best = None
    for _ in range(5):
        a = time.perf_counter()
        wall = time.time_ns()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, 0.5 * (a + b), wall)
    return best[1], best[2]


_LAST_SUMMARY: Optional[Dict[str, Dict[str, Any]]] = None


def last_summary() -> Optional[Dict[str, Dict[str, Any]]]:
    """The :meth:`Tracer.summary` of the tracer this process resolved last
    (None before any): plain numbers, for a reader that runs after the
    traced result is gone."""
    return _LAST_SUMMARY


class Tracer:
    """Collects a forest of :class:`Span` trees for one traced region.

    ``annotate=True`` also wraps every span in a
    ``torch.profiler.record_function`` range.  ``memory=True`` (the
    default) samples the memory of ``device`` (``obs.memory.sample``: the
    allocator's stats of a CUDA device, the live tensors' bytes for the CPU
    or None) on every span boundary and attaches ``peak_hbm_bytes`` (the
    peak of the traced region up to the span's close) /
    ``own_peak_hbm_bytes`` (the peak between the span's open and close,
    children included) / ``hbm_bytes_in_use`` / ``hbm_delta_bytes`` /
    ``hbm_source`` to each span (off a CUDA device, to each span but the
    steps).  On a CUDA device a span's opening resets
    the allocator's peak (after folding its enter sample into every open
    window), so ``torch.cuda.max_memory_allocated`` reads the peak since the
    last span opened while the tracer is active."""

    def __init__(self, annotate: bool = False, memory: bool = True,
                 device=None):
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        self.annotate = annotate
        self.memory = memory
        self.device = device
        self.cuda = device is not None and torch.device(device).type == "cuda"
        # the running maximum of every memory sample the spans took
        self.peak_hbm_bytes = 0
        # (perf_counter s, CLOCK_REALTIME ns) at activation and at resolve
        self.anchor: Tuple[float, int] = _anchor_pair()
        self.end_anchor: Optional[Tuple[float, int]] = None
        self._activated = False
        self._device_anchor: Optional[Tuple[Any, float]] = None
        self._events: List[Tuple[Span, Any, Any]] = []

    def clock_ns(self, t: float) -> int:
        """A ``perf_counter`` time on ``torch.profiler``'s clock:
        ``CLOCK_REALTIME`` nanoseconds.  Once resolved, on the line through
        the anchor pairs of activation and resolve: the profiler maps its
        own clock by the line through its start and its stop, so where the
        wall clock is stepped while the region runs, the two maps move
        together instead of parting by the steps taken since activation."""
        pc, wall = self.anchor
        rate = 1.0
        if self.end_anchor is not None and self.end_anchor[0] > pc:
            pc1, wall1 = self.end_anchor
            rate = (wall1 - wall) / ((pc1 - pc) * 1e9)
        return wall + round((t - pc) * 1e9 * rate)

    def _activate(self) -> None:
        """On first activation: the host anchor pair and, on a CUDA device,
        one event recorded right after a synchronise, whose host time
        anchors every span's event; with ``annotate`` the anchor is a
        profiler range of its own (``trace.anchor``), which also takes a
        profiling session's first-range costs out of the spans' ranges."""
        if self._activated:
            return
        self._activated = True
        ann = None
        if self.annotate:
            ann = torch.profiler.record_function("trace.anchor")
            ann.__enter__()
        if self.cuda:
            torch.cuda.synchronize(self.device)
            ev = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
            self._device_anchor = (ev, 0.5 * (h0 + time.perf_counter()))
        self.anchor = _anchor_pair()
        if ann is not None:
            ann.__exit__(None, None, None)

    def _event(self):
        """An event recorded now on the device's current stream (None off
        a CUDA device)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _samples(self, sp: Span) -> bool:
        """Whether ``sp`` takes memory samples: every span on a CUDA device;
        off it, every span but the steps, since the live-tensor scan walks
        every Python object at each boundary."""
        return self.memory and (self.cuda or sp.attrs.get("kind") != "step")

    def _open_memory(self):
        """The enter sample, folded into every window open, then a reset
        of the allocator's peak; returns the span's window (None if the
        sample failed: the span runs without memory attributes)."""
        from . import memory as _memory

        try:
            enter = _memory.sample(self.device)
        except Exception:
            return None  # telemetry must not kill the span
        self.peak_hbm_bytes = max(self.peak_hbm_bytes, enter.peak_bytes)
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        wm = _memory.Watermark(enter=enter, peak_hbm_bytes=enter.bytes_in_use,
                               source=enter.source)
        _memory._open_watermarks().append(wm)
        return wm

    def _close_memory(self, sp: Span, wm) -> None:
        from . import memory as _memory

        try:
            wm.exit = _memory.sample(self.device)
        except Exception:
            pass  # exit attributes degrade to the enter-side numbers
        finally:
            _memory._open_watermarks().remove(wm)
        self.peak_hbm_bytes = max(self.peak_hbm_bytes, wm.peak_hbm_bytes)
        sp.attrs.setdefault("peak_hbm_bytes", self.peak_hbm_bytes)
        sp.attrs.setdefault("own_peak_hbm_bytes", wm.peak_hbm_bytes)
        sp.attrs.setdefault("hbm_bytes_in_use", wm.hbm_bytes_in_use)
        sp.attrs.setdefault("hbm_delta_bytes", wm.delta_bytes)
        sp.attrs.setdefault("hbm_source", wm.source)

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

    def resolve(self) -> None:
        """Give every closed span its device interval: on a CUDA device
        wait for the recorded events and place each on the host clock
        through the anchor event; elsewhere the device interval is the host
        interval.  Drops the events, takes the second anchor pair of
        :meth:`clock_ns`, and publishes :meth:`summary` as
        :func:`last_summary`.  Call it once the traced work is done."""
        global _LAST_SUMMARY
        self.end_anchor = _anchor_pair()
        if self._events:
            torch.cuda.synchronize(self.device)
            ev_a, h_a = self._device_anchor
            for sp, e0, e1 in self._events:
                sp.device_t0 = h_a + ev_a.elapsed_time(e0) * 1e-3
                sp.device_t1 = h_a + ev_a.elapsed_time(e1) * 1e-3
            self._events = []
        elif not self.cuda:
            for sp in self.spans():
                if sp.t1 is not None:
                    sp.device_t0, sp.device_t1 = sp.t0, sp.t1
        _LAST_SUMMARY = self.summary()

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """By label: ``count``, ``host_s`` and ``device_s`` summed over the
        spans of that label (``device_s`` None where none was resolved),
        and the largest ``own_peak_hbm_bytes`` (None without memory)."""
        out: Dict[str, Dict[str, Any]] = {}
        for sp in self.spans():
            row = out.setdefault(sp.label, {
                "count": 0, "host_s": 0.0, "device_s": None,
                "own_peak_hbm_bytes": None})
            row["count"] += 1
            row["host_s"] += sp.duration_s
            if sp.device_s is not None:
                row["device_s"] = (row["device_s"] or 0.0) + sp.device_s
            own = sp.attrs.get("own_peak_hbm_bytes")
            if own is not None:
                row["own_peak_hbm_bytes"] = max(row["own_peak_hbm_bytes"] or 0,
                                                int(own))
        return out


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
    if tracer is not None:
        tracer._activate()
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
    if tracer is None:
        sp.t0 = time.perf_counter()
        try:
            yield sp
        finally:
            sync(sp._out)
            sp._out = None
            sp.t1 = time.perf_counter()
        return
    tracer._push(sp)
    wm = tracer._open_memory() if tracer._samples(sp) else None
    ann = None
    if tracer.annotate:
        ann = torch.profiler.record_function(sp.label)
        ann.__enter__()
    # the host interval opens right after the profiler range opens and
    # closes right after it closes: record_function stamps a range's start
    # and end nearest to those
    sp.t0 = time.perf_counter()
    ev0 = tracer._event()
    try:
        yield sp
    finally:
        try:
            sync(sp._out)
            sp._out = None
            ev1 = tracer._event()
            if ev0 is not None:
                tracer._events.append((sp, ev0, ev1))
            if ann is not None:
                ann.__exit__(None, None, None)
            sp.t1 = time.perf_counter()
        finally:
            if wm is not None:
                tracer._close_memory(sp, wm)
            tracer._pop(sp)
