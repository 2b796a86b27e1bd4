"""Device-memory watermark telemetry, in torch.

The port's copy of ``repro.obs.memory``: one sampling path for every
consumer.

* :func:`sample` takes one :class:`MemorySample` of the run's ``device``
  — ``bytes_in_use`` and the best-known ``peak_bytes``.  For a CUDA device
  it reads that device's ``torch.cuda.memory_stats(device)``
  (``allocated_bytes.all.current`` / ``.peak``: the caching allocator's
  own high-water mark, ``source="device_stats"``).  For the CPU, or no
  device named, it sums the bytes of the live tensors' storages (each
  storage once, so views are not counted twice; ``source="live_buffers"``).
  The choice follows the device the caller names, never what the process
  happens to have initialised, and the source travels with every number,
  so a fallback count is never mistaken for an allocator watermark.
* :func:`watermark` (``device=`` as for :func:`sample`) is a context
  manager yielding a :class:`Watermark`:
  every :func:`sample` taken inside the window — including the samples of
  nested spans and nested windows — folds into its ``peak_hbm_bytes``.  On
  the fallback path the peak is therefore sampled at span boundaries, not
  continuous.
* ``obs.trace.span`` samples the tracer's ``device`` on enter and exit
  while a memory-enabled tracer is active and attaches ``peak_hbm_bytes``
  (the traced region's peak up to the span's close) /
  ``own_peak_hbm_bytes`` (the span's own) / ``hbm_bytes_in_use`` /
  ``hbm_delta_bytes`` / ``hbm_source`` to the span.  On a CUDA device the
  span resets the allocator's peak after its enter sample has folded into
  every open window, so every window still sees every peak.

The windows open on a thread are a per-thread stack: a sample folds into
the calling thread's windows only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import threading
from typing import Iterator, List, Optional

import torch

@dataclasses.dataclass(frozen=True)
class MemorySample:
    """One point-in-time device-memory reading: current allocation, the
    best-known high-water mark at sample time (the allocator's on the
    device-stats path, ``== bytes_in_use`` on the fallback) and the path
    that produced them."""

    bytes_in_use: int
    peak_bytes: int
    source: str


def _device_stats(device) -> Optional[MemorySample]:
    """The caching allocator's stats of ``device``, or None unless it is a
    CUDA device."""
    if device is None or torch.device(device).type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    b = int(stats.get("allocated_bytes.all.current", 0))
    p = int(stats.get("allocated_bytes.all.peak", b))
    return MemorySample(b, max(p, b), "device_stats")


def _live_buffer_bytes() -> int:
    """Total bytes of the storages of every live tensor (the CPU
    fallback), each storage counted once."""
    seen = set()
    total = 0
    objs = gc.get_objects()
    # type(), not isinstance(): the latter reads __class__, which some
    # deprecated module proxies answer with a warning.  The tensor types
    # are found once among the distinct types and the objects picked in C:
    # a traced CPU run scans at every span boundary
    kinds = {t for t in set(map(type, objs)) if issubclass(t, torch.Tensor)}
    for obj in itertools.compress(objs, map(kinds.__contains__, map(type, objs))):
        if obj.device.type == "meta":
            continue
        try:
            st = obj.untyped_storage()
        except RuntimeError:  # tensors without storage (sparse, nested)
            continue
        key = (st.device, st.data_ptr())
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


@dataclasses.dataclass
class Watermark:
    """Device-memory accounting for one :func:`watermark` window:
    ``peak_hbm_bytes`` folds every sample taken while the window was open,
    ``hbm_bytes_in_use`` is the reading at exit, ``delta_bytes`` the exit
    minus enter growth, ``source`` the sampling path."""

    enter: Optional[MemorySample] = None
    exit: Optional[MemorySample] = None
    peak_hbm_bytes: int = 0
    source: str = "live_buffers"

    def _observe(self, s: MemorySample) -> None:
        self.peak_hbm_bytes = max(self.peak_hbm_bytes, s.peak_bytes)
        self.source = s.source

    @property
    def hbm_bytes_in_use(self) -> int:
        """Bytes in use at window exit (0 before the window closed)."""
        return 0 if self.exit is None else self.exit.bytes_in_use

    @property
    def delta_bytes(self) -> int:
        """Exit-minus-enter growth in bytes in use."""
        if self.enter is None or self.exit is None:
            return 0
        return self.exit.bytes_in_use - self.enter.bytes_in_use


_LOCAL = threading.local()


def _open_watermarks() -> List[Watermark]:
    """The calling thread's stack of open watermark windows."""
    try:
        return _LOCAL.open
    except AttributeError:
        out: List[Watermark] = []
        _LOCAL.open = out
        return out


def sample(device=None) -> MemorySample:
    """Take one memory sample of ``device`` (a CUDA device: its allocator's
    stats; the CPU or None: the live tensors' bytes) and fold it into every
    window open on this thread."""
    s = _device_stats(device)
    if s is None:
        b = _live_buffer_bytes()
        s = MemorySample(b, b, "live_buffers")
    for w in _open_watermarks():
        w._observe(s)
    return s


@contextlib.contextmanager
def watermark(device=None) -> Iterator[Watermark]:
    """Open a device-memory watermark window: samples ``device`` on enter
    and exit and absorbs every sample taken in between on this thread."""
    w = Watermark()
    opened = _open_watermarks()
    opened.append(w)
    try:
        w.enter = sample(device)
        yield w
    finally:
        try:
            w.exit = sample(device)
        finally:
            opened.remove(w)
