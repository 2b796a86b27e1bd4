"""Straggler detection & mitigation policy (the port's copy of
``repro.runtime.straggler``; host-side, standard library only).

On a multi-host deployment each host reports per-step wall-clock; the
monitor keeps an EWMA per host, flags hosts slower than ``threshold ×
median`` for ``patience`` consecutive steps, and the launcher acts on the
flags (re-shard the data pipeline away from the host / swap in a hot spare
/ exclude from the next allocation).  The detection logic is deterministic
and tested with injected timings; the actuation hooks are no-ops on a
single host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step times per host and the flags they raise."""

    n_hosts: int
    threshold: float = 1.5  # × median EWMA
    patience: int = 3
    alpha: float = 0.3  # EWMA coefficient
    on_straggler: Optional[Callable[[int], None]] = None

    def __post_init__(self):
        self._ewma: List[Optional[float]] = [None] * self.n_hosts
        self._strikes = [0] * self.n_hosts
        self.flagged: set = set()
        self.history: List[Dict] = []

    def report(self, host: int, step_time: float) -> None:
        """Fold one step time of ``host`` into its EWMA."""
        prev = self._ewma[host]
        self._ewma[host] = (
            step_time if prev is None
            else self.alpha * step_time + (1 - self.alpha) * prev
        )

    def evaluate(self) -> List[int]:
        """Call once per step after all reports; returns newly flagged hosts."""
        vals = [v for v in self._ewma if v is not None]
        if len(vals) < max(2, self.n_hosts // 2):
            return []
        med = sorted(vals)[len(vals) // 2]
        new = []
        for h, v in enumerate(self._ewma):
            if v is None:
                continue
            if v > self.threshold * med:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
                self.flagged.discard(h)
            if self._strikes[h] >= self.patience and h not in self.flagged:
                self.flagged.add(h)
                new.append(h)
                if self.on_straggler:
                    self.on_straggler(h)
        self.history.append({"median": med, "flagged": sorted(self.flagged)})
        return new

    def reassign_data_shards(self, host: int):
        """Move the host's input shards to its neighbour (deterministic
        round-robin), so a slow host never gates the input pipeline."""
        return [(host, (host + 1) % self.n_hosts)]
