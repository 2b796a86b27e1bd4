"""Typed metrics registry: the emit surface over ``obs.schema``.

:class:`Metrics` is the validating stats accumulator of the JAX package
(``repro.obs.metrics``): every :meth:`Metrics.emit` checks the key against
the declared schema at write time, and :meth:`Metrics.as_dict` returns the
plain dict that ``AssemblyResult.stats`` carries.  Stage timing is
``obs.trace.span`` and memory is ``obs.memory``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from . import schema


class MetricsError(ValueError):
    """An emission violated the declared schema (unknown key / wrong kind)."""


class Metrics:
    """Schema-validated stats accumulator with a dict-compatible view.

    ``strict=True`` (the default) raises :class:`MetricsError` on the first
    violation; ``strict=False`` collects violations in :attr:`violations`."""

    def __init__(self, *, context: str = "stats", strict: bool = True):
        self._values: Dict[str, Any] = {}
        self.context = context
        self.strict = strict
        self.violations: list = []

    def _check(self, name: str, value: Any) -> None:
        s = schema.SCHEMA.get(name)
        if s is None:
            msg = f"{self.context}: unregistered stats key {name!r}"
        elif not schema._kind_ok(s.kind, value):
            msg = (f"{self.context}: {name} = {value!r} is not a valid "
                   f"{s.kind} ({s.unit})")
        else:
            return
        if self.strict:
            raise MetricsError(msg)
        self.violations.append(msg)

    def emit(self, name: str, value: Any) -> Any:
        """Record one metric value (validated against the schema)."""
        self._check(name, value)
        self._values[name] = value
        return value

    def emit_many(self, values: Mapping[str, Any]) -> None:
        """Record every ``(name, value)`` of a mapping, each validated."""
        for name, value in values.items():
            self.emit(name, value)

    def seed_zero(self, zero_group: str) -> None:
        """Set every key of ``zero_group`` to 0 unless already emitted."""
        for key, zero in schema.zero_defaults(zero_group).items():
            self._values.setdefault(key, zero)

    def get(self, name: str, default: Any = None) -> Any:
        """The recorded value for ``name`` (or ``default``)."""
        return self._values.get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def __getitem__(self, name: str) -> Any:
        return self._values[name]

    def as_dict(self) -> Dict[str, Any]:
        """The plain-dict view (a copy, insertion-ordered)."""
        return dict(self._values)


def validated(stats: Mapping[str, Any], *, context: str = "stats",
              require_groups: tuple = ()) -> Dict[str, Any]:
    """Validate a ready-made stats dict against the schema and return it as
    a plain dict; raises :class:`MetricsError` on any violation."""
    problems = schema.validate_stats(
        stats, context=context, require_groups=require_groups
    )
    if problems:
        raise MetricsError("; ".join(problems))
    return dict(stats)

