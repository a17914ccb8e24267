"""Metrics registry: named counters.

The port's own copy of the counters of the reference's ``obs/metrics.py``
(standard library only): registry-scoped instruments that tests can read
in isolation: swap a fresh ``MetricsRegistry`` in with ``use_registry``
and nothing bleeds across tests. Gauges, histograms and snapshots wait
for the session's tracer and its export.

Instruments are keyed by dotted name; the convention is
``family.dimension``, e.g. ``executor_cache.hits``. Lookups are
get-or-create on the *current* registry, so code written against
``registry().counter(...)`` lands in whatever scope a test installed.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional


class Counter:
    """Monotonic count."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class MetricsRegistry:
    """Named counters, get-or-create."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c


# ---------------------------------------------------------------------------
# Current registry: a default process-wide one, swappable for isolation
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()
_ACTIVE = _DEFAULT


def registry() -> MetricsRegistry:
    """The registry instrumentation sites record into right now."""
    return _ACTIVE


def set_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install ``reg`` as current (``None`` restores the default).
    Returns the previous registry."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = _DEFAULT if reg is None else reg
    return prev


@contextlib.contextmanager
def use_registry(reg: MetricsRegistry):
    """Scoped registry swap — the test-isolation primitive."""
    prev = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)
