"""Span tracer: nested, thread-safe spans with monotonic timestamps.

The port's own copy of the reference's ``obs/trace.py`` (standard
library only). A ``Tracer`` records nested spans around the executors'
stages: one ``cat="execute"`` span per layer executor call, and
``compile`` / ``run`` spans around the executor cache's first and later
calls of an entry. The port runs eagerly, so an execute span fires on
every call (the reference's fire once per jit trace). Spans carry
monotonic ``perf_counter_ns`` timestamps and structured attributes.

Instrumentation is **opt-in with a no-op fast path**: sites call the
module-level ``span(...)`` helper, which reads one module global and
returns a shared ``nullcontext`` when no tracer is active, so the
disabled path is a single load+compare. Activate with ``set_tracer(t)``
or scoped via ``use_tracer(t)``. Instant events, marks and the
Chrome/Perfetto export wait for the session's tracer.

Thread safety: each thread keeps its own open-span stack (so nesting
is correct under concurrent serving) while the finished-span list is
shared under a lock. A span that exits via an exception still closes,
with an ``error`` attribute, so traces of failing runs are complete.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional


class Span:
    """One closed-or-open interval: name, category, [start, end) ns."""

    __slots__ = ("id", "parent_id", "name", "cat", "start_ns", "end_ns",
                 "tid", "attrs")

    def __init__(self, id: int, parent_id: Optional[int], name: str,
                 cat: str, start_ns: int, tid: int,
                 attrs: Dict[str, object]):
        self.id = id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None   # set at close
        self.tid = tid
        self.attrs = attrs

    @property
    def dur_ns(self) -> Optional[int]:
        return None if self.end_ns is None else self.end_ns - self.start_ns

    def __repr__(self) -> str:
        dur = self.dur_ns
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"dur={'open' if dur is None else f'{dur / 1e3:.1f}us'})")


class Tracer:
    """Collects spans; bounded so long-lived servers cannot grow a trace
    without limit (``max_spans``, oldest kept — the drop count is
    reported so truncation is never silent)."""

    def __init__(self, max_spans: int = 200_000):
        self.max_spans = int(max_spans)
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.dropped = 0

    # -- recording -----------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **attrs):
        """Open a nested span; yields the ``Span`` so callers can attach
        attributes mid-flight. Exceptions close the span with an
        ``error`` attribute and propagate."""
        stack = self._stack()
        parent = stack[-1].id if stack else None
        sp = Span(next(self._ids), parent, name, cat,
                  time.perf_counter_ns(), threading.get_ident(),
                  dict(attrs))
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
            else:
                self._spans.append(sp)
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.attrs["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            sp.end_ns = time.perf_counter_ns()
            stack.pop()

    # -- reading -------------------------------------------------------
    def spans(self, cat: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        return out

    def span_count(self, cat: Optional[str] = None) -> int:
        return len(self.spans(cat))


# ---------------------------------------------------------------------------
# Module-level current tracer: the one global the disabled fast path reads
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None

# one shared, stateless, reentrant no-op context manager: the disabled
# span() path allocates nothing
_NULL_CM = contextlib.nullcontext()


def current_tracer() -> Optional[Tracer]:
    return _ACTIVE


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process-wide active tracer (or disable
    with ``None``). Returns the previous tracer."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Optional[Tracer]):
    """Scoped activation. ``None`` leaves the current tracer in place
    (so a session without its own tracer never masks an outer one)."""
    if tracer is None:
        yield current_tracer()
        return
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, cat: str = "", **attrs):
    """Open a span on the active tracer — or a shared no-op context
    when tracing is disabled (one global read, zero allocation)."""
    t = _ACTIVE
    if t is None:
        return _NULL_CM
    return t.span(name, cat, **attrs)
