"""Lightweight span tracing of the two hot paths.

A *span* is a named, labeled, timed tree node: the OLAP serve path opens
`olap_serve` with children for route -> resolve -> kernel dispatch ->
finalize, and the OLTP commit path opens `oltp_commit` with certify/WAL
children — so a trace dump answers "where did this serve spend its
time?" per replica / policy / plan kind / kernel mode.

Capture is OFF by default and costs one cached boolean check per
`span()` call (a shared no-op context manager is returned, nothing
allocated).  Enable with ``REPRO_TRACE=1`` — resolved once at import —
or at runtime
via `TRACER.set_enabled(True)`.  Even when enabled, spans are plain
perf_counter pairs and small dicts: no I/O, no thread handoff.

The tracer also keeps always-on `spans_opened` / `spans_closed`
registry counters (balance is a verify.sh invariant: an unbalanced tree
means an instrumented path raised past its finally or a span leaked).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

from .registry import REGISTRY

_FALSE = ("0", "false", "no", "off")


def _env_trace_default() -> bool:
    return os.environ.get("REPRO_TRACE", "0").strip().lower() not in _FALSE


class Span:
    """One timed node of a trace tree."""

    __slots__ = ("name", "labels", "t0", "dt", "children")

    def __init__(self, name: str, labels: dict) -> None:
        self.name = name
        self.labels = labels
        self.t0 = time.perf_counter()
        self.dt = 0.0
        self.children: list[Span] = []

    def close(self) -> None:
        self.dt = time.perf_counter() - self.t0

    def render(self, indent: int = 0) -> str:
        lbl = " ".join(f"{k}={v}" for k, v in self.labels.items())
        line = (f"{'  ' * indent}{self.name:<{max(1, 24 - 2 * indent)}} "
                f"{self.dt * 1e6:9.1f}us" + (f"  [{lbl}]" if lbl else ""))
        return "\n".join([line] + [c.render(indent + 1)
                                   for c in self.children])


class _NullSpan:
    """Shared do-nothing context manager handed out when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self._span = span

    def __enter__(self):
        return self._span

    def __exit__(self, *exc):
        self._tracer._close(self._span)
        return False


class Tracer:
    """Per-process span collector: root spans land in a bounded deque."""

    def __init__(self, max_traces: int = 256) -> None:
        self._enabled: Optional[bool] = None       # None -> env default
        self._stack: list[Span] = []
        self.traces: deque[Span] = deque(maxlen=max_traces)
        self._opened = REGISTRY.counter("trace_spans_opened")
        self._closed = REGISTRY.counter("trace_spans_closed")

    # ----------------------------------------------------------- switch
    @property
    def enabled(self) -> bool:
        return _env_trace_default() if self._enabled is None \
            else self._enabled

    def set_enabled(self, on: Optional[bool]) -> None:
        """True/False to force; None to fall back to REPRO_TRACE."""
        self._enabled = on

    # ---------------------------------------------------------- capture
    def span(self, name: str, **labels):
        """Context manager opening a child of the current span (or a new
        root).  Returns a shared no-op object when capture is off."""
        if not self.enabled:
            return _NULL_SPAN
        s = Span(name, labels)
        if self._stack:
            self._stack[-1].children.append(s)
        self._stack.append(s)
        self._opened.inc()
        return _SpanCtx(self, s)

    def _close(self, span: Span) -> None:
        span.close()
        self._closed.inc()
        # tolerate a corrupted stack (an instrumented frame that escaped
        # its with-block) rather than cascading: drop back to the span
        if self._stack and self._stack[-1] is span:
            self._stack.pop()
        elif span in self._stack:
            del self._stack[self._stack.index(span):]
        if not self._stack:
            self.traces.append(span)

    def annotate(self, **labels) -> None:
        """Attach labels to the innermost open span (no-op when off or at
        top level) — used where the value is only known mid-span, e.g.
        the routed replica index or the selected kernel mode."""
        if self._stack:
            self._stack[-1].labels.update(labels)

    # ------------------------------------------------------------ query
    @property
    def depth(self) -> int:
        return len(self._stack)

    @property
    def opened(self) -> int:
        return self._opened.value

    @property
    def closed(self) -> int:
        return self._closed.value

    def render(self, limit: int = 5) -> str:
        """Human-readable dump of the most recent `limit` trace trees."""
        roots = list(self.traces)[-limit:]
        if not roots:
            return "(no traces captured; set REPRO_TRACE=1)"
        return "\n".join(r.render() for r in roots)

    def clear(self) -> None:
        """Drop captured trees and any dangling stack (counters are reset
        by the registry-wide reset, not here)."""
        self._stack.clear()
        self.traces.clear()


# the process-wide default tracer
TRACER = Tracer()
