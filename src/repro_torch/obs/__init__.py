"""Unified observability layer: process-wide metric registry + hot-path
span tracing.

Everything operational in the repo reports here: counters/gauges are
always on (one attribute add each), latency histograms are on by default
and stubbable via `set_timing(False)`, span capture is off by default
and enabled with REPRO_TRACE=1 (or `TRACER.set_enabled(True)`).

`reset_run()` is the one atomic "start a fresh measurement window"
entry point the driver calls per run.
"""

from .registry import (DEFAULT_BOUNDS, REGISTRY, Counter, CounterList, Gauge,
                       Histogram, LabeledCounterMap, MetricRegistry,
                       StatsView, set_timing, summarize, tick,
                       timing_enabled, tock)
from .trace import TRACER, Span, Tracer

__all__ = [
    "Counter", "CounterList", "DEFAULT_BOUNDS", "Gauge", "Histogram",
    "LabeledCounterMap", "MetricRegistry", "REGISTRY", "Span", "StatsView",
    "TRACER", "Tracer", "reset_run", "set_timing", "summarize", "tick",
    "timing_enabled", "tock",
]


def reset_run() -> dict:
    """Start a fresh measurement window: atomically zero every registered
    series and drop captured traces.  Returns the pre-reset snapshot."""
    snap = REGISTRY.reset()
    TRACER.clear()
    return snap
