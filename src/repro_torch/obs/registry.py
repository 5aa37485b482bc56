"""Process-wide metric registry: counters, gauges, and fixed-bucket latency
histograms that yield p50/p95/p99 without storing samples.

One `MetricRegistry` (`repro_torch.obs.REGISTRY`) is the single source of truth
for every operational statistic in the repo.  A *metric* is a named series
with a frozen label set — `registry.counter("engine_commits", engine="e3",
certifier="ssn")` returns the same `Counter` object on every call with the
same (name, labels) pair, so components hold direct references and
increments are one attribute add (no lookup on the hot path).

The pre-registry ad-hoc stats dicts (`Engine.stats`,
`PagedMirror.range_stats`/`exec_stats`, `ReplicaCluster.stats`, the kernel
layer's `LAUNCH_STATS`) survive as *views* over registry series:

  * `StatsView`        — dict-shaped view, one counter per fixed key
                         (`stats["commits"] += 1` still works)
  * `LabeledCounterMap` — open-keyed dict view, one labeled series per key
                         seen (`stats["by_reason"]["pivot"] += 1`)
  * `CounterList`      — list-shaped view over an indexed family
                         (`stats["served"][idx] += 1`, per-replica labels)

so no caller churns, but `snapshot()` / `to_json()` /
`render_prometheus()` see everything, and `reset()` is one atomic
zero-everything with a pre-reset snapshot returned (the cross-run-leakage
fix for process-global stats).

Latency histograms use fixed log-spaced bucket boundaries (1 µs .. 10 s,
4 per decade): `observe()` is a bisect + two adds, percentiles come from
linear interpolation inside the covering bucket — bounded memory at any
sample count.

Timing is cheap-by-default and stubbable: instrument with
``t0 = tick()`` ... ``tock(hist, t0)``; `set_timing(False)` turns both
into no-ops (no `perf_counter` calls), which is how the observability
bench measures its own overhead bound.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from bisect import bisect_left
from collections import abc
from typing import Optional, Sequence

# latency bucket boundaries in SECONDS: 1 µs .. 10 s, 4 per decade, plus an
# implicit overflow bucket.  Fixed across every histogram so merged
# summaries (e.g. per-stage across replicas) stay exact bucket sums.
DEFAULT_BOUNDS = tuple(1e-6 * 10 ** (i / 4) for i in range(29))


class Counter:
    """Monotonic (by convention) integer series."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: tuple) -> None:
        self.name, self.labels, self.value = name, labels, 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0

    def snap(self):
        return self.value


class Gauge(Counter):
    """Point-in-time value (peaks tracked via `track_max`)."""

    __slots__ = ()
    kind = "gauge"

    def track_max(self, v) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Fixed-bucket latency histogram: p50/p95/p99 from bucket counts, no
    samples stored.  Values are seconds; summaries report microseconds."""

    __slots__ = ("name", "labels", "bounds", "counts", "total", "count")
    kind = "histogram"

    def __init__(self, name: str, labels: tuple,
                 bounds: Sequence[float] = DEFAULT_BOUNDS) -> None:
        self.name, self.labels = name, labels
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow bucket
        self.total = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        self.counts[bisect_left(self.bounds, seconds)] += 1
        self.total += seconds
        self.count += 1

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def percentile(self, q: float) -> float:
        """q-th percentile (q in [0, 1]) in seconds, linearly interpolated
        inside the covering bucket; 0.0 when empty."""
        return percentile_of(self.bounds, self.counts, self.count, q)

    def snap(self) -> dict:
        return summarize(self.bounds, self.counts, self.count, self.total)


def percentile_of(bounds: Sequence[float], counts: Sequence[int],
                  total_count: int, q: float) -> float:
    if not total_count:
        return 0.0
    target = q * total_count
    cum, lo = 0, 0.0
    for bound, c in zip(bounds, counts):
        if c and cum + c >= target:
            return lo + (target - cum) / c * (bound - lo)
        cum += c
        lo = bound
    return bounds[-1]        # overflow bucket: clamp to the last boundary


def summarize(bounds, counts, count, total) -> dict:
    """The standard latency summary: count + p50/p95/p99 in µs (rounded)."""
    return {
        "count": count,
        "sum_us": round(total * 1e6, 1),
        "p50_us": round(percentile_of(bounds, counts, count, 0.50) * 1e6, 1),
        "p95_us": round(percentile_of(bounds, counts, count, 0.95) * 1e6, 1),
        "p99_us": round(percentile_of(bounds, counts, count, 0.99) * 1e6, 1),
    }


def _fmt_series(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricRegistry:
    """Process-wide named-series registry with atomic reset/snapshot."""

    def __init__(self) -> None:
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.RLock()
        self._scopes = itertools.count(1)

    # ------------------------------------------------------------ creation
    def scope(self, prefix: str) -> str:
        """A unique per-instance label value (e.g. "engine3"): component
        instances scope their series so per-instance views never alias."""
        return f"{prefix}{next(self._scopes)}"

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, key[1], **kw)
            assert isinstance(m, cls), \
                f"metric {name} already registered as {m.kind}"
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, bounds: Sequence[float] = DEFAULT_BOUNDS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    # ----------------------------------------------------------- queries
    def series(self, name: str) -> list:
        with self._lock:
            return [m for m in self._metrics.values() if m.name == name]

    def total(self, name: str, **label_filter) -> int:
        """Sum a counter/gauge family over every label set matching the
        filter (aggregation across instances/replicas comes free)."""
        out = 0
        for m in self.series(name):
            lbl = dict(m.labels)
            if all(lbl.get(k) == str(v) for k, v in label_filter.items()):
                out += m.value
        return out

    def hist_summary(self, name: str, **label_filter) -> dict:
        """Merged latency summary of a histogram family: exact bucket sums
        across every matching label set (shared fixed bounds)."""
        counts, count, total, bounds = None, 0, 0.0, DEFAULT_BOUNDS
        for m in self.series(name):
            lbl = dict(m.labels)
            if not all(lbl.get(k) == str(v) for k, v in label_filter.items()):
                continue
            bounds = m.bounds
            if counts is None:
                counts = [0] * (len(m.bounds) + 1)
            for i, c in enumerate(m.counts):
                counts[i] += c
            count += m.count
            total += m.total
        return summarize(bounds, counts or [0] * (len(bounds) + 1),
                         count, total)

    def hist_group(self, name: str, by: str, **label_filter) -> dict:
        """Per-label-value merged summaries of a histogram family, e.g.
        hist_group("olap_serve_seconds", "plan") -> {plan kind: summary}."""
        values = sorted({dict(m.labels).get(by) for m in self.series(name)
                         if dict(m.labels).get(by) is not None})
        out = {v: self.hist_summary(name, **{by: v}, **label_filter)
               for v in values}
        # registrations survive reset; groups that saw nothing in this
        # measurement window are noise, not data
        return {v: s for v, s in out.items() if s["count"]}

    # ----------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Plain-data snapshot: {"counters": {series: value}, "gauges":
        {...}, "histograms": {series: summary}}."""
        with self._lock:
            out = {"counters": {}, "gauges": {}, "histograms": {}}
            for m in self._metrics.values():
                out[m.kind + "s"][_fmt_series(m.name, m.labels)] = m.snap()
            return out

    def totals(self) -> dict:
        """Counter/gauge families aggregated over all label sets — the
        compact cross-instance view driver metrics snapshot from."""
        with self._lock:
            out: dict[str, int] = {}
            for m in self._metrics.values():
                if m.kind in ("counter", "gauge"):
                    out[m.name] = out.get(m.name, 0) + m.value
            return out

    def to_json(self, *, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def render_prometheus(self) -> str:
        """Prometheus text exposition (cumulative histogram buckets)."""
        with self._lock:
            lines: list[str] = []
            seen_type: set[str] = set()
            for m in sorted(self._metrics.values(),
                            key=lambda m: (m.name, m.labels)):
                if m.name not in seen_type:
                    seen_type.add(m.name)
                    lines.append(f"# TYPE {m.name} {m.kind}")
                if m.kind != "histogram":
                    lines.append(f"{_fmt_series(m.name, m.labels)} {m.value}")
                    continue
                cum = 0
                for bound, c in zip(m.bounds, m.counts):
                    cum += c
                    lbl = m.labels + (("le", f"{bound:.6g}"),)
                    lines.append(
                        f"{_fmt_series(m.name + '_bucket', lbl)} {cum}")
                lbl = m.labels + (("le", "+Inf"),)
                lines.append(
                    f"{_fmt_series(m.name + '_bucket', lbl)} {m.count}")
                lines.append(
                    f"{_fmt_series(m.name + '_sum', m.labels)} "
                    f"{m.total:.9f}")
                lines.append(
                    f"{_fmt_series(m.name + '_count', m.labels)} {m.count}")
            return "\n".join(lines) + "\n"

    # ------------------------------------------------------------- reset
    def reset(self) -> dict:
        """Atomically zero EVERY registered series (registrations — and the
        object identities views hold — survive) and return the pre-reset
        snapshot.  The driver calls this at run start so two back-to-back
        runs both start from zero."""
        with self._lock:
            snap = self.snapshot()
            for m in self._metrics.values():
                m.reset()
            return snap

    def reset_metrics(self, metrics) -> None:
        """Atomically zero a subset of series (e.g. one view's counters)."""
        with self._lock:
            for m in metrics:
                m.reset()


# ---------------------------------------------------------------- views
class StatsView(abc.MutableMapping):
    """Dict-shaped thin view over registry counters: preserves the
    pre-registry stats-attribute API (`stats["k"] += 1`, `dict(stats)`,
    `==`), one fixed-key series each; `sub` mounts nested views (e.g. a
    `LabeledCounterMap` under "by_reason")."""

    __slots__ = ("_reg", "_c", "_sub")

    def __init__(self, registry: MetricRegistry, prefix: str,
                 keys: Sequence[str], *, labels: Optional[dict] = None,
                 sub: Optional[dict] = None) -> None:
        self._reg = registry
        self._c = {k: registry.counter(f"{prefix}_{k}", **(labels or {}))
                   for k in keys}
        self._sub = dict(sub or {})

    def __getitem__(self, k):
        if k in self._sub:
            return self._sub[k]
        return self._c[k].value

    def __setitem__(self, k, v) -> None:
        if k in self._sub:
            raise TypeError(f"nested stats view {k!r} cannot be assigned")
        self._c[k].set(v)

    def __delitem__(self, k) -> None:
        raise TypeError("stats views have a fixed key set")

    def __iter__(self):
        yield from self._c
        yield from self._sub

    def __len__(self) -> int:
        return len(self._c) + len(self._sub)

    def __eq__(self, other):
        if isinstance(other, abc.Mapping):
            return dict(self) == dict(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"

    def reset(self) -> dict:
        """Atomic zero of this view's series; returns the pre-reset dict."""
        with self._reg._lock:
            snap = {k: c.value for k, c in self._c.items()}
            self._reg.reset_metrics(self._c.values())
            return snap

    def detach(self) -> dict:
        """Deep plain-dict copy, severed from the registry: what a run
        hands back to callers that outlive the measurement window (a
        later `REGISTRY.reset()` must not zero their copy)."""
        return {k: dict(v) if isinstance(v, abc.Mapping) else v
                for k, v in self.items()}


class LabeledCounterMap(abc.MutableMapping):
    """Open-keyed dict view: each key materializes one labeled series of a
    family (e.g. engine_aborts_by_reason{reason=...}).  Iteration skips
    zero-valued keys, matching the ad-hoc-dict semantics where an unseen
    reason was simply absent."""

    __slots__ = ("_reg", "_name", "_lk", "_labels", "_c")

    def __init__(self, registry: MetricRegistry, name: str, label_key: str,
                 *, labels: Optional[dict] = None) -> None:
        self._reg, self._name, self._lk = registry, name, label_key
        self._labels = dict(labels or {})
        self._c: dict = {}

    def _counter(self, k) -> Counter:
        c = self._c.get(k)
        if c is None:
            c = self._c[k] = self._reg.counter(
                self._name, **self._labels, **{self._lk: k})
        return c

    def __getitem__(self, k):
        if k not in self._c:
            raise KeyError(k)
        return self._c[k].value

    def __setitem__(self, k, v) -> None:
        self._counter(k).set(v)

    def __delitem__(self, k) -> None:
        raise TypeError("labeled counter maps cannot drop series")

    def __iter__(self):
        return (k for k, c in self._c.items() if c.value)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __eq__(self, other):
        if isinstance(other, abc.Mapping):
            return dict(self) == dict(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"LabeledCounterMap({dict(self)!r})"


class CounterList(abc.Sequence):
    """List-shaped view over an indexed counter family (e.g. per-replica
    serve counts: cluster_served{replica="0"} ...)."""

    __slots__ = ("_c",)

    def __init__(self, registry: MetricRegistry, name: str, n: int,
                 label_key: str = "replica", *,
                 labels: Optional[dict] = None) -> None:
        self._c = [registry.counter(name, **(labels or {}),
                                    **{label_key: str(i)})
                   for i in range(n)]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [c.value for c in self._c[i]]
        return self._c[i].value

    def __setitem__(self, i: int, v) -> None:
        self._c[i].set(v)

    def __len__(self) -> int:
        return len(self._c)

    def __eq__(self, other):
        return list(self) == other if isinstance(other, (list, tuple)) \
            else NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"CounterList({list(self)!r})"


# ------------------------------------------------------- timing switch
# Counters stay on unconditionally (one add each); timing instrumentation
# (perf_counter pairs feeding latency histograms) flows through tick/tock
# so the whole layer can be stubbed — the overhead bound in
# benchmarks.bench_serve_latency compares default vs stubbed runs.
_TIMING = [True]


def set_timing(enabled: bool) -> None:
    """Enable/disable latency timing (histogram observes) process-wide."""
    _TIMING[0] = bool(enabled)


def timing_enabled() -> bool:
    return _TIMING[0]


def tick() -> float:
    """Start a latency measurement (0.0 when timing is stubbed)."""
    return time.perf_counter() if _TIMING[0] else 0.0


def tock(hist: Histogram, t0: float) -> None:
    """Finish a latency measurement into `hist` (no-op when stubbed)."""
    if t0:
        hist.observe(time.perf_counter() - t0)


# the process-wide default registry
REGISTRY = MetricRegistry()
