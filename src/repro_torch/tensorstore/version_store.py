"""VersionStore: one read interface over the Python chain store and the
device-resident paged mirror.

The HTAP stack has two multiversion stores with the same visibility
semantics but different shapes:

  * `mvcc.store.Store` — per-key Python version chains (the PostgreSQL-heap
    analogue; the engine's source of truth),
  * `tensorstore.mirror.PagedMirror` — the WAL-mirrored K-slot paged store
    (the kernel-shaped OLAP surface).

`VersionStore` unifies them behind four operations:

  * point read at a watermark        (SI-V prefix visibility),
  * point read under RSS membership  (the paper's protected read),
  * **batched snapshot scan** over a key sequence — ONE visibility
    resolution for the whole read set instead of N per-key walks,
  * **plan execution** — the query-plan IR of the device-resident OLAP
    executor: `ScanPlan` (materialize the visible values), `AggPlan`
    (reduce a tagged field of the visible values: sum / count /
    count-below / min / max), `MultiAggPlan` (a compound of several
    statistics over ONE read set, e.g. sum+count for AVG, served by a
    single visibility pass — the kernel computes all five lanes anyway),
    and `GroupByPlan` (GROUP BY: per-group key sequences reduced to a
    small [groups × ops] tile in one fused pass).  `BatchPlan` fuses
    several same-horizon aggregate plans into ONE kernel launch
    (whole-batch plan fusion — the device half of cross-reader
    batching).  `ChainVersionStore`
    executes plans on the per-key Python path (the oracle);
    `PagedVersionStore` lowers aggregate plans to the fused
    `rss_scan_agg` CUDA kernels, so results come back as a handful of
    scalars — page payloads never decode back to Python.

`execute(plan, snapshot)` is the ONE OLAP seam every layer above exposes
(engine, HTAP facades, replica, cluster, driver): new plan kinds are a
one-layer change here plus a kernel lowering, never a new method pair at
six layers.

Snapshots are either an int commit-seq watermark or an exported
`RssSnapshot`; `scan()`/`execute()` dispatch on the type.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Protocol, Sequence, Union, runtime_checkable

from ..core.replica import RssSnapshot
from .mirror import PagedMirror

Snapshot = Union[int, RssSnapshot]


# ------------------------------------------------------------- query-plan IR
@dataclass(frozen=True)
class AggOp:
    """One aggregate over a tagged scalar field of the visible values.

    kind:  "sum" | "count" | "count_below" | "min" | "max" |
           "count_above" | "sum_below"
    field: "int"   — plain integer values (an unwritten/initial key IS the
                     int 0, so it participates — matching the per-key
                     oracle's `isinstance(v, int)` test),
           "total" — the "total" field of order-shaped dict values.
    threshold: the predicate bound of the thresholded kinds — count_below
               and sum_below take x < threshold, count_above takes
               x > threshold (predicate pushdown through the one
               (field, threshold) kernel-config seam).
    """
    kind: str
    field: str = "int"
    threshold: Optional[int] = None


@dataclass(frozen=True)
class ScanPlan:
    keys: tuple[str, ...]


@dataclass(frozen=True)
class AggPlan:
    keys: tuple[str, ...]
    op: AggOp


@dataclass(frozen=True)
class MultiAggPlan:
    """Compound multi-statistic plan: several `AggOp`s over ONE key
    sequence, answered from a single visibility resolve (the fused kernel
    emits all five statistic lanes per pass, so e.g. AVG = sum+count costs
    one device pass, not two).  Result: a tuple of ints aligned with
    `ops`."""
    keys: tuple[str, ...]
    ops: tuple[AggOp, ...]


@dataclass(frozen=True)
class GroupByPlan:
    """Grouped aggregate (GROUP BY district / warehouse / ...): group i is
    the key sequence `key_groups[i]`, and every group is reduced under
    every op in ONE fused pass emitting a small [groups × ops] tile.
    Result: a tuple over groups of tuples of ints aligned with `ops`.
    Groups may be empty (count 0, min/max fold to 0) and a key may appear
    in more than one group.  Build from a key-classifier function with
    `group_by`."""
    key_groups: tuple[tuple[str, ...], ...]
    ops: tuple[AggOp, ...]

    @property
    def keys(self) -> tuple[str, ...]:
        """The flat read set, group-major — what read-set recording and
        the per-key oracle walk."""
        return tuple(k for grp in self.key_groups for k in grp)


@dataclass(frozen=True)
class BatchPlan:
    """Whole-batch plan fusion: several aggregate-shaped plans sharing ONE
    snapshot horizon, lowered to a single fused kernel launch — one
    visibility resolve, one pass over the pages, one accumulator lane per
    (plan, kernel config, group) — instead of one launch per plan.  This
    is the device half of cross-reader batching: PRoT pin sharing already
    hands same-horizon readers the same `RssSnapshot` object, and a
    `BatchPlan` lets their plans ride one kernel dispatch.  Result: a
    tuple of per-plan results in `plans` order, each exactly what the
    plan would return unbatched.  `ScanPlan`s don't batch (they
    materialize values, not lanes)."""
    plans: tuple[Plan, ...]

    def __post_init__(self) -> None:
        assert self.plans, "empty BatchPlan"
        for p in self.plans:
            assert isinstance(p, (AggPlan, MultiAggPlan, GroupByPlan)), \
                f"BatchPlan takes aggregate plans, not {type(p).__name__}"

    @property
    def keys(self) -> tuple[str, ...]:
        """Flat read set: every member plan's keys, plan-major."""
        return tuple(k for p in self.plans for k in plan_keys(p))


Plan = Union[ScanPlan, AggPlan, MultiAggPlan, GroupByPlan, BatchPlan]


def plan_keys(plan: Plan) -> tuple[str, ...]:
    """Every plan's flat key sequence (group-major for `GroupByPlan`) —
    the read set a plan execution records, in oracle-walk order."""
    return plan.keys


def group_by(keys: Sequence[str], group_key_fn,
             ops: Sequence[AggOp]) -> tuple[tuple, GroupByPlan]:
    """Build a `GroupByPlan` from a key-classifier: groups appear in
    first-appearance order of `group_key_fn(key)`.  Returns (group labels,
    plan) so callers can zip labels with the per-group result rows."""
    groups: dict[Any, list[str]] = {}
    for k in keys:
        groups.setdefault(group_key_fn(k), []).append(k)
    return tuple(groups), GroupByPlan(
        tuple(tuple(g) for g in groups.values()), tuple(ops))


def agg_value(value: Any, field: str) -> Optional[int]:
    """The aggregable scalar of a decoded value under `field`, or None when
    the value does not participate (the Python-side twin of the kernel's
    tag test — `tensorstore.mirror.AGG_FIELD_TAGS` maps fields to payload
    tags)."""
    if field == "int":
        if isinstance(value, int) and not isinstance(value, bool):
            return int(value)
        return None
    if field == "total":
        if isinstance(value, dict) and "total" in value:
            return int(value["total"])
        return None
    raise ValueError(f"unknown aggregate field {field!r}")


def apply_agg(values: Sequence[Any], op: AggOp) -> int:
    """Reduce decoded values under `op` — the per-key oracle the fused
    kernel path must equal bitwise."""
    xs = [x for v in values if (x := agg_value(v, op.field)) is not None]
    if op.kind == "sum":
        return sum(xs)
    if op.kind == "count":
        return len(xs)
    if op.kind == "count_below":
        assert op.threshold is not None, "count_below needs a threshold"
        return sum(1 for x in xs if x < op.threshold)
    if op.kind == "count_above":
        assert op.threshold is not None, "count_above needs a threshold"
        return sum(1 for x in xs if x > op.threshold)
    if op.kind == "sum_below":
        assert op.threshold is not None, "sum_below needs a threshold"
        return sum(x for x in xs if x < op.threshold)
    if op.kind == "min":
        return min(xs, default=0)
    if op.kind == "max":
        return max(xs, default=0)
    raise ValueError(f"unknown aggregate kind {op.kind!r}")


def apply_plan(values: Sequence[Any], plan: Plan) -> Any:
    """Host-side plan application over the flat scanned values (in
    `plan_keys` order) — the per-key oracle every fused lowering must
    equal bitwise.  `ScanPlan` -> list of values; `AggPlan` -> int;
    `MultiAggPlan` -> tuple[int] per op; `GroupByPlan` -> tuple over
    groups of tuple[int] per op."""
    if isinstance(plan, ScanPlan):
        return list(values)
    if isinstance(plan, AggPlan):
        return apply_agg(values, plan.op)
    if isinstance(plan, MultiAggPlan):
        return tuple(apply_agg(values, op) for op in plan.ops)
    if isinstance(plan, GroupByPlan):
        out, i = [], 0
        for grp in plan.key_groups:
            gvals = values[i:i + len(grp)]
            i += len(grp)
            out.append(tuple(apply_agg(gvals, op) for op in plan.ops))
        return tuple(out)
    if isinstance(plan, BatchPlan):
        out, i = [], 0
        for p in plan.plans:
            pk = plan_keys(p)
            out.append(apply_plan(values[i:i + len(pk)], p))
            i += len(pk)
        return tuple(out)
    raise TypeError(f"unknown plan kind {type(plan).__name__}")


def finalize_agg(raw: Sequence[int], op: AggOp) -> int:
    """Pick `op`'s statistic out of the kernel's [sum, count, count_below,
    min, max, count_above, sum_below] vector (min/max fold their empty-set
    sentinels to 0, matching `apply_agg`).  Legacy 5-lane raws still
    finalize every pre-pushdown kind."""
    vals = [int(v) for v in raw]
    s, n, below, mn, mx = vals[:5]
    if op.kind == "sum":
        return s
    if op.kind == "count":
        return n
    if op.kind == "count_below":
        return below
    if op.kind == "min":
        return mn if n else 0
    if op.kind == "max":
        return mx if n else 0
    if op.kind == "count_above":
        return vals[5]
    if op.kind == "sum_below":
        return vals[6]
    raise ValueError(f"unknown aggregate kind {op.kind!r}")


@runtime_checkable
class VersionStore(Protocol):
    def read_at(self, key: str, watermark: int) -> Any: ...

    def read_members(self, key: str, snap: RssSnapshot) -> Any: ...

    def scan_at(self, keys: Sequence[str], watermark: int) -> list[Any]: ...

    def scan_members(self, keys: Sequence[str],
                     snap: RssSnapshot) -> list[Any]: ...

    def scan(self, keys: Sequence[str], snapshot: Snapshot) -> list[Any]: ...

    def scan_with_writers(self, keys: Sequence[str], snapshot: Snapshot) \
        -> tuple[list[Any], list[int]]: ...

    def execute(self, plan: Plan, snapshot: Snapshot) -> Any: ...

    def execute_with_writers(self, plan: Plan, snapshot: Snapshot) \
        -> tuple[Any, list[int]]: ...


class _ScanDispatch:
    def scan(self, keys: Sequence[str], snapshot: Snapshot) -> list[Any]:
        if isinstance(snapshot, RssSnapshot):
            return self.scan_members(keys, snapshot)
        return self.scan_at(keys, int(snapshot))

    # ------------------------------------------------------ plan execution
    def execute(self, plan: Plan, snapshot: Snapshot) -> Any:
        """Execute a query plan at a snapshot: a list of values for
        `ScanPlan`, one int for `AggPlan`."""
        return self.execute_with_writers(plan, snapshot)[0]

    def execute_with_writers(self, plan: Plan, snapshot: Snapshot) \
            -> tuple[Any, list[int]]:
        """Default lowering: one batched visibility walk over the plan's
        flat key sequence, then a host-side `apply_plan` — the per-key
        oracle path for every plan kind.  Stores with a device-resident
        image override this to fuse resolve + reduce in one kernel pass.
        The writers always cover every plan key (group-major for
        `GroupByPlan`), so the engine records aggregate read sets exactly
        like scan read sets."""
        vals, writers = self.scan_with_writers(plan_keys(plan), snapshot)
        return apply_plan(vals, plan), writers


class ChainVersionStore(_ScanDispatch):
    """VersionStore over a `mvcc.store.Store` (or anything exposing a
    `chains: dict[str, VersionChain]` mapping).  Reads never materialize
    missing chains: an unwritten key is the initial value 0."""

    def __init__(self, store) -> None:
        self.store = store

    def read_at(self, key: str, watermark: int) -> Any:
        ch = self.store.chains.get(key)
        return ch.visible_at(watermark).value if ch is not None else 0

    def read_members(self, key: str, snap: RssSnapshot) -> Any:
        ch = self.store.chains.get(key)
        return ch.visible_in(snap.visible).value if ch is not None else 0

    def scan_at(self, keys: Sequence[str], watermark: int) -> list[Any]:
        return self.scan_with_writers(keys, watermark)[0]

    def scan_members(self, keys: Sequence[str],
                     snap: RssSnapshot) -> list[Any]:
        return self.scan_with_writers(keys, snap)[0]

    def scan_with_writers(self, keys: Sequence[str], snapshot: Snapshot) \
            -> tuple[list[Any], list[int]]:
        """Batched scan returning (values, writer txn ids) in one chain
        walk — the single visibility-resolution loop `scan_at` and
        `scan_members` delegate to; the writers let the engine record the
        read set without a second per-key pass."""
        chains = self.store.chains
        if isinstance(snapshot, RssSnapshot):
            visible = snapshot.visible
            resolve = lambda ch: ch.visible_in(visible)
        else:
            wm = int(snapshot)
            resolve = lambda ch: ch.visible_at(wm)
        vals, writers = [], []
        for key in keys:
            ch = chains.get(key)
            if ch is None:
                vals.append(0)
                writers.append(0)
            else:
                v = resolve(ch)
                vals.append(v.value)
                writers.append(v.writer)
        return vals, writers


class PagedVersionStore(_ScanDispatch):
    """VersionStore over the WAL-mirrored paged store: scans are single
    vectorized visibility passes (`version_gather`/`rss_gather` algorithm);
    `mirror.torch_store()` exposes the same state to the kernels, and
    aggregate plans (`AggPlan`/`MultiAggPlan`/`GroupByPlan`) lower to the
    fused `rss_scan_agg` kernel family via
    `PagedMirror.execute_with_writers` — visibility resolve + reduction in
    one device pass per kernel config over the plan's page range."""

    def __init__(self, mirror: PagedMirror) -> None:
        self.mirror = mirror

    def execute_with_writers(self, plan: Plan, snapshot: Snapshot) \
            -> tuple[Any, list[int]]:
        return self.mirror.execute_with_writers(plan, snapshot)

    def execute(self, plan: Plan, snapshot: Snapshot) -> Any:
        """Execute-only fast path: no writer resolve — a materialized-view
        hit serves with NO per-key host work (the replica/bench serve
        path, where nothing records read sets)."""
        return self.mirror.execute_with_writers(plan, snapshot,
                                                need_writers=False)[0]

    def register_view(self, plan: Plan):
        """Register `plan` for incremental materialization on the backing
        mirror (see `tensorstore.materialized`)."""
        return self.mirror.register_view(plan)

    def read_at(self, key: str, watermark: int) -> Any:
        return self.mirror.read_at(key, watermark)

    def read_members(self, key: str, snap: RssSnapshot) -> Any:
        return self.mirror.read_members(key, snap)

    def scan_at(self, keys: Sequence[str], watermark: int) -> list[Any]:
        return self.mirror.scan_at(keys, watermark)

    def scan_members(self, keys: Sequence[str],
                     snap: RssSnapshot) -> list[Any]:
        return self.mirror.scan_members(keys, snap)

    def scan_with_writers(self, keys: Sequence[str], snapshot: Snapshot) \
            -> tuple[list[Any], list[int]]:
        return self.mirror.scan_with_writers(keys, snapshot)
