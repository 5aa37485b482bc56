"""WAL -> paged-store mirror: a device-shaped OLAP surface over the HTAP WAL.

`PagedMirror` applies committed writesets from `Wal.tail()` into K-slot page
versions (the `tensorstore.paged` layout), stamping each version with the
primary's commit seq shipped in the commit record — the SAME clock the
RSS membership mapping uses.  That gives replicas (and the single-node HTAP
facade) a columnar, batch-scannable image of the keyspace:

  * `scan_at(keys, watermark)`       — SI-V snapshot scan (prefix visibility)
  * `scan_members(keys, snapshot)`   — RSS membership scan (set visibility)

Both resolve visibility for all requested pages in one vectorized pass (the
`version_gather` / `rss_gather` algorithms on host numpy buffers — mutable
in-place, so publishes are O(K+E) and scans allocation-light), and
`torch_store()` / `torch_store_for()` export the live buffers as a
`{'data','ts'}` int32 paged store on the mirror's device for the fused
kernels: CUDA kernels on "cuda" (the default), their plain PyTorch versions
on "cpu" (`kernels.config.resolve_device`).  The reference's `use_kernel=`
and `interpret=` arguments are gone: the mirror's `device` is the choice.

The key -> page codec is `encode_value`/`decode_value`: a fixed-width int32
payload per page tagged by value shape (int / district / order), chosen so
the CH-like workload of `mvcc.workload` round-trips bit-exactly — scans over
the mirror must equal per-key engine reads.

GC: publishes honour a `gc_floor` (commit-seq units, from
`PRoTManager.gc_floor_seq()`): the newest slot at-or-below the floor is never
recycled (hot_standby_feedback analogue).  Like the paper's K-slot design
this is a BOUNDED-staleness guarantee: pinned readers' versions above the
floor survive only while publishers outrun readers by fewer than K-1
versions per page — size K (`slots`) to the publish rate between reader
release points, and use `check_scans` to assert parity against the
unbounded chain store in-run.
"""

from __future__ import annotations

import bisect
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from ..core.replica import RssSnapshot
from ..core.wal import Wal, WalRecord, effective_commit_seq
from ..kernels.config import resolve_device
from ..obs import REGISTRY, TRACER, StatsView, tick, tock

# serve-path per-stage latency: visibility resolve, kernel dispatch, and
# result fold/finalize (the route stage is observed by the facades /
# cluster).  Shared across mirrors: summaries merge per stage.
_RESOLVE_H = REGISTRY.histogram("olap_stage_seconds", stage="resolve")
_DISPATCH_H = REGISTRY.histogram("olap_stage_seconds", stage="dispatch")
_FINALIZE_H = REGISTRY.histogram("olap_stage_seconds", stage="finalize")

# payload tags (element 0 of every page payload)
TAG_INIT = 0        # never-written page: decodes to the initial value 0
TAG_INT = 1         # [1, v]
TAG_DISTRICT = 2    # [2, next_o_id, ytd]
TAG_ORDER = 3       # [3, total, n_items, items...]
TAG_PAD = -1        # sublane-padding page: participates in NO aggregate
_NO_TAG = -2        # "no alternate tag": matches nothing (incl. TAG_PAD)

# aggregate-field -> (tag_main, tag_alt) payload validity for the fused
# device aggregation (`rss_scan_agg`): the kernel-side twin of
# `version_store.agg_value`.  "int" includes TAG_INIT because an initial
# page decodes to the int 0 (and its field element is 0).
AGG_FIELD_TAGS = {"int": (TAG_INT, TAG_INIT), "total": (TAG_ORDER, _NO_TAG)}

_INT32 = np.iinfo(np.int32)


# AggOp kinds whose lane depends on the threshold scalar (predicate
# pushdown: count_below / count_above / sum_below share one kernel pass
# per (field, threshold) config)
_THRESHOLDED_KINDS = ("count_below", "count_above", "sum_below")


def _op_config(op) -> tuple:
    """The fused-kernel pass an `AggOp` needs: (field, threshold) —
    threshold only matters to the thresholded kinds, so every other kind
    shares its field's default pass (the kernel emits all seven lanes
    regardless)."""
    return (op.field,
            op.threshold if op.kind in _THRESHOLDED_KINDS else None)


def _lane_layout(plans) -> tuple[list, list, dict]:
    """Accumulator-lane layout for a sequence of aggregate plans served by
    ONE fused grouped launch: one lane per (plan, kernel config, group),
    where a config is the (field, threshold) pass `_op_config` derives.
    Per-lane kernel params (tag_main, tag_alt, threshold) ride the
    kernel's group-param tile, so lanes from different plans/configs
    coexist in a single dispatch — whole-batch plan fusion.

    Returns (lane_groups, lane_params, lane_of): the key sequence feeding
    each lane, each lane's (field, tag_main, tag_alt, threshold), and
    (plan index, config, group index) -> lane index for result
    assembly."""
    from .version_store import AggPlan, GroupByPlan, MultiAggPlan

    lane_groups: list[tuple] = []
    lane_params: list[tuple] = []
    lane_of: dict[tuple, int] = {}
    for p_i, plan in enumerate(plans):
        if isinstance(plan, GroupByPlan):
            key_groups, ops = plan.key_groups, plan.ops
        elif isinstance(plan, MultiAggPlan):
            key_groups, ops = (plan.keys,), plan.ops
        elif isinstance(plan, AggPlan):
            key_groups, ops = (plan.keys,), (plan.op,)
        else:
            raise TypeError(f"not an aggregate plan: {type(plan).__name__}")
        for cfg in dict.fromkeys(_op_config(op) for op in ops):
            field, thr = cfg
            tag_main, tag_alt = AGG_FIELD_TAGS[field]
            for g_i, grp in enumerate(key_groups):
                lane_of[(p_i, cfg, g_i)] = len(lane_groups)
                lane_groups.append(tuple(grp))
                lane_params.append((field, tag_main, tag_alt, thr))
    return lane_groups, lane_params, lane_of


def encode_value(value: Any, elems: int) -> np.ndarray:
    """Encode a workload value into a fixed [elems] int32 payload."""
    out = np.zeros(elems, np.int32)
    if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        assert _INT32.min <= value <= _INT32.max, value
        out[0], out[1] = TAG_INT, value
        return out
    if isinstance(value, dict):
        if set(value) <= {"next_o_id", "ytd"}:
            out[0] = TAG_DISTRICT
            out[1] = value.get("next_o_id", 0)
            out[2] = value.get("ytd", 0)
            return out
        if set(value) <= {"items", "total"}:
            items = list(value.get("items", ()))
            assert len(items) + 3 <= elems, \
                f"order with {len(items)} items needs page_elems >= " \
                f"{len(items) + 3}"
            out[0], out[1], out[2] = TAG_ORDER, value.get("total", 0), \
                len(items)
            out[3:3 + len(items)] = items
            return out
    raise TypeError(f"no paged-store codec for value {value!r}")


def decode_value(row: np.ndarray) -> Any:
    """Inverse of encode_value; TAG_INIT decodes to the chain-store initial
    value 0."""
    tag = int(row[0])
    if tag == TAG_INIT:
        return 0
    if tag == TAG_INT:
        return int(row[1])
    if tag == TAG_DISTRICT:
        return {"next_o_id": int(row[1]), "ytd": int(row[2])}
    if tag == TAG_ORDER:
        n = int(row[2])
        return {"items": [int(x) for x in row[3:3 + n]],
                "total": int(row[1])}
    raise ValueError(f"corrupt page payload tag {tag}")


class PagedMirror:
    def __init__(self, *, slots: int = 8, page_elems: int = 32,
                 capacity: int = 64, resolve_cache: bool = True,
                 device=None) -> None:
        """`device` is where exported stores and kernel launches live:
        "cuda" by default (raises without a GPU), or "cpu" for the plain
        PyTorch versions.  The mirror's own page buffers stay host numpy,
        as in the reference."""
        assert page_elems >= 3
        self.device = resolve_device(device)
        self.slots = slots
        self.page_elems = page_elems
        self.data = np.zeros((capacity, slots, page_elems), np.int32)
        self.ts = np.zeros((capacity, slots), np.int32)
        self.writer = np.zeros((capacity, slots), np.int32)  # txn per slot
        self.page_of: dict[str, int] = {}
        self.keys: list[str] = []
        self.applied_lsn = 0
        self.commit_seq: dict[int, int] = {}   # txn -> commit seq
        self.watermark = 0                     # newest applied commit seq
        # registry-backed accounting (series mirror_range_* /
        # mirror_exec_*), scoped per mirror instance so replicas never
        # alias; dict-shaped views keep the old reader API.
        # range: dense-range fast-path hits for fused plan executions — a
        # contiguous ascending page run slices the store (no gather);
        # `reserve` key families contiguously to raise the hit rate.
        lbl = {"mirror": REGISTRY.scope("mirror")}
        self.range_stats = StatsView(REGISTRY, "mirror_range",
                                     ("dense", "gather"), labels=lbl)
        # grouped-strategy override (None = shape dispatch; "host" /
        # "flat" / "chunked" forces a mode — tests and benches pin it)
        self.grouped_mode: str | None = None
        # plan-execution accounting: plans served, fused batches, grouped
        # dispatches and which strategy each took (the driver surfaces
        # these as plans/dispatch and mode counters)
        self.exec_stats = StatsView(
            REGISTRY, "mirror_exec",
            ("plans", "batches", "batched_plans", "agg_dispatches",
             "mode_flat", "mode_chunked", "mode_host",
             "view_hits", "view_fallbacks", "view_demotions"), labels=lbl)
        # materialized-aggregate registry: plan (frozen dataclass, hashed
        # by value — the fingerprint) -> MaterializedView.  Applied
        # commits queue in `_unfolded` and fold into the tiles as they
        # become VISIBLE to a served/constructed snapshot
        # (`advance_views` — RSS member sets grow monotonically, so the
        # freshest snapshot serves from the tile while commits still
        # excluded for unresolved deps stay queued).  `_folded_seqs`
        # (sorted, pruned by `gc_views`) is what `view_gate` checks a
        # snapshot against; seqs at-or-below `_seqs_floor` are covered by
        # any snapshot floor >= it.
        self.views: dict = {}
        self._unfolded: list = []              # [(seq, WalRecord)], ascending
        self._folded_seqs: list[int] = []
        self._seqs_floor = 0
        # ------------------------------------------- horizon-keyed resolve
        # cache: N serves sharing one applied horizon (thousands of
        # sessions routed to one replica between ships) do the host-side
        # resolve work ONCE.  Three layers, each invalidated precisely by
        # the one event that can change its value:
        #   _member_cache  snapshot -> member-seq array.  Stamped
        #                  (compressed) snapshots are pure — the array is
        #                  a function of the frozen snapshot alone — and
        #                  never invalidate; explicit-set snapshots read
        #                  `commit_seq`, so commit applies drop them.
        #   _pindex_cache  plan key-tuple (the plan fingerprint's key
        #                  sequence) -> page-index array.  `page_of` is
        #                  append-only, so an entry with NO misses is
        #                  valid forever; entries holding a -1 are stamped
        #                  with `_page_gen` and die when `_ensure_page`
        #                  allocates (a reserve / first write may have
        #                  filled the hole).
        #   _store_cache   key-tuple -> gathered {'data','ts'} device
        #                  buffers (+ the dense/gather verdict).  The
        #                  buffers are device copies of page content, so
        #                  only `apply` installing writes changes their
        #                  value — it clears the cache; reserve-only page
        #                  allocation leaves entries valid (reserved
        #                  pages are all-zero: they decode to 0 exactly
        #                  like the missing keys they replace).
        #   _lane_cache    plan tuple -> `_lane_layout` (pure function of
        #                  the frozen plans; never invalidated).
        self.resolve_cache = resolve_cache
        self._member_cache: dict = {}
        self._pindex_cache: dict = {}
        self._store_cache: dict = {}
        self._lane_cache: dict = {}
        self._page_gen = 0
        self._last_range_verdict = "gather"
        self.cache_stats = StatsView(
            REGISTRY, "mirror_cache",
            ("member_hits", "member_misses",
             "pindex_hits", "pindex_misses",
             "store_hits", "store_misses",
             "invalidations"), labels=lbl)

    @classmethod
    def from_numpy_state(cls, data, ts, writer, page_of, keys, commit_seq,
                         watermark, applied_lsn, **kwargs) -> "PagedMirror":
        """A mirror holding a given page state (copies of the arrays and
        maps of another mirror, e.g. the reference's), so two mirrors can
        start from the same state without replaying a WAL.  `kwargs` go
        to the constructor (`device`, `resolve_cache`, ...); slots and
        page_elems come from `data`."""
        data = np.array(data, np.int32)
        ts, writer = np.array(ts, np.int32), np.array(writer, np.int32)
        if data.ndim != 3 or not ts.shape == writer.shape == data.shape[:2]:
            raise ValueError(f"inconsistent page state: data {data.shape}, "
                             f"ts {ts.shape}, writer {writer.shape}")
        if not len(keys) == len(page_of) <= data.shape[0]:
            raise ValueError(f"{len(keys)} keys / {len(page_of)} pages "
                             f"do not fit {data.shape[0]} page rows")
        m = cls(slots=data.shape[1], page_elems=data.shape[2],
                capacity=max(1, data.shape[0]), **kwargs)
        m.data, m.ts, m.writer = data, ts, writer
        m.page_of = dict(page_of)
        m.keys = list(keys)
        m.commit_seq = dict(commit_seq)
        m.watermark = int(watermark)
        m.applied_lsn = int(applied_lsn)
        return m

    # ------------------------------------------------------- resolve cache
    _MEMBER_CAP = 64          # live horizons are few; FIFO-evict beyond
    _PINDEX_CAP = 256         # distinct plan key sequences
    _STORE_CAP = 32           # device buffers are the big entries

    def invalidate_caches(self) -> None:
        """Drop every resolve-cache layer (tests / recovery); counted so
        hit-rate accounting stays explainable."""
        self._member_cache.clear()
        self._pindex_cache.clear()
        self._store_cache.clear()
        self._lane_cache.clear()
        self.cache_stats["invalidations"] += 1

    @staticmethod
    def _cap(cache: dict, cap: int) -> None:
        while len(cache) >= cap:
            cache.pop(next(iter(cache)))       # FIFO: dicts keep insert order

    # ----------------------------------------------------------- page alloc
    @property
    def n_pages(self) -> int:
        return len(self.keys)

    def _ensure_page(self, key: str) -> int:
        page = self.page_of.get(key)
        if page is not None:
            return page
        page = len(self.keys)
        if page == self.data.shape[0]:         # grow by doubling
            self.data = np.concatenate([self.data, np.zeros_like(self.data)])
            self.ts = np.concatenate([self.ts, np.zeros_like(self.ts)])
            self.writer = np.concatenate([self.writer,
                                          np.zeros_like(self.writer)])
        self.page_of[key] = page
        self.keys.append(key)
        self._page_gen += 1        # page-index entries holding a -1 for
        return page                # this key are stale now

    def reserve(self, keys: Iterable[str]) -> int:
        """Pre-allocate pages for a key sequence IN ORDER (page-range
        locality): a workload key family reserved contiguously resolves to
        a dense ascending page run, so fused plan executions over it hit
        the `paged.as_page_range` slice fast path instead of gathering.
        Reserved-but-unwritten pages hold only the initial (ts == 0) slot
        and decode to 0 — exactly what a missing key reads as.  Returns
        the number of pages newly allocated."""
        before = len(self.keys)
        for key in keys:
            self._ensure_page(key)
        return len(self.keys) - before

    # -------------------------------------------------------------- publish
    def _publish(self, page: int, payload: np.ndarray, seq: int, writer: int,
                 gc_floor: int) -> None:
        """numpy twin of `paged.publish_page`: recycle the oldest slot, but
        never the newest slot at-or-below gc_floor (a pinned reader may still
        resolve to it)."""
        row = self.ts[page]
        masked = np.where(row <= gc_floor, row, -1)
        protected = int(masked.argmax())
        order = row.astype(np.int64).copy()
        order[protected] = np.iinfo(np.int64).max
        victim = int(order.argmin())
        self.data[page, victim] = payload
        self.ts[page, victim] = seq
        self.writer[page, victim] = writer

    # --------------------------------------------------------------- replay
    def apply(self, rec: WalRecord, *, gc_floor: int = 0) -> bool:
        """Apply one WAL record (idempotent by LSN); returns True when the
        record installed new versions."""
        if rec.lsn <= self.applied_lsn:
            return False
        self.applied_lsn = rec.lsn
        if rec.type != "commit":
            return False
        # the shared WAL commit clock (effective_commit_seq), so member-ts
        # mapping and mirrored version stamps never diverge from RSSManager
        seq = effective_commit_seq(self.watermark, rec.seq)
        self.commit_seq[rec.txn] = seq
        self.watermark = seq
        # precise cache invalidation: the new commit-seq mapping can extend
        # any explicit-set snapshot's member resolve (stamped snapshots are
        # pure and survive); installed writes change page content, killing
        # every gathered device buffer
        if self._member_cache:
            for s in [s for s in self._member_cache
                      if s.member_seqs is None]:
                del self._member_cache[s]
        if rec.writes and self._store_cache:
            self._store_cache.clear()
        for key, value in rec.writes:
            page = self._ensure_page(key)
            self._publish(page, encode_value(value, self.page_elems), seq,
                          rec.txn, gc_floor)
        if self.views:
            # queue the commit for folding; it advances into the tiles
            # once a served/constructed snapshot admits it (advance_views)
            self._unfolded.append((seq, rec))
        return bool(rec.writes)

    def catch_up(self, wal: Wal, *, gc_floor: int = 0) -> int:
        """Pull and apply all records past applied_lsn; returns #applied."""
        n = 0
        for rec in wal.tail(self.applied_lsn):
            self.apply(rec, gc_floor=gc_floor)
            n += 1
        return n

    # ------------------------------------------------- materialized views
    def register_view(self, plan):
        """Register an aggregate plan for incremental materialization:
        subsequent `execute_with_writers` calls with an equal plan (frozen
        dataclasses hash by value — the fingerprint) serve from a live
        accumulator tile advanced by commit-delta folds, when the
        snapshot gate proves consistency.  Idempotent per plan; seeds the
        tile with one full SI-prefix scan at the current watermark."""
        from .materialized import MaterializedView

        view = self.views.get(plan)
        if view is not None:
            return view
        if self.views and self._unfolded:
            # drain pending folds so the new view's full-prefix reseed
            # baseline matches the fold state of its siblings
            self.advance_views(self.watermark)
        view = MaterializedView(self, plan)
        if not self.views:
            # the reseed scan folded every applied commit: record them
            # all so the gate can check each against a snapshot
            self._folded_seqs = sorted(
                s for s in self.commit_seq.values() if s > self._seqs_floor)
        self.views[plan] = view
        return view

    def gc_views(self, keep_seq: int) -> None:
        """Prune `_folded_seqs` bookkeeping below the protected floor
        (`PRoTManager.gc_floor_seq()` units): every live or future
        snapshot has floor_seq >= keep_seq, so individual membership of
        folded seqs at-or-below it never needs checking again.  Call
        wherever RSS gc runs — the view analogue of WAL truncation."""
        i = bisect.bisect_right(self._folded_seqs, keep_seq)
        if i:
            del self._folded_seqs[:i]
        self._seqs_floor = max(self._seqs_floor, keep_seq)

    def reseed_views(self) -> None:
        """Recovery path: re-materialize every registered view from a
        full SI-prefix scan at the current watermark (after deep GC, WAL
        truncation, or degradation invalidated incremental state) and
        re-baseline the fold bookkeeping to match — queued commits are
        already in the rescanned prefix, so they are marked folded, not
        re-applied."""
        if not self.views:
            return
        self._unfolded = []
        self._folded_seqs = sorted(
            s for s in self.commit_seq.values() if s > self._seqs_floor)
        for view in self.views.values():
            view.reseed()

    def _visible_fn(self, snapshot):
        """seq -> bool visibility predicate for an RSS snapshot or an int
        SI watermark."""
        if isinstance(snapshot, RssSnapshot):
            members = set(self.member_seqs_for(snapshot).tolist())
            floor = snapshot.floor_seq
            return lambda s: s <= floor or s in members
        wm = int(snapshot)
        return lambda s: s <= wm

    def advance_views(self, snapshot) -> int:
        """Fold every queued commit VISIBLE to `snapshot` into the
        registered views (ascending seq order) and leave the rest queued;
        returns the number folded.  RSS member sets grow monotonically,
        so advancing at each constructed/served snapshot keeps the tiles
        exactly at the freshest snapshot while commits still excluded
        for unresolved dependencies wait their turn."""
        if not self.views or not self._unfolded:
            return 0
        visible = self._visible_fn(snapshot)
        keep, folded = [], 0
        for seq, rec in self._unfolded:
            if visible(seq):
                for view in self.views.values():
                    view.on_commit(rec, seq)
                bisect.insort(self._folded_seqs, seq)
                folded += 1
            else:
                keep.append((seq, rec))
        self._unfolded = keep
        return folded

    def view_gate(self, snapshot) -> bool:
        """True when `snapshot` provably equals the fold prefix the
        materialized tiles hold: every folded seq visible to it, every
        still-queued applied seq invisible.  Unverifiable when an RSS
        snapshot's floor predates the tracking floor (`_seqs_floor`) ->
        clean fallback."""
        if isinstance(snapshot, RssSnapshot):
            if snapshot.floor_seq < self._seqs_floor:
                return False
            above = self._folded_seqs[
                bisect.bisect_right(self._folded_seqs, snapshot.floor_seq):]
            if not above and not self._unfolded:
                return True
            visible = self._visible_fn(snapshot)
            return (all(visible(s) for s in above)
                    and not any(visible(s) for s, _ in self._unfolded))
        wm = int(snapshot)
        if self._folded_seqs and self._folded_seqs[-1] > wm:
            return False
        return not any(s <= wm for s, _ in self._unfolded)

    def _try_views(self, plan, snapshot, need_writers: bool):
        """Serve a plan (or a whole fused batch, all-or-nothing) from the
        materialized registry: returns (result, writers) on a hit, None
        to fall through to the fused-scan path.  Fallbacks are counted
        only for REGISTERED plans that failed the gate (or degraded) —
        an unregistered plan is not a fallback, it never had a view."""
        from .version_store import BatchPlan, plan_keys

        plans = plan.plans if isinstance(plan, BatchPlan) else (plan,)
        views = [self.views.get(p) for p in plans]
        n_reg = sum(v is not None for v in views)
        if not n_reg:
            return None
        # fold whatever this snapshot admits before gating — serving the
        # freshest snapshot then hits; older pinned ones fall back
        self.advance_views(snapshot)
        if (any(v is None or v.degraded for v in views)
                or not self.view_gate(snapshot)):
            self.exec_stats["view_fallbacks"] += n_reg
            return None
        t0 = tick()
        with TRACER.span("view_serve", plans=len(views)):
            results = [v.result() for v in views]
        tock(_DISPATCH_H, t0)
        if need_writers:
            t0 = tick()
            with TRACER.span("resolve"):
                all_keys = [k for p in plans for k in plan_keys(p)]
                mask_fn, _m, _f = self._snapshot_mask(snapshot)
                writers = self._writers_for(self.page_index(all_keys),
                                            mask_fn)
            tock(_RESOLVE_H, t0)
        else:
            writers = []
        self.exec_stats["view_hits"] += len(views)
        self.exec_stats["plans"] += len(views)
        if isinstance(plan, BatchPlan):
            self.exec_stats["batches"] += 1
            self.exec_stats["batched_plans"] += len(views)
            return tuple(results), writers
        return results[0], writers

    # ------------------------------------------------------ batched reads
    def member_seqs_for(self, snap: RssSnapshot) -> np.ndarray:
        """Sorted member commit seqs ABOVE the snapshot's floor (with
        `snap.floor_seq`, the member-ts state the rss_gather kernel takes).
        Compressed snapshots carry their own seqs; explicit-set snapshots
        map `txns` through the mirror's commit-seq bookkeeping.  Cached per
        snapshot (frozen dataclass — identity IS the horizon), so repeat
        serves at one horizon skip the rebuild."""
        if self.resolve_cache:
            arr = self._member_cache.get(snap)
            if arr is not None:
                self.cache_stats["member_hits"] += 1
                return arr
        if snap.member_seqs is not None:
            arr = np.asarray(snap.member_seqs, np.int32)
        else:
            seqs = [self.commit_seq[t] for t in snap.txns
                    if t in self.commit_seq]
            arr = np.asarray(sorted(seqs), np.int32)
        if self.resolve_cache:
            self.cache_stats["member_misses"] += 1
            arr.flags.writeable = False
            self._cap(self._member_cache, self._MEMBER_CAP)
            self._member_cache[snap] = arr
        return arr

    def _visible_slots(self, rows: np.ndarray, mask_fn) -> np.ndarray:
        """Resolve visibility for a batch of pages: [n] slot indices."""
        ts = self.ts[rows]                                  # [n, K]
        masked = mask_fn(ts)
        return masked.argmax(1)                             # first max: ties
                                                            # toward slot 0

    def _scan(self, keys: Sequence[str], mask_fn, *,
              with_writers: bool = False):
        pages = self.page_index(keys)
        out: list[Any] = [0] * len(keys)
        writers = [0] * len(keys)
        hit = np.nonzero(pages >= 0)[0]
        if hit.size:
            rows = pages[hit]
            slot = self._visible_slots(rows, mask_fn)
            payloads = self.data[rows, slot]
            for i, row, wtr in zip(hit, payloads, self.writer[rows, slot]):
                out[int(i)] = decode_value(row)
                writers[int(i)] = int(wtr)
        return (out, writers) if with_writers else out

    def _writers_for(self, pages: np.ndarray, mask_fn) -> list[int]:
        """Writer txn per key out of the SAME visibility resolve `_scan`
        uses — no payload decode; the read-set half of a fused aggregate."""
        writers = [0] * len(pages)
        hit = np.nonzero(pages >= 0)[0]
        if hit.size:
            rows = pages[hit]
            slot = self._visible_slots(rows, mask_fn)
            for i, wtr in zip(hit, self.writer[rows, slot]):
                writers[int(i)] = int(wtr)
        return writers

    @staticmethod
    def _member_mask(snap: RssSnapshot, members: np.ndarray):
        """Slot visibility under a compressed snapshot: initial (ts == 0),
        floor-covered (ts <= floor_seq), or an explicit above-floor
        member."""
        floor = snap.floor_seq
        return lambda ts: np.where(
            (ts <= floor) | np.isin(ts, members), ts, -1)

    def scan_at(self, keys: Sequence[str], watermark: int) -> list[Any]:
        """SI-V batched snapshot scan: one vectorized visibility pass."""
        return self._scan(
            keys, lambda ts: np.where(ts <= watermark, ts, -1))

    def scan_members(self, keys: Sequence[str],
                     snap: RssSnapshot) -> list[Any]:
        """RSS membership batched scan (empty member set -> initial slots)."""
        return self._scan(
            keys, self._member_mask(snap, self.member_seqs_for(snap)))

    def scan_with_writers(self, keys: Sequence[str], snapshot) \
            -> tuple[list[Any], list[int]]:
        """Batched scan returning (values, writer txn ids) — the writers
        feed read-set recording on the engine's batched scan path."""
        if isinstance(snapshot, RssSnapshot):
            mask = self._member_mask(snapshot,
                                     self.member_seqs_for(snapshot))
        else:
            wm = int(snapshot)
            mask = lambda ts: np.where(ts <= wm, ts, -1)
        return self._scan(keys, mask, with_writers=True)

    def read_at(self, key: str, watermark: int) -> Any:
        return self.scan_at([key], watermark)[0]

    def read_members(self, key: str, snap: RssSnapshot) -> Any:
        return self.scan_members([key], snap)[0]

    # ------------------------------------------------------ fused aggregates
    def page_index(self, keys: Sequence[str]) -> np.ndarray:
        """Dense key -> page resolution for a plan's key sequence (-1 for
        keys never written: they read as the initial value 0).  Memoized
        per key-tuple (== per plan fingerprint, since `plan_keys` is a
        pure function of the frozen plan): `page_of` is append-only, so a
        fully-resolved entry never goes stale; an entry holding misses is
        stamped with the page-allocation generation and re-resolved after
        any `reserve`/first-write allocates (the hole may be filled)."""
        if not self.resolve_cache:
            return np.asarray([self.page_of.get(k, -1) for k in keys],
                              np.int64)
        keys_t = keys if isinstance(keys, tuple) else tuple(keys)
        ent = self._pindex_cache.get(keys_t)
        if ent is not None:
            pages, has_miss, gen = ent
            if not has_miss or gen == self._page_gen:
                self.cache_stats["pindex_hits"] += 1
                return pages
        self.cache_stats["pindex_misses"] += 1
        get = self.page_of.get
        pages = np.fromiter((get(k, -1) for k in keys_t), np.int64,
                            count=len(keys_t))
        pages.flags.writeable = False
        self._cap(self._pindex_cache, self._PINDEX_CAP)
        self._pindex_cache[keys_t] = (pages, bool((pages < 0).any()),
                                      self._page_gen)
        return pages

    def _store_for(self, keys, pages: np.ndarray) -> dict:
        """`torch_store_for` behind the horizon-keyed store cache: the
        gathered `{'data','ts'}` device buffers for a plan's key sequence,
        reused until a publish changes page content (`apply` clears the
        cache).  The cached dense/gather verdict re-counts into
        `range_stats` on hits, so the fast-path hit RATE keeps meaning
        'per fused plan execution' with the cache on."""
        if not self.resolve_cache:
            return self.torch_store_for(pages)
        keys_t = keys if isinstance(keys, tuple) else tuple(keys)
        ent = self._store_cache.get(keys_t)
        if ent is not None:
            store, verdict = ent
            self.range_stats[verdict] += 1
            self.cache_stats["store_hits"] += 1
            return store
        self.cache_stats["store_misses"] += 1
        store = self.torch_store_for(pages)
        self._cap(self._store_cache, self._STORE_CAP)
        self._store_cache[keys_t] = (store, self._last_range_verdict)
        return store

    def _lane_layout_for(self, plans) -> tuple[list, list, dict]:
        """`_lane_layout` memoized per plan tuple (frozen dataclasses hash
        by value, so the tuple IS the batch fingerprint)."""
        if not self.resolve_cache:
            return _lane_layout(plans)
        plans_t = tuple(plans)
        layout = self._lane_cache.get(plans_t)
        if layout is None:
            layout = _lane_layout(plans_t)
            self._cap(self._lane_cache, self._PINDEX_CAP)
            self._lane_cache[plans_t] = layout
        return layout

    def _snapshot_mask(self, snapshot):
        """(mask_fn, member_ts, floor) for either snapshot kind: an RSS
        snapshot masks by floor + above-floor members; an int watermark is
        the degenerate empty-member case (floor == watermark), so the same
        fused kernel serves SI-V aggregates."""
        if isinstance(snapshot, RssSnapshot):
            members = self.member_seqs_for(snapshot)
            return (self._member_mask(snapshot, members), members,
                    snapshot.floor_seq)
        wm = int(snapshot)
        return (lambda ts: np.where(ts <= wm, ts, -1),
                np.zeros((0,), np.int32), wm)

    def _export(self, data: np.ndarray, ts: np.ndarray, pad: int,
                pad_tag: int) -> dict:
        """Copy host page buffers into fresh int32 tensors on the mirror's
        device, plus `pad` padding pages (ts == 0, tag `pad_tag`, zero
        payload).  Always a copy: the mirror mutates its buffers in
        place."""
        n = data.shape[0]
        out_d = torch.empty((n + pad,) + data.shape[1:], dtype=torch.int32,
                            device=self.device)
        out_t = torch.empty((n + pad,) + ts.shape[1:], dtype=torch.int32,
                            device=self.device)
        out_d[:n].copy_(torch.from_numpy(data))
        out_t[:n].copy_(torch.from_numpy(ts))
        if pad:
            out_d[n:] = 0
            out_d[n:, :, 0] = pad_tag
            out_t[n:] = 0
        return {"data": out_d, "ts": out_t}

    def torch_store_for(self, pages: np.ndarray) -> dict:
        """Columnar multi-page gather: the `{'data','ts'}` int32 sub-store
        on the mirror's device for a resolved page-index array, shaped for
        the fused scan kernels.  Missing keys (-1) become initial pages
        (ts == 0, decode to 0); padding pages (to a multiple of 8) are
        tagged TAG_PAD so fused aggregates never count them.  A contiguous
        ascending page range (`paged.as_page_range`) skips the host gather
        entirely (pure slice — the dense key-range fast path)."""
        from .paged import as_page_range

        n = int(pages.shape[0])
        pad = (-n) % 8 if n else 8
        rng = as_page_range(pages)
        self._last_range_verdict = "dense" if rng is not None else "gather"
        self.range_stats[self._last_range_verdict] += 1
        if rng is not None:
            data, ts = self.data[rng[0]:rng[1]], self.ts[rng[0]:rng[1]]
        else:
            safe = np.where(pages >= 0, pages, 0)
            data, ts = self.data[safe], self.ts[safe]
            miss = pages < 0
            if miss.any():
                data[miss] = 0
                ts[miss] = 0
        return self._export(data, ts, pad, TAG_PAD)

    def _scalar_raws(self, pages: np.ndarray, member_ts, floor, ops, *,
                     keys: Sequence[str] | None = None) -> dict:
        """One fused `rss_scan_agg` pass per distinct kernel config the op
        list needs (ops sharing a field — and a threshold for count_below —
        fold into one pass, since the kernel emits all seven statistic
        lanes).  The gathered sub-store is built ONCE and shared across
        configs.  Returns {config: [sum, count, count_below, min, max,
        count_above, sum_below]}."""
        configs = list(dict.fromkeys(_op_config(op) for op in ops))
        empty = [0, 0, 0, int(_INT32.max), int(_INT32.min), 0, 0]
        if not len(pages):
            return {cfg: list(empty) for cfg in configs}
        from ..kernels.rss_scan_agg.ops import snapshot_agg_members

        store = self.torch_store_for(pages) if keys is None \
            else self._store_for(keys, pages)
        mem = np.asarray(member_ts, np.int32)
        raws = {}
        for field, thr in configs:
            tag_main, tag_alt = AGG_FIELD_TAGS[field]
            raws[(field, thr)] = snapshot_agg_members(
                store, mem, floor, tag_main=tag_main, tag_alt=tag_alt,
                threshold=thr)
        return raws

    def _grouped_rows(self, lane_groups, lane_params, mask_fn, member_ts,
                      floor, n_plans) -> list:
        """Serve one fused grouped dispatch: every accumulator lane of a
        `_lane_layout` reduced in ONE strategy-dispatched pass.  The
        strategy comes from `ops.select_grouped_mode` (or the mirror's
        `grouped_mode` override): "host" decodes the scanned values and
        aggregates in Python (small scans — launch overhead dominates);
        "flat"/"chunked" gather the lane-major sub-store once, hand every
        lane its own kernel params, and launch a single grouped kernel
        pipeline.  Returns [lane][sum, count, count_below, min, max,
        count_above, sum_below]."""
        from ..kernels.rss_scan_agg import ops as kops
        from .version_store import agg_value

        empty = [0, 0, 0, int(_INT32.max), int(_INT32.min), 0, 0]
        flat_keys = [k for grp in lane_groups for k in grp]
        if not lane_groups or not flat_keys:
            return [list(empty) for _ in lane_groups]
        self.exec_stats["agg_dispatches"] += 1
        mode = kops.select_grouped_mode(
            len(flat_keys), len(lane_groups), n_plans,
            override=self.grouped_mode)
        if mode == "host":
            with TRACER.span("kernel_dispatch", mode="host",
                             lanes=len(lane_groups)):
                kops.LAUNCH_STATS["dispatches"] += 1
                kops.LAUNCH_STATS["host"] += 1
                self.exec_stats["mode_host"] += 1
                vals = self._scan(flat_keys, mask_fn)
                rows, off = [], 0
                for grp, (field, _tm, _ta, thr) in zip(lane_groups,
                                                       lane_params):
                    xs = [x for v in vals[off:off + len(grp)]
                          if (x := agg_value(v, field)) is not None]
                    off += len(grp)
                    thr_eff = int(_INT32.max) if thr is None else int(thr)
                    rows.append([sum(xs), len(xs),
                                 sum(1 for x in xs if x < thr_eff),
                                 min(xs, default=int(_INT32.max)),
                                 max(xs, default=int(_INT32.min)),
                                 sum(1 for x in xs if x > thr_eff),
                                 sum(x for x in xs if x < thr_eff)])
                return rows
        with TRACER.span("kernel_dispatch", lanes=len(lane_groups)):
            flat_keys = tuple(flat_keys)
            pages = self.page_index(flat_keys)
            store = self._store_for(flat_keys, pages)
            gid = np.full(int(store["ts"].shape[0]), -1, np.int32)
            gid[:len(pages)] = np.concatenate(
                [np.full(len(grp), g, np.int32)
                 for g, grp in enumerate(lane_groups)])
            gparams = np.asarray(
                [[tm, ta, int(_INT32.max) if thr is None else int(thr)]
                 for _f, tm, ta, thr in lane_params], np.int32)
            rows, used = kops.grouped_agg_auto(
                store, gid, len(lane_groups),
                np.asarray(member_ts, np.int32), floor,
                group_params=gparams, n_plans=n_plans, mode=mode)
            TRACER.annotate(mode=used)
        self.exec_stats["mode_" + used] += 1
        return rows

    def _grouped_execute(self, plans, snapshot) -> tuple:
        """Execute a sequence of aggregate plans sharing ONE snapshot in a
        single fused grouped dispatch (one visibility resolve, one pass
        over the gathered pages, one accumulator lane per plan × config ×
        group).  Returns (per-plan results list, writers over the
        plan-major flat key sequence)."""
        from .version_store import (AggPlan, GroupByPlan, MultiAggPlan,
                                    finalize_agg, plan_keys)

        lane_groups, lane_params, lane_of = self._lane_layout_for(plans)
        t0 = tick()
        with TRACER.span("resolve"):
            mask_fn, member_ts, floor = self._snapshot_mask(snapshot)
            all_keys = [k for p in plans for k in plan_keys(p)]
            writers = self._writers_for(self.page_index(all_keys), mask_fn)
        tock(_RESOLVE_H, t0)
        t0 = tick()
        rows = self._grouped_rows(lane_groups, lane_params, mask_fn,
                                  member_ts, floor, len(plans))
        tock(_DISPATCH_H, t0)
        t0 = tick()
        results = []
        for p_i, plan in enumerate(plans):
            if isinstance(plan, GroupByPlan):
                results.append(tuple(
                    tuple(finalize_agg(
                        rows[lane_of[(p_i, _op_config(op), g)]], op)
                        for op in plan.ops)
                    for g in range(len(plan.key_groups))))
            elif isinstance(plan, MultiAggPlan):
                results.append(tuple(finalize_agg(
                    rows[lane_of[(p_i, _op_config(op), 0)]], op)
                    for op in plan.ops))
            else:
                assert isinstance(plan, AggPlan), plan
                results.append(finalize_agg(
                    rows[lane_of[(p_i, _op_config(plan.op), 0)]], plan.op))
        tock(_FINALIZE_H, t0)
        return results, writers

    def execute_with_writers(self, plan, snapshot, *,
                             need_writers: bool = True) -> tuple:
        """The paged store's ONE plan-execution seam (what
        `PagedVersionStore.execute_with_writers` delegates to): `ScanPlan`
        takes the batched scan path; aggregate plans first try the
        materialized-view registry (`register_view` — O(delta) serve when
        the snapshot gate holds, whole batches all-or-nothing), then
        lower to the fused kernels — `AggPlan`/`MultiAggPlan` to
        `rss_scan_agg` (one pass per
        distinct field/threshold config, all of a compound's statistics
        from the same pass), `GroupByPlan` to the strategy-dispatched
        grouped reduction (flat accumulator lanes, chunked two-stage, or
        host — `kernels.rss_scan_agg.ops.select_grouped_mode`), and
        `BatchPlan` to ONE fused grouped dispatch for ALL its member
        plans (whole-batch plan fusion: one lane per plan × config ×
        group).  Writers always cover the plan's flat key sequence from
        the same host-side slot resolve, so read-set recording is
        identical for every plan kind; `need_writers=False` (execute-only
        callers: replica serves, benches) skips that O(keys) host resolve
        — on a view hit the serve then does NO per-key work at all."""
        from .version_store import (AggPlan, BatchPlan, GroupByPlan,
                                    MultiAggPlan, ScanPlan, finalize_agg,
                                    plan_keys)

        with TRACER.span("mirror_execute", plan=type(plan).__name__):
            if self.views and not isinstance(plan, ScanPlan):
                served = self._try_views(plan, snapshot, need_writers)
                if served is not None:
                    return served
            if isinstance(plan, ScanPlan):
                self.exec_stats["plans"] += 1
                t0 = tick()
                out = self.scan_with_writers(plan.keys, snapshot)
                tock(_RESOLVE_H, t0)       # a scan IS its visibility resolve
                return out
            if isinstance(plan, BatchPlan):
                self.exec_stats["plans"] += len(plan.plans)
                self.exec_stats["batches"] += 1
                self.exec_stats["batched_plans"] += len(plan.plans)
                results, writers = self._grouped_execute(plan.plans,
                                                         snapshot)
                return tuple(results), writers
            self.exec_stats["plans"] += 1
            if isinstance(plan, GroupByPlan):
                results, writers = self._grouped_execute([plan], snapshot)
                return results[0], writers
            keys = plan_keys(plan)
            t0 = tick()
            with TRACER.span("resolve"):
                pages = self.page_index(keys)
                mask_fn, member_ts, floor = self._snapshot_mask(snapshot)
                writers = self._writers_for(pages, mask_fn)
            tock(_RESOLVE_H, t0)
            ops = (plan.op,) if isinstance(plan, AggPlan) else plan.ops
            t0 = tick()
            with TRACER.span("kernel_dispatch", mode="scalar",
                             configs=len(set(_op_config(op) for op in ops))):
                raws = self._scalar_raws(pages, member_ts, floor, ops,
                                         keys=keys)
            tock(_DISPATCH_H, t0)
            t0 = tick()
            vals = tuple(finalize_agg(raws[_op_config(op)], op)
                         for op in ops)
            tock(_FINALIZE_H, t0)
            if isinstance(plan, AggPlan):
                return vals[0], writers
            assert isinstance(plan, MultiAggPlan), plan
            return vals, writers

    # -------------------------------------------------------- device export
    def torch_store(self) -> dict:
        """The live mirror as a `{'data','ts'}` int32 paged store on the
        mirror's device, pages padded to a multiple of 8 (padding pages
        hold only the initial ts=0 slot and decode to 0)."""
        p = max(self.n_pages, 1)
        pad = (-p) % 8
        have = min(p + pad, self.data.shape[0])
        return self._export(self.data[:have], self.ts[:have], p + pad - have,
                            TAG_INIT)
