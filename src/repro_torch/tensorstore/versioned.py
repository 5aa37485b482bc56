"""Versioned parameter store with RSS snapshot export — the paper's
multinode architecture mapped onto the training/serving boundary.

Roles (mirrors Sec 5.1):
  * the TRAINER (OLTP primary) publishes committed parameter versions and
    appends begin/commit/abort (+ rw-dependency) records to a WAL,
  * the SERVING pod (OLAP replica) replays the WAL through `RSSManager`
    (Algorithm 1) and reads *pinned* RSS snapshots — wait-free and
    abort-free: `pin_snapshot()` never blocks publishers, `publish()` never
    invalidates pinned readers,
  * slot GC honours reader pins (PostgreSQL hot_standby_feedback analogue):
    a slot is recyclable only when no pin references it and a newer RSS
    snapshot exists.

Snapshot pinning is a host-side buffer selection (zero device copies) —
"reading the prepared view": the expensive page-granular path (interleaved
in-flight versions) is `repro_torch.tensorstore.paged` + the
`version_gather` / `rss_gather` CUDA kernels.  This module runs no kernel
and holds `params` as given (any object: a dict of tensors, a state dict).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Optional

from ..core.replica import RSSManager, RssSnapshot
from ..core.wal import Wal
from ..obs import REGISTRY, StatsView


@dataclass
class _Slot:
    txn_id: int = 0            # writer transaction (0 = initial version)
    commit_lsn: int = 0
    params: Any = None
    pins: int = 0
    valid: bool = False


class VersionedParamStore:
    """K-slot ring of full parameter versions + RSS watermark export."""

    def __init__(self, *, slots: int = 2, wal: Optional[Wal] = None) -> None:
        assert slots >= 1
        self.wal = wal if wal is not None else Wal()
        self.rss = RSSManager()
        self.slots: list[_Slot] = [_Slot() for _ in range(slots)]
        self._txn_ids = itertools.count(1)
        self._pin_ids = itertools.count(1)
        self._pins: dict[int, int] = {}       # pin id -> slot index
        self.stats = StatsView(REGISTRY, "param_store",
                               ("publishes", "gc_blocked", "pins"),
                               labels={"store": REGISTRY.scope("pstore")})

    # --------------------------------------------------------------- writers
    def begin_txn(self) -> int:
        tid = next(self._txn_ids)
        self.wal.log_begin(tid)
        return tid

    def publish(self, params, *, txn_id: Optional[int] = None,
                out_rw: tuple[int, ...] = ()) -> int:
        """Commit a new parameter version.  Wait-free w.r.t. readers: if every
        slot is pinned or is the newest visible version, publishing *extends*
        the ring rather than blocking (bounded by reader count)."""
        tid = self.begin_txn() if txn_id is None else txn_id
        slot = self._free_slot()
        if slot is None:
            self.stats["gc_blocked"] += 1
            slot = _Slot()
            self.slots.append(slot)           # grow rather than wait/abort
        rec = self.wal.log_commit(tid)
        if out_rw:
            self.wal.log_deps(tid, list(out_rw))
        slot.txn_id, slot.commit_lsn = tid, rec.lsn
        slot.params, slot.valid, slot.pins = params, True, 0
        self.stats["publishes"] += 1
        return tid

    def _newest_visible(self, snap: RssSnapshot) -> Optional[_Slot]:
        best = None
        commit_seq = self.rss.commit_seq
        for s in self.slots:
            # compressed snapshots fold Clear members into floor_seq, so
            # membership needs the writer's commit seq (resolved through
            # this store's own RSS manager — never GC'd here)
            if s.valid and (s.txn_id == 0
                            or snap.visible(s.txn_id,
                                            commit_seq.get(s.txn_id))):
                if best is None or s.commit_lsn > best.commit_lsn:
                    best = s
        return best

    def _newest(self) -> Optional[_Slot]:
        best = None
        for s in self.slots:
            if s.valid and (best is None or s.commit_lsn > best.commit_lsn):
                best = s
        return best

    def _free_slot(self) -> Optional[_Slot]:
        newest = self._newest()
        for s in self.slots:
            if not s.valid:
                return s
        for s in self.slots:
            if s.pins == 0 and s is not newest:
                return s                      # recycle oldest unpinned
        return None

    # --------------------------------------------------------------- readers
    def refresh(self) -> RssSnapshot:
        """Replica-side: replay WAL, run Algorithm 1."""
        self.rss.catch_up(self.wal)
        return self.rss.construct()

    def pin_snapshot(self) -> tuple[int, Any]:
        """Wait-free protected read: pin the newest version inside the
        current RSS.  Returns (pin_id, params)."""
        snap = self.rss.snapshot
        slot = self._newest_visible(snap)
        if slot is None:
            raise RuntimeError("no committed version inside RSS yet; "
                               "call refresh() after the first publish")
        slot.pins += 1
        pid = next(self._pin_ids)
        self._pins[pid] = self.slots.index(slot)
        self.stats["pins"] += 1
        return pid, slot.params

    def release(self, pin_id: int) -> None:
        idx = self._pins.pop(pin_id, None)
        if idx is not None:
            self.slots[idx].pins = max(self.slots[idx].pins - 1, 0)

    # ------------------------------------------------------------------ info
    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def visible_lsn(self) -> int:
        slot = self._newest_visible(self.rss.snapshot)
        return 0 if slot is None else slot.commit_lsn

    def freshness_lag(self) -> int:
        """LSNs between the newest committed version and the newest
        RSS-visible version — the staleness RSS trades for wait-freedom."""
        newest = self._newest()
        return 0 if newest is None else newest.commit_lsn - self.visible_lsn()
