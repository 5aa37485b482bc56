"""Replica-side RSS construction from a shipped WAL (paper Sec 5.1).

`RSSManager` replays WAL records (in LSN order, possibly in batches — the
log-shipping is asynchronous) and maintains:

  * Active / Done / Clear transaction states (Definition 4.6) keyed by the
    replayed prefix — *incrementally*: an ordered begin-LSN heap of active
    transactions replaces the full min-scan, so one replication round costs
    O(records applied), not O(history),
  * the concurrent-rw dependency adjacency shipped via "deps" records,
  * the current RSS via `core.rss.IncrementalRss` (Algorithm 1 applied only
    to the delta of newly-Clear transactions and newly-shipped edges) and
    its *watermark*: RSS only ever grows forward, so exporting a snapshot is
    O(active-window) for readers — this is the abort-/wait-free property.

Exported snapshots are COMPRESSED: `floor_seq` covers every committed
transaction with commit seq <= floor (Clear members fold into the floor as
it advances), and only the members ABOVE the floor are carried explicitly.
Snapshot size and construction cost are therefore bounded by the concurrent
window, independent of replayed-history length.

`gc(keep_lsn=...)` prunes per-transaction bookkeeping (begun/ended/rw_out/
commit_seq) below min(active horizon, oldest pinned PRoT snapshot) — the
replica-state analogue of PostgreSQL's SSI SLRU summarization (Ports &
Grittner): state is bounded by the active/pinned window under sustained
load.

`PRoTManager` pins exported snapshots until readers release them, the
analogue of the paper's snapshot-preserving transactions +
hot_standby_feedback (it prevents version GC below the oldest pinned
snapshot).
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Optional

from ..obs import REGISTRY, StatsView
from .rss import IncrementalRss, advance, construct_rss_ssi
from .wal import Wal, WalRecord, effective_commit_seq

_INF = 1 << 62


@dataclass(frozen=True)
class RssSnapshot:
    """An immutable exported snapshot: the RSS transaction set at some LSN.

    Compressed membership: a transaction is a member iff its commit seq is
    <= `floor_seq` (the *prefix-safe* horizon: every transaction committed
    at seq <= floor is a member) or its id is in `txns` (the sparse members
    above the floor — bounded by the concurrent window).  Snapshots built
    directly with an explicit `txns` set and floor_seq == 0 (tests, oracle
    harnesses) degenerate to plain set membership.

    `member_seqs` carries the sorted commit seqs of the above-floor members
    for device-resident scans (`rss_gather`); None means "not stamped"
    (explicit-set snapshots) and consumers fall back to mapping `txns`
    through their own commit-seq bookkeeping.

    Pruning versions below floor_seq can never remove a version a member
    read resolves to (any version in (s, floor] overwriting a
    member-visible version at seq s would itself be a member and newer) —
    so floor_seq is the safe GC floor for a pinned reader."""
    lsn: int
    txns: frozenset[int]
    floor_seq: int = 0
    member_seqs: Optional[tuple[int, ...]] = None

    def visible(self, writer_txn: int, commit_seq: Optional[int] = None) \
            -> bool:
        """Is a version written by `writer_txn` (committed at `commit_seq`,
        when known) inside this snapshot?  T0 (writer 0) is always
        visible."""
        if writer_txn == 0 or writer_txn in self.txns:
            return True
        return commit_seq is not None and 0 < commit_seq <= self.floor_seq


class RSSManager:
    def __init__(self) -> None:
        self.applied_lsn = 0
        self.begun: dict[int, int] = {}      # txn -> begin lsn
        self.ended: dict[int, int] = {}      # txn -> end lsn
        self.committed: set[int] = set()
        self.aborted: set[int] = set()
        # commit bookkeeping, in LSN (== commit-seq) order: the shipped
        # commit-seq of every committed txn, for the commit-seq -> member-ts
        # mapping a device-resident mirror needs.
        self.commit_seq: dict[int, int] = {}
        self.commit_order: deque[int] = deque()  # txn ids, commit-seq asc
        self.max_seq = 0                     # newest seq seen (fallback base)
        # incremental Algorithm 1 state (shares the shipped rw adjacency)
        self._inc = IncrementalRss()
        # --- incremental Done/Clear machinery -------------------------
        self._active_heap: list[tuple[int, int]] = []   # (begin_lsn, txn)
        self._pending_clear: list[tuple[int, int]] = []  # (end_lsn, txn)
        self._resolved: deque[tuple[int, int]] = deque()  # (end_lsn, txn)
        # --- compressed-snapshot export state -------------------------
        self.floor_seq = 0
        self._floor_pending: deque[tuple[int, int]] = deque()  # (seq, txn)
        self._above_floor: set[int] = set()  # RSS members with seq > floor
        self._gc_lsn = 0                     # state pruned below this lsn
        self._snapshot: RssSnapshot = RssSnapshot(0, frozenset(),
                                                  member_seqs=())
        self.members_total = 0               # monotone member count
        self.stats = StatsView(REGISTRY, "rss",
                               ("gc_txns", "edges_pruned_pull"),
                               labels={"rss": REGISTRY.scope("rss")})

    @property
    def rw_out(self) -> dict[int, set[int]]:
        """Shipped outgoing concurrent rw edges: reader -> {writers}."""
        return self._inc.rw_out

    # ------------------------------------------------------------- replay
    def apply(self, rec: WalRecord) -> None:
        if rec.lsn <= self.applied_lsn:
            return  # idempotent replay (restart safety)
        self.applied_lsn = rec.lsn
        if rec.type == "begin":
            if rec.txn not in self.begun:
                self.begun[rec.txn] = rec.lsn
                heapq.heappush(self._active_heap, (rec.lsn, rec.txn))
        elif rec.type == "commit":
            self.begun.setdefault(rec.txn, rec.lsn)
            self.ended[rec.txn] = rec.lsn
            self.committed.add(rec.txn)
            # shared strictly-monotone clock (see effective_commit_seq):
            # legacy records mint max(seen) + 1 — a dense local clock could
            # collide with or regress below shipped seqs when record kinds
            # mix, corrupting floor_seq.
            seq = effective_commit_seq(self.max_seq, rec.seq)
            self.max_seq = seq
            self.commit_seq[rec.txn] = seq
            self.commit_order.append(rec.txn)
            self._floor_pending.append((seq, rec.txn))
            self._resolved.append((rec.lsn, rec.txn))
            self._inc.add_committed(rec.txn)
            heapq.heappush(self._pending_clear, (rec.lsn, rec.txn))
        elif rec.type == "abort":
            self.begun.setdefault(rec.txn, rec.lsn)
            self.ended[rec.txn] = rec.lsn
            self.aborted.add(rec.txn)
            self._resolved.append((rec.lsn, rec.txn))
        elif rec.type == "deps":
            if rec.txn not in self.begun and self._gc_lsn:
                # the READER itself was already GC'd (its commit landed in a
                # previous ship batch and state GC ran before this deps
                # record arrived): it is a floor-covered member, and a deps
                # edge (u, w) only ever affects u's membership — drop the
                # record instead of stashing edges that would never drain.
                pass
            else:
                for w in rec.out_rw:
                    if w not in self.begun and self._gc_lsn:
                        # writer bookkeeping already GC'd: its End preceded
                        # the GC watermark, and deps ship in LSN order right
                        # after the reader's commit, so the writer can only
                        # have been pruned as a Clear member — pull the
                        # reader directly.
                        self._inc.pull(rec.txn)
                        self.stats["edges_pruned_pull"] += 1
                    else:
                        self._inc.add_edge(rec.txn, w)
        self._drain_clear()

    def _drain_clear(self) -> None:
        """Advance the Clear horizon: pop ended txns off the active heap,
        then promote every committed txn whose End precedes the horizon."""
        heap = self._active_heap
        while heap and heap[0][1] in self.ended:
            heapq.heappop(heap)
        horizon = heap[0][0] if heap else _INF
        pend = self._pending_clear
        while pend and pend[0][0] < horizon:
            _, txn = heapq.heappop(pend)
            self._inc.add_clear(txn)

    def catch_up(self, wal: Wal) -> int:
        """Pull and apply all records past applied_lsn; returns #applied."""
        n = 0
        for rec in wal.tail(self.applied_lsn):
            self.apply(rec)
            n += 1
        return n

    # -------------------------------------------------------------- states
    def active(self) -> set[int]:
        return {t for t in self.begun if t not in self.ended}

    def done(self) -> set[int]:
        return set(self.ended)

    def clear(self) -> set[int]:
        """Clear(p) among retained (non-GC'd) transactions."""
        return set(self._inc.clear)

    def obscure(self) -> set[int]:
        return self.committed - self._inc.clear - self.active()

    # ----------------------------------------------------------- Algorithm 1
    def _fold_floor(self) -> None:
        """Fold the contiguous commit-seq prefix of members into floor_seq,
        leaving only the (bounded) above-floor remainder explicit."""
        new = self._inc.drain_new()
        self.members_total += len(new)
        for t in new:
            self._above_floor.add(t)
        pend = self._floor_pending
        rss = self._inc.rss
        while pend and pend[0][1] in rss:
            seq, txn = pend.popleft()
            self.floor_seq = seq
            self._above_floor.discard(txn)

    def construct(self) -> RssSnapshot:
        """Export the incrementally-maintained RSS: fold newly-added members
        into the floor and snapshot the (bounded) above-floor remainder.
        O(delta) amortized per round.  RSS is monotone across calls (older
        members stay valid for already-pinned readers; the exported set is
        the newest)."""
        self._fold_floor()
        seqs = sorted(self.commit_seq[t] for t in self._above_floor)
        self._snapshot = RssSnapshot(self.applied_lsn,
                                     frozenset(self._above_floor),
                                     self.floor_seq, tuple(seqs))
        return self._snapshot

    def construct_batch(self) -> RssSnapshot:
        """The pre-incremental O(history) construction path, kept as the
        cost baseline for `benchmarks.bench_freshness` and as an oracle.
        Requires an un-GC'd manager (full begin/end bookkeeping)."""
        act = self.active()
        horizon = min((self.begun[t] for t in act), default=_INF)
        clear = {t for t in self.committed if self.ended[t] < horizon}
        edges = [(u, w) for u, outs in self._inc.rw_out.items() for w in outs]
        rss = construct_rss_ssi(clear, self.committed, edges)
        floor = 0
        for t in self.commit_order:          # commit-seq ascending
            if t not in rss:
                break
            floor = self.commit_seq[t]
        above = {t for t in rss if self.commit_seq[t] > floor}
        seqs = sorted(self.commit_seq[t] for t in above)
        return RssSnapshot(self.applied_lsn, frozenset(above), floor,
                           tuple(seqs))

    @property
    def snapshot(self) -> RssSnapshot:
        return self._snapshot

    def is_member(self, txn: int, snap: Optional[RssSnapshot] = None) -> bool:
        """Membership of a COMMITTED transaction in `snap` (default: the
        current snapshot), resolving txn -> commit seq through this
        manager's bookkeeping.  GC'd transactions resolve via the floor:
        `gc()` only ever prunes commits below every live snapshot's
        floor_seq, so a pruned id is a member of any snapshot this manager
        still serves."""
        seq = self.commit_seq.get(txn)
        if seq is None and self._gc_lsn and txn not in self.begun:
            return True
        return (snap or self._snapshot).visible(txn, seq)

    def member_seqs(self, snap: RssSnapshot) -> list[int]:
        """Sorted commit seqs of the snapshot's ABOVE-FLOOR members — with
        `snap.floor_seq`, the member-ts state a device-resident paged mirror
        feeds to `rss_gather`.  Explicit-set snapshots (member_seqs not
        stamped) map their full `txns` through the local clock."""
        if snap.member_seqs is not None:
            return list(snap.member_seqs)
        return sorted(self.commit_seq[t] for t in snap.txns
                      if t in self.commit_seq)

    # --------------------------------------------------------------- state GC
    def gc(self, *, keep_lsn: Optional[int] = None,
           keep_seq: Optional[int] = None) -> int:
        """Prune per-transaction bookkeeping (begun/ended/rw edges/commit
        seq) below the state watermark.  A transaction is prunable when

          * its End precedes the active-transaction horizon AND `keep_lsn`
            (the oldest pinned PRoT snapshot's LSN) — so it is Clear (or
            aborted) and can never gain a non-Clear role in a future
            Algorithm 1 step, and
          * if committed, its commit seq is at-or-below every live
            snapshot's floor (`keep_seq`, bounded by the current exported
            floor) — so membership queries stay exact: pruned commits are
            floor-covered members of every snapshot this manager serves.

        Returns #transactions pruned.  State left behind is bounded by the
        active/pinned window, independent of replayed-history length."""
        self._fold_floor()
        heap = self._active_heap
        while heap and heap[0][1] in self.ended:
            heapq.heappop(heap)
        watermark = heap[0][0] if heap else self.applied_lsn + 1
        if keep_lsn is not None:
            watermark = min(watermark, keep_lsn + 1)
        seq_cap = self._snapshot.floor_seq
        if keep_seq is not None:
            seq_cap = min(seq_cap, keep_seq)
        n = 0
        resolved = self._resolved
        while resolved and resolved[0][0] < watermark:
            end_lsn, txn = resolved.popleft()
            if txn in self.committed and self.commit_seq[txn] > seq_cap:
                resolved.appendleft((end_lsn, txn))
                break
            self.begun.pop(txn, None)
            self.ended.pop(txn, None)
            self.committed.discard(txn)
            self.aborted.discard(txn)
            self.commit_seq.pop(txn, None)
            self._above_floor.discard(txn)
            self._inc.forget(txn)
            n += 1
        order = self.commit_order
        while order and order[0] not in self.commit_seq:
            order.popleft()
        if n:
            self._gc_lsn = max(self._gc_lsn, watermark - 1)
            self.stats["gc_txns"] += n
        return n

    def tracked_txns(self) -> int:
        """Per-transaction bookkeeping size (the bounded-state metric)."""
        return len(self.begun)


class PRoTManager:
    """Export/pin/release snapshots for protected read-only transactions.

    GC boundary: versions written by transactions committed at-or-below every
    pinned snapshot's LSN horizon must be preserved (hot_standby_feedback
    analogue).  `gc_floor()` returns the lowest pinned LSN, or the current
    snapshot's LSN when nothing is pinned.

    Pins are SHARED: every reader acquiring at the same horizon (the same
    constructed-snapshot LSN) refcounts ONE pin-table entry holding one
    `RssSnapshot`, instead of one entry per reader — at high PRoT reader
    counts the pin table is bounded by the number of distinct live horizons
    (<= refresh rounds spanned by the oldest reader), not by reader count.
    The floor semantics are unchanged: an entry holds the GC floor until its
    LAST sharer releases, and because readers only ever pin the newest
    snapshot (whose floor is monotone in LSN), `gc_floor_seq()` can never
    regress while any sharer is live.
    """

    def __init__(self, manager: RSSManager) -> None:
        self.manager = manager
        self._readers: dict[int, int] = {}    # reader id -> pinned horizon lsn
        # horizon lsn -> [snapshot, sharer refcount]: ONE entry per horizon
        self._pins: dict[int, list] = {}
        self._next_reader = 1

    def acquire(self) -> tuple[int, RssSnapshot]:
        """Wait-free: returns the most recent constructed snapshot, sharing
        the pin-table entry with every other reader at the same horizon."""
        snap = self.manager.snapshot
        rid = self._next_reader
        self._next_reader += 1
        ent = self._pins.get(snap.lsn)
        if ent is None:
            self._pins[snap.lsn] = [snap, 1]
        else:
            ent[1] += 1
            snap = ent[0]                     # all sharers see one snapshot
        self._readers[rid] = snap.lsn
        return rid, snap

    def release(self, reader_id: int) -> None:
        lsn = self._readers.pop(reader_id, None)
        if lsn is None:
            return
        ent = self._pins[lsn]
        ent[1] -= 1
        if ent[1] == 0:                       # last sharer drops the pin
            del self._pins[lsn]

    def gc_floor(self) -> int:
        if not self._pins:
            return self.manager.snapshot.lsn
        return min(self._pins)

    def gc_floor_seq(self) -> int:
        """Version-GC floor in commit-seq units: the minimum prefix-safe
        horizon over pinned snapshots.  `Store.prune(floor)` at this floor
        preserves every version any pinned RSS reader can still resolve to
        (prune only drops versions below the floor, and below the floor the
        member-visible version IS the newest at-or-below it).  K-slot paged
        stores (`publish_page(..., gc_floor=floor)`) give the weaker bounded
        guarantee: the floor-visible slot is never recycled, but member
        versions above the floor survive only while publishers outrun
        readers by fewer than K-1 versions per page."""
        if not self._pins:
            return self.manager.snapshot.floor_seq
        return min(s.floor_seq for s, _ in self._pins.values())

    @property
    def pinned(self) -> int:
        """Live pin-table entries (one per distinct pinned horizon)."""
        return len(self._pins)

    @property
    def readers(self) -> int:
        """Live sharers across all pinned horizons (>= pinned)."""
        return len(self._readers)


def replicate(wal: Wal, manager: RSSManager, *, batch: int = 0) -> RssSnapshot:
    """One asynchronous replication round: catch up on the WAL (optionally in
    bounded batches, modelling streaming-lag) and advance the RSS."""
    if batch <= 0:
        manager.catch_up(wal)
    else:
        applied = 0
        for rec in wal.tail(manager.applied_lsn):
            manager.apply(rec)
            applied += 1
            if applied >= batch:
                break
    return manager.construct()
