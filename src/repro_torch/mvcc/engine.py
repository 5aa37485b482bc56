"""Transactional engine: SI / SSI execution with RSS and SafeSnapshots modes.

This is the executable counterpart of `repro_torch.core`: a single-node MVCC engine
whose accepted histories satisfy the specification-level checks (asserted by
property tests).  It implements:

  * SI        — snapshot reads (SI-V) + first-committer-wins (SI-W)
  * SSI       — SI + SIRead-lock rw-antidependency tracking + pluggable
                commit certification (`repro_torch.mvcc.certify`): conservative
                PostgreSQL-style pivot aborts by default, commit-order-
                precise SSI or SSN by configuration
  * SafeSnapshots — READ ONLY DEFERRABLE readers: reader-WAITS until no
                read/write transaction is active, then reads snapshot without
                SSI validation (Ports & Grittner)
  * RSS       — protected read-only transactions read the newest version
                whose writer is inside the constructed RSS: wait-free,
                abort-free, no SIRead locks (the paper's contribution)

The engine emits the WAL records of Sec 5.1 (begin/commit/abort + outgoing
concurrent-rw "deps" logical messages, and the committed writeset for
log-shipping replication).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Iterable, Optional, Sequence

from ..core.history import History, b as op_b, r as op_r, w as op_w, \
    c as op_c, a as op_a
from ..core.replica import RssSnapshot
from ..core.wal import Wal, WalRecord
from ..obs import REGISTRY, TRACER, LabeledCounterMap, StatsView, tick, tock
from ..tensorstore.version_store import (ChainVersionStore, Plan,
                                         VersionStore, apply_plan, plan_keys)
from .store import Store, Version


class Status(Enum):
    ACTIVE = 0
    COMMITTED = 1
    ABORTED = 2


class AbortReason(Enum):
    WW_CONFLICT = "first-committer-wins"
    PIVOT = "dangerous-structure pivot"
    INCOMING_PIVOT = "dangerous-structure (in-edge to committed pivot)"
    FATAL_PIVOT = "fatal dangerous structure (out-neighbour committed first)"
    FATAL_NEIGHBOUR = "fatal dangerous structure (commit into fatal pivot)"
    EXCLUSION_WINDOW = "SSN exclusion window (pi <= eta)"
    USER = "user abort"


class SerializationFailure(Exception):
    def __init__(self, reason: AbortReason):
        super().__init__(reason.value)
        self.reason = reason


@dataclass
class Txn:
    tid: int
    begin_seq: int              # logical clock at begin (snapshot horizon)
    read_only: bool = False
    rss: Optional[RssSnapshot] = None        # protected reader snapshot
    skip_siread: bool = False   # safe-snapshot / RSS readers skip SSI locks
    status: Status = Status.ACTIVE
    end_seq: int = 0
    reads: dict[str, int] = field(default_factory=dict)   # key -> writer seen
    writes: dict[str, Any] = field(default_factory=dict)  # buffered writeset
    in_rw: set[int] = field(default_factory=set)          # readers -> self
    out_rw: set[int] = field(default_factory=set)         # self -> writers
    abort_reason: Optional[AbortReason] = None

    @property
    def is_pivot(self) -> bool:
        return bool(self.in_rw) and bool(self.out_rw)


class Engine:
    """mode: 'si' or 'ssi'.  SafeSnapshots/RSS are per-transaction options.

    `certifier` selects the commit-certification policy for SSI-tracked
    transactions (see `repro_torch.mvcc.certify`): a registry name
    ('conservative' / 'commit-order' / 'ssn'), a `Certifier` instance, or
    a zero-arg factory.  Default is the conservative structural pivot
    abort — the seed behaviour.  The engine owns the mechanism (version
    install, WAL, rw-edge bookkeeping, GC); the certifier owns every
    serializability abort decision."""

    def __init__(self, mode: str = "ssi", *, record: bool = False,
                 certifier=None) -> None:
        assert mode in ("si", "ssi")
        self.mode = mode
        from .certify import make_certifier   # lazy: certify imports us
        self.certifier = make_certifier(certifier)
        self.certifier.attach(self)
        self.store = Store()
        # unified read surface over the chain store; HTAP facades may swap in
        # a paged/mirrored VersionStore for the batched OLAP scan path
        self.version_store: VersionStore = ChainVersionStore(self.store)
        self.wal = Wal()
        # optional Adya-history recorder for specification-level checks
        self.history: Optional[History] = History() if record else None
        self.clock = itertools.count(1)
        self.seq = 0                       # last assigned sequence number
        self.txns: dict[int, Txn] = {}     # all known txns (GC'd)
        self.active: dict[int, Txn] = {}
        self._next_tid = itertools.count(1)
        # SIRead "locks": key -> list of reader txn ids (kept past commit
        # while concurrency with future writers is possible)
        self.siread: dict[str, set[int]] = {}
        # registry-backed stats (series engine_* / engine_aborts_by_reason):
        # dict-shaped view per instance — the `engine` scope label keeps two
        # engines (e.g. per-test, or oracle vs primary) from aliasing, the
        # `certifier` label gives per-policy breakdowns for free
        lbl = {"engine": REGISTRY.scope("engine"),
               "certifier": self.certifier.name}
        self.stats = StatsView(
            REGISTRY, "engine",
            ("commits", "aborts", "writer_aborts", "reader_aborts",
             "ww_aborts", "gc_versions"), labels=lbl,
            sub={"by_reason": LabeledCounterMap(
                REGISTRY, "engine_aborts_by_reason", "reason", labels=lbl)})
        self._commit_hist = REGISTRY.histogram("oltp_commit_seconds", **lbl)
        self._certify_hist = REGISTRY.histogram("oltp_certify_seconds", **lbl)
        self._wal_hist = REGISTRY.histogram("oltp_wal_seconds", **lbl)

    # -------------------------------------------------------------- lifecycle
    def _tick(self) -> int:
        self.seq = next(self.clock)
        return self.seq

    def begin(self, *, read_only: bool = False,
              rss: Optional[RssSnapshot] = None,
              skip_siread: bool = False,
              snapshot_seq: Optional[int] = None) -> Txn:
        """snapshot_seq: pin visibility to an older snapshot (deferrable
        readers resuming a previously-taken safe snapshot)."""
        t = Txn(tid=next(self._next_tid),
                begin_seq=self.seq if snapshot_seq is None else snapshot_seq,
                read_only=read_only, rss=rss,
                skip_siread=skip_siread or rss is not None)
        self._tick()
        self.txns[t.tid] = t
        self.active[t.tid] = t
        self.wal.log_begin(t.tid)
        if self.history is not None:
            self.history.append(op_b(t.tid))
        if self._tracked(t):
            self.certifier.on_begin(t)
        return t

    def _tracked(self, t: Txn) -> bool:
        """Does t participate in SSI conflict tracking / certification?
        (Exactly the seed gate: RSS / safe-snapshot readers and plain-SI
        transactions are outside certification.)"""
        return self.mode == "ssi" and not t.skip_siread

    def safe_snapshot_ready(self) -> bool:
        """Deferrable-reader condition: no active read/write transaction."""
        return all(t.read_only for t in self.active.values())

    def begin_deferred(self) -> Optional[Txn]:
        """SafeSnapshots mode: returns a transaction only when the snapshot is
        safe; callers must retry (reader-wait) otherwise."""
        if not self.safe_snapshot_ready():
            return None
        return self.begin(read_only=True, skip_siread=True)

    def _check_active(self, t: Txn) -> None:
        """PostgreSQL-style: touching a transaction the SSI detector has
        already aborted surfaces the serialization failure to the client."""
        if t.status == Status.ABORTED:
            raise SerializationFailure(t.abort_reason or AbortReason.PIVOT)
        assert t.status == Status.ACTIVE, "transaction already committed"

    # ------------------------------------------------------------------ reads
    def read(self, t: Txn, key: str) -> Any:
        self._check_active(t)
        if key in t.writes:                       # read-your-own-writes
            return t.writes[key]
        ch = self.store.chain(key)
        if t.rss is not None:                     # protected (RSS) read
            v = ch.visible_in(t.rss.visible)
        else:                                     # SI-V
            v = ch.visible_at(t.begin_seq)
        t.reads[key] = v.writer
        if self.history is not None:
            self.history.append(op_r(t.tid, key, v.writer))
        if self._tracked(t):
            self.siread.setdefault(key, set()).add(t.tid)
            self.certifier.on_read(t, v.writer, v.commit_seq)
            # reading an old version while *committed* newer versions exist
            # creates an out-going rw edge to EVERY skipped writer still
            # concurrent with us (PostgreSQL's CheckForSerializableConflictOut
            # fires per skipped tuple version during the scan).
            for ver in ch.versions:
                if ver.commit_seq > t.begin_seq:
                    writer = self.txns.get(ver.writer)
                    self.certifier.on_read_skipped_version(t, writer,
                                                           ver.commit_seq)
                    self._add_rw_edge(t, writer)
            # ... and so is reading a key an in-progress transaction has an
            # uncommitted write for (the invisible-tuple case).
            for u in list(self.active.values()):
                if u.tid != t.tid and key in u.writes:
                    self._add_rw_edge(t, u)
        return v.value

    # ------------------------------------------------------------- OLAP plans
    def execute(self, t: Txn, plan: Plan) -> Any:
        """The engine's ONE OLAP plan-execution seam: resolve visibility
        for the plan's whole key sequence in ONE `VersionStore` call and
        apply the plan (`ScanPlan` materializes values; aggregate plans
        reduce — the paged store fuses resolve + reduction in a single
        device pass per kernel config).

        Only transactions outside SSI conflict tracking (RSS protected
        readers, safe-snapshot readers, plain-SI transactions) take the
        batched path — their reads are pure visibility resolution with no
        SIRead side effects.  SSI-tracked transactions fall back to per-key
        `read` so rw-antidependency detection observes every key, and a
        transaction with buffered writes on plan keys falls back to the
        batched scan + host `apply_plan` (read-your-own-writes never hits
        the store).

        Every path records the read set (`t.reads` and the Adya history
        when recording): resolved writers come out of the same visibility
        walk, so the serializability oracle sees an aggregate exactly as
        it sees the equivalent scan."""
        self._check_active(t)
        keys = plan_keys(plan)
        if self.mode == "ssi" and not t.skip_siread:
            return apply_plan([self.read(t, k) for k in keys], plan)
        snapshot = t.rss if t.rss is not None else t.begin_seq
        if t.writes and any(k in t.writes for k in keys):
            vals, writers = self.version_store.scan_with_writers(keys,
                                                                 snapshot)
            self.record_scan(t, keys, writers)
            vals = [t.writes.get(k, v) for k, v in zip(keys, vals)]
            return apply_plan(vals, plan)
        result, writers = self.version_store.execute_with_writers(plan,
                                                                  snapshot)
        self.record_scan(t, keys, writers)
        return result

    def record_scan(self, t: Txn, keys: Sequence[str],
                    writers: Sequence[int]) -> None:
        """Record a batched scan's resolved (key -> writer) read set, like
        per-key `read` does — skipping keys the transaction overwrote
        (read-your-own-writes never hits the store)."""
        hist = self.history
        for key, writer in zip(keys, writers):
            if key in t.writes:
                continue
            t.reads[key] = writer
            if hist is not None:
                hist.append(op_r(t.tid, key, writer))

    # ----------------------------------------------------------------- writes
    def write(self, t: Txn, key: str, value: Any) -> None:
        self._check_active(t)
        assert not t.read_only
        assert t.rss is None, "protected read-only transactions cannot write"
        if self.history is not None and key not in t.writes:
            self.history.append(op_w(t.tid, key))
        t.writes[key] = value
        if self.mode == "ssi":
            # writing over a version some concurrent/overlapping reader read:
            # reader -> self rw edge (SIRead check).
            for rid in self.siread.get(key, ()):
                reader = self.txns.get(rid)
                if reader is not None and rid != t.tid:
                    self._add_rw_edge(reader, t)

    # ----------------------------------------------------------------- commit
    def commit(self, t: Txn) -> None:
        self._check_active(t)
        t0 = tick()
        with TRACER.span("oltp_commit", certifier=self.certifier.name,
                         n_reads=len(t.reads), n_writes=len(t.writes)):
            tc = tick()
            try:
                with TRACER.span("certify"):
                    if t.writes:
                        # SI-W first-committer-wins: a version committed
                        # after our snapshot on any written key aborts us.
                        for key in t.writes:
                            if self.store.chain(key).newest().commit_seq \
                                    > t.begin_seq:
                                raise SerializationFailure(
                                    AbortReason.WW_CONFLICT)
                    if self._tracked(t):
                        self.certifier.on_precommit(t)
            except SerializationFailure as e:
                self._abort(t, e.reason)
                raise
            tock(self._certify_hist, tc)
            cseq = self._tick()
            for key, value in t.writes.items():
                self.store.chain(key).install(cseq, t.tid, value)
            t.status, t.end_seq = Status.COMMITTED, cseq
            self.active.pop(t.tid, None)
            tw = tick()
            with TRACER.span("wal_emit"):
                self.wal.log_commit(t.tid, sorted(t.writes.items()),
                                    seq=cseq)
                if t.out_rw:
                    # the paper's logical message: outgoing concurrent rw
                    # edges of a just-committed reader, for replica-side
                    # RSS construction.
                    self.wal.log_deps(t.tid, sorted(t.out_rw))
            tock(self._wal_hist, tw)
            if self.history is not None:
                self.history.append(op_c(t.tid))
            self.stats["commits"] += 1
            if self._tracked(t):
                self.certifier.on_end(t, committed=True)
            self._gc()
            # observed on success only: histogram count == engine commits
            tock(self._commit_hist, t0)

    def abort(self, t: Txn) -> None:
        self._abort(t, AbortReason.USER)

    def _abort(self, t: Txn, reason: AbortReason) -> None:
        if t.status != Status.ACTIVE:
            return
        t.status, t.end_seq = Status.ABORTED, self._tick()
        t.abort_reason = reason
        t.writes.clear()
        self.active.pop(t.tid, None)
        self.wal.log_abort(t.tid)
        if self.history is not None:
            self.history.append(op_a(t.tid))
        self.stats["aborts"] += 1
        if reason == AbortReason.WW_CONFLICT:
            self.stats["ww_aborts"] += 1
        elif reason is not AbortReason.USER:
            if t.read_only:
                self.stats["reader_aborts"] += 1
            else:
                self.stats["writer_aborts"] += 1
        self.stats["by_reason"][reason.value] = \
            self.stats["by_reason"].get(reason.value, 0) + 1
        # drop edges referencing the aborted txn — via its OWN edge sets
        # (edges are maintained symmetrically, so t's neighbours are exactly
        # the txns holding a reference to it; scanning all of `self.txns`
        # made every abort O(tracked transactions))
        for nid in t.in_rw | t.out_rw:
            n = self.txns.get(nid)
            if n is not None:
                n.in_rw.discard(t.tid)
                n.out_rw.discard(t.tid)
        t.in_rw.clear()
        t.out_rw.clear()
        if self._tracked(t):
            self.certifier.on_end(t, committed=False)

    # --------------------------------------------------------------- SSI core
    def _concurrent(self, a: Txn, b: Txn) -> bool:
        if a.tid == b.tid:
            return False
        ea = a.end_seq if a.status != Status.ACTIVE else (1 << 62)
        eb = b.end_seq if b.status != Status.ACTIVE else (1 << 62)
        return a.begin_seq < eb and b.begin_seq < ea

    def _add_rw_edge(self, reader: Optional[Txn], writer: Optional[Txn]) -> None:
        if reader is None or writer is None or reader.tid == writer.tid:
            return
        if reader.status == Status.ABORTED or writer.status == Status.ABORTED:
            return
        if not self._concurrent(reader, writer):
            return  # only *vulnerable* (concurrent) rw edges matter
        reader.out_rw.add(writer.tid)
        writer.in_rw.add(reader.tid)
        self.certifier.on_rw_edge(reader, writer)

    # --------------------------------------------------------------------- GC
    def _gc(self) -> None:
        """Forget ended txns (and their SIRead entries) that can no longer be
        concurrent with any future transaction.

        rw edges between two txns that are BOTH ended below the concurrency
        horizon are released first (the analogue of PostgreSQL's SSI SLRU
        summarization): such an edge can never participate in a future
        dangerous-structure decision — any new edge involves a transaction
        whose end is at-or-above the horizon, so every pivot check that
        could still fire only needs edges with at least one endpoint there.
        Without this, committed transactions joined by an rw edge pinned
        each other in `txns` forever (edges were only dropped on abort)."""
        horizon = min((t.begin_seq for t in self.active.values()),
                      default=self.seq)

        def _released(tid: int) -> bool:
            u = self.txns.get(tid)
            return u is None or (u.status != Status.ACTIVE
                                 and u.end_seq < horizon)

        dead = []
        for tid, t in self.txns.items():
            if t.status == Status.ACTIVE or t.end_seq >= horizon:
                continue
            if t.in_rw:
                t.in_rw = {x for x in t.in_rw if not _released(x)}
            if t.out_rw:
                t.out_rw = {x for x in t.out_rw if not _released(x)}
            if not t.in_rw and not t.out_rw:
                dead.append(tid)
        if not dead:
            return
        deadset = set(dead)
        for tid in dead:
            self.txns.pop(tid, None)
        for key in list(self.siread):
            self.siread[key] -= deadset
            if not self.siread[key]:
                del self.siread[key]
        self.certifier.on_gc(deadset)

    def prune_versions(self, floor_seq: int) -> int:
        n = self.store.prune(floor_seq)
        self.stats["gc_versions"] += n
        return n

    # ------------------------------------------------------------ convenience
    def run(self, ops: Iterable[tuple], t: Txn) -> Any:
        """Run ('r', key) / ('w', key, value) ops then commit. For tests."""
        out = []
        for op in ops:
            if op[0] == "r":
                out.append(self.read(t, op[1]))
            else:
                self.write(t, op[1], op[2])
        self.commit(t)
        return out
