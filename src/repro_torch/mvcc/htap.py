"""HTAP system facades: the paper's two architectures × CC configurations.

Single-node (unified storage, Sec 5.2):
  * "ssi"                — OLAP readers are plain SSI transactions
                           (reader-/writer-aborts possible)
  * "ssi+safesnapshots"  — OLAP readers are READ ONLY DEFERRABLE
                           (reader-WAIT until a safe snapshot exists)
  * "ssi+rss"            — OLAP readers are PRoTs over the in-process RSS
                           (wait-free, abort-free; the paper's system)

Multi-node (decoupled storage, Sec 5.1): primary runs SSI; an asynchronous
log-shipping replica applies committed writesets and serves OLAP:
  * "ssi+si"   — replica readers use plain SI at the replication horizon
                 (NOT serializable: read-only anomalies possible; baseline)
  * "ssi+rss"  — replica-side RSSManager replays begin/commit/abort + deps
                 records and serves RSS snapshots (serializable, wait-free)

Both facades serve every OLAP read through ONE plan-execution seam
(`olap_execute(plan)` here, `VersionStore.execute` below): a `Plan`
(`ScanPlan`/`AggPlan`/`MultiAggPlan`/`GroupByPlan`) in, one batched
visibility resolution for its whole key sequence instead of N per-key chain
walks.  With `paged=True` they additionally mirror committed writesets into
the device-resident K-slot paged store (`tensorstore.mirror.PagedMirror`)
and lower aggregate plans to the fused `rss_scan_agg` kernels.  With
`check_scans=True` every plan result is asserted equal to the per-key
engine read path (the `apply_plan` oracle).  `execute(plan)` is the only
OLAP read path.

`olap_execute_batch` is the cross-reader batching seam: aggregate plans
from several same-horizon readers (PRoT pin sharing hands them the SAME
snapshot object) fuse into one `BatchPlan` — ONE kernel dispatch serves
the whole batch, with per-transaction read-set recording and per-plan
oracle checks preserved.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from ..cluster import ReplicaCluster
from ..core.replica import PRoTManager, RSSManager, RssSnapshot
from ..core.wal import effective_commit_seq
from ..kernels.config import resolve_device
from ..obs import REGISTRY, TRACER, tick, tock
from ..tensorstore.mirror import PagedMirror
from ..tensorstore.version_store import (AggPlan, BatchPlan,
                                         ChainVersionStore, GroupByPlan,
                                         MultiAggPlan, PagedVersionStore,
                                         Plan, VersionStore, apply_plan,
                                         plan_keys)
from .engine import AbortReason, Engine, SerializationFailure, Status, Txn
from .store import Store

# single-node route stage: PRoT snapshot acquisition (the multi-node twin
# — policy choice + cadence/ship decision — is timed in cluster.acquire
# into the SAME series)
_ROUTE_H = REGISTRY.histogram("olap_stage_seconds", stage="route")


def _serve_hist(cache: dict, key: tuple, **labels):
    """Per-facade cache of olap_serve_seconds{facade, plan[, replica]}
    histograms: one dict hit per serve instead of a registry lookup."""
    h = cache.get(key)
    if h is None:
        h = cache[key] = REGISTRY.histogram("olap_serve_seconds", **labels)
    return h


# --------------------------------------------------------------- single node
class SingleNodeHTAP:
    def __init__(self, olap_mode: str = "ssi+rss", *, paged: bool = False,
                 check_scans: bool = False,
                 reserve_keys: Optional[Sequence[str]] = None,
                 materialize: Optional[Sequence[Plan]] = None,
                 certifier=None, resolve_cache: bool = True,
                 device=None) -> None:
        """`device` places the paged mirror's exported stores and kernel
        launches: "cuda" by default (raises without a GPU), "cpu" for the
        plain PyTorch versions (`kernels.config.resolve_device`).
        `certifier` picks the OLTP commit-certification policy
        (`repro_torch.mvcc.certify`): name / instance / factory; None keeps the
        conservative structural SSI abort.  OLAP behaviour — RSS
        construction, the WAL deps messages it feeds on — is certifier-
        independent by design.  `materialize` registers aggregate plans
        for incremental materialization on the paged mirror
        (`tensorstore.materialized`): serves of an equal plan cost
        O(delta since last commit) instead of O(pages scanned), falling
        back to the fused scan whenever the snapshot gate can't prove
        consistency."""
        assert olap_mode in ("ssi", "ssi+safesnapshots", "ssi+rss")
        self.olap_mode = olap_mode
        self.device = resolve_device(device)
        self.engine = Engine("ssi", certifier=certifier)
        self.rss_manager = RSSManager()
        self.prot = PRoTManager(self.rss_manager)
        self.check_scans = check_scans
        # device-backed OLAP surface: WAL-mirrored paged store + kernel-shaped
        # scans for protected readers; `reserve_keys` pre-allocates workload
        # key families contiguously so dense plans hit the page-range slice
        # fast path instead of gathering
        self.mirror: Optional[PagedMirror] = \
            PagedMirror(resolve_cache=resolve_cache,
                        device=self.device) if paged else None
        self.paged_store: Optional[PagedVersionStore] = \
            PagedVersionStore(self.mirror) if paged else None
        if self.mirror is not None and reserve_keys:
            self.mirror.reserve(reserve_keys)
        if materialize:
            assert self.mirror is not None, \
                "materialize= needs paged=True (views live on the mirror)"
            for p in materialize:
                self.mirror.register_view(p)
        self._pins: dict[int, int] = {}       # txn tid -> PRoT reader id
        self._serve_h: dict[tuple, Any] = {}  # plan kind -> serve histogram
        # in-process WAL consumers as registered slots: truncation goes
        # through the same min-acked accounting the replica cluster uses
        self.engine.wal.register_consumer("rss")
        if self.mirror is not None:
            self.engine.wal.register_consumer("mirror")

    # OLTP path -------------------------------------------------------------
    def oltp_begin(self, *, read_only: bool = False) -> Txn:
        return self.engine.begin(read_only=read_only)

    # OLAP path -------------------------------------------------------------
    def refresh_rss(self) -> RssSnapshot:
        """RSS construction invoker: replay the WAL delta and advance the
        incrementally-maintained RSS — O(records since the last round), not
        O(history) (Sec 5.2).  With a paged mirror, also advance the device
        store to the same LSN under the pinned-reader GC floor.  Afterwards,
        bound the bookkeeping: prune RSS per-txn state below the oldest
        pinned PRoT snapshot and recycle the WAL prefix every consumer has
        applied."""
        self.rss_manager.catch_up(self.engine.wal)
        snap = self.rss_manager.construct()
        if self.mirror is not None:
            self.mirror.catch_up(self.engine.wal,
                                 gc_floor=self.prot.gc_floor_seq())
            # fold commits the fresh snapshot admits into the view tiles
            self.mirror.advance_views(snap)
        self.rss_manager.gc(keep_lsn=self.prot.gc_floor(),
                            keep_seq=self.prot.gc_floor_seq())
        if self.mirror is not None:
            # bound view-gate bookkeeping by the same pinned floor
            self.mirror.gc_views(self.prot.gc_floor_seq())
        self.engine.wal.ack("rss", self.rss_manager.applied_lsn)
        if self.mirror is not None:
            self.engine.wal.ack("mirror", self.mirror.applied_lsn)
        self.engine.wal.truncate()
        return snap

    def olap_begin(self) -> Optional[Txn]:
        """Returns None when the reader must wait (SafeSnapshots only)."""
        if self.olap_mode == "ssi":
            return self.engine.begin(read_only=True)
        if self.olap_mode == "ssi+safesnapshots":
            return self.engine.begin_deferred()   # None => reader-wait
        # ssi+rss: wait-free protected read over the freshest constructed RSS
        t0 = tick()
        with TRACER.span("route", policy="prot"):
            rid, snap = self.prot.acquire()
        tock(_ROUTE_H, t0)
        t = self.engine.begin(read_only=True, rss=snap)
        self._pins[t.tid] = rid
        return t

    def olap_read(self, t: Txn, key: str) -> Any:
        return self.engine.read(t, key)

    def olap_execute(self, t: Txn, plan: Plan) -> Any:
        """The facade's ONE OLAP plan-execution seam: protected readers on
        the paged mirror run the plan's fused device lowering (visibility
        resolve + reduction in one `rss_scan_agg` pass per kernel config,
        batched scan for `ScanPlan`); everything else executes through the
        engine's chain-store seam (the oracle shape).  Read sets record
        identically either way — the mirror resolves writers in the same
        vectorized pass.  With `check_scans`, every result is asserted
        equal to the per-key engine read path (`apply_plan` oracle)."""
        kind = type(plan).__name__
        t0 = tick()
        with TRACER.span("olap_serve", facade="single", plan=kind):
            if self.paged_store is not None and t.rss is not None:
                self.engine._check_active(t)
                result, writers = self.paged_store.execute_with_writers(
                    plan, t.rss)
                self.engine.record_scan(t, plan_keys(plan), writers)
            else:
                result = self.engine.execute(t, plan)
        tock(_serve_hist(self._serve_h, (kind,), facade="single",
                         plan=kind), t0)
        if self.check_scans:
            # per-key oracle parity (history suppressed: the read set was
            # already recorded by the plan execution above, and the check
            # must not double it)
            hist, self.engine.history = self.engine.history, None
            try:
                oracle = apply_plan(
                    [self.engine.read(t, k) for k in plan_keys(plan)], plan)
            finally:
                self.engine.history = hist
            assert result == oracle, (result, oracle)
        return result

    def olap_execute_batch(self, entries: Sequence[tuple]) -> list[Any]:
        """Cross-reader whole-batch plan fusion: `entries` is a sequence
        of (txn, plan) pairs whose plans are aggregate-shaped and whose
        transactions share ONE RSS horizon (PRoT pin sharing hands
        same-round readers the same snapshot object).  The plans lower to
        a single `BatchPlan` — ONE fused kernel dispatch — and each
        transaction records exactly the read set its plan would record
        unbatched.  Entries that can't fuse (no paged mirror, non-RSS
        readers, mixed horizons, scan plans) fall back to per-plan
        `olap_execute`.  Returns per-entry results in order."""
        entries = list(entries)
        batchable = (
            self.paged_store is not None and len(entries) > 1 and
            all(isinstance(p, (AggPlan, MultiAggPlan, GroupByPlan))
                for _, p in entries) and
            all(t.rss is not None for t, _ in entries) and
            len({t.rss.lsn for t, _ in entries}) == 1)
        if not batchable:
            return [self.olap_execute(t, p) for t, p in entries]
        for t, _ in entries:
            self.engine._check_active(t)
        snap = entries[0][0].rss
        batch = BatchPlan(tuple(p for _, p in entries))
        t0 = tick()
        with TRACER.span("olap_serve", facade="single", plan="BatchPlan",
                         fused=len(entries)):
            results, writers = self.paged_store.execute_with_writers(batch,
                                                                     snap)
        # one observation per fused dispatch: histogram count stays equal
        # to the number of serve-path executions, not member plans
        tock(_serve_hist(self._serve_h, ("BatchPlan",), facade="single",
                         plan="BatchPlan"), t0)
        off = 0
        for (t, p), result in zip(entries, results):
            pk = plan_keys(p)
            self.engine.record_scan(t, pk, writers[off:off + len(pk)])
            off += len(pk)
            if self.check_scans:
                hist, self.engine.history = self.engine.history, None
                try:
                    oracle = apply_plan(
                        [self.engine.read(t, k) for k in pk], p)
                finally:
                    self.engine.history = hist
                assert result == oracle, (result, oracle)
        return list(results)

    def olap_commit(self, t: Txn) -> None:
        try:
            self.engine.commit(t)
        finally:
            self._release(t)

    def olap_abandon(self, t: Txn) -> None:
        """Drop the PRoT pin of a finished/aborted OLAP transaction."""
        self._release(t)

    def _release(self, t: Txn) -> None:
        rid = self._pins.pop(t.tid, None)
        if rid is not None:
            self.prot.release(rid)

    # GC --------------------------------------------------------------------
    def gc_versions(self) -> int:
        """hot_standby_feedback loop: prune chain versions below the pinned
        PRoT floor (never above an active transaction's snapshot)."""
        floor = self.prot.gc_floor_seq()
        active = min((t.begin_seq for t in self.engine.active.values()),
                     default=self.engine.seq)
        return self.engine.prune_versions(min(floor, active))


# ---------------------------------------------------------------- multi node
class Replica:
    """Asynchronous log-shipping replica: applies committed writesets in LSN
    order into its own store; optionally maintains an RSSManager from the
    same stream (begin/commit/abort + deps records) and a device-resident
    paged mirror serving batched kernel-shaped scans."""

    def __init__(self, *, with_rss: bool, paged: bool = False,
                 check_scans: bool = False,
                 reserve_keys: Optional[Sequence[str]] = None,
                 materialize: Optional[Sequence[Plan]] = None,
                 resolve_cache: bool = True, device=None) -> None:
        self.store = Store()
        self.version_store: VersionStore = ChainVersionStore(self.store)
        self.applied_lsn = 0
        self.applied_seq = 0          # commit-seq horizon for SI readers
        self.with_rss = with_rss
        self.check_scans = check_scans
        self.rss_manager = RSSManager() if with_rss else None
        self.prot = PRoTManager(self.rss_manager) if with_rss else None
        self.mirror: Optional[PagedMirror] = \
            PagedMirror(resolve_cache=resolve_cache,
                        device=device) if paged else None
        self.paged_store: Optional[PagedVersionStore] = \
            PagedVersionStore(self.mirror) if paged else None
        if self.mirror is not None and reserve_keys:
            self.mirror.reserve(reserve_keys)   # page-range locality
        if materialize:
            assert self.mirror is not None, \
                "materialize= needs paged=True (views live on the mirror)"
            for p in materialize:
                self.mirror.register_view(p)    # advance during delta ships
        self._si_pins: dict[int, int] = {}    # reader id -> pinned seq
        self._next_si_reader = 1

    def catch_up(self, primary: Engine, *, max_records: int = 0) -> int:
        n = 0
        # GC floor for mirror publishes: pinned PRoT snapshots (RSS) or the
        # oldest pinned SI snapshot.  Bounded, not absolute: an SI reader
        # that holds its snapshot across multiple ship rounds (or an RSS
        # member version above the prefix floor) is protected only while
        # publishers stay < K-1 versions ahead per page — the K-slot
        # staleness bound.
        gc_floor = self.gc_floor_seq()
        for rec in primary.wal.tail(self.applied_lsn):
            if max_records and n >= max_records:
                break
            self.applied_lsn = rec.lsn
            if self.rss_manager is not None:
                self.rss_manager.apply(rec)
            if self.mirror is not None:
                self.mirror.apply(rec, gc_floor=gc_floor)
            if rec.type == "commit":
                # the shared WAL commit clock (effective_commit_seq), so
                # manager/mirror/store version stamps agree and installs
                # stay strictly monotone even across mixed record kinds
                seq = effective_commit_seq(self.applied_seq, rec.seq)
                for key, value in rec.writes:
                    self.store.chain(key).install(seq, rec.txn, value)
                self.applied_seq = seq
            n += 1
        if self.rss_manager is not None and n:
            snap = self.rss_manager.construct()
            if self.mirror is not None:
                # views advance with the delta ship, at the snapshot the
                # fresh construct admits
                self.mirror.advance_views(snap)
            # bound replica-side RSS bookkeeping by the active/pinned window
            self.rss_manager.gc(keep_lsn=self.prot.gc_floor(),
                                keep_seq=self.prot.gc_floor_seq())
        elif self.mirror is not None and n:
            self.mirror.advance_views(self.applied_seq)
        if self.mirror is not None and n:
            self.mirror.gc_views(self.gc_floor_seq())
        return n

    # reader snapshots -------------------------------------------------------
    def si_snapshot(self) -> int:
        return self.applied_seq

    def si_snapshot_pinned(self) -> tuple[int, int]:
        """Acquire (pin) the replication horizon as an SI snapshot; the pin
        holds this replica's version-GC floor until `release(rid)`.  SI
        reader ids are NEGATIVE — disjoint from the PRoT manager's positive
        ids, so releasing one kind of pin can never drop the other's."""
        rid = -self._next_si_reader
        self._next_si_reader += 1
        self._si_pins[rid] = self.applied_seq
        return rid, self.applied_seq

    def rss_snapshot(self) -> tuple[int, RssSnapshot]:
        """Acquire (pin) the freshest exported snapshot; release the returned
        reader id via `release(rid)` when the reader finishes."""
        assert self.prot is not None
        return self.prot.acquire()

    def release(self, reader_id: int) -> None:
        if reader_id < 0:
            self._si_pins.pop(reader_id, None)
        elif self.prot is not None:
            self.prot.release(reader_id)

    # GC ---------------------------------------------------------------------
    def gc_floor_seq(self) -> int:
        """This replica's version-GC floor: min(oldest pinned snapshot —
        PRoT or SI — and the replication horizon) in commit-seq units, the
        per-replica term of the cluster-wide GC floor."""
        floor = self.prot.gc_floor_seq() if self.prot is not None \
            else self.applied_seq
        si_floor = min(self._si_pins.values(), default=floor)
        return min(floor, si_floor)

    def gc_versions(self) -> int:
        """Prune replica-side chain versions below the pinned floor
        (hot_standby_feedback analogue on the replica's own store)."""
        return self.store.prune(self.gc_floor_seq())

    def read_si(self, snapshot_seq: int, key: str) -> Any:
        return self.version_store.read_at(key, snapshot_seq)

    def read_rss(self, snap: RssSnapshot, key: str) -> Any:
        return self.version_store.read_members(key, snap)

    # plan execution --------------------------------------------------------
    def _execute(self, snapshot, plan: Plan) -> Any:
        """The replica's ONE plan-execution seam: fused device lowering on
        the paged mirror, chain-walk + host `apply_plan` otherwise;
        parity-asserted against the per-key oracle under check_scans."""
        store = self.paged_store or self.version_store
        val = store.execute(plan, snapshot)
        if self.check_scans:
            if isinstance(snapshot, RssSnapshot):
                vals = [self.version_store.read_members(k, snapshot)
                        for k in plan_keys(plan)]
            else:
                vals = [self.version_store.read_at(k, snapshot)
                        for k in plan_keys(plan)]
            oracle = apply_plan(vals, plan)
            assert val == oracle, (val, oracle)
        return val

    def execute_si(self, snapshot_seq: int, plan: Plan) -> Any:
        """Execute a plan at an SI watermark (the replication horizon)."""
        return self._execute(int(snapshot_seq), plan)

    def execute_rss(self, snap: RssSnapshot, plan: Plan) -> Any:
        """Execute a plan under RSS membership visibility."""
        return self._execute(snap, plan)


class MultiNodeHTAP:
    """Primary + N-replica decoupled-storage cluster.  Snapshot handles are
    the cluster's `(kind, replica_idx, reader_id, snapshot)` tuples; all
    log shipping, WAL recycling (min applied LSN across consumers), snapshot
    routing, and version GC flow through `cluster.ReplicaCluster`."""

    def __init__(self, olap_mode: str = "ssi+rss", *, paged_olap: bool = False,
                 check_scans: bool = False, n_replicas: int = 1,
                 route_policy="freshest", max_staleness: int = 100,
                 reserve_keys: Optional[Sequence[str]] = None,
                 materialize: Optional[Sequence[Plan]] = None,
                 certifier=None, resolve_cache: bool = True,
                 device=None) -> None:
        """`device` places every paged replica's mirror ("cuda" by
        default — raises without a GPU — or "cpu"; see
        `kernels.config.resolve_device`).  `certifier` configures the
        PRIMARY's commit certification (see
        `repro_torch.mvcc.certify`).  Replicas replay begin/commit/abort + deps
        WAL records, which are certifier-independent: only WHICH txns
        commit varies, never the shape of a committed txn's records — so
        replica-side RSS construction is untouched by the choice."""
        assert olap_mode in ("ssi+si", "ssi+rss")
        assert n_replicas >= 1
        self.olap_mode = olap_mode
        self.device = resolve_device(device)
        self.primary = Engine("ssi", certifier=certifier)
        replicas = [Replica(with_rss=(olap_mode == "ssi+rss"),
                            paged=paged_olap, check_scans=check_scans,
                            reserve_keys=reserve_keys,
                            materialize=materialize,
                            resolve_cache=resolve_cache,
                            device=self.device)
                    for _ in range(n_replicas)]
        self.cluster = ReplicaCluster(self.primary, replicas,
                                      policy=route_policy,
                                      max_lag=max_staleness)
        self.replica = replicas[0]     # single-replica legacy surface
        self._serve_h: dict[tuple, Any] = {}   # (plan, replica) -> histogram

    def oltp_begin(self, *, read_only: bool = False) -> Txn:
        return self.primary.begin(read_only=read_only)

    def ship_log(self, *, max_records: int = 0,
                 replica: Optional[int] = None) -> int:
        """One asynchronous replication round into one replica (or all);
        afterwards the primary recycles the WAL prefix EVERY consumer has
        applied — truncation only ever discards records below the minimum
        applied LSN across the fleet (bounded log state at N > 1)."""
        return self.cluster.ship(replica, max_records=max_records)

    def session(self, *, keep_history: bool = False):
        """Open a client `Session` (cluster token: last-commit LSN +
        last-read horizon).  Pass it to `olap_snapshot(session=...)` for
        read-your-writes / monotonic reads, and call
        `note_commit(session)` after each of the client's OLTP commits."""
        return self.cluster.session(keep_history=keep_history)

    def note_commit(self, session) -> None:
        """Stamp a session with the client's just-committed OLTP write:
        any later read through this session is served at or above the WAL
        position holding that commit record."""
        session.note_commit(self.primary.wal.head_lsn)

    def olap_snapshot(self, *, max_lag: Optional[int] = None, session=None):
        """Route a snapshot acquisition through the cluster's policy;
        `max_lag` is a per-query freshness hint (bounded staleness in WAL
        records) — unsatisfiable hints trigger ship-then-serve.  A
        `session` token restricts routing to replicas covering the
        client's observed horizon (read-your-writes + monotonic reads),
        falling back to a cadence-owed delta ship when none does."""
        return self.cluster.acquire(max_lag=max_lag, session=session)

    def olap_read(self, snap, key: str) -> Any:
        return self.cluster.read(snap, key)

    def olap_execute(self, snap, plan: Plan) -> Any:
        """The facade's ONE OLAP plan-execution seam: plans route to the
        replica that served the handle's snapshot — the same
        freshness-policy decision as the acquisition."""
        kind, idx = type(plan).__name__, snap[1]
        t0 = tick()
        with TRACER.span("olap_serve", facade="multi", plan=kind,
                         replica=idx):
            result = self.cluster.execute(snap, plan)
        tock(_serve_hist(self._serve_h, (kind, idx), facade="multi",
                         plan=kind, replica=idx), t0)
        return result

    def olap_execute_batch(self, entries: Sequence[tuple]) -> list[Any]:
        """Cross-reader whole-batch plan fusion, cluster-routed: `entries`
        is a sequence of (snapshot handle, plan) pairs.  When every plan
        is aggregate-shaped and every handle names the same replica and
        snapshot horizon, the plans fuse into one `BatchPlan` served by a
        single replica dispatch (one fused kernel launch on a paged
        replica); otherwise each entry executes alone.  Returns per-entry
        results in order."""
        entries = list(entries)

        def _horizon(handle):
            kind, idx, _rid, snap = handle
            return (kind, idx,
                    snap.lsn if isinstance(snap, RssSnapshot) else int(snap))

        batchable = (
            len(entries) > 1 and
            all(isinstance(p, (AggPlan, MultiAggPlan, GroupByPlan))
                for _, p in entries) and
            len({_horizon(h) for h, _ in entries}) == 1)
        if not batchable:
            return [self.olap_execute(h, p) for h, p in entries]
        batch = BatchPlan(tuple(p for _, p in entries))
        idx = entries[0][0][1]
        t0 = tick()
        with TRACER.span("olap_serve", facade="multi", plan="BatchPlan",
                         replica=idx, fused=len(entries)):
            results = list(self.cluster.execute(entries[0][0], batch))
        tock(_serve_hist(self._serve_h, ("BatchPlan", idx), facade="multi",
                         plan="BatchPlan", replica=idx), t0)
        return results

    def olap_release(self, snap) -> None:
        self.cluster.release(snap)

    # GC --------------------------------------------------------------------
    def gc_versions(self) -> int:
        """Cluster-wide hot_standby_feedback: every replica prunes its chain
        versions under its own pinned floor, and the primary prunes under
        min(cluster-wide floor, active-transaction horizon) — the min over
        replicas of min(replication horizon, oldest pin)."""
        n = self.cluster.gc_versions()
        active = min((t.begin_seq for t in self.primary.active.values()),
                     default=self.primary.seq)
        n += self.primary.prune_versions(
            min(self.cluster.gc_floor_seq(), active))
        return n
