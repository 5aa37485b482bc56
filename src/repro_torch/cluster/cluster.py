"""N-way WAL fan-out: one primary, N log-shipping replicas (paper Sec 5.1).

`ReplicaCluster` is the unit of decoupled-storage HTAP design at N > 1:

  * **Fan-out** — every replica is registered as a named WAL consumer
    (replication slot) on the primary's log; `ship(i)` replays the tail
    into replica i (its own RSSManager, paged mirror, and PRoT pin table)
    and acks the applied LSN back to the slot.
  * **Bounded log** — after every ship round the primary WAL is recycled
    up to `min_acked_lsn()`: the minimum applied LSN across ALL consumers.
    A lagging replica holds the log; it can never be handed a recycled
    prefix (the single-consumer truncation bug this subsystem replaces).
  * **Routing** — snapshot acquisition goes through a `RoutingPolicy`
    (freshest / round_robin / bounded_staleness); when no replica meets
    the staleness bound the cluster *ships-then-serves*: one synchronous
    replication round on the freshest replica, then serve it.
  * **Cluster-wide GC floor** — `gc_floor_seq()` is the min over replicas
    of min(replication horizon, oldest pinned snapshot); `gc_versions()`
    prunes every replica's version chains under its own floor, and the
    facade (`mvcc.htap.MultiNodeHTAP`) additionally prunes the primary
    under min(cluster floor, active-transaction horizon).

Snapshot handles are `(kind, replica_idx, reader_id, snapshot)` tuples —
kind is "rss" (an `RssSnapshot`, PRoT-pinned) or "si" (a commit-seq
horizon, pinned in the replica's SI pin table); `release(handle)` drops
the pin on the replica that served it.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterable, Optional, Sequence, Union

from ..obs import (REGISTRY, TRACER, CounterList, StatsView, tick, tock)
from ..tensorstore.version_store import Plan
from .routing import Freshest, RoutingPolicy, make_policy
from .session import Session

# handle: (kind, replica_idx, reader_id, snapshot)
SnapshotHandle = tuple

# the serve path's route stage: policy choice + cadence/ship decision +
# snapshot pin (the resolve/dispatch/finalize stages live in the mirror)
_ROUTE_H = REGISTRY.histogram("olap_stage_seconds", stage="route")


class ReplicaCluster:
    def __init__(self, primary, replicas: Iterable,
                 *, policy: Union[str, RoutingPolicy] = "freshest",
                 max_lag: int = 100) -> None:
        """`primary` is the OLTP engine (only its `.wal` and `.seq` are
        touched here); `replicas` are `mvcc.htap.Replica` instances (or
        anything with the same catch_up/snapshot/release surface)."""
        self.primary = primary
        self.replicas = list(replicas)
        assert self.replicas, "a cluster needs at least one replica"
        self.policy = make_policy(policy, max_lag=max_lag)
        self._slots: list[str] = []
        for i, rep in enumerate(self.replicas):
            name = primary.wal.register_consumer(f"replica{i}",
                                                 start_lsn=rep.applied_lsn)
            self._slots.append(name)
        # per-replica cadence history: head LSN at each EXTERNALLY-driven
        # ship (the replication schedule).  Serve-time ships (scheduled /
        # ship-then-serve) are excluded — recording them would shrink the
        # learned cadence, fire ship_due earlier, and trigger yet more
        # serve-time ships (a self-reinforcing collapse toward shipping on
        # every acquire).  `_last_ship_lsn` tracks ships of ANY kind so
        # due-ness still throttles to one serve-time ship per interval.
        self._ship_lsns: list[deque] = [deque(maxlen=8)
                                        for _ in self.replicas]
        self._last_ship_lsn: list[int] = [primary.wal.head_lsn
                                          for _ in self.replicas]
        # registry-backed accounting (series cluster_*), dict-shaped view;
        # "served" is a per-replica counter family (cluster_served{replica=i})
        lbl = {"cluster": REGISTRY.scope("cluster"),
               "policy": self.policy.name}
        self.stats = StatsView(
            REGISTRY, "cluster",
            ("acquires",
             "ship_then_serve",
             "scheduled_ships",         # cadence-due ships run at serve
             "lag_records_sum",         # observed, summed over served snaps
             "predicted_lag_sum",       # predicted at routing time, ditto
             "truncated_records",
             "token_acquires",          # acquires routed through a session
             "token_ships",             # delta ships run to cover a token
             "token_violations"),       # served below the token (must stay 0)
            labels=lbl,
            sub={"served": CounterList(REGISTRY, "cluster_served",
                                       len(self.replicas), labels=lbl)})
        self._next_sid = 0

    def __len__(self) -> int:
        return len(self.replicas)

    # ------------------------------------------------------------ lag state
    def lag_records(self, i: int) -> int:
        """Replication lag of replica i, in unapplied WAL records."""
        return self.primary.wal.head_lsn - self.replicas[i].applied_lsn

    def min_applied_lsn(self) -> int:
        return min(rep.applied_lsn for rep in self.replicas)

    def freshest_idx(self) -> int:
        return Freshest().choose(self)

    # -------------------------------------------------------- predicted lag
    def ship_cadence(self, i: int) -> Optional[float]:
        """Replica i's learned ship cadence in WAL records (mean head-LSN
        gap between its recent ships), or None before two ships."""
        h = self._ship_lsns[i]
        if len(h) < 2:
            return None
        return max((h[-1] - h[0]) / (len(h) - 1), 1.0)

    # a replica's next ship counts as imminent once this fraction of its
    # cadence interval has elapsed: running it early at serve replays the
    # same delta the schedule was about to replay (delta shipping makes
    # total replication work invariant — only the per-ship overhead is
    # pulled forward), at most once per window (`_last_ship_lsn` resets)
    DUE_FRACTION = 0.5

    def ship_due(self, i: int) -> bool:
        """Has the primary appended most of a cadence interval since
        replica i's last ship — of any kind, so a serve-time ship consumes
        the owed interval?  (Its next scheduled ship is imminent.)"""
        cadence = self.ship_cadence(i)
        return cadence is not None and \
            self.primary.wal.head_lsn - self._last_ship_lsn[i] >= \
            self.DUE_FRACTION * cadence

    def predicted_lag(self, i: int) -> int:
        """The lag replica i would serve with at THIS moment: observed lag,
        except ~0 when its cadence says a scheduled ship is due now (the
        serve path runs the due ship before serving — `acquire` with a
        predictive policy)."""
        return 0 if self.ship_due(i) else self.lag_records(i)

    # -------------------------------------------------------------- fan-out
    def ship(self, replica: Optional[int] = None, *,
             max_records: int = 0, record_cadence: bool = True) -> int:
        """One replication round: replay the WAL tail into one replica
        (or all, when `replica` is None), ack the applied LSNs, then
        recycle the primary WAL prefix EVERY consumer has applied.

        `record_cadence=False` marks a serve-time ship (scheduled /
        ship-then-serve): it advances `_last_ship_lsn` but stays out of
        the cadence history, so the learned cadence keeps reflecting the
        external replication schedule only."""
        idxs = range(len(self.replicas)) if replica is None else [replica]
        n = 0
        for i in idxs:
            rep = self.replicas[i]
            n += rep.catch_up(self.primary, max_records=max_records)
            self.primary.wal.ack(self._slots[i], rep.applied_lsn)
            self._last_ship_lsn[i] = self.primary.wal.head_lsn
            h = self._ship_lsns[i]
            # cadence points only when the head actually advanced: two
            # ships at the same LSN (e.g. back-to-back warm-up ships)
            # would otherwise teach a degenerate ~0-record cadence and
            # make every acquire look ship-due
            if record_cadence and (not h or self.primary.wal.head_lsn >
                                   h[-1]):
                h.append(self.primary.wal.head_lsn)
        self.stats["truncated_records"] += self.primary.wal.truncate()
        return n

    # ------------------------------------------------------------- sessions
    def session(self, *, keep_history: bool = False) -> Session:
        """Open a client session: a token carrying the LSN horizon this
        client has observed.  Pass it to `acquire(session=...)` for
        read-your-writes / monotonic reads across the fleet; call
        `session.note_commit(primary.wal.head_lsn)` after each of the
        client's OLTP commits."""
        sid, self._next_sid = self._next_sid, self._next_sid + 1
        return Session(sid, keep_history=keep_history)

    # -------------------------------------------------------------- routing
    def acquire(self, *, max_lag: Optional[int] = None,
                session: Optional[Session] = None) -> SnapshotHandle:
        """Route a snapshot acquisition through the policy.  A predictive
        policy may pick a replica on predicted lag (its scheduled ship is
        due): run that due ship before serving — cadence-owed work, not an
        emergency round.  When no replica satisfies the staleness bound,
        ship-then-serve: catch the freshest replica up synchronously, then
        serve it.

        With a `session`, only replicas whose applied LSN covers the
        session token (read-your-writes + monotonic reads) are eligible;
        when none does, the freshest replica gets a cadence-owed DELTA
        ship (`token_ships`) — never a synchronous stall, since delta
        shipping replays exactly what the replication schedule owed — and
        the token's floor is ratcheted forward after the serve."""
        min_lsn = session.min_required_lsn() if session is not None else 0
        t0 = tick()
        with TRACER.span("route", policy=self.policy.name):
            idx = self.policy.choose(self, max_lag=max_lag, min_lsn=min_lsn)
            predicted = self.predicted_lag(idx) if idx is not None else 0
            if idx is None:
                idx = self.freshest_idx()
                predicted = 0                  # served post-ship: lag ~0
                if min_lsn and \
                        self.policy.choose(self, max_lag=max_lag) is not None:
                    # staleness was satisfiable — only the session token
                    # wasn't: the freshest replica's delta ship covers it
                    # (cadence-owed records, not an emergency round)
                    with TRACER.span("token_ship", replica=idx):
                        self.ship(idx, record_cadence=False)
                    self.stats["token_ships"] += 1
                else:
                    with TRACER.span("ship_then_serve", replica=idx):
                        self.ship(idx, record_cadence=False)
                    self.stats["ship_then_serve"] += 1
            elif getattr(self.policy, "predictive", False) and \
                    (predicted < self.lag_records(idx) or
                     self.replicas[idx].applied_lsn < min_lsn):
                # the prediction was load-bearing: this replica only met
                # the staleness bound (or the session token) because its
                # imminent ship counts as run — run it (cadence-owed work
                # pulled forward, not an emergency round).  A replica
                # whose OBSERVED lag already satisfies the bound is
                # served as-is: no ship, no extra work.
                bound = self.policy.effective_bound(max_lag)
                if self.replicas[idx].applied_lsn < min_lsn:
                    with TRACER.span("token_ship", replica=idx):
                        self.ship(idx, record_cadence=False)
                    self.stats["token_ships"] += 1
                elif bound is not None and self.lag_records(idx) > bound:
                    with TRACER.span("scheduled_ship", replica=idx):
                        self.ship(idx, record_cadence=False)
                    self.stats["scheduled_ships"] += 1
                else:
                    predicted = self.lag_records(idx)   # served unshipped
            self.stats["acquires"] += 1
            self.stats["served"][idx] += 1
            self.stats["predicted_lag_sum"] += predicted
            self.stats["lag_records_sum"] += self.lag_records(idx)
            rep = self.replicas[idx]
            TRACER.annotate(replica=idx)
            if rep.with_rss:
                rid, snap = rep.rss_snapshot()
                handle = ("rss", idx, rid, snap)
            else:
                rid, seq = rep.si_snapshot_pinned()
                handle = ("si", idx, rid, seq)
            if session is not None:
                self.stats["token_acquires"] += 1
                if rep.applied_lsn < min_lsn:      # must never happen
                    self.stats["token_violations"] += 1
                session.note_read(rep.applied_lsn, idx)
        tock(_ROUTE_H, t0)
        return handle

    def avg_served_lag(self) -> float:
        """Mean observed replication lag (WAL records) of served snapshots —
        the cluster's freshness metric per routing policy."""
        return self.stats["lag_records_sum"] / max(self.stats["acquires"], 1)

    def avg_predicted_lag(self) -> float:
        """Mean lag predicted at routing time for served snapshots; compare
        with `avg_served_lag` to see what the cadence model promised vs
        what the replicas delivered."""
        return self.stats["predicted_lag_sum"] / max(self.stats["acquires"],
                                                     1)

    # ---------------------------------------------------------------- reads
    def read(self, handle: SnapshotHandle, key: str) -> Any:
        kind, idx, _, s = handle
        rep = self.replicas[idx]
        return rep.read_si(s, key) if kind == "si" else rep.read_rss(s, key)

    def execute(self, handle: SnapshotHandle, plan: Plan) -> Any:
        """The cluster's ONE plan-execution seam: serve any plan on the
        replica that served the handle's snapshot (same routing/freshness
        decision as the acquisition), under the handle's snapshot kind."""
        kind, idx, _, s = handle
        rep = self.replicas[idx]
        return rep.execute_si(s, plan) if kind == "si" \
            else rep.execute_rss(s, plan)

    def release(self, handle: SnapshotHandle) -> None:
        _, idx, rid, _ = handle
        self.replicas[idx].release(rid)

    # ------------------------------------------------------------------- GC
    def gc_floor_seq(self) -> int:
        """The cluster-wide version-GC floor (commit-seq units): the min
        over replicas of min(replication horizon, oldest pinned
        snapshot)."""
        return min(rep.gc_floor_seq() for rep in self.replicas)

    def gc_versions(self) -> int:
        """Prune every replica's chain versions under its own pinned floor;
        returns total versions dropped."""
        return sum(rep.gc_versions() for rep in self.replicas)
