"""Snapshot routing policies over a lag-skewed replica fleet.

A decoupled-storage HTAP cluster (paper Sec 5.1 at N > 1) serves OLAP
readers from whichever replica a *routing policy* picks.  Replicas lag the
primary by different amounts (each ships the WAL on its own cadence), so the
policy is where the freshness/throughput trade-off lives:

  * `Freshest`          — route to the replica with the maximum applied
                          commit horizon (minimum replication lag).  Best
                          staleness, but concentrates the read load on one
                          node.
  * `RoundRobin`        — spread readers uniformly across the fleet.  Best
                          load balance, worst-case staleness is the slowest
                          replica's lag.
  * `BoundedStaleness`  — serve from any replica within `max_lag` WAL
                          records of the primary (round-robin among the
                          eligible set, so load still spreads).  When EVERY
                          replica is too stale the policy abstains
                          (`choose` returns None) and the cluster falls
                          back to ship-then-serve: synchronously catch one
                          replica up, then serve it — freshness bought with
                          one synchronous replication round.
  * `PredictedStaleness` — bounded staleness on PREDICTED lag at serve
                          time: the cluster knows each replica's ship
                          cadence (`ReplicaCluster.ship_cadence`, learned
                          from the slot-ack history), so a replica whose
                          scheduled ship is due predicts lag ~0 and stays
                          eligible even when its observed lag exceeds the
                          bound.  The cluster then runs that due ship at
                          serve (a *scheduled* ship the replication cadence
                          owed anyway) instead of an emergency
                          ship-then-serve round on the freshest replica —
                          cutting sync fallbacks on cadence-skewed fleets.
  * `LatencySLO`         — bounded staleness PLUS a serve-latency SLO:
                          replicas whose `olap_serve_seconds{replica=i}`
                          p99 (from the `repro_torch.obs` histograms) degrades
                          past `slo_factor` x the fleet median drop out of
                          the eligible set, so a slow replica sheds read
                          load instead of dragging tail latency — unless
                          EVERY replica is slow, in which case the SLO
                          filter stands down (staleness still binds).

Policies see the cluster read-only through `lag_records(i)` /
`replicas[i].applied_lsn`; a per-call `max_lag` (e.g. a query-class
freshness hint from the workload) narrows ANY policy's eligible set the
same way, so `Freshest` and `RoundRobin` also degrade to ship-then-serve
when a hint is unsatisfiable.  A per-call `min_lsn` (a session token's
required horizon — read-your-writes / monotonic reads) filters the same
way from below: only replicas whose applied LSN covers the token are
eligible; predictive policies additionally keep ship-due replicas
eligible (their serve-time delta ship applies the full tail, covering
any token the primary has issued).
"""

from __future__ import annotations

from typing import Optional, Union

from ..obs import REGISTRY


class RoutingPolicy:
    """Pick a replica index for the next snapshot acquisition, or None when
    no replica satisfies the staleness bound / session token (caller
    ships-then-serves, or delta-ships for a token)."""

    name = "policy"

    def choose(self, cluster, *, max_lag: Optional[int] = None,
               min_lsn: int = 0) -> Optional[int]:
        raise NotImplementedError

    def _lag(self, cluster, i: int) -> float:
        """The staleness measure eligibility filters on; predictive
        policies override (observed lag by default)."""
        return cluster.lag_records(i)

    def _covers(self, cluster, i: int, min_lsn: int) -> bool:
        """Does replica i satisfy a session token requiring `min_lsn`?
        Predictive policies also accept ship-due replicas (the serve-time
        delta ship catches them fully up before the pin)."""
        return cluster.replicas[i].applied_lsn >= min_lsn or \
            (self.predictive and cluster.ship_due(i))

    predictive = False

    def effective_bound(self, max_lag: Optional[int]) -> Optional[int]:
        """The staleness bound this policy actually enforced for a choice
        made with `max_lag` (the per-query hint; bounded-staleness
        policies tighten it with their default)."""
        return max_lag

    def _eligible(self, cluster, max_lag: Optional[int],
                  min_lsn: int = 0) -> list[int]:
        idxs = range(len(cluster.replicas))
        return [i for i in idxs
                if (max_lag is None or self._lag(cluster, i) <= max_lag)
                and (min_lsn <= 0 or self._covers(cluster, i, min_lsn))]


class Freshest(RoutingPolicy):
    """Max applied commit horizon == min replication lag; ties break toward
    the lowest replica index (deterministic)."""

    name = "freshest"

    def choose(self, cluster, *, max_lag: Optional[int] = None,
               min_lsn: int = 0) -> Optional[int]:
        elig = self._eligible(cluster, max_lag, min_lsn)
        if not elig:
            return None
        return min(elig, key=lambda i: (cluster.lag_records(i), i))


class RoundRobin(RoutingPolicy):
    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def choose(self, cluster, *, max_lag: Optional[int] = None,
               min_lsn: int = 0) -> Optional[int]:
        elig = self._eligible(cluster, max_lag, min_lsn)
        if not elig:
            return None
        idx = elig[self._next % len(elig)]
        self._next += 1
        return idx


class BoundedStaleness(RoundRobin):
    """Any replica within `max_lag` WAL records of the primary may serve;
    round-robin among the eligible set spreads load.  A per-call `max_lag`
    (query freshness hint) overrides the policy default when tighter."""

    name = "bounded_staleness"

    def __init__(self, max_lag: int = 100) -> None:
        super().__init__()
        self.max_lag = max_lag

    def choose(self, cluster, *, max_lag: Optional[int] = None,
               min_lsn: int = 0) -> Optional[int]:
        return super().choose(cluster, max_lag=self.effective_bound(max_lag),
                              min_lsn=min_lsn)

    def effective_bound(self, max_lag: Optional[int]) -> Optional[int]:
        return self.max_lag if max_lag is None else min(self.max_lag,
                                                        max_lag)


class PredictedStaleness(BoundedStaleness):
    """Bounded staleness evaluated on `cluster.predicted_lag(i)` — the lag
    replica i will serve with once its cadence-due scheduled ship runs —
    instead of last-observed lag.  The `predictive` marker tells the
    cluster to actually run that due ship before serving, so the served
    snapshot honours the bound; clusters without cadence tracking degrade
    to observed lag."""

    name = "predicted_staleness"
    predictive = True

    def _lag(self, cluster, i: int) -> float:
        return getattr(cluster, "predicted_lag", cluster.lag_records)(i)


class LatencySLO(PredictedStaleness):
    """Predicted-staleness routing with a serve-latency SLO on top: a
    replica whose merged `olap_serve_seconds{replica=i}` p99 exceeds
    `slo_factor` x the fleet median (with at least `min_count` serves
    observed, so cold replicas aren't judged on noise) is steered around.

    The p99s come straight from the `repro_torch.obs` histograms the serve path
    already populates — no new instrumentation — and are refreshed every
    `refresh` choices (histogram merging walks bucket arrays; per-choice
    recomputation would put O(replicas x buckets) on the route stage).
    The filter NEVER empties the eligible set: when every replica busts
    the SLO there is no better replica to steer to, so staleness alone
    decides."""

    name = "latency_slo"
    predictive = True

    def __init__(self, max_lag: int = 100, *, slo_factor: float = 3.0,
                 min_count: int = 20, refresh: int = 64) -> None:
        super().__init__(max_lag)
        self.slo_factor = slo_factor
        self.min_count = min_count
        self.refresh = refresh
        self._slow: set[int] = set()
        self._choices = 0

    def _refresh_slow(self, cluster) -> None:
        p99s = {}
        for i in range(len(cluster.replicas)):
            s = REGISTRY.hist_summary("olap_serve_seconds", replica=i)
            if s["count"] >= self.min_count:
                p99s[i] = s["p99_us"]
        self._slow = set()
        if len(p99s) >= 2:
            med = sorted(p99s.values())[len(p99s) // 2]
            if med > 0:
                self._slow = {i for i, p in p99s.items()
                              if p > self.slo_factor * med}

    def _eligible(self, cluster, max_lag: Optional[int],
                  min_lsn: int = 0) -> list[int]:
        if self._choices % self.refresh == 0:
            self._refresh_slow(cluster)
        self._choices += 1
        base = super()._eligible(cluster, max_lag, min_lsn)
        healthy = [i for i in base if i not in self._slow]
        return healthy or base


def make_policy(spec: Union[str, RoutingPolicy], *,
                max_lag: int = 100) -> RoutingPolicy:
    """Resolve a policy spec: an instance passes through; a name constructs
    one ('bounded_staleness' / 'predicted_staleness' / 'latency_slo' take
    `max_lag` as their default bound)."""
    if isinstance(spec, RoutingPolicy):
        return spec
    if spec == "freshest":
        return Freshest()
    if spec == "round_robin":
        return RoundRobin()
    if spec == "bounded_staleness":
        return BoundedStaleness(max_lag)
    if spec == "predicted_staleness":
        return PredictedStaleness(max_lag)
    if spec == "latency_slo":
        return LatencySLO(max_lag)
    raise ValueError(f"unknown routing policy {spec!r}")
