"""Decoupled-storage replica cluster: N-way WAL fan-out with lag-aware
RSS snapshot routing (paper Sec 5.1 generalized to N replicas).

  cluster.py  ReplicaCluster — fan-out, min-LSN WAL recycling, routing
              (+ ship-cadence tracking for predicted-lag serves),
              session-token enforcement, cluster-wide GC floor
  routing.py  Freshest / RoundRobin / BoundedStaleness /
              PredictedStaleness / LatencySLO policies (+ ship-then-serve
              fallback when every replica is too stale, token-aware
              eligibility from below)
  session.py  Session — per-client token (last-commit LSN + last-read
              horizon) for read-your-writes / monotonic reads across the
              fleet
"""

from .cluster import ReplicaCluster, SnapshotHandle
from .routing import (BoundedStaleness, Freshest, LatencySLO,
                      PredictedStaleness, RoundRobin, RoutingPolicy,
                      make_policy)
from .session import Session

__all__ = [
    "ReplicaCluster", "SnapshotHandle", "Session",
    "RoutingPolicy", "Freshest", "RoundRobin", "BoundedStaleness",
    "PredictedStaleness", "LatencySLO", "make_policy",
]
