"""Decoupled-storage replica cluster: N-way WAL fan-out with lag-aware
RSS snapshot routing (the paper's Sec 5.1 architecture at N > 1), on the
PyTorch/CUDA port (`repro_torch`).  The twin of
`examples/cluster_fanout.py`: for the same seed its output is the
reference's, line for line.

One OLTP primary ships its WAL to three replicas on skewed cadences, so the
fleet carries genuinely different replication lags.  The demo then shows:

  1. fan-out + bounded log: every replica applies the same stream; the
     primary recycles the WAL only up to min(applied LSN) across consumers,
  2. routing policies: freshest / round_robin / bounded_staleness, and the
     ship-then-serve fallback when every replica is too stale,
  3. serializability across the fleet: every replica's RSS snapshot serves
     the same wait-free, abort-free reads the primary's protected readers
     see — regardless of its lag,
  4. the cluster-wide GC floor: version chains prune everywhere once the
     laggiest replica (or oldest pin) moves past them.

    PYTHONPATH=src python examples/pt_cluster_fanout.py              # GPU
    PYTHONPATH=src python examples/pt_cluster_fanout.py --device cpu

The replicas are placed on the device; this demo serves chain reads.
"""

import argparse
import random

from repro_torch.cluster import make_policy
from repro_torch.mvcc import MultiNodeHTAP
from repro_torch.tensorstore import ScanPlan


def oltp_burst(eng, rng, n_txns):
    """A burst of small writer transactions (some concurrency, some deps)."""
    for _ in range(n_txns):
        t = eng.begin()
        for _ in range(rng.randint(1, 3)):
            eng.write(t, f"k{rng.randrange(8)}", rng.randrange(1000))
        try:
            eng.commit(t)
        except Exception:
            pass


def show_lags(htap, label):
    cl = htap.cluster
    lags = [cl.lag_records(i) for i in range(len(cl))]
    print(f"  {label}: wal [{htap.primary.wal.base_lsn}.."
          f"{htap.primary.wal.head_lsn}]  replica lags {lags} records")


def main(device: str = "cuda"):
    rng = random.Random(0)
    htap = MultiNodeHTAP("ssi+rss", n_replicas=3,
                         route_policy="bounded_staleness", max_staleness=30,
                         device=device)
    eng = htap.primary
    cl = htap.cluster
    print(f"cluster: 1 primary -> {len(cl)} replicas "
          f"(policy={cl.policy.name}, max_lag={cl.policy.max_lag} records)")

    # -- 1. skewed fan-out + min-LSN log recycling --------------------------
    print("\n-- skewed fan-out: replicas ship on different cadences --")
    for round_ in range(3):
        oltp_burst(eng, rng, 12)
        htap.ship_log(replica=0)                 # replica 0: every round
        if round_ % 2 == 0:
            htap.ship_log(replica=1)             # replica 1: every other
        show_lags(htap, f"round {round_} (replica 2 never shipped)")
    assert eng.wal.base_lsn == cl.min_applied_lsn() == 0
    print("  -> laggiest consumer holds the log: base_lsn stays 0")
    htap.ship_log(replica=2)
    show_lags(htap, "after replica 2 finally ships")
    print(f"  -> WAL recycled up to min applied LSN "
          f"({cl.stats['truncated_records']} records)")

    # -- 2. routing policies ------------------------------------------------
    print("\n-- routing: who serves the next snapshot? --")
    oltp_burst(eng, rng, 10)
    htap.ship_log(replica=0)                     # make the lags unequal
    show_lags(htap, "state")
    for policy in ("freshest", "round_robin"):
        picks = []
        cl.policy = make_policy(policy)
        for _ in range(4):
            h = htap.olap_snapshot()
            picks.append(h[1])
            htap.olap_release(h)
        print(f"  {policy:17s} -> replicas {picks}")
    cl.policy = make_policy("bounded_staleness", max_lag=5)
    oltp_burst(eng, rng, 6)                      # now EVERY replica is stale
    before = cl.stats["ship_then_serve"]
    h = htap.olap_snapshot()
    print(f"  bounded(max_lag=5) -> replica {h[1]} "
          f"(ship-then-serve: +{cl.stats['ship_then_serve'] - before} "
          f"sync round, lag now {cl.lag_records(h[1])})")
    htap.olap_release(h)

    # -- 3. fleet-wide serializable snapshot reads --------------------------
    print("\n-- every replica serves the same wait-free RSS reads --")
    t = eng.begin(); eng.write(t, "k0", 7777)    # stays active: not Clear
    oltp_burst(eng, rng, 4)
    htap.ship_log()                              # whole fleet to head
    keys = [f"k{i}" for i in range(4)]
    rows = []
    for i in range(len(cl)):
        rid, snap = cl.replicas[i].rss_snapshot()
        rows.append(cl.replicas[i].execute_rss(snap,
                                               ScanPlan(tuple(keys))))
        cl.replicas[i].release(rid)
    assert rows[0] == rows[1] == rows[2]
    print(f"  scan {keys} -> {rows[0]}  (identical on all 3 replicas; "
          f"active txn's write invisible)")
    eng.abort(t)

    # -- 4. cluster-wide GC floor -------------------------------------------
    print("\n-- cluster-wide GC floor --")
    oltp_burst(eng, rng, 20)
    htap.ship_log(replica=0)
    held = htap.gc_versions()
    floor = cl.gc_floor_seq()
    print(f"  replicas 1,2 lag -> floor seq {floor}, pruned {held} versions")
    htap.ship_log()
    pruned = htap.gc_versions()
    print(f"  fleet caught up  -> floor seq {cl.gc_floor_seq()}, "
          f"pruned {pruned} more (chains bounded everywhere)")
    print("\ncluster fan-out demo OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
