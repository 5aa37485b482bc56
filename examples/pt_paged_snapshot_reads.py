"""Page-granular snapshot reads on the PyTorch/CUDA port (`repro_torch`):
the SI-V read protocol on the GPU, with the version_gather and rss_gather
CUDA kernels.  The twin of `examples/paged_snapshot_reads.py`, in four
parts, asserting what it asserts.

Part 1: a writer streams page updates into a K-slot paged store while
readers resolve consistent snapshots at different watermarks — including
an RSS *member-set* read that skips a newer version whose writer is
outside the RSS (the paper's previous-version read), served by the
rss_gather kernel.

Part 2: the same protocol end-to-end through the HTAP stack — an SSI
engine runs transactions, its WAL is mirrored into the paged store
(`tensorstore.mirror.PagedMirror`), an RSS snapshot is constructed from
the same WAL, and the rss_gather kernel answers a batched membership scan
over the mirrored pages that matches the engine's per-key protected reads.

Parts 3 and 4: a GROUP BY through both HTAP facades, and a materialized
dashboard served from commit-delta folds.

    PYTHONPATH=src python examples/pt_paged_snapshot_reads.py            # GPU
    PYTHONPATH=src python examples/pt_paged_snapshot_reads.py --device cpu

On "cuda" every kernel is the CUDA kernel; on "cpu" the wrappers take
their plain PyTorch versions.
"""

import argparse
import random

import torch

from repro_torch.kernels.rss_gather.ops import \
    snapshot_read_members as kernel_members
from repro_torch.kernels.version_gather.ops import snapshot_read
from repro_torch.tensorstore import (gather_pages, init_store, publish_page,
                                     snapshot_read_ref,
                                     visible_slots_members)


def main(device: str = "cuda") -> None:
    P, K, E = 8, 3, 16
    store = init_store(P, K, E, torch.float32,
                       initial=torch.zeros((P, E)), device=device)
    dev = store["data"].device
    print(f"paged store on {dev}: {P} pages × {K} version slots × {E} elems")

    # writer commits at ts 10, 20, 30 touching different pages
    publish_page(store, 2, torch.full((E,), 1.0), 10)
    publish_page(store, 2, torch.full((E,), 2.0), 20)
    publish_page(store, 5, torch.full((E,), 7.0), 30)

    for wm in (5, 15, 25, 35):
        out = snapshot_read(store, wm)                   # version_gather
        ref = snapshot_read_ref(store, wm)               # plain oracle
        assert torch.equal(out, ref)
        print(f"watermark {wm:2d}: page2={float(out[2, 0]):.0f} "
              f"page5={float(out[5, 0]):.0f}  (kernel == oracle)")

    # RSS member-set read: ts=20's writer is NOT in the RSS (e.g. concurrent
    # with an active txn) -> the reader sees the PREVIOUS version (ts=10)
    members = torch.tensor([10, 30], dtype=torch.int32, device=dev)
    out = kernel_members(store, members)                 # rss_gather
    slots = visible_slots_members(store["ts"], members)
    ref = store["data"][torch.arange(P, device=dev), slots.long()]
    assert torch.equal(out, ref)
    assert float(out[2, 0]) == 1.0 and float(out[5, 0]) == 7.0
    print(f"RSS member read (members ts=10,30): page2="
          f"{float(out[2, 0]):.0f} (skipped ts=20 non-member) "
          f"page5={float(out[5, 0]):.0f}  (rss_gather kernel == oracle)")

    # an EMPTY RSS resolves every page to its initial version
    out = kernel_members(store, torch.zeros((0,), dtype=torch.int32,
                                            device=dev))
    assert not out.any()
    print(f"empty-RSS read: page2={float(out[2, 0]):.0f} "
          f"page5={float(out[5, 0]):.0f}  (initial slots)")

    # columnar multi-page gather: a key-range of pages as a device
    # sub-store (dense ranges slice, arbitrary sets gather)
    sub = gather_pages(store, [2, 5])
    out = snapshot_read(sub, 35)
    assert float(out[0, 0]) == 2.0 and float(out[1, 0]) == 7.0
    print(f"gather_pages([2,5]) @35: {float(out[0, 0]):.0f}, "
          f"{float(out[1, 0]):.0f}  (columnar sub-store scan)")

    mirrored_htap_demo(device)
    group_by_demo(device)
    materialized_dashboard_demo(device)


def mirrored_htap_demo(device: str) -> None:
    """WAL -> paged mirror -> rss_gather: device-backed OLAP on live HTAP."""
    from repro_torch.core.replica import PRoTManager, RSSManager
    from repro_torch.mvcc import Engine
    from repro_torch.tensorstore import (AggOp, AggPlan, ChainVersionStore,
                                         PagedMirror, PagedVersionStore)
    from repro_torch.tensorstore.mirror import decode_value

    print("\n-- WAL-mirrored paged store (device-backed OLAP surface) --")
    eng = Engine("ssi")
    t = eng.begin()
    for i in range(6):
        eng.write(t, f"stock:0:{i}", 100)
    eng.commit(t)
    t1 = eng.begin(); eng.write(t1, "stock:0:0", 61); eng.commit(t1)
    t2 = eng.begin()                                   # stays active ...
    eng.write(t2, "stock:0:1", 7)
    t3 = eng.begin(); eng.write(t3, "stock:0:2", 43); eng.commit(t3)
    # ... so t3 is committed but NOT Clear: outside the RSS

    rss = RSSManager()
    prot = PRoTManager(rss)
    rss.catch_up(eng.wal)
    rss.construct()
    mirror = PagedMirror(device=device)
    mirror.catch_up(eng.wal, gc_floor=prot.gc_floor_seq())
    _, snap = prot.acquire()
    print(f"mirror: {mirror.n_pages} pages @ lsn {mirror.applied_lsn}, "
          f"RSS floor_seq={snap.floor_seq} "
          f"above-floor members={sorted(snap.txns)}")

    keys = [f"stock:0:{i}" for i in range(6)]
    host = mirror.scan_members(keys, snap)       # batched numpy scan
    member_ts = rss.member_seqs(snap)
    assert list(mirror.member_seqs_for(snap)) == member_ts
    # the same scan through the rss_gather kernel on the exported store
    out = kernel_members(mirror.torch_store(), member_ts,
                         snap.floor_seq).cpu().numpy()
    dev = [decode_value(out[mirror.page_of[k]]) for k in keys]
    r = eng.begin(read_only=True, rss=snap)      # engine per-key oracle
    oracle = [eng.read(r, k) for k in keys]
    assert host == dev == oracle, (host, dev, oracle)
    print(f"RSS scan over mirror: {host}")
    print("  stock:0:0=61 (t1 in RSS), stock:0:2=100 (t3 committed but "
          "concurrent with active t2 -> previous version)")
    print("  mirror scan == rss_gather kernel == engine per-key reads")

    # the same read set as ONE fused rss_scan_agg pass on the device
    plan = AggPlan(tuple(keys), AggOp("count_below", "int", 80))
    fused = PagedVersionStore(mirror).execute(plan, snap)
    chain = ChainVersionStore(eng.store).execute(plan, snap)
    assert fused == chain == sum(1 for v in oracle if v < 80)
    print(f"fused agg (count stock < 80) = {fused}  "
          "(rss_scan_agg kernel == chain-oracle plan == python reduce)")


def group_by_demo(device: str) -> None:
    """GROUP BY district revenue through BOTH HTAP facades: one
    `GroupByPlan` with compound (sum, count) ops."""
    from repro_torch.mvcc.htap import MultiNodeHTAP, SingleNodeHTAP
    from repro_torch.mvcc.workload import Scale, load_initial
    from repro_torch.tensorstore import AggOp, GroupByPlan, ScanPlan

    print("\n-- plan-first executor: GROUP BY district revenue (AVG via "
          "compound sum+count) --")
    sc = Scale(warehouses=2, districts=2, customers=4, items=8)
    ops = (AggOp("sum", "total"), AggOp("count", "total"))

    def seed_orders(engine):
        load_initial(engine, sc)
        rng = random.Random(7)
        for w in range(sc.warehouses):
            for d in range(sc.districts):
                for o in range(rng.randrange(1, 4)):
                    t = engine.begin()
                    engine.write(t, f"district:{w}:{d}",
                                 {"next_o_id": o + 1, "ytd": 0})
                    engine.write(t, f"order:{w}:{d}:{o}",
                                 {"items": [1],
                                  "total": rng.randrange(50, 500)})
                    engine.commit(t)

    def district_plan(dists, dkeys):
        groups = []
        for dk, dist in zip(dkeys, dists):
            _, w, d = dk.split(":")
            hi = (dist or {"next_o_id": 0})["next_o_id"]
            groups.append(tuple(f"order:{w}:{d}:{o}" for o in range(hi)))
        return GroupByPlan(tuple(groups), ops)

    dkeys = sc.all_district_keys()
    sn = SingleNodeHTAP("ssi+rss", paged=True, check_scans=True,
                        reserve_keys=sc.key_families(), device=device)
    seed_orders(sn.engine)
    sn.refresh_rss()
    t = sn.olap_begin()
    dists = sn.olap_execute(t, ScanPlan(tuple(dkeys)))
    rows_single = sn.olap_execute(t, district_plan(dists, dkeys))
    sn.olap_commit(t)

    mn = MultiNodeHTAP("ssi+rss", paged_olap=True, check_scans=True,
                       n_replicas=2, reserve_keys=sc.key_families(),
                       device=device)
    seed_orders(mn.primary)
    mn.ship_log()
    snap = mn.olap_snapshot()
    dists = mn.olap_execute(snap, ScanPlan(tuple(dkeys)))
    rows_multi = mn.olap_execute(snap, district_plan(dists, dkeys))
    mn.olap_release(snap)

    assert rows_single == rows_multi    # same WAL -> same snapshot-set read
    for dk, (s, n) in zip(dkeys, rows_single):
        print(f"  {dk}: revenue={s:4d} orders={n} "
              f"avg={s // n if n else 0:3d}")
    print("  single-node == multi-node facade (check_scans asserted "
          "fused == per-key oracle)")


def materialized_dashboard_demo(device: str) -> None:
    """Hot plans registered as materialized views serve each refresh from
    a live device tile advanced by commit-delta folds."""
    from repro_torch.mvcc.htap import SingleNodeHTAP
    from repro_torch.mvcc.workload import Scale, load_initial

    print("\n-- materialized dashboard: commit-delta folds, O(delta) "
          "serves --")
    sc = Scale(warehouses=2, districts=2, customers=4, items=8)
    plan = sc.stock_overview_plan()         # sum/count/min/count_above>90
    htap = SingleNodeHTAP("ssi+rss", paged=True, check_scans=True,
                          reserve_keys=sc.key_families(),
                          materialize=[plan], device=device)
    load_initial(htap.engine, sc)
    rng = random.Random(3)
    stock_keys = list(sc.all_stock_keys())
    for tick in range(4):
        for _ in range(3):                  # OLTP traffic between refreshes
            t = htap.oltp_begin()
            htap.engine.write(t, rng.choice(stock_keys),
                              rng.randrange(0, 120))
            htap.engine.commit(t)
        htap.refresh_rss()                  # ships delta, folds into tile
        t = htap.olap_begin()
        s, n, mn, hi = htap.olap_execute(t, plan)
        htap.olap_commit(t)
        print(f"  tick {tick}: stock sum={s} count={n} min={mn} "
              f">90={hi}")
    stats = dict(htap.mirror.exec_stats)
    assert stats["view_hits"] > 0, stats
    print(f"  view hits={stats['view_hits']} "
          f"fallbacks={stats['view_fallbacks']} "
          f"demotions={stats['view_demotions']}  (check_scans asserted "
          "tile == fused scan == per-key oracle every serve)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; needs a GPU) or "cpu"')
    main(ap.parse_args().device)
