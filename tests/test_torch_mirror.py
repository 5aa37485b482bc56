"""Mirror parity: the same WAL fed into the reference `PagedMirror` (Pallas
kernels in interpret mode) and the port's (device="cpu", plain PyTorch
versions), the same plans served at the same RSS and watermark snapshots.

Results, writers, `exec_stats`, `range_stats`, the resolve-cache counters
and the kernel layer's launch accounting must be equal; materialized views
must match through register, fold, demote and serve.  Every plan kind is
driven (ScanPlan, AggPlan, MultiAggPlan, GroupByPlan, BatchPlan) through
every grouped strategy (host, flat, chunked), under replication lag, PRoT
pins, RSS GC and K-slot recycling.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore  # noqa: E402
import repro.tensorstore as rts  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.tensorstore as tts  # noqa: E402
from repro.kernels.rss_scan_agg import ops as jops  # noqa: E402
from repro_torch.kernels.rss_scan_agg import ops as tops  # noqa: E402

STOCK = [f"stock:{i}" for i in range(72)]
ORDERS = [f"order:0:{d}:{o}" for d in range(3) for o in range(3)]
KEYS = STOCK + ["warehouse:0", "district:0:0"] + ORDERS

OPS = [("sum", "int", None), ("count", "int", None),
       ("count_below", "int", 50), ("min", "int", None),
       ("max", "int", None), ("count_above", "int", 90),
       ("sum_below", "int", 100), ("sum", "total", None),
       ("count", "total", None), ("max", "total", None)]

# materializable plans (duplicate-free key groups), as specs
VIEW_SPECS = [
    ("multi", tuple(STOCK[:8]), tuple(OPS[:7])),
    ("group", (tuple(STOCK[:4]), tuple(STOCK[4:8])), (OPS[0], OPS[4])),
    ("multi", tuple(ORDERS[:2]), (OPS[7], OPS[8])),
]


def _value(rng, key):
    if key.startswith("district"):
        return {"next_o_id": rng.randrange(40), "ytd": rng.randrange(99)}
    if key.startswith("order"):
        return {"items": [rng.randrange(9) for _ in range(rng.randrange(4))],
                "total": rng.randrange(500)}
    return rng.randrange(-100, 200)


def _events(seed, steps=110, legacy_prob=0.1):
    """A WAL-shaped event stream (begin / commit with writes / deps /
    abort), replayable into either package's `Wal`."""
    rng = random.Random(seed)
    events, active, tid = [], [], 0
    for _ in range(steps):
        act = rng.random()
        if act < 0.35 or not active:
            tid += 1
            events.append(("begin", tid))
            active.append(tid)
        elif act < 0.8:
            t = active.pop(rng.randrange(len(active)))
            writes = [(k, _value(rng, k))
                      for k in rng.sample(KEYS, rng.randint(1, 4))]
            events.append(("commit", t, writes, rng.random() < legacy_prob))
            if active and rng.random() < 0.5:
                events.append(("deps", t, sorted(rng.sample(
                    active, rng.randint(1, min(2, len(active)))))))
        else:
            events.append(("abort", active.pop(rng.randrange(len(active)))))
    return events


def _plan_specs(seed):
    rng = random.Random(1000 + seed)
    some = lambda n: tuple(rng.sample(KEYS, n)) + ("missing:key",)
    agg = ("agg", some(20), rng.choice(OPS))
    multi = ("multi", tuple(STOCK), tuple(OPS[:7]))
    group_flat = ("group", (tuple(STOCK[:30]), tuple(STOCK[30:]),
                            tuple(ORDERS)), (OPS[0], OPS[4], OPS[7]))
    group_wide = ("group", tuple((k,) for k in STOCK[:40]),
                  (OPS[0], OPS[3]))
    group_small = ("group", (tuple(ORDERS[:4]), tuple(ORDERS[4:])),
                   (OPS[7], OPS[8]))
    return [("scan", some(12)), ("agg", tuple(STOCK), OPS[2]), agg, multi,
            group_flat, group_wide, group_small,
            ("batch", (agg, ("agg", tuple(STOCK), OPS[4]), group_small)),
            ("batch", (multi, group_wide))]


def _build(ts, spec):
    kind, body = spec[0], spec[1]
    op = lambda o: ts.AggOp(*o)
    if kind == "scan":
        return ts.ScanPlan(body)
    if kind == "agg":
        return ts.AggPlan(body, op(spec[2]))
    if kind == "multi":
        return ts.MultiAggPlan(body, tuple(map(op, spec[2])))
    if kind == "group":
        return ts.GroupByPlan(body, tuple(map(op, spec[2])))
    return ts.BatchPlan(tuple(_build(ts, s) for s in body))


class _Side:
    """One package's replica-side stack: WAL, RSSManager + PRoT pins,
    paged mirror and its version store."""

    def __init__(self, core, ts, events, *, slots, grouped_mode, **kw):
        self.core, self.ts = core, ts
        self.wal = core.Wal()
        for ev in events:
            if ev[0] == "begin":
                self.wal.log_begin(ev[1])
            elif ev[0] == "commit":
                seq = 0 if ev[3] else self.wal.head_lsn + 1
                self.wal.log_commit(ev[1], ev[2], seq=seq)
            elif ev[0] == "deps":
                self.wal.log_deps(ev[1], ev[2])
            else:
                self.wal.log_abort(ev[1])
        self.man = core.RSSManager()
        self.prot = core.PRoTManager(self.man)
        self.mirror = ts.PagedMirror(slots=slots, **kw)
        self.mirror.grouped_mode = grouped_mode
        self.paged = ts.PagedVersionStore(self.mirror)
        self.pins = []

    def ship(self, n):
        for rec in self.wal.tail(self.man.applied_lsn):
            self.man.apply(rec)
            self.mirror.apply(rec, gc_floor=self.prot.gc_floor_seq())
            n -= 1
            if n <= 0:
                break
        snap = self.man.construct()
        self.mirror.advance_views(snap)
        return snap

    def snapshots(self, snap):
        return [snap, self.mirror.watermark] + [p[1] for p in self.pins]

    def gc(self):
        self.man.gc(keep_lsn=self.prot.gc_floor(),
                    keep_seq=self.prot.gc_floor_seq())
        self.mirror.gc_views(self.prot.gc_floor_seq())


def _stats(mirror):
    return (dict(mirror.exec_stats), dict(mirror.range_stats),
            dict(mirror.cache_stats))


def _launch_stats(rename):
    d = dict(jops.LAUNCH_STATS if rename else tops.LAUNCH_STATS)
    if rename:
        d["device_calls"] = d.pop("pallas_calls")
    return d


def run_twins(seed, *, grouped_mode=None, slots=64, views=False,
              resolve_cache=True):
    events = _events(seed)
    ref = _Side(rcore, rts, events, slots=slots, grouped_mode=grouped_mode,
                resolve_cache=resolve_cache)
    port = _Side(tcore, tts, events, slots=slots, grouped_mode=grouped_mode,
                 resolve_cache=resolve_cache, device="cpu")
    specs = _plan_specs(seed)
    if views:
        for side in (ref, port):
            for spec in VIEW_SPECS:
                side.mirror.register_view(_build(side.ts, spec))
        specs = VIEW_SPECS + specs[:2]
    jops.reset_launch_stats()
    tops.reset_launch_stats()
    rng = random.Random(seed)
    while ref.man.applied_lsn < ref.wal.head_lsn:
        n = rng.randint(1, 15)
        snaps = list(zip(ref.snapshots(ref.ship(n)),
                         port.snapshots(port.ship(n))))
        for s_ref, s_port in snaps:
            for spec in rng.sample(specs, 3):
                want, ww = ref.paged.execute_with_writers(
                    _build(rts, spec), s_ref)
                got, gw = port.paged.execute_with_writers(
                    _build(tts, spec), s_port)
                assert want == got, (seed, spec[0], want, got)
                assert ww == gw, (seed, spec[0])
        if views:
            for (pr, vr), (pp, vp) in zip(ref.mirror.views.items(),
                                          port.mirror.views.items()):
                assert vr.degraded == vp.degraded
                if not vr.degraded:
                    assert vr.serve_rows() == vp.serve_rows()
                    assert vr.watermark == vp.watermark
        if rng.random() < 0.3:
            for side in (ref, port):
                side.pins.append(side.prot.acquire())
        if ref.pins and rng.random() < 0.3:
            i = rng.randrange(len(ref.pins))
            for side in (ref, port):
                side.prot.release(side.pins.pop(i)[0])
        if rng.random() < 0.4:
            ref.gc()
            port.gc()
    assert _stats(ref.mirror) == _stats(port.mirror)
    assert _launch_stats(True) == _launch_stats(False)
    return port.mirror


@pytest.mark.parametrize("seed,mode", [(0, None), (1, "flat"),
                                       (2, "chunked"), (3, "host")])
def test_mirrors_serve_equal_plans(seed, mode):
    mirror = run_twins(seed, grouped_mode=mode)
    assert mirror.exec_stats["agg_dispatches"] > 0


def test_mirrors_equal_under_slot_recycling_without_cache():
    run_twins(5, slots=3, resolve_cache=False)


@pytest.mark.parametrize("seed", range(2))
def test_materialized_views_match(seed):
    mirror = run_twins(seed, views=True)
    st = mirror.exec_stats
    assert st["view_hits"] and st["view_fallbacks"] and st["view_demotions"]


def _ref_mirror(seed):
    events = _events(seed)
    ref = _Side(rcore, rts, events, slots=8, grouped_mode=None)
    while ref.man.applied_lsn < ref.wal.head_lsn:
        snap = ref.ship(7)
    return ref, snap


def _port_snapshot(s):
    return tcore.RssSnapshot(lsn=s.lsn, txns=s.txns, floor_seq=s.floor_seq,
                             member_seqs=s.member_seqs)


def test_from_numpy_state_serves_like_reference():
    ref, snap = _ref_mirror(4)
    m = ref.mirror
    port = tts.PagedMirror.from_numpy_state(
        m.data, m.ts, m.writer, m.page_of, m.keys, m.commit_seq,
        m.watermark, m.applied_lsn, device="cpu")
    store = tts.PagedVersionStore(port)
    assert port.slots == m.slots and port.n_pages == m.n_pages
    for spec in _plan_specs(4):
        for s_ref, s_port in [(snap, _port_snapshot(snap)),
                              (m.watermark, m.watermark), (3, 3)]:
            assert ref.paged.execute_with_writers(_build(rts, spec), s_ref) \
                == store.execute_with_writers(_build(tts, spec), s_port)


def test_exported_stores_equal_reference():
    ref, _ = _ref_mirror(1)
    m = ref.mirror
    port = tts.PagedMirror.from_numpy_state(
        m.data, m.ts, m.writer, m.page_of, m.keys, m.commit_seq,
        m.watermark, m.applied_lsn, device="cpu")
    want, got = m.jnp_store(), port.torch_store()
    for k in ("data", "ts"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    for pages in (m.page_index(STOCK[5:30]),
                  m.page_index(["missing:key"] + ORDERS + STOCK[:3]),
                  np.zeros(0, np.int64)):
        want, got = m.jnp_store_for(pages), port.torch_store_for(pages)
        for k in ("data", "ts"):
            np.testing.assert_array_equal(np.asarray(want[k]),
                                          got[k].numpy())
    assert dict(m.range_stats) == dict(port.range_stats)
