"""A miniature CH-BenCHmark: TPC-C-style writers + TPC-H-style analytics.

Schema (flat keyspace):
  warehouse:{w}              -> ytd balance
  district:{w}:{d}           -> {"next_o_id": int, "ytd": int}
  customer:{w}:{d}:{c}       -> balance
  stock:{w}:{i}              -> quantity
  order:{w}:{d}:{o}          -> {"items": [...], "total": int}

OLTP transactions (the paper's writers): new_order, payment, order_status
(read-only OLTP — runs under SSI, not RSS, per Sec 5.2).
OLAP queries (scan-heavy, long-running): stock_level_scan, customer_balance,
order_revenue, district_revenue_group (GROUP BY district, AVG via compound
sum+count), district_revenue_all (its statically-keyed, materializable
twin), stock_overview (multi-statistic compound incl. a pushed-down
count_above predicate) — read sets of
hundreds of keys, the shape that makes SSI writer-abort OLTP transactions
(Fig. 5/7) and SafeSnapshots reader-wait.  `Scale.materialized_plans()`
names the fixed-key plans worth a live accumulator tile.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator

from ..tensorstore.version_store import (AggOp, AggPlan, GroupByPlan,
                                         MultiAggPlan, ScanPlan)


@dataclass(frozen=True)
class Scale:
    warehouses: int = 4
    districts: int = 4        # per warehouse
    customers: int = 20       # per district
    items: int = 50           # stock rows per warehouse
    order_capacity: int = 8   # statically-addressable orders per district

    def all_stock_keys(self) -> list[str]:
        return [f"stock:{w}:{i}" for w in range(self.warehouses)
                for i in range(self.items)]

    def all_customer_keys(self) -> list[str]:
        return [f"customer:{w}:{d}:{c}" for w in range(self.warehouses)
                for d in range(self.districts) for c in range(self.customers)]

    def all_district_keys(self) -> list[str]:
        return [f"district:{w}:{d}" for w in range(self.warehouses)
                for d in range(self.districts)]

    def order_range_keys(self, w: int, d: int) -> list[str]:
        """The district's statically-addressable order key range (the
        first `order_capacity` o_ids) — a FIXED key set, so plans over it
        fingerprint identically query to query and can be materialized
        (unwritten order keys decode to 0, which no "total"-field
        aggregate counts)."""
        return [f"order:{w}:{d}:{o}" for o in range(self.order_capacity)]

    def key_families(self) -> list[str]:
        """Every statically-known workload key, family-major and in the
        exact order the OLAP plans enumerate them — reserve these
        contiguously in a `PagedMirror` so dense plans resolve to page
        RANGES (the `paged.as_page_range` slice fast path) instead of
        gathers.  Each district's first `order_capacity` order keys are
        reserved too (the static revenue plan's ranges); o_ids past the
        capacity are allocated on demand."""
        return ([f"warehouse:{w}" for w in range(self.warehouses)]
                + self.all_district_keys()
                + self.all_customer_keys()
                + self.all_stock_keys()
                + [k for w in range(self.warehouses)
                   for d in range(self.districts)
                   for k in self.order_range_keys(w, d)])

    # ---------------------------------------------- registrable plan builders
    # Frozen plan dataclasses hash by value, so plans built here always
    # fingerprint-match the registry entries `materialized_plans` seeds —
    # the queries below construct their batched shapes through these.
    def stock_level_plan(self) -> AggPlan:
        return AggPlan(tuple(self.all_stock_keys()),
                       AggOp("count_below", "int", 50))

    def customer_balance_plan(self) -> AggPlan:
        return AggPlan(tuple(self.all_customer_keys()), AggOp("sum", "int"))

    def stock_overview_plan(self) -> MultiAggPlan:
        return MultiAggPlan(
            tuple(self.all_stock_keys()),
            (AggOp("sum", "int"), AggOp("count", "int"), AggOp("min", "int"),
             AggOp("count_above", "int", 90)))

    def district_revenue_plan(self) -> GroupByPlan:
        return GroupByPlan(
            tuple(tuple(self.order_range_keys(w, d))
                  for w in range(self.warehouses)
                  for d in range(self.districts)),
            (AggOp("sum", "total"), AggOp("count", "total")))

    def materialized_plans(self) -> tuple:
        """The hot statically-keyed OLAP plans worth a live accumulator
        tile (`materialize=` on the HTAP facades): every batched query
        over a fixed key range.  `district_revenue_group` stays
        unregistrable by design — its key ranges chase next_o_id, so its
        fingerprint changes query to query."""
        return (self.stock_level_plan(), self.customer_balance_plan(),
                self.stock_overview_plan(), self.district_revenue_plan())


# Each yielded step is ('r', key) or ('w', key, update_fn) where update_fn
# maps the read value to the written value;  ('olap', plan) to execute a
# query plan (`tensorstore.Plan`: ScanPlan / AggPlan / MultiAggPlan /
# GroupByPlan) in ONE plan-execution seam call — the generator receives
# the plan's result (a value list for ScanPlan; scalars/tuples for the
# aggregate plans, which never materialize values on host);  or
# ('out', value) to emit a result.  The driver executes steps against an
# engine transaction.  (Legacy ('scan', keys) / ('agg', keys, op) step
# kinds are still served, as ScanPlan/AggPlan shims.)
Step = tuple


def new_order(rng: random.Random, sc: Scale) -> Iterator[Step]:
    w = rng.randrange(sc.warehouses)
    d = rng.randrange(sc.districts)
    dk = f"district:{w}:{d}"
    dist = yield ("r", dk)
    o_id = (dist or {"next_o_id": 0})["next_o_id"]
    yield ("w", dk, {"next_o_id": o_id + 1, "ytd": (dist or {}).get("ytd", 0)})
    n_items = rng.randint(5, 15)
    total = 0
    items = []
    for _ in range(n_items):
        i = rng.randrange(sc.items)
        skey = f"stock:{w}:{i}"
        qty = yield ("r", skey)
        qty = qty if isinstance(qty, int) else 100
        take = rng.randint(1, 10)
        newq = qty - take if qty - take >= 10 else qty - take + 91
        yield ("w", skey, newq)
        total += take
        items.append(i)
    yield ("w", f"order:{w}:{d}:{o_id}", {"items": items, "total": total})


def payment(rng: random.Random, sc: Scale) -> Iterator[Step]:
    w = rng.randrange(sc.warehouses)
    d = rng.randrange(sc.districts)
    cu = rng.randrange(sc.customers)
    amount = rng.randint(1, 5000)
    wkey = f"warehouse:{w}"
    bal = yield ("r", wkey)
    yield ("w", wkey, (bal if isinstance(bal, int) else 0) + amount)
    ckey = f"customer:{w}:{d}:{cu}"
    cbal = yield ("r", ckey)
    yield ("w", ckey, (cbal if isinstance(cbal, int) else 0) - amount)


def order_status(rng: random.Random, sc: Scale) -> Iterator[Step]:
    """Read-only OLTP transaction (stays under SSI per the paper Sec 5.2)."""
    w = rng.randrange(sc.warehouses)
    d = rng.randrange(sc.districts)
    dist = yield ("r", f"district:{w}:{d}")
    o_id = max(((dist or {"next_o_id": 1})["next_o_id"]) - 1, 0)
    order = yield ("r", f"order:{w}:{d}:{o_id}")
    yield ("out", order)


OLTP_MIX = ((new_order, 0.45), (payment, 0.43), (order_status, 0.12))


def oltp_transaction(rng: random.Random, sc: Scale):
    x = rng.random()
    acc = 0.0
    for fn, p in OLTP_MIX:
        acc += p
        if x <= acc:
            return fn(rng, sc), fn.__name__
    return payment(rng, sc), "payment"


# ----------------------------------------------------------------- OLAP side
# Every query has two execution shapes over the SAME read set: the per-key
# generator walk (one engine.read per round — the oracle, and the shape that
# keeps a query active for hundreds of rounds) and the batched shape —
# ('olap', plan) steps, each answered by ONE plan-execution seam call
# (aggregate plans reduce in fused device passes; ScanPlan where the query
# needs the values themselves, e.g. the district pass that derives the
# order key range).
def stock_level_scan(rng: random.Random, sc: Scale,
                     batched: bool = False) -> Iterator[Step]:
    """CH Q-like: total stock below threshold across every warehouse."""
    low = 0
    if batched:
        low = yield ("olap", sc.stock_level_plan())
    else:
        for key in sc.all_stock_keys():
            q = yield ("r", key)
            if isinstance(q, int) and q < 50:
                low += 1
    yield ("out", low)


def customer_balance(rng: random.Random, sc: Scale,
                     batched: bool = False) -> Iterator[Step]:
    total = 0
    if batched:
        total = yield ("olap", sc.customer_balance_plan())
    else:
        for key in sc.all_customer_keys():
            v = yield ("r", key)
            if isinstance(v, int):
                total += v
    yield ("out", total)


def _recent_order_groups(dkeys, dists, last_n: int = 5):
    """Per-district key groups of the last `last_n` orders, derived from a
    scanned district pass (the GROUP BY key ranges)."""
    groups = []
    for dk, dist in zip(dkeys, dists):
        _, w, d = dk.split(":")
        hi = (dist or {"next_o_id": 0})["next_o_id"]
        groups.append(tuple(f"order:{w}:{d}:{o}"
                            for o in range(max(hi - last_n, 0), hi)))
    return tuple(groups)


def order_revenue(rng: random.Random, sc: Scale,
                  batched: bool = False) -> Iterator[Step]:
    """Scan districts then recent orders; aggregates revenue."""
    rev = 0
    if batched:
        dkeys = sc.all_district_keys()
        dists = yield ("olap", ScanPlan(tuple(dkeys)))  # derive key range
        okeys = [k for g in _recent_order_groups(dkeys, dists) for k in g]
        if okeys:
            rev = yield ("olap", AggPlan(tuple(okeys), AggOp("sum", "total")))
        yield ("out", rev)
        return
    for w in range(sc.warehouses):
        for d in range(sc.districts):
            dist = yield ("r", f"district:{w}:{d}")
            hi = (dist or {"next_o_id": 0})["next_o_id"]
            for o in range(max(hi - 5, 0), hi):
                order = yield ("r", f"order:{w}:{d}:{o}")
                if isinstance(order, dict):
                    rev += order.get("total", 0)
    yield ("out", rev)


def district_revenue_group(rng: random.Random, sc: Scale,
                           batched: bool = False) -> Iterator[Step]:
    """GROUP BY district: revenue and AVG order value per district over
    the recent orders — the batched shape is ONE `GroupByPlan` whose
    compound (sum, count) ops come back as a [districts × 2] tile from a
    single fused device pass (AVG derived on host from the two lanes;
    groups with no orders are empty groups)."""
    dkeys = sc.all_district_keys()
    if batched:
        dists = yield ("olap", ScanPlan(tuple(dkeys)))
        groups = _recent_order_groups(dkeys, dists)
        rows = yield ("olap", GroupByPlan(
            groups, (AggOp("sum", "total"), AggOp("count", "total"))))
        out = [(dk, s, s // n if n else 0) for dk, (s, n) in zip(dkeys, rows)]
        yield ("out", out)
        return
    out = []
    for dk in dkeys:
        dist = yield ("r", dk)
        _, w, d = dk.split(":")
        hi = (dist or {"next_o_id": 0})["next_o_id"]
        s = n = 0
        for o in range(max(hi - 5, 0), hi):
            order = yield ("r", f"order:{w}:{d}:{o}")
            if isinstance(order, dict) and "total" in order:
                s += order["total"]
                n += 1
        out.append((dk, s, s // n if n else 0))
    yield ("out", out)


def district_revenue_all(rng: random.Random, sc: Scale,
                         batched: bool = False) -> Iterator[Step]:
    """GROUP BY district over the STATIC order ranges (the first
    `order_capacity` o_ids per district): revenue and order count.  The
    registrable twin of `district_revenue_group` — that query's key
    ranges chase next_o_id, so its plan fingerprint changes query to
    query; this one's ranges are fixed, so its `GroupByPlan` can be
    served from a live materialized tile (`materialize=` on the
    facades)."""
    dkeys = sc.all_district_keys()
    if batched:
        rows = yield ("olap", sc.district_revenue_plan())
        out = [(dk, s, n) for dk, (s, n) in zip(dkeys, rows)]
        yield ("out", out)
        return
    out = []
    for dk in dkeys:
        _, w, d = dk.split(":")
        s = n = 0
        for key in sc.order_range_keys(int(w), int(d)):
            order = yield ("r", key)
            if isinstance(order, dict) and "total" in order:
                s += order["total"]
                n += 1
        out.append((dk, s, n))
    yield ("out", out)


def stock_overview(rng: random.Random, sc: Scale,
                   batched: bool = False) -> Iterator[Step]:
    """Compound multi-statistic dashboard: total, AVG, floor, and
    over-90 headcount of stock quantities — the batched shape is ONE
    `MultiAggPlan` answered from a single visibility pass (the kernel
    computes all seven statistic lanes anyway), never four scans.  The
    count_above op rides the predicate-pushdown seam: the (field,
    threshold) config lowers to its own kernel pass, with the count
    folded on device."""
    keys = sc.all_stock_keys()
    if batched:
        s, n, mn, hi = yield ("olap", sc.stock_overview_plan())
    else:
        s = n = hi = 0
        mn = None
        for key in keys:
            q = yield ("r", key)
            if isinstance(q, int):
                s += q
                n += 1
                mn = q if mn is None or q < mn else mn
                hi += 1 if q > 90 else 0
        mn = mn if mn is not None else 0
    yield ("out", (s, s // n if n else 0, mn, hi))


OLAP_QUERIES = (stock_level_scan, customer_balance, order_revenue,
                district_revenue_group, district_revenue_all,
                stock_overview)

# Per-query freshness requirements (bounded staleness, in WAL records) for
# replica-cluster snapshot routing: None tolerates any replication lag; a
# bound narrows the eligible replica set, and an unsatisfiable bound makes
# the cluster ship-then-serve.  Shapes the skewed-lag mix: trend scans ride
# the laggiest replica while the revenue dashboard demands near-real-time.
OLAP_FRESHNESS = {
    "stock_level_scan": None,     # historical trend: any replica will do
    "customer_balance": 400,      # moderately fresh balance sheet
    "order_revenue": 120,         # near-real-time revenue dashboard
    "district_revenue_group": 200,  # per-district drill-down, fairly fresh
    "district_revenue_all": 200,  # static drill-down twin, same freshness
    "stock_overview": None,       # inventory dashboard: staleness tolerant
}


def olap_freshness(name: str):
    """Max tolerated replication lag (WAL records) for a query, or None."""
    return OLAP_FRESHNESS.get(name)


# ----------------------------------------------------------- write-skew bench
def write_skew(n_clients: int, contention: float = 0.5, *,
               doctors: int = 6):
    """Doctor-on-call write-skew stress generator (the classic SSI
    anomaly, grown from the ddia-study-practice snippet into a driver/
    bench workload): doctors are partitioned into on-call groups; each
    transaction reads its whole group's rota, then — believing at least
    one colleague stays on call — writes only its OWN slot.  Two
    concurrent sign-offs in one group are write skew: disjoint writes,
    serializable only if a certifier kills one.

    `contention` in [0, 1] sets how many clients share a group:  0 gives
    ~one group per client (almost no conflicts), 1 gives a single group
    everyone fights over.  Returns `(txn_factory, load, keys)`:
    `txn_factory(rng) -> (step generator, name)` (the `_OltpClient`
    transaction-factory interface), `load(engine)` commits the initial
    everyone-on-call rota, and `keys` lists the rota keys."""
    assert 0.0 <= contention <= 1.0
    groups = max(1, round(n_clients * (1.0 - contention)))
    keys = [f"oncall:{g}:{d}" for g in range(groups)
            for d in range(doctors)]

    def load(engine) -> None:
        t = engine.begin()
        for k in keys:
            engine.write(t, k, 1)          # 1 = on call
        engine.commit(t)

    def txn_factory(rng: random.Random):
        return _write_skew_txn(rng, groups, doctors), "write_skew"

    return txn_factory, load, keys


def _write_skew_txn(rng: random.Random, groups: int,
                    doctors: int) -> Iterator[Step]:
    g = rng.randrange(groups)
    me = rng.randrange(doctors)
    on_call = 0
    mine = 0
    for d in range(doctors):
        v = yield ("r", f"oncall:{g}:{d}")
        v = v if isinstance(v, int) else 0
        on_call += v
        if d == me:
            mine = v
    if mine and on_call > 1:
        # someone else is on call: sign off (the write-skew write)
        yield ("w", f"oncall:{g}:{me}", 0)
    elif not mine:
        # understaffed rota oscillates back: go on call again
        yield ("w", f"oncall:{g}:{me}", 1)
    yield ("out", on_call)


def olap_query(rng: random.Random, sc: Scale, *, batched: bool = False):
    fn = OLAP_QUERIES[rng.randrange(len(OLAP_QUERIES))]
    return fn(rng, sc, batched=batched), fn.__name__


# ------------------------------------------------------- session workloads
def session_plan_families(sc: Scale) -> tuple:
    """The fixed-fingerprint plan families a session-serving fleet hands
    out: each family is a `(name, plan)` pair whose plan hashes
    identically serve to serve (frozen dataclasses), so same-horizon
    sessions on one family collapse onto one resolve/dispatch.  Beyond
    the four fleet-wide dashboards, every warehouse gets two drill-down
    families (stock + customer balance) — the per-tenant shape a
    million-user deployment skews over."""
    fams = [("stock_level", sc.stock_level_plan()),
            ("customer_balance", sc.customer_balance_plan()),
            ("stock_overview", sc.stock_overview_plan()),
            ("district_revenue", sc.district_revenue_plan())]
    for w in range(sc.warehouses):
        fams.append((f"stock_sum:w{w}", AggPlan(
            tuple(f"stock:{w}:{i}" for i in range(sc.items)),
            AggOp("sum", "int"))))
        fams.append((f"balance:w{w}", MultiAggPlan(
            tuple(f"customer:{w}:{d}:{c}" for d in range(sc.districts)
                  for c in range(sc.customers)),
            (AggOp("sum", "int"), AggOp("min", "int")))))
    return tuple(fams)


def zipf_assign(rng: random.Random, n_sessions: int, n_families: int,
                *, s: float = 1.2) -> list[int]:
    """Assign each of `n_sessions` a plan-family index, Zipf(s)-skewed
    over the families (rank r drawn with weight 1/r^s): a handful of hot
    dashboards dominate while the tail of per-tenant drill-downs stays
    thin — the popularity shape cross-session batching amortizes."""
    assert n_families >= 1
    weights = [1.0 / (r + 1) ** s for r in range(n_families)]
    total = sum(weights)
    cum, acc = [], 0.0
    for w in weights:
        acc += w / total
        cum.append(acc)
    out = []
    for _ in range(n_sessions):
        x = rng.random()
        out.append(next(i for i, c in enumerate(cum) if x <= c or
                        i == n_families - 1))
    return out


def session_write(rng: random.Random, sc: Scale) -> Iterator[Step]:
    """The session's own OLTP write (read-your-writes pressure): a
    payment-shaped balance move the session must observe on its very
    next read, whichever replica serves it."""
    return payment(rng, sc)


def load_initial(engine, sc: Scale) -> None:
    """Initial data load (one big transaction)."""
    t = engine.begin()
    for w in range(sc.warehouses):
        engine.write(t, f"warehouse:{w}", 0)
        for d in range(sc.districts):
            engine.write(t, f"district:{w}:{d}", {"next_o_id": 0, "ytd": 0})
            for cu in range(sc.customers):
                engine.write(t, f"customer:{w}:{d}:{cu}", 1000)
        for i in range(sc.items):
            engine.write(t, f"stock:{w}:{i}", 100)
    engine.commit(t)
