"""Deterministic logical-time workload driver for the HTAP benchmarks.

Model: N clients run concurrently; in every *round* each client advances by
exactly one step (one storage operation, one wait-poll, or one commit).  The
round counter is the logical clock, so a scan of 800 keys stays active for
800 rounds and overlaps hundreds of OLTP commits — reproducing the
concurrency structure the paper's figures measure (writer-aborts under SSI,
reader-waits under SafeSnapshots, neither under RSS).

Throughput  = commits / rounds (per class), abort rate = aborts/(commits+aborts).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from ..core.replica import RssSnapshot
from ..obs import REGISTRY, reset_run
from ..tensorstore.version_store import (AggPlan, GroupByPlan, MultiAggPlan,
                                         ScanPlan)
from .engine import Engine, SerializationFailure, Status
from .htap import MultiNodeHTAP, SingleNodeHTAP
from .workload import (Scale, load_initial, olap_freshness, olap_query,
                       oltp_transaction, session_plan_families, session_write,
                       write_skew, zipf_assign)


@dataclass
class Metrics:
    certifier: str = ""          # commit-certification policy of the run
    oltp_commits: int = 0
    oltp_aborts: int = 0
    oltp_retries: int = 0
    olap_commits: int = 0
    olap_aborts: int = 0
    olap_wait_rounds: int = 0
    olap_scan_steps: int = 0     # ScanPlan steps served
    olap_agg_steps: int = 0      # fused AggPlan steps served
    olap_multi_agg_steps: int = 0   # compound MultiAggPlan steps served
    olap_group_steps: int = 0    # grouped GroupByPlan steps served
    # dense page-range fast path (paged mirrors): fused plan executions
    # that sliced the store vs gathered (page-range locality metric)
    olap_dense_range_hits: int = 0
    olap_dense_range_misses: int = 0
    # cross-reader plan batching (batch_plans=True): same-horizon
    # aggregate plans collected per round and served by one fused
    # BatchPlan dispatch each
    olap_batch_dispatches: int = 0   # fused multi-plan dispatches
    olap_batched_plans: int = 0      # plans served via those dispatches
    # grouped-kernel dispatch accounting (paged mirrors): fused aggregate
    # dispatches and which strategy the shape dispatcher picked
    olap_agg_dispatches: int = 0
    olap_mode_flat: int = 0
    olap_mode_chunked: int = 0
    olap_mode_host: int = 0
    # materialized-aggregate serving (materialize=True runs): plans served
    # from a live accumulator tile vs registered plans that fell back to
    # the fused scan, and dirty min/max lanes demoted to partial rescans
    olap_view_hits: int = 0
    olap_view_fallbacks: int = 0
    olap_view_demotions: int = 0
    max_engine_txns: int = 0     # peak engine per-txn state (bounded by GC)
    max_rss_tracked: int = 0     # peak RSSManager per-txn state (ditto)
    max_wal_records: int = 0     # peak primary WAL length (truncation bound)
    rounds: int = 0
    by_abort_reason: dict = field(default_factory=dict)
    olap_outputs: list = field(default_factory=list)  # ("out", v) results
    # replica-cluster routing (multi-node at N >= 1)
    olap_served_by: list = field(default_factory=list)  # per-replica serves
    olap_ship_then_serve: int = 0   # sync catch-ups forced by staleness
    olap_scheduled_ships: int = 0   # cadence-due ships run at serve time
    olap_avg_lag_records: float = 0.0  # mean served-snapshot lag (observed)
    olap_avg_predicted_lag: float = 0.0  # mean lag predicted at routing
    gc_versions_pruned: int = 0     # chain versions pruned cluster-wide
    # kernel-layer launch accounting (registry series kernel_launch_*)
    olap_kernel_dispatches: int = 0
    olap_kernel_device_calls: int = 0   # the reference's pallas_calls
    # latency distributions (registry histograms; {count, sum_us, p50_us,
    # p95_us, p99_us} summaries — no samples stored anywhere)
    serve_latency: dict = field(default_factory=dict)          # merged
    serve_latency_by_plan: dict = field(default_factory=dict)  # per plan kind
    serve_stage_latency: dict = field(default_factory=dict)    # per stage
    oltp_commit_latency: dict = field(default_factory=dict)
    # session serving (run_sessions / session_tokens runs): token-routed
    # acquires, cadence-owed delta ships run to cover a token, and serves
    # below the token floor (the guarantee counter — must stay 0)
    session_serves: int = 0
    session_token_acquires: int = 0
    session_token_ships: int = 0
    session_token_violations: int = 0
    # horizon-keyed resolve cache (PagedMirror): per-layer hit/miss
    cache_member_hits: int = 0
    cache_member_misses: int = 0
    cache_pindex_hits: int = 0
    cache_pindex_misses: int = 0
    cache_store_hits: int = 0
    cache_store_misses: int = 0

    def oltp_tps(self) -> float:
        return self.oltp_commits / max(self.rounds, 1)

    def olap_qps(self) -> float:
        return self.olap_commits / max(self.rounds, 1)

    def oltp_abort_rate(self) -> float:
        d = self.oltp_commits + self.oltp_aborts
        return self.oltp_aborts / d if d else 0.0

    def olap_abort_rate(self) -> float:
        d = self.olap_commits + self.olap_aborts
        return self.olap_aborts / d if d else 0.0

    def count_plan_step(self, plan) -> None:
        """Bump the per-plan-kind served-step counter."""
        if isinstance(plan, ScanPlan):
            self.olap_scan_steps += 1
        elif isinstance(plan, AggPlan):
            self.olap_agg_steps += 1
        elif isinstance(plan, MultiAggPlan):
            self.olap_multi_agg_steps += 1
        elif isinstance(plan, GroupByPlan):
            self.olap_group_steps += 1

    def dense_range_hit_rate(self) -> float:
        d = self.olap_dense_range_hits + self.olap_dense_range_misses
        return self.olap_dense_range_hits / d if d else 0.0

    def plans_per_dispatch(self) -> float:
        """Mean plans served per fused multi-plan dispatch (1.0 = no
        cross-reader batching happened)."""
        return self.olap_batched_plans / max(self.olap_batch_dispatches, 1)

    def cache_hit_rates(self) -> dict:
        """Per-layer resolve-cache hit rates (member / pindex / store)."""
        out = {}
        for layer in ("member", "pindex", "store"):
            h = getattr(self, f"cache_{layer}_hits")
            s = h + getattr(self, f"cache_{layer}_misses")
            out[layer] = h / s if s else 0.0
        return out


def _harvest_obs(m: Metrics) -> None:
    """Snapshot the run's layer metrics out of the registry into the
    Metrics record.  ONE harvest path for both architectures: family
    totals sum over every instance label set (mirrors of all replicas,
    the kernel layer's launch counters), so single-node assignment and
    multi-node summation can never diverge again — the registry was reset
    at run start, so totals are exactly this run's activity."""
    tot = REGISTRY.totals()
    m.olap_dense_range_hits = tot.get("mirror_range_dense", 0)
    m.olap_dense_range_misses = tot.get("mirror_range_gather", 0)
    m.olap_agg_dispatches = tot.get("mirror_exec_agg_dispatches", 0)
    m.olap_mode_flat = tot.get("mirror_exec_mode_flat", 0)
    m.olap_mode_chunked = tot.get("mirror_exec_mode_chunked", 0)
    m.olap_mode_host = tot.get("mirror_exec_mode_host", 0)
    m.olap_view_hits = tot.get("mirror_exec_view_hits", 0)
    m.olap_view_fallbacks = tot.get("mirror_exec_view_fallbacks", 0)
    m.olap_view_demotions = tot.get("mirror_exec_view_demotions", 0)
    m.olap_kernel_dispatches = tot.get("kernel_launch_dispatches", 0)
    m.olap_kernel_device_calls = tot.get("kernel_launch_device_calls", 0)
    m.cache_member_hits = tot.get("mirror_cache_member_hits", 0)
    m.cache_member_misses = tot.get("mirror_cache_member_misses", 0)
    m.cache_pindex_hits = tot.get("mirror_cache_pindex_hits", 0)
    m.cache_pindex_misses = tot.get("mirror_cache_pindex_misses", 0)
    m.cache_store_hits = tot.get("mirror_cache_store_hits", 0)
    m.cache_store_misses = tot.get("mirror_cache_store_misses", 0)
    m.session_token_acquires = tot.get("cluster_token_acquires", 0)
    m.session_token_ships = tot.get("cluster_token_ships", 0)
    m.session_token_violations = tot.get("cluster_token_violations", 0)
    m.serve_latency = REGISTRY.hist_summary("olap_serve_seconds")
    m.serve_latency_by_plan = REGISTRY.hist_group("olap_serve_seconds",
                                                  "plan")
    m.serve_stage_latency = REGISTRY.hist_group("olap_stage_seconds",
                                                "stage")
    m.oltp_commit_latency = REGISTRY.hist_summary("oltp_commit_seconds")
    # peaks as gauges, so snapshot()/export surfaces them alongside the
    # counter families
    REGISTRY.gauge("driver_peak_engine_txns").track_max(m.max_engine_txns)
    REGISTRY.gauge("driver_peak_rss_tracked").track_max(m.max_rss_tracked)
    REGISTRY.gauge("driver_peak_wal_records").track_max(m.max_wal_records)


class _PlanBatcher:
    """Round-scope cross-reader plan batcher: OLAP clients whose current
    step is an aggregate plan at a shared snapshot horizon enqueue
    (client, context, plan) instead of executing; at the end of the round
    the driver flushes each horizon group through ONE
    `olap_execute_batch` call — whole-batch plan fusion across readers
    (PRoT pin sharing means same-round RSS readers share a horizon
    almost always).  Results land in each client's `pending` slot exactly
    as an unbatched execution would.

    `dedup=True` (the session-serving scale mode) additionally collapses
    EQUAL plans within a horizon group before dispatch: a thousand
    sessions skewed onto a dozen plan families cost one BatchPlan of a
    dozen member plans, and every session gets its family's result.
    Only valid when results need no per-client side effects (snapshot-
    handle contexts — the multi-node serve path; single-node txn
    contexts record per-txn read sets, so they must not dedup)."""

    def __init__(self, htap, m: Metrics, *, dedup: bool = False) -> None:
        self.htap, self.m = htap, m
        self.dedup = dedup
        self.groups: dict = {}

    def add(self, key, client, ctx, plan) -> None:
        self.groups.setdefault(key, []).append((client, ctx, plan))

    def flush(self) -> None:
        for entries in self.groups.values():
            if self.dedup:
                unique = list(dict.fromkeys(p for _c, _x, p in entries))
                ctx = entries[0][1]
                results = self.htap.olap_execute_batch(
                    [(ctx, p) for p in unique])
                by_plan = dict(zip(unique, results))
                if len(entries) > 1:
                    self.m.olap_batch_dispatches += 1
                    self.m.olap_batched_plans += len(entries)
                for client, _ctx, plan in entries:
                    client.pending = by_plan[plan]
                continue
            results = self.htap.olap_execute_batch(
                [(ctx, plan) for _cl, ctx, plan in entries])
            if len(entries) > 1:
                self.m.olap_batch_dispatches += 1
                self.m.olap_batched_plans += len(entries)
            for (client, _ctx, _plan), result in zip(entries, results):
                client.pending = result
        self.groups.clear()


class _OltpClient:
    def __init__(self, engine, rng: random.Random, sc: Scale, m: Metrics,
                 *, txn_factory=None):
        """`txn_factory(rng) -> (step generator, name)` swaps the CH-style
        OLTP mix for another workload (e.g. `workload.write_skew`)."""
        self.engine, self.rng, self.sc, self.m = engine, rng, sc, m
        self.txn_factory = txn_factory
        self.txn = None
        self.gen = None
        self.pending = None  # value to send into the generator

    def _restart(self) -> None:
        if self.txn_factory is not None:
            self.gen, self.name = self.txn_factory(self.rng)
        else:
            self.gen, self.name = oltp_transaction(self.rng, self.sc)
        read_only = self.name == "order_status"
        self.txn = self.engine.begin(read_only=read_only)
        self.pending = None

    def step(self) -> None:
        if self.txn is None:
            self._restart()
            return
        if self.txn.status == Status.ABORTED:   # aborted by SSI mid-flight
            self.m.oltp_aborts += 1
            self.m.oltp_retries += 1
            self._bump_reason(self.txn.abort_reason)
            self._restart()
            return
        try:
            step = self.gen.send(self.pending)
            self.pending = None
        except StopIteration:
            try:
                self.engine.commit(self.txn)
                self.m.oltp_commits += 1
            except SerializationFailure as e:
                self.m.oltp_aborts += 1
                self.m.oltp_retries += 1
                self._bump_reason(e.reason)
            self.txn = None
            return
        try:
            if step[0] == "r":
                self.pending = self.engine.read(self.txn, step[1])
            elif step[0] == "w":
                self.engine.write(self.txn, step[1], step[2])
            # ("out", v) steps are free
        except SerializationFailure as e:
            self.m.oltp_aborts += 1
            self.m.oltp_retries += 1
            self._bump_reason(e.reason)
            self.txn = None

    def _bump_reason(self, reason) -> None:
        if reason is not None:
            k = getattr(reason, "value", str(reason))
            self.m.by_abort_reason[k] = self.m.by_abort_reason.get(k, 0) + 1


class _OlapClientSingle:
    """OLAP client against the unified (single-node) architecture."""

    def __init__(self, htap: SingleNodeHTAP, rng, sc: Scale, m: Metrics,
                 *, batched: bool = False,
                 batcher: Optional[_PlanBatcher] = None):
        self.htap, self.rng, self.sc, self.m = htap, rng, sc, m
        self.batched = batched
        self.batcher = batcher
        self.txn = None
        self.gen = None
        self.pending = None
        self.deferred: Optional[dict] = None  # SafeSnapshots wait state

    def step(self) -> None:
        eng = self.htap.engine
        if self.txn is None:
            if self.htap.olap_mode == "ssi+safesnapshots":
                self._step_deferred(eng)
                return
            self.txn = self.htap.olap_begin()
            self.gen, _ = olap_query(self.rng, self.sc,
                                     batched=self.batched)
            self.pending = None
            return
        if self.txn.status == Status.ABORTED:
            self.m.olap_aborts += 1
            self.htap.olap_abandon(self.txn)
            self.txn = None
            return
        try:
            step = self.gen.send(self.pending)
            self.pending = None
        except StopIteration:
            try:
                self.htap.olap_commit(self.txn)
                self.m.olap_commits += 1
            except SerializationFailure:
                self.m.olap_aborts += 1
            self.txn = None
            return
        try:
            if step[0] == "r":
                self.pending = eng.read(self.txn, step[1])
            elif step[0] == "olap":
                # ONE plan-execution seam serves every OLAP step kind;
                # aggregate plans at a shared RSS horizon may defer to the
                # round's cross-reader batcher (one fused dispatch)
                plan = step[1]
                if (self.batcher is not None and self.txn.rss is not None
                        and isinstance(plan, (AggPlan, MultiAggPlan,
                                              GroupByPlan))):
                    self.batcher.add(("rss", self.txn.rss.lsn), self,
                                     self.txn, plan)
                else:
                    self.pending = self.htap.olap_execute(self.txn, plan)
                self.m.count_plan_step(plan)
            elif step[0] == "scan":            # legacy step kind
                self.pending = self.htap.olap_execute(
                    self.txn, ScanPlan(tuple(step[1])))
                self.m.olap_scan_steps += 1
            elif step[0] == "agg":             # legacy step kind
                self.pending = self.htap.olap_execute(
                    self.txn, AggPlan(tuple(step[1]), step[2]))
                self.m.olap_agg_steps += 1
            elif step[0] == "out":
                self.m.olap_outputs.append(step[1])
        except SerializationFailure:
            self.m.olap_aborts += 1
            self.txn = None

    def _step_deferred(self, eng) -> None:
        """Ports & Grittner deferrable protocol: take a snapshot, wait for the
        read/write transactions concurrent with it; retry if any committed
        with an outgoing rw-conflict (unsafe); else run on that snapshot."""
        if self.deferred is None:
            watch = {tid for tid, t in eng.active.items() if not t.read_only}
            self.deferred = {"seq": eng.seq, "watch": watch}
            self.m.olap_wait_rounds += 1
            return
        watch = self.deferred["watch"]
        live = [tid for tid in watch if tid in eng.active]
        if live:
            self.m.olap_wait_rounds += 1
            return
        unsafe = any(t.out_rw for tid in watch
                     if (t := eng.txns.get(tid)) is not None
                     and t.status == Status.COMMITTED)
        if unsafe:
            self.deferred = None          # retry with a fresh snapshot
            self.m.olap_wait_rounds += 1
            return
        self.txn = eng.begin(read_only=True, skip_siread=True,
                             snapshot_seq=self.deferred["seq"])
        self.gen, _ = olap_query(self.rng, self.sc, batched=self.batched)
        self.pending = None
        self.deferred = None


class _OlapClientMulti:
    """OLAP client against the log-shipping replica cluster.  With
    `freshness_hints` the query's bounded-staleness requirement
    (`workload.olap_freshness`) narrows the routing policy's eligible
    replica set per acquisition."""

    def __init__(self, htap: MultiNodeHTAP, rng, sc: Scale, m: Metrics,
                 *, batched: bool = False, freshness_hints: bool = False,
                 batcher: Optional[_PlanBatcher] = None, session=None):
        self.htap, self.rng, self.sc, self.m = htap, rng, sc, m
        self.batched = batched
        self.freshness_hints = freshness_hints
        self.batcher = batcher
        self.session = session      # sticky client token (read-your-writes
        self.snap = None            # / monotonic reads across replicas)
        self.gen = None
        self.pending = None

    def step(self) -> None:
        if self.snap is None:
            self.gen, name = olap_query(self.rng, self.sc,
                                        batched=self.batched)
            max_lag = olap_freshness(name) if self.freshness_hints else None
            self.snap = self.htap.olap_snapshot(max_lag=max_lag,
                                                session=self.session)
            self.pending = None
            return
        try:
            step = self.gen.send(self.pending)
            self.pending = None
        except StopIteration:
            self.m.olap_commits += 1
            self.htap.olap_release(self.snap)
            self.snap = None
            return
        if step[0] == "r":
            self.pending = self.htap.olap_read(self.snap, step[1])
        elif step[0] == "olap":
            # ONE plan-execution seam serves every OLAP step kind; aggregate
            # plans may defer to the round's cross-reader batcher, keyed by
            # (snapshot kind, serving replica, horizon)
            plan = step[1]
            if (self.batcher is not None
                    and isinstance(plan, (AggPlan, MultiAggPlan,
                                          GroupByPlan))):
                kind, idx, _, s = self.snap
                horizon = s.lsn if isinstance(s, RssSnapshot) else int(s)
                self.batcher.add((kind, idx, horizon), self, self.snap, plan)
            else:
                self.pending = self.htap.olap_execute(self.snap, plan)
            self.m.count_plan_step(plan)
        elif step[0] == "scan":                # legacy step kind
            self.pending = self.htap.olap_execute(self.snap,
                                                  ScanPlan(tuple(step[1])))
            self.m.olap_scan_steps += 1
        elif step[0] == "agg":                 # legacy step kind
            self.pending = self.htap.olap_execute(
                self.snap, AggPlan(tuple(step[1]), step[2]))
            self.m.olap_agg_steps += 1
        elif step[0] == "out":
            self.m.olap_outputs.append(step[1])


def run_single_node(*, olap_mode: str, oltp_clients: int, olap_clients: int,
                    rounds: int = 20_000, seed: int = 0,
                    scale: Scale = Scale(),
                    rss_refresh_every: int = 50,
                    olap_scan: bool = False,
                    paged_olap: bool = False,
                    check_scans: bool = False,
                    batch_plans: bool = False,
                    materialize: bool = False,
                    resolve_cache: bool = True,
                    certifier=None, device=None) -> Metrics:
    """olap_scan=True routes OLAP queries through batched ("olap", plan)
    steps served by one plan-execution seam call each; paged_olap=True
    additionally serves protected readers from the WAL-mirrored paged store
    (workload key families reserved contiguously for the dense page-range
    fast path); check_scans=True asserts every plan result equals the
    per-key engine read path (the oracle); batch_plans=True collects
    each round's same-horizon aggregate plans into ONE fused BatchPlan
    dispatch (cross-reader whole-batch plan fusion); materialize=True
    registers the workload's fixed-key plans
    (`Scale.materialized_plans()`) for incremental materialization —
    serves become O(delta) on view hits, counted in olap_view_*;
    `resolve_cache` toggles the mirror's horizon-keyed resolve cache; and
    `certifier`
    selects the OLTP commit-certification policy (`repro_torch.mvcc.certify`);
    `device` places the paged mirror ("cuda" by default, raising without a
    GPU; "cpu" for the plain PyTorch versions)."""
    htap = SingleNodeHTAP(olap_mode, paged=paged_olap,
                          check_scans=check_scans,
                          reserve_keys=scale.key_families(),
                          materialize=(scale.materialized_plans()
                                       if materialize else None),
                          certifier=certifier, resolve_cache=resolve_cache,
                          device=device)
    load_initial(htap.engine, scale)
    m = Metrics(certifier=htap.engine.certifier.name)
    rng = random.Random(seed)
    batcher = _PlanBatcher(htap, m) if batch_plans else None
    clients = [_OltpClient(htap.engine, random.Random(rng.random()), scale, m)
               for _ in range(oltp_clients)]
    clients += [_OlapClientSingle(htap, random.Random(rng.random()), scale, m,
                                  batched=olap_scan, batcher=batcher)
                for _ in range(olap_clients)]
    if olap_mode == "ssi+rss":
        htap.refresh_rss()
    # fresh measurement window: zero every registry series (incl. the
    # kernel layer's LAUNCH_STATS and any prior run's engines/mirrors)
    # and drop captured traces — back-to-back runs both start from zero
    reset_run()
    for rnd in range(rounds):
        m.rounds = rnd + 1
        if olap_mode == "ssi+rss" and rnd % rss_refresh_every == 0:
            htap.refresh_rss()   # RSS construction invoker (fixed interval)
        for cl in clients:
            cl.step()
        if batcher is not None:
            batcher.flush()
        m.max_engine_txns = max(m.max_engine_txns, len(htap.engine.txns))
        m.max_rss_tracked = max(m.max_rss_tracked,
                                htap.rss_manager.tracked_txns())
        m.max_wal_records = max(m.max_wal_records,
                                len(htap.engine.wal.records))
    _harvest_obs(m)
    return m


def run_multi_node(*, olap_mode: str, oltp_clients: int, olap_clients: int,
                   rounds: int = 20_000, seed: int = 0,
                   scale: Scale = Scale(),
                   ship_every: int = 25,
                   olap_scan: bool = False,
                   paged_olap: bool = False,
                   check_scans: bool = False,
                   n_replicas: int = 1,
                   route_policy="freshest",
                   max_staleness: int = 100,
                   ship_skew: int = 0,
                   freshness_hints: bool = False,
                   batch_plans: bool = False,
                   materialize: bool = False,
                   session_tokens: bool = False,
                   resolve_cache: bool = True,
                   certifier=None, device=None) -> Metrics:
    """N-replica decoupled-storage run.  `ship_skew` staggers the fleet:
    replica i ships every `ship_every * (1 + i * ship_skew)` rounds, so the
    run exercises skewed per-replica lag (the routing policies' input);
    `freshness_hints` routes each OLAP query with its bounded-staleness
    requirement from `workload.OLAP_FRESHNESS`; `materialize` registers
    the workload's fixed-key plans on every replica's mirror — views
    advance during delta ships and serve O(delta) on gate hits;
    `session_tokens` gives every OLAP client a sticky `Session` (routing
    honours read-your-writes / monotonic reads per client);
    `resolve_cache` toggles the mirrors' horizon-keyed resolve cache;
    `device` places the replicas' mirrors ("cuda" by default, "cpu")."""
    htap = MultiNodeHTAP(olap_mode, paged_olap=paged_olap,
                         check_scans=check_scans, n_replicas=n_replicas,
                         route_policy=route_policy,
                         max_staleness=max_staleness,
                         reserve_keys=scale.key_families(),
                         materialize=(scale.materialized_plans()
                                      if materialize else None),
                         certifier=certifier, resolve_cache=resolve_cache,
                         device=device)
    load_initial(htap.primary, scale)
    htap.ship_log()
    m = Metrics(certifier=htap.primary.certifier.name)
    rng = random.Random(seed)
    batcher = _PlanBatcher(htap, m) if batch_plans else None
    clients = [_OltpClient(htap.primary, random.Random(rng.random()), scale, m)
               for _ in range(oltp_clients)]
    clients += [_OlapClientMulti(htap, random.Random(rng.random()), scale, m,
                                 batched=olap_scan,
                                 freshness_hints=freshness_hints,
                                 batcher=batcher,
                                 session=(htap.session() if session_tokens
                                          else None))
                for _ in range(olap_clients)]
    reset_run()    # fresh measurement window (see run_single_node)
    for rnd in range(rounds):
        m.rounds = rnd + 1
        for i in range(n_replicas):   # asynchronous streaming replication,
            if rnd % (ship_every * (1 + i * ship_skew)) == 0:  # skewed lag
                htap.ship_log(replica=i)
        if rnd % ship_every == 0:
            # cluster-wide GC floor: replicas + primary prune versions
            # under min(replication horizon, oldest pin) per replica
            m.gc_versions_pruned += htap.gc_versions()
        for cl in clients:
            cl.step()
        if batcher is not None:
            batcher.flush()
        m.max_engine_txns = max(m.max_engine_txns, len(htap.primary.txns))
        for rep in htap.cluster.replicas:
            if rep.rss_manager is not None:
                m.max_rss_tracked = max(m.max_rss_tracked,
                                        rep.rss_manager.tracked_txns())
        m.max_wal_records = max(m.max_wal_records,
                                len(htap.primary.wal.records))
    _harvest_obs(m)
    st = htap.cluster.stats
    m.olap_served_by = list(st["served"])
    m.olap_ship_then_serve = st["ship_then_serve"]
    m.olap_scheduled_ships = st["scheduled_ships"]
    m.olap_avg_lag_records = round(htap.cluster.avg_served_lag(), 2)
    m.olap_avg_predicted_lag = round(htap.cluster.avg_predicted_lag(), 2)
    return m


class _SessionClient:
    """One serving fleet member: a sticky `Session` token plus the
    Zipf-assigned plan family it re-issues every round.  Exposes the
    `pending` slot `_PlanBatcher` delivers results into."""

    __slots__ = ("session", "name", "plan", "pending")

    def __init__(self, session, name: str, plan) -> None:
        self.session, self.name, self.plan = session, name, plan
        self.pending = None


def _run_oltp(engine, gen, m: Metrics) -> bool:
    """Run one OLTP step generator to completion synchronously (the
    session driver's write path — writers within a round are sequential,
    so certification aborts are rare but still only successful commits
    stamp a session).  Returns True on commit."""
    t = engine.begin()
    pending = None
    try:
        while True:
            try:
                step = gen.send(pending)
                pending = None
            except StopIteration:
                break
            if step[0] == "r":
                pending = engine.read(t, step[1])
            elif step[0] == "w":
                engine.write(t, step[1], step[2])
        engine.commit(t)
    except SerializationFailure as e:
        m.oltp_aborts += 1
        k = getattr(e.reason, "value", str(e.reason))
        m.by_abort_reason[k] = m.by_abort_reason.get(k, 0) + 1
        return False
    m.oltp_commits += 1
    return True


def run_sessions(*, n_sessions: int = 200, rounds: int = 8, seed: int = 0,
                 scale: Scale = Scale(),
                 n_replicas: int = 2,
                 route_policy="predicted_staleness",
                 max_staleness: int = 100,
                 ship_every: int = 2,
                 ship_skew: int = 1,
                 zipf_s: float = 1.2,
                 resolve_cache: bool = True,
                 batch_plans: bool = True,
                 write_fraction: float = 0.05,
                 check_scans: bool = False,
                 keep_history: bool = False,
                 olap_mode: str = "ssi+rss",
                 device=None) -> tuple[Metrics, list]:
    """Million-session serving drill, scaled down: `n_sessions` sticky
    clients each hold a `Session` token and a Zipf(`zipf_s`)-assigned
    plan family from `workload.session_plan_families`.  Every round a
    `write_fraction` sample of the fleet commits a payment txn and
    stamps its token (read-your-writes pressure), then EVERY session
    acquires a snapshot through token-aware routing and serves its
    family plan.  With `batch_plans` the round's same-horizon serves
    fold through `_PlanBatcher(dedup=True)` — a thousand sessions skewed
    onto a dozen families dispatch one BatchPlan of unique plans per
    horizon group; with `resolve_cache` the replicas' paged mirrors keep
    horizon-keyed member/page-index/device-buffer caches warm between
    rounds.  Ships are cadence-skewed across replicas so tokens actually
    bind.  Asserts zero token-guarantee violations; returns
    `(metrics, session clients)` so callers can audit per-session
    history (`keep_history=True`).  `device` places the replicas' mirrors
    ("cuda" by default, "cpu")."""
    htap = MultiNodeHTAP(olap_mode, paged_olap=True, check_scans=check_scans,
                         n_replicas=n_replicas, route_policy=route_policy,
                         max_staleness=max_staleness,
                         reserve_keys=scale.key_families(),
                         resolve_cache=resolve_cache, device=device)
    load_initial(htap.primary, scale)
    htap.ship_log()
    m = Metrics(certifier=htap.primary.certifier.name)
    rng = random.Random(seed)
    fams = session_plan_families(scale)
    assign = zipf_assign(rng, n_sessions, len(fams), s=zipf_s)
    sessions = [_SessionClient(htap.session(keep_history=keep_history),
                               *fams[assign[i]])
                for i in range(n_sessions)]
    writers = min(n_sessions, max(1, round(write_fraction * n_sessions))) \
        if write_fraction > 0 else 0
    batcher = _PlanBatcher(htap, m, dedup=True) if batch_plans else None
    reset_run()    # fresh measurement window (see run_single_node)
    for rnd in range(rounds):
        m.rounds = rnd + 1
        for i in range(n_replicas):   # cadence-skewed async replication
            if rnd % (ship_every * (1 + i * ship_skew)) == 0:
                htap.ship_log(replica=i)
        if rnd and rnd % ship_every == 0:
            m.gc_versions_pruned += htap.gc_versions()
        for cl in rng.sample(sessions, writers):
            if _run_oltp(htap.primary, session_write(rng, scale), m):
                htap.note_commit(cl.session)
        handles = []
        for cl in sessions:
            handle = htap.olap_snapshot(session=cl.session)
            handles.append(handle)
            m.session_serves += 1
            if batcher is not None:
                _kind, idx, _rid, s = handle
                horizon = s.lsn if isinstance(s, RssSnapshot) else int(s)
                batcher.add((_kind, idx, horizon), cl, handle, cl.plan)
            else:
                cl.pending = htap.olap_execute(handle, cl.plan)
            m.count_plan_step(cl.plan)
        if batcher is not None:
            batcher.flush()
        for handle in handles:   # pins released only after the round's
            htap.olap_release(handle)   # serves — PRoT pin sharing
        m.max_engine_txns = max(m.max_engine_txns, len(htap.primary.txns))
        for rep in htap.cluster.replicas:
            if rep.rss_manager is not None:
                m.max_rss_tracked = max(m.max_rss_tracked,
                                        rep.rss_manager.tracked_txns())
    st = htap.cluster.stats
    assert st["token_violations"] == 0, \
        "session token guarantee violated (served below required LSN)"
    _harvest_obs(m)
    m.olap_served_by = list(st["served"])
    m.olap_ship_then_serve = st["ship_then_serve"]
    m.olap_scheduled_ships = st["scheduled_ships"]
    m.olap_avg_lag_records = round(htap.cluster.avg_served_lag(), 2)
    m.olap_avg_predicted_lag = round(htap.cluster.avg_predicted_lag(), 2)
    return m, sessions


def run_write_skew(*, certifier=None, n_clients: int = 8,
                   contention: float = 0.5, rounds: int = 4000,
                   seed: int = 0, record: bool = False
                   ) -> tuple[Metrics, Engine]:
    """Contended write-skew stress run (the certifier comparison bench):
    `n_clients` OLTP clients replay `workload.write_skew` transactions
    against one SSI engine under the chosen certifier.  Returns
    `(metrics, engine)` so callers can inspect engine stats, the final
    rota state (every on-call group must keep >= 1 doctor under any
    serializable execution), and — with `record=True` — check the Adya
    history against the `repro_torch.core` serializability oracles."""
    txn_factory, load, _keys = write_skew(n_clients, contention)
    engine = Engine("ssi", record=record, certifier=certifier)
    load(engine)
    m = Metrics(certifier=engine.certifier.name)
    rng = random.Random(seed)
    clients = [_OltpClient(engine, random.Random(rng.random()), None, m,
                           txn_factory=txn_factory)
               for _ in range(n_clients)]
    reset_run()    # fresh measurement window (see run_single_node)
    for rnd in range(rounds):
        m.rounds = rnd + 1
        for cl in clients:
            cl.step()
        m.max_engine_txns = max(m.max_engine_txns, len(engine.txns))
    _harvest_obs(m)
    # the engine outlives this measurement window: detach its stats into a
    # plain dict so a later run's registry-wide reset can't zero the copy
    # the caller inspects (e.g. comparing engines across certifier runs)
    engine.stats = engine.stats.detach()
    return m, engine
