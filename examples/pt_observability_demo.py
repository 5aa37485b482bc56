"""Unified observability layer, end to end on a live HTAP run, on the
PyTorch/CUDA port (`repro_torch`).  The twin of
`examples/observability_demo.py`: for the same seed its counts (plans
served, commits, dispatches, spans) are the reference's; its latencies
are this machine's.

One registry (`repro_torch.obs.REGISTRY`) carries every layer's counters,
gauges, and fixed-bucket latency histograms; one tracer
(`repro_torch.obs.TRACER`) captures span trees of the two hot paths:

    oltp_commit -> certify -> wal_emit
    olap_serve  -> route -> [mirror_execute] resolve -> kernel_dispatch
                   -> finalize

The demo runs the single-node HTAP driver with span capture ON, then
shows what an operator gets for free:

  1. p50/p95/p99 serve latency, per plan kind and per stage,
  2. OLTP commit latency with the certify/WAL split,
  3. a trace-tree dump of the most recent serves,
  4. cross-layer consistency (mirror dispatches == kernel launches;
     engine commits == driver-observed commits; span trees balanced),
  5. the Prometheus text exposition + JSON snapshot exports.

    PYTHONPATH=src python examples/pt_observability_demo.py          # GPU
    PYTHONPATH=src python examples/pt_observability_demo.py --device cpu

On "cuda" the aggregate plans run the `rss_scan_agg` kernels; on "cpu"
their plain PyTorch versions.
"""

import argparse

from repro_torch.mvcc import run_single_node
from repro_torch.obs import REGISTRY, TRACER


def fmt(s: dict) -> str:
    return (f"n={s['count']:<4d} p50={s['p50_us']:>8.1f}us "
            f"p95={s['p95_us']:>9.1f}us p99={s['p99_us']:>9.1f}us")


def main(device: str = "cuda") -> None:
    TRACER.set_enabled(True)      # == REPRO_TRACE=1; off by default
    try:
        m = run_single_node(olap_mode="ssi+rss", oltp_clients=3,
                            olap_clients=3, rounds=600, seed=3,
                            olap_scan=True, paged_olap=True,
                            batch_plans=True, device=device)
    finally:
        TRACER.set_enabled(None)

    print("1) OLAP serve latency (end to end)")
    print(f"   all plans        {fmt(m.serve_latency)}")
    for plan, s in sorted(m.serve_latency_by_plan.items()):
        print(f"   {plan:<16s} {fmt(s)}")

    print("\n2) serve-path stages + OLTP commit latency")
    for stage in ("route", "resolve", "dispatch", "finalize"):
        if stage in m.serve_stage_latency:
            print(f"   {stage:<16s} {fmt(m.serve_stage_latency[stage])}")
    print(f"   oltp_commit      {fmt(m.oltp_commit_latency)}")
    print(f"     certify        "
          f"{fmt(REGISTRY.hist_summary('oltp_certify_seconds'))}")
    print(f"     wal_emit       "
          f"{fmt(REGISTRY.hist_summary('oltp_wal_seconds'))}")

    print("\n3) most recent trace trees (REPRO_TRACE=1)")
    print(TRACER.render(limit=2))

    print("\n4) cross-layer consistency")
    assert m.olap_agg_dispatches == m.olap_kernel_dispatches
    assert REGISTRY.total("engine_commits") == m.oltp_commits \
        + m.olap_commits
    assert TRACER.opened == TRACER.closed and TRACER.depth == 0
    print(f"   mirror agg dispatches == kernel dispatches "
          f"({m.olap_agg_dispatches})")
    print(f"   engine commits == driver oltp+olap commits "
          f"({m.oltp_commits + m.olap_commits})")
    print(f"   span trees balanced ({TRACER.opened} opened == "
          f"{TRACER.closed} closed, depth 0)")

    print("\n5) exports")
    prom = REGISTRY.render_prometheus()
    wanted = ("engine_commits", "olap_serve_seconds_bucket",
              "kernel_launch_dispatches")
    lines = [ln for ln in prom.splitlines()
             if any(ln.startswith(w) for w in wanted)]
    print("   prometheus text ({} lines total), e.g.:".format(
        len(prom.splitlines())))
    for ln in lines[:3] + lines[-2:]:
        print(f"     {ln}")
    print(f"   json snapshot: {len(REGISTRY.to_json())} bytes "
          f"(REGISTRY.to_json())")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
