#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: build, kernels, driver

Phases, in order (any failure exits non-zero; no phase catches its own):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from `src/repro_torch/csrc/` with nvcc (sm_90a)
   into `build/repro_torch/`;
3. kernel phase: each of the four `rss_scan_agg` kernels on numpy-seeded
   inputs at the main path's shapes (P = 400,000 pages, K = 8 slots,
   E = 32 elements; M in {0, 64, 4096} members; G in {1, 16, 40, 256}
   groups; a 256-row delta into a 64-lane tile) must be `torch.equal` to
   its plain PyTorch version on the card; prints kernel, plain and bound
   times (CUDA events, median, L2 flushed before each launch);
4. small-driver phase: a small `run_single_node` on "cuda" and on "cpu"
   with one seed must give equal metrics and OLAP outputs;
5. driver phase: `run_single_node` at TPC-C's cardinalities (4 warehouses,
   10 districts, 3,000 customers per district, 100,000 items, 3,000
   orders per district) with `check_scans` (every plan result asserted
   equal to the per-key engine oracle), batched plans and materialized
   views; every kernel must have launched in it.

It prints one `{"kernels": [...]}` JSON line, the card line, and last
`{"ok": true, "device": {...}}`.  It imports neither jax nor the JAX
package `repro`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = "src/repro_torch/csrc/rss_scan_agg.cu"
TPU_SRC = "src/repro/kernels/rss_scan_agg/kernel.py"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SLEEP_CYCLES = 20_000_000          # lets the host enqueue ahead of a timing
ROUNDS = 150                       # driver rounds at TPC-C scale


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, flush, reps: int = 15) -> float:
    """Median device time of one `fn()` call in ms: each rep flushes L2
    (writes a buffer larger than it), parks the stream in a sleep so the
    host enqueues the call behind it, and brackets the call with CUDA
    events — so host launch overhead stays out of the reading."""
    pairs = []
    for _ in range(reps + 2):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    vals = sorted(s.elapsed_time(e) for s, e in pairs[2:])
    return vals[len(vals) // 2]


# ------------------------------------------------------------ kernel phase
def make_store(np, P, K, E, rng):
    """A mirror-shaped store: tags drawn from the codec's (init, int,
    order, pad), fields from a stock-quantity-like range with negatives,
    timestamps with floor-visible and above-floor slots."""
    data = np.zeros((P, K, E), np.int32)
    data[:, :, 0] = rng.choice(np.array([0, 1, 1, 1, 3, -1], np.int32),
                               (P, K))
    data[:, :, 1] = rng.integers(-1000, 1001, (P, K), dtype=np.int32)
    data[:, :, 2:] = rng.integers(0, 100, (P, K, E - 2), dtype=np.int32)
    ts = rng.integers(0, 12_000, (P, K), dtype=np.int32)
    return data, ts


def kernel_phase(torch, np, K_mod, flush, P=400_000, K=8, E=32):
    from repro_torch.kernels.rss_scan_agg import ref as R

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    data_np, ts_np = make_store(np, P, K, E, rng)
    data = torch.from_numpy(data_np).to(dev)
    ts = torch.from_numpy(ts_np).to(dev)
    floor = 6_000
    members = {m: torch.from_numpy(np.sort(rng.choice(
        np.arange(floor + 1, 12_000, dtype=np.int32), m, replace=False)))
        .to(dev) for m in (0, 64, 4096)}
    results = {}

    def check(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            diff = (got.long() - want.long()).abs().max().item()
            raise AssertionError(f"{name}: kernel != plain (max |d| {diff})")
        err = (got.long() - want.long()).abs().max().item() \
            if got.numel() else 0
        res = results.setdefault(name, {"max_abs_err": 0})
        res["max_abs_err"] = max(res["max_abs_err"], err)

    def report(name, shape, fn, plain, nbytes):
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name} {shape}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({nbytes / 1e6:.1f} MB)", flush=True)
        return ms, plain_ms, bound_ms

    # per page: K*4 bytes of ts + one 32-byte sector of the chosen slot
    page_bytes = K * 4 + 32
    # rss_scan_agg: every M, timed at the main path's block size (BP=8)
    for m, mem in members.items():
        args = (data, ts, mem, floor, 1, 0, 50)
        got = K_mod.rss_scan_agg(*args, block_pages=8)
        check("rss_scan_agg", got, R.rss_scan_agg_ref(*args, block_pages=8))
        nbytes = P * page_bytes + m * 4 + got.numel() * 4
        t = report("rss_scan_agg", f"P={P} M={m} BP=8",
                   lambda: K_mod.rss_scan_agg(*args, block_pages=8),
                   lambda: R.rss_scan_agg_ref(*args, block_pages=8), nbytes)
        if m == 64:
            results["rss_scan_agg"]["times"] = t
    for bp in (1, 2, 4):          # the shrink ladder's block sizes
        args = (data, ts, members[64], floor, 1, 0, 50)
        check("rss_scan_agg", K_mod.rss_scan_agg(*args, block_pages=bp),
              R.rss_scan_agg_ref(*args, block_pages=bp))

    # grouped (flat) and chunked: every G with M = 64, plus every M at G=40
    gid_full = rng.integers(-1, 48, (P, 1), dtype=np.int32)
    for g in (1, 16, 40, 256):
        gid_np = np.where(gid_full >= 0, gid_full % g, -1).astype(np.int32)
        gid = torch.from_numpy(gid_np).to(dev)
        prm = torch.from_numpy(np.stack([
            rng.choice(np.array([1, 3], np.int32), g),
            rng.choice(np.array([0, -2], np.int32), g),
            rng.integers(-500, 500, g, dtype=np.int32)], 1)).to(dev)
        n_active = int((gid_np >= 0).sum())
        for m in ((0, 64, 4096) if g == 40 else (64,)):
            mem = members[m]
            kw = dict(n_groups=g, group_params=prm)
            gargs = (data, ts, gid, mem, floor)
            got = K_mod.rss_scan_agg_grouped(*gargs, block_pages=8, **kw)
            check("rss_scan_agg_grouped", got,
                  R.rss_scan_agg_grouped_ref(*gargs, block_pages=8, **kw))
            got_c = K_mod.rss_scan_agg_chunked(*gargs, **kw)
            check("rss_scan_agg_chunked", got_c,
                  R.rss_scan_agg_chunked_ref(*gargs, **kw))
            if m != 64:
                continue
            base = P * 4 + n_active * page_bytes + m * 4 + g * 12
            t = report("rss_scan_agg_grouped", f"P={P} G={g} M={m} BP=8",
                       lambda: K_mod.rss_scan_agg_grouped(
                           *gargs, block_pages=8, **kw),
                       lambda: R.rss_scan_agg_grouped_ref(
                           *gargs, block_pages=8, **kw),
                       base + got.numel() * 4)
            tc = report("rss_scan_agg_chunked", f"P={P} G={g} M={m}",
                        lambda: K_mod.rss_scan_agg_chunked(*gargs, **kw),
                        lambda: R.rss_scan_agg_chunked_ref(*gargs, **kw),
                        base + got_c.numel() * 4)
            if g == 40:
                results["rss_scan_agg_grouped"]["times"] = t
                results["rss_scan_agg_chunked"]["times"] = tc

    # delta fold: a full flush buffer (FLUSH_ROWS = 256) into 64 lanes
    lp, dp = 64, 256
    acc = rng.integers(-2**20, 2**20, (lp, 128), dtype=np.int32)
    acc[:, 3] = rng.integers(-100, 100, lp)
    acc[:, 4] = rng.integers(-100, 100, lp)
    delta = np.zeros((dp, 128), np.int32)
    delta[:, 0] = rng.integers(-1, lp, dp)
    delta[:, 1] = rng.integers(-2**20, 2**20, dp)
    delta[:, 2] = rng.integers(0, 2, dp)
    delta[:, 3] = rng.integers(-2**20, 2**20, dp)
    delta[:, 4] = rng.integers(0, 2, dp)
    delta[:, 5] = rng.integers(-1000, 1000, dp)
    acc_t, delta_t = (torch.from_numpy(acc).to(dev),
                      torch.from_numpy(delta).to(dev))
    check("rss_delta_fold", K_mod.rss_delta_fold(acc_t, delta_t),
          R.rss_delta_fold_ref(acc_t, delta_t))
    results["rss_delta_fold"]["times"] = report(
        "rss_delta_fold", f"Lp={lp} Dp={dp}",
        lambda: K_mod.rss_delta_fold(acc_t, delta_t),
        lambda: R.rss_delta_fold_ref(acc_t, delta_t),
        dp * 32 + 2 * lp * 128 * 4)
    return results


# ------------------------------------------------------------ driver phases
def _metrics_equal(a, b) -> None:
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    for k in da:
        va, vb = da[k], db[k]
        if k in ("serve_latency", "oltp_commit_latency"):
            va, vb = va.get("count"), vb.get("count")
        elif k in ("serve_latency_by_plan", "serve_stage_latency"):
            va = {x: y["count"] for x, y in va.items()}
            vb = {x: y["count"] for x, y in vb.items()}
        if va != vb:
            raise AssertionError(f"cuda vs cpu metric {k}: {va} != {vb}")


def small_driver_phase() -> None:
    """The whole port on "cuda" against the same run on "cpu" (plain
    versions): equal metrics, OLAP outputs included."""
    from repro_torch.mvcc import Scale, run_single_node

    kw = dict(olap_mode="ssi+rss", oltp_clients=4, olap_clients=3,
              rounds=150, seed=3, olap_scan=True, paged_olap=True,
              check_scans=True, batch_plans=True, materialize=True,
              scale=Scale(warehouses=2, districts=20, customers=10,
                          items=200, order_capacity=10))
    t0 = time.perf_counter()
    a = run_single_node(device="cuda", **kw)
    b = run_single_node(device="cpu", **kw)
    _metrics_equal(a, b)
    print(f"small driver: cuda == cpu over {a.olap_commits} OLAP commits, "
          f"{len(a.olap_outputs)} outputs, modes flat/chunked/host "
          f"{a.olap_mode_flat}/{a.olap_mode_chunked}/{a.olap_mode_host} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _profiled(torch, fn, out_dir: Path):
    """Run `fn` under cProfile (host) and torch.profiler (device), write
    both reports under `out_dir`, print the device-time totals; returns
    fn's result.  Host times under cProfile run slower than unprofiled."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    host = cProfile.Profile()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        host.enable()
        result = fn()
        host.disable()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    buf = io.StringIO()
    stats = pstats.Stats(host, stream=buf)
    stats.sort_stats("cumulative").print_stats(60)
    stats.sort_stats("tottime").print_stats(40)
    (out_dir / "driver_cprofile.txt").write_text(buf.getvalue())
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    (out_dir / "driver_device_time.txt").write_text("\n".join(
        f"{us:14.1f} us  x{n:6d}  {k}" for k, us, n in rows))
    busy = sum(us for _k, us, _n in rows) / 1e6
    print(f"profile: wall {wall:.1f} s (under cProfile), device busy "
          f"{busy:.3f} s, idle share {1 - busy / wall:.4f}", flush=True)
    for k, us, n in rows[:12]:
        print(f"profile device: {us / 1e3:10.3f} ms x{n:5d} {k[:70]}",
              flush=True)
    top = pstats.Stats(host).sort_stats("cumulative")
    for (fname, line, func), (_cc, nc, tt, ct, _c) in sorted(
            top.stats.items(), key=lambda kv: -kv[1][3])[:25]:
        if "repro_torch" in fname:
            short = fname.split("repro_torch/")[-1]
            print(f"profile host: {ct:8.2f} s cum {tt:7.2f} s self "
                  f"x{nc:8d} {short}:{line}({func})", flush=True)
    return result


def driver_phase(torch, K_mod, rounds: int,
                 profile_dir: Path | None = None) -> dict:
    from repro_torch.mvcc import Scale, run_single_node

    # TPC-C cardinalities (TPC-C spec 1.4 / 4.3.3.1; CH-benCHmark): 4
    # warehouses, 10 districts each, 3,000 customers per district, 100,000
    # stock items per warehouse, 3,000 orders per district
    scale = Scale(warehouses=4, districts=10, customers=3000, items=100_000,
                  order_capacity=3000)
    run = lambda: run_single_node(
        olap_mode="ssi+rss", oltp_clients=8, olap_clients=4, rounds=rounds,
        seed=0, scale=scale, olap_scan=True, paged_olap=True,
        batch_plans=True, materialize=True, check_scans=True, device="cuda")
    K_mod.reset_launches()
    t0 = time.perf_counter()
    m = run() if profile_dir is None else _profiled(torch, run, profile_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in K_mod.KERNELS}
    print(f"driver: {rounds} rounds in {wall:.1f} s: oltp commits "
          f"{m.oltp_commits} aborts {m.oltp_aborts}, olap commits "
          f"{m.olap_commits} aborts {m.olap_aborts}; modes flat "
          f"{m.olap_mode_flat} chunked {m.olap_mode_chunked} host "
          f"{m.olap_mode_host}; view hits {m.olap_view_hits} fallbacks "
          f"{m.olap_view_fallbacks} demotions {m.olap_view_demotions}; "
          f"device calls {m.olap_kernel_device_calls}", flush=True)
    for stage, s in sorted(m.serve_stage_latency.items()):
        print(f"driver stage {stage}: n={s['count']} p50_us={s['p50_us']} "
              f"p99_us={s['p99_us']}", flush=True)
    print(f"driver launches: {json.dumps(launches)}", flush=True)
    if m.olap_aborts or m.olap_commits == 0:
        raise AssertionError("RSS readers must commit and never abort")
    if min(launches.values()) == 0:
        raise AssertionError(f"kernels never launched: {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="profile the driver phase (cProfile + "
                    "torch.profiler) and write the reports into DIR")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels.rss_scan_agg import kernel as K_mod

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    lib = K_mod.build()
    print(f"build: {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in K_mod.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    results = kernel_phase(torch, np, K_mod, flush)
    del flush
    torch.cuda.empty_cache()
    small_driver_phase()
    launches = driver_phase(torch, K_mod, ROUNDS, args.profile)

    replaces = {"rss_scan_agg": 189, "rss_scan_agg_grouped": 260,
                "rss_scan_agg_chunked": 405, "rss_delta_fold": 524}
    rows = []
    for name, line in replaces.items():
        ms, plain_ms, bound_ms = results[name]["times"]
        rows.append({"name": name, "route": "cuda", "source": SRC,
                     "replaces": f"{TPU_SRC}:{line}",
                     "launches": launches[name],
                     "max_abs_err": results[name]["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
