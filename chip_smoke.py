#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: build, kernels, paths

Phases, in order (any failure exits non-zero; no phase catches its own):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from `src/repro_torch/csrc/*.cu` with nvcc
   (sm_90a) into `build/repro_torch/`, one nvcc per source, all at once;
3. kernel phase: each of the four `rss_scan_agg` kernels on numpy-seeded
   inputs at the main path's shapes (P = 400,000 pages, K = 8 slots,
   E = 32 elements; M in {0, 64, 4096} members; G in {1, 16, 40, 256}
   groups; a 256-row delta into a 64-lane tile), and the two gather
   kernels (`version_gather`, `rss_gather`) at the mirror's shape (int32,
   P = 400,000, K = 8, E = 32, M in {0, 64, 4096}), at an embedding-row
   param store (bf16, P = 151,936, K = 2, E = 1,024: Qwen1.5-0.5B's
   vocabulary and width) and at edge shapes (K in {1, 3, 33}, E in
   {1, 3, 32, 640}, unaligned rows; E = 32 at a P that gives each warp of
   the tile route several tiles) and with member sets that drive each
   staging of the members in shared memory (bitmap, array, global) must
   be `torch.equal` to their plain PyTorch versions on the card, on the
   route each wrapper chose and on each route forced where more than one
   takes the store; prints each gather call's route and launch shape (as
   the wrappers report them), kernel, plain and bound times (CUDA events,
   median, L2 flushed before each launch), the gathers' time on each
   route and `copy_only_ms` (the chosen rows copied by indexing, slots
   precomputed);
4. small-driver phase: a small `run_single_node` on "cuda" and on "cpu"
   with one seed must give equal metrics and OLAP outputs;
5. driver phase: `run_single_node` at TPC-C's cardinalities (4
   warehouses, 10 districts, 3,000 customers per district, 100,000 items,
   3,000 orders per district) with `check_scans` (every plan result
   asserted equal to the per-key engine oracle), batched plans and
   materialized views; every `rss_scan_agg` kernel must have launched;
6. snapshot-read path phase: a `SingleNodeHTAP` paged mirror at the same
   cardinalities (640,044 pages) after OLTP traffic that leaves writers
   in flight; the whole mirror read through `torch_store()` +
   `snapshot_read_members` (rss_gather) must decode to
   `mirror.scan_members` and to the engine's per-key protected reads,
   with at least one page read at a previous version; `snapshot_read`
   (version_gather) at the floor and at the newest commit must equal
   `mirror.scan_at`, and a `gather_pages` sub-store its rows;
7. param-store phase: the bf16 embedding store on the card, a few hundred
   `publish_page`s at rising ts under a rising `gc_floor`, read by
   `snapshot_read` / `snapshot_read_members` at several watermarks
   against a dict-of-versions oracle; both gather kernels must have
   launched in phases 6 and 7;
8. attention kernel phase: `flash_attention` at the serve path's prefill
   shape (bf16, B = 8, S = T = 1,024, H = K = 16, hd = 64, causal), at a
   GQA + window shape (H = 32, K = 8, hd = 128, window 256), at Jamba's
   prefill shape (H = 64, K = 8, hd = 128), at ragged S = T = 1,000
   (bf16, and f32 with TF32 off), and `decode_attention` at B = 8,
   T = 1,088, valid_len in {1, 600, 1,088}, G = 1 (hd 64), G = 4 and
   G = 8 (hd 128, Jamba's), and at the long-context run's B = 1,
   T = 8,256 (G = 1), each against its plain PyTorch version on the card
   (bf16 rtol = atol = 3e-2, f32 2e-5); prints the kernel each flash
   call ran and the split each decode call took (as the wrappers report
   them), kernel, plain, bound and `scaled_dot_product_attention`
   (library) times, decode's kernel and library times again after a
   flush that leaves L2 clean, and decode at every split of the bf16
   route at each timed shape (each held against plain);
9. WKV kernel phase: `wkv_scan` in the model's [B,T,H,N] layout at the
   RWKV serve path's prefill shape (f32, B = 8, T = 1,024, H = 40,
   N = 64) and decode shape (T = 1, the state as s0 and output, in
   place), and at edge shapes (ragged T = 37, N = 32, bf16 and f16
   inputs, s0 given at T > 1), against its plain version on the card at
   rtol = atol = 1e-4 (the reference's tolerance for its kernel); at
   RWKV6-3B's own decay scale (w_base = -6, unit r/k/v) f32 sums of
   64 terms of size ~|o| cancel, so there the check holds |d| to 1e-4
   of the output's max-abs; prints each call's route (chunked for T > 1,
   step for T = 1) and launch shape as the wrapper reports it, and
   kernel, plain and bound times of the prefill and of the decode, the
   decode also on the chunked route (forced), beside the step route;
10. SSM kernel phase: `ssm_scan` at Jamba's prefill shape (f32, Bb = 8,
   T = 1,024, Di = 16,384, N = 16, Jamba's own scales) and decode shape
   (T = 1, the state as h0 and output, in place), and at edge shapes
   (ragged T = 37, Di = 1,000, N = 8, bf16 u, h0 given at T > 1, the
   reference test's shapes and scales), against its plain version on the
   card at rtol = atol = 2e-4 (the reference's tolerance for its kernel);
   prints each call's route and launch shape, and kernel, plain and
   bound times of the
   prefill at Jamba's scales and at the reference test's (A = -exp(z)),
   and of the decode with f32 u and with bf16 u (the served case), the
   served decode also on the chunked route (forced);
11. serve phase, once per architecture: Qwen1.5-0.5B, RWKV6-3B, then
   Jamba-1.5-Large, then Qwen1.5-0.5B again at one long conversation
   (1 prompt of 8,192 tokens, 64 decode steps; every decode_attention
   launch splits the cache, which (c) checks) (`repro_torch.configs`, bf16, random weights from
   torch.Generator seed 0; Qwen and RWKV at full width and depth, Jamba
   at full width, one period deep (8 of 72 layers), each MoE layer
   holding experts 0-7 of 16: one card's share of an expert-parallel
   deployment, ~54 GB) published into a `VersionedParamStore` and served
   by `ServingEngine`: request 1 (8 prompts of 1,024 tokens, 64 decode
   steps, refresh between steps) while a writer publishes v2 (embedding
   rows and lm_head columns perturbed) under request 1's pin, then
   request 2 on v2.  Checks: (a) request 1's prefill and decode logits
   against the plain path on the card (the layers' attention, WKV and
   selective scan on their plain versions; Jamba's MoE routing recorded
   in request 1 and replayed, so a near tie that rounds the other way
   does not move the comparison by a whole expert); (b) prefill + decode
   against `forward` over the whole 1,088 tokens (Jamba's at capacity
   factor 8.0, drop-free, with routing replayed: at 1.25 the capacity
   depends on the length, so prefill + decode drops choices the forward
   keeps, in the reference too); both within 3e-2 of the logits'
   max-abs for Qwen and Jamba.  RWKV6-3B's 32 bf16 layers amplify a
   1e-6 relative change of the WKV output to ~8% of the logits (the
   phase prints this noise floor), so there (a) holds every `wkv_scan`
   launch of request 1's replay against the plain version on the same
   inputs (1e-4), and (a) and (b) run end to end on the same weights in
   f32 (1e-3); the bf16 ratios are printed.  Jamba adds the same
   per-launch check of `ssm_scan` (1e-4), its noise floor, and one
   full-width Mamba block in f32 (1e-3); (c) each kernel's launches per
   request: Qwen 24 flash in prefill and 24 x 64 decode attention, RWKV
   32 `wkv_scan` in prefill and 32 x 64 in decode, Jamba 7 `ssm_scan` in
   prefill and 7 x 64 in decode, 1 flash and 64 decode attention; the
   decode attention launches that split: all 24 x 64 in the long run,
   none in the others; the scans' launches by route: every prefill
   launch chunked, every decode launch a step; (d)
   request 2's snapshot LSN above request 1's, and request 1 served from
   v1 alone; then one more request under torch.profiler for the device's
   busy time, idle share, peak memory and time by kernel kind.

It prints one `{"kernels": [...]}` JSON line (a row per kernel: the
scans' two routes are two kernels each, `wkv_scan` / `ssm_scan` for the
chunked prefill and `wkv_scan step` / `ssm_scan step` for the decode,
each with its route's launches), the card line, and last
`{"ok": true, "device": {...}}`.  It imports neither jax nor the JAX
package `repro`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = "src/repro_torch/csrc/rss_scan_agg.cu"
TPU_SRC = "src/repro/kernels/rss_scan_agg/kernel.py"
GATHER_SRC = "src/repro_torch/csrc/gather.cu"
GATHER_TPU = {
    "version_gather": "src/repro/kernels/version_gather/kernel.py:48",
    "rss_gather": "src/repro/kernels/rss_gather/kernel.py:66"}
ATTN_SRC = "src/repro_torch/csrc/attention.cu"
ATTN_TPU = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:75",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:62"}
WKV_SRC = "src/repro_torch/csrc/wkv.cu"
WKV_TPU = {"wkv_scan": "src/repro/kernels/wkv_scan/kernel.py:64"}
SSM_SRC = "src/repro_torch/csrc/ssm.cu"
SSM_TPU = {"ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:63"}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
# H100 SXM dense peaks: bf16/f16 on the tensor cores, f32 outside them
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# H100 SXM special-function units: 16 exp2 results per clock per SM, 132
# SMs, 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
SLEEP_CYCLES = 20_000_000          # lets the host enqueue ahead of a timing
ROUNDS = 150                       # driver rounds at TPC-C scale
PATH_TXNS = 3000                   # OLTP transactions before the read
# TPC-C cardinalities (TPC-C spec 1.4 / 4.3.3.1; CH-benCHmark): 4
# warehouses, 10 districts each, 3,000 customers per district, 100,000
# stock items per warehouse, 3,000 orders per district
TPCC = dict(warehouses=4, districts=10, customers=3000, items=100_000,
            order_capacity=3000)
# Qwen1.5-0.5B's embedding table (src/repro/configs/qwen1_5_0_5b.py):
# vocabulary 151,936 rows of d_model 1,024, here with K = 2 versions
EMBED_P, EMBED_K, EMBED_E = 151_936, 2, 1024
# serve phase, per architecture: the kernels its path launches, each with
# its launches per layer of the kernel's mixer (KERNEL_MIXER) in a prefill
# and per such layer in a decode step
SERVE_KERNELS = {
    "qwen1.5-0.5b": {"flash_attention": (1, 0), "decode_attention": (0, 1)},
    "rwkv6-3b": {"wkv_scan": (1, 1)},
    "jamba-1.5-large-398b": {"ssm_scan": (1, 1), "flash_attention": (1, 0),
                             "decode_attention": (0, 1)}}
KERNEL_MIXER = {"flash_attention": "attn", "decode_attention": "attn",
                "wkv_scan": "rwkv", "ssm_scan": "mamba"}
# checks (a) and (b) on the served bf16 logits: max |d| within this share
# of the logits' max-abs (the CPU tests' bf16 tolerance).  None for
# RWKV6-3B: its 32 bf16 layers move the logits by ~8% of their max-abs
# for a 1e-6 relative change of the WKV output (PERF.md), so there the
# kernel is held per launch and in f32 instead (`_wkv_checks`)
SERVE_BF16_TOL = {"qwen1.5-0.5b": 3e-2, "rwkv6-3b": None,
                  "jamba-1.5-large-398b": 3e-2}
# Jamba-1.5-Large does not fit one card (one period at full width is
# 45.2 B parameters, 90.5 GB in bf16).  The card holds its share of a
# deployment that places each MoE layer's 16 experts on 2 cards by expert
# and the other 8 periods on further pipeline stages: one period (8 of
# 72 layers) at the published widths, experts 0-7 of each MoE layer (the
# router keeps all 16 outputs and top-2).  The CPU rehearsal cuts the
# smoke variant the same way.
SERVE_DEPTH = {"jamba-1.5-large-398b": 8}
SERVE_EXPERT_CARDS = {"jamba-1.5-large-398b": 2}
SERVE_SMOKE = False
# 8 prompts of 1,024 tokens, 64 decode steps (cache of 1,088); the writer
# publishes v2 after this decode step
SERVE_B, SERVE_S, SERVE_STEPS, SERVE_PUBLISH_AT = 8, 1024, 64, 8
# a second Qwen run: one long conversation (B = 1, a prompt of 8,192 of
# the model's 32,768 positions, 64 decode steps), served as the others.
# Its decode grid is 16 blocks, so every decode_attention launch splits
# the cache over a cluster; the batch-8 runs never split
SERVE_LONG = {"qwen1.5-0.5b": (1, 8192, 64)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, flush, reps: int = 15, clean=None) -> float:
    """Median device time of one `fn()` call in ms: each rep flushes L2
    (writes a buffer larger than it), parks the stream in a sleep so the
    host enqueues the call behind it, and brackets the call with CUDA
    events — so host launch overhead stays out of the reading.  The write
    leaves L2 full of dirty lines that the call's own reads must write
    back; with `clean` (a second buffer larger than L2) the flush then
    reads it, so the call starts on clean lines."""
    pairs = []
    for _ in range(reps + 2):
        flush.zero_()
        if clean is not None:
            clean.sum()
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
        """kernel == plain: `torch.equal`, and for the gathers (which copy
        bits) the same bit patterns too."""
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            diff = (got.double() - want.double()).abs().max().item()
            raise AssertionError(f"{name}: kernel != plain (max |d| {diff})")
        bits = {2: torch.int16, 4: torch.int32}.get(got.element_size())
        if bits is not None and not torch.equal(got.view(bits),
                                                want.view(bits)):
            raise AssertionError(f"{name}: kernel != plain bit patterns")
        err = (got.double() - want.double()).abs().max().item() \
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

    gather_kernels(torch, np, check, results, data, ts, members, floor,
                   flush)
    return results


def _gather_launch_txt(launch) -> str:
    """A gather wrapper's `last_route` as printed: route, grid x block,
    and the pages a warp takes at a time."""
    return (f"route {launch.route}, grid {launch.grid[0]} of {launch.block} "
            f"threads, {launch.pages_per_warp} pages a warp")


def gather_kernels(torch, np, check, results, data, ts, members, floor,
                   flush):
    """version_gather and rss_gather against their plain versions on the
    wrappers' own route and, where more than one takes the store
    (`routes_for`), on each forced: at the mirror's shape (the scan phase's store)
    with M in {0, 64, 4096} and with member sets that drive each staging
    of the members (`member_staging`), at the bf16 embedding store, and
    at edge shapes.  Timed at the mirror and embedding shapes, every
    route, beside the plain version, the bound and `copy_only_ms`: the
    chosen rows copied by `data[rows, slot]` with the row index and the
    int64 slots built before the timed call, a yardstick of the copy half
    (the port never calls it).
    `library_ms` is None: no PyTorch call computes the visibility
    resolve.  Bound: per page K*4 bytes of ts, one row read and one row
    written, plus M*4 bytes of members."""
    from repro_torch.kernels.rss_gather import kernel as RG
    from repro_torch.kernels.rss_gather import ref as RGR
    from repro_torch.kernels.version_gather import kernel as VG
    from repro_torch.kernels.version_gather import ref as VGR

    def routes(d):
        """The routes that take `d` (outputs from torch.empty start on 16
        bytes, so the data's start decides)."""
        return RG.routes_for(d.shape[1], d.shape[2] * d.element_size(),
                             d.data_ptr() % 16 == 0)

    def both(shape, d, t, mem, fl, wm, timed, say=True):
        """Each kernel on its own route choice and on every route forced,
        each == plain; when `timed`, each route timed.  Returns the times
        (ms, plain, bound) of the routes `plan` chose.  `say`: print the
        untimed checks too."""
        nbytes = d.shape[0] * (d.shape[1] * 4 + 2 * d.shape[2]
                               * d.element_size())
        no_mem = mem[:0]
        cases = (("rss_gather", RG.rss_gather, (d, t, mem, fl),
                  lambda: RGR.rss_gather_ref(d, t, mem, fl),
                  RGR.rss_visible_slots_ref(t, mem, fl),
                  f"{shape} M={mem.numel()}", nbytes + mem.numel() * 4),
                 ("version_gather", VG.version_gather, (d, t, wm),
                  lambda: VGR.version_gather_ref(d, t, wm),
                  RGR.rss_visible_slots_ref(t, no_mem, wm), shape, nbytes))
        times = {}
        forced = routes(d) if len(routes(d)) > 1 else ()
        for name, fn, args, plain, slot, label, nb in cases:
            want = plain()
            for route in (None, *forced):
                check(name, fn(*args, route=route), want)
                launch = fn.last_route
                if route is None:
                    chosen = launch
                if not timed:
                    continue
                ms = time_ms(torch, lambda: fn(*args, route=route), flush)
                if route is not None:
                    print(f"kernel {name} {label} [{_gather_launch_txt(launch)}"
                          f", forced]: kernel_ms={ms:.4f}", flush=True)
                    continue
                plain_ms = time_ms(torch, plain, flush, reps=5)
                rows = torch.arange(d.shape[0], device=d.device)
                slot64 = slot.long()
                copy_ms = time_ms(torch, lambda: d[rows, slot64], flush)
                bound_ms = nb / HBM_BYTES_PER_S * 1e3
                print(f"kernel {name} {label} [{_gather_launch_txt(launch)}]:"
                      f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"copy_only_ms={copy_ms:.4f} bound_ms={bound_ms:.4f} "
                      f"library_ms=null (no PyTorch call computes the "
                      f"visibility resolve) ({nb / 1e6:.1f} MB)", flush=True)
                times[name] = (ms, plain_ms, bound_ms)
            if say and not timed:
                print(f"kernel {name} {label}: routes {routes(d)} == plain; "
                      f"chosen [{_gather_launch_txt(chosen)}]", flush=True)
        return times

    P, K, E = data.shape
    mirror = f"mirror int32 P={P} K={K} E={E}"
    for m, mem in members.items():
        t = both(mirror, data, ts, mem, floor, floor, timed=True)
        if m == 64:               # the mirror's concurrent window
            results["rss_gather"]["times"] = t["rss_gather"]
            results["version_gather"]["times"] = t["version_gather"]
            _clean_l2_time(torch, f"rss_gather {mirror} M=64",
                           lambda: RG.rss_gather(data, ts, mem, floor), flush)
            _clean_l2_time(torch, f"version_gather {mirror}",
                           lambda: VG.version_gather(data, ts, floor), flush)

    # member sets for each staging of the members in shared memory on the
    # tile route: the bitmap with duplicates and members at or below the
    # floor; a span over the bitmap's cap (the shared array); a span that
    # overflows int32; an M over the array's cap (binary search in device
    # memory, as the warp route does for every set).  The staging is what
    # gather.cu's rule reports (`member_staging`).
    _, array_cap = RG.staging_caps()
    rng = np.random.default_rng(3)
    above = np.arange(floor + 1, 12_000, dtype=np.int64)
    sets = {
        "dups+below": np.concatenate([[0, 5, floor], rng.choice(above, 300),
                                      rng.choice(above, 300)]),
        "span>cap": np.concatenate([rng.choice(above, 4096, replace=False),
                                    [10**7]]),
        "int32 span": np.concatenate([[-2**31, -5, 0, floor],
                                      rng.choice(above, 2000),
                                      [2**31 - 1, 2**31 - 1]]),
        "M>cap": np.concatenate([rng.choice(above, 5000, replace=False),
                                 rng.choice(np.arange(10**6, 2 * 10**6),
                                            array_cap, replace=False)]),
    }
    seen = set()
    for label, arr in sets.items():
        arr = np.sort(arr).astype(np.int32)
        how = RG.member_staging(arr.size, int(arr[0]), int(arr[-1]))
        seen.add(how)
        mem = torch.from_numpy(arr).to(data.device)
        print(f"kernel rss_gather members {label}: M={arr.size} span "
              f"{int(arr[-1]) - int(arr[0]) + 1} staged as {how} on the "
              f"tile route", flush=True)
        both(f"{mirror} {label}", data, ts, mem, floor, floor, timed=False)
    if seen != {"bitmap", "array", "global"}:
        raise AssertionError(f"member sets staged as {seen}: not every "
                             "staging driven")

    dev = data.device
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    emb = torch.randn((EMBED_P, EMBED_K, EMBED_E), generator=g, device=dev,
                      dtype=torch.bfloat16)
    emb_ts = torch.randint(0, 1000, (EMBED_P, EMBED_K), generator=g,
                           device=dev, dtype=torch.int32)
    rng = np.random.default_rng(1)
    mem = torch.from_numpy(np.sort(rng.choice(np.arange(251, 1000), 64,
                                              replace=False)).astype(
        np.int32)).to(dev)
    t = both(f"embedding bf16 P={EMBED_P} K={EMBED_K} E={EMBED_E}", emb,
             emb_ts, mem, 250, 500, timed=True)
    results["rss_gather"]["times_embedding"] = t["rss_gather"]
    results["version_gather"]["times_embedding"] = t["version_gather"]
    del emb, emb_ts

    # E 32 (64- and 128-byte rows) takes the tile route where the rows are
    # aligned and K <= 8, at a P over two rounds of its persistent grid
    # (several tiles a warp, the last one part way)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p_tiles = 2 * RG.TILE_BLOCKS_PER_SM * sms * (RG.THREADS // 32) * 32 + 17
    n_edge = 0
    for dtype in (torch.bfloat16, torch.int32):
        for k in (1, 3, 33):
            for e in (1, 3, 32, 640):
                for offset in (0, 1):           # 1: rows not 16-B aligned
                    p = p_tiles if e == 32 else 10_007
                    flat = torch.randint(-2**31, 2**31 - 1,
                                         (p * k * e + offset,), generator=g,
                                         device=dev, dtype=torch.int32)
                    d = (flat.to(torch.bfloat16) if dtype == torch.bfloat16
                         else flat)[offset:].view(p, k, e)
                    t = torch.randint(0, 60, (p, k), generator=g,
                                      device=dev, dtype=torch.int32)
                    mem = torch.arange(31, 60, 3, dtype=torch.int32,
                                       device=dev)
                    both(f"edge {dtype} K={k} E={e} offset={offset}", d, t,
                         mem, 20, 40, timed=False, say=False)
                    n_edge += 1
    print(f"kernel gathers: {n_edge} edge shapes (K 1/3/33, E 1/3/32/640, "
          f"bf16/int32, aligned/unaligned rows; P {p_tiles} at E 32) equal "
          "to plain on each route that takes them", flush=True)


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

    scale = Scale(**TPCC)
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


# ------------------------------------------------------ snapshot-read path
def oltp_traffic(engine, scale, n_txns: int, refresh, *, clients: int = 8,
                 seed: int = 0, refresh_every: int = 64):
    """Interleave `clients` OLTP writers of the `mvcc.workload` mix one
    step each per round until `n_txns` have finished, calling `refresh()`
    every `refresh_every` rounds (as the driver refreshes its RSS); the
    writers open at the end stay in flight.  Returns (commits, aborts,
    keys written by committed transactions)."""
    from repro_torch.mvcc import SerializationFailure, Status, \
        oltp_transaction

    rng = random.Random(seed)
    live = [None] * clients          # [txn, step generator, pending, keys]
    done = commits = aborts = rounds = 0
    written = set()
    while done < n_txns:
        rounds += 1
        if rounds % refresh_every == 0:
            refresh()
        for i in range(clients):
            c = live[i]
            if c is None:
                gen, name = oltp_transaction(rng, scale)
                live[i] = [engine.begin(read_only=name == "order_status"),
                           gen, None, []]
                continue
            txn, gen, pending, keys = c
            try:
                if txn.status == Status.ABORTED:
                    raise SerializationFailure(txn.abort_reason)
                try:
                    step = gen.send(pending)
                except StopIteration:
                    engine.commit(txn)
                    commits += 1
                    written.update(keys)
                    done += 1
                    live[i] = None
                    continue
                c[2] = None
                if step[0] == "r":
                    c[2] = engine.read(txn, step[1])
                elif step[0] == "w":
                    engine.write(txn, step[1], step[2])
                    keys.append(step[1])
            except SerializationFailure:
                aborts += 1
                done += 1
                live[i] = None
    in_flight = sum(1 for c in live if c is not None and c[3])
    return commits, aborts, written, in_flight


def path_phase(torch, n_txns: int, device: str = "cuda") -> dict:
    """The whole TPC-C-scale mirror read at a pinned RSS snapshot through
    the gather kernels, held against the mirror's host scans and the
    engine's per-key protected reads.  Returns phase timings (s).
    (`device="cpu"` runs the plain versions: a rehearsal off the card.)"""
    from repro_torch.kernels.rss_gather.ops import (member_tensor,
                                                    snapshot_read_members)
    from repro_torch.kernels.rss_gather.ref import rss_gather_ref
    from repro_torch.kernels.version_gather.ops import snapshot_read
    from repro_torch.mvcc import Scale, SingleNodeHTAP, load_initial
    from repro_torch.tensorstore import decode_value, gather_pages

    times = {}
    clock = [time.perf_counter()]

    def lap(name):
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        times[name] = now - clock[0]
        clock[0] = now

    scale = Scale(**TPCC)
    htap = SingleNodeHTAP("ssi+rss", paged=True, device=device,
                          reserve_keys=scale.key_families())
    load_initial(htap.engine, scale)
    htap.refresh_rss()
    lap("setup_load_s")
    commits, aborts, written, in_flight = oltp_traffic(
        htap.engine, scale, n_txns, htap.refresh_rss)
    htap.refresh_rss()
    rid, snap = htap.prot.acquire()
    lap("oltp_s")
    mirror = htap.mirror
    members = mirror.member_seqs_for(snap)
    store = mirror.torch_store()
    lap("export_s")
    out = snapshot_read_members(store, members, snap.floor_seq)
    lap("rss_read_s")
    if not torch.equal(out, rss_gather_ref(
            store["data"], store["ts"],
            member_tensor(members, store["ts"].device), snap.floor_seq)):
        raise AssertionError("rss_gather != plain on the mirror")
    lap("plain_check_s")
    keys, page_of = mirror.keys, mirror.page_of      # page i holds keys[i]
    dev_vals = [decode_value(r) for r in out[:len(keys)].cpu().numpy()]
    lap("decode_s")
    host_vals = mirror.scan_members(keys, snap)
    lap("scan_members_s")
    if dev_vals != host_vals:
        bad = next(i for i, (a, b) in enumerate(zip(dev_vals, host_vals))
                   if a != b)
        raise AssertionError(f"rss_gather != scan_members at {keys[bad]}: "
                             f"{dev_vals[bad]} != {host_vals[bad]}")
    read = dict(zip(keys, dev_vals))
    rng = random.Random(1)
    check_keys = sorted(written) + rng.sample(keys, min(10_000, len(keys)))
    reader = htap.engine.begin(read_only=True, rss=snap)
    for k in check_keys:
        want = htap.engine.read(reader, k)
        want = 0 if want is None else want    # never written: the codec's 0
        if read[k] != want:
            raise AssertionError(f"rss_gather != engine read at {k}: "
                                 f"{read[k]} != {want}")
    lap("engine_reads_s")
    for wm in (snap.floor_seq, mirror.watermark):
        at = snapshot_read(store, wm)
        if [decode_value(r) for r in at[:len(keys)].cpu().numpy()] != \
                mirror.scan_at(keys, wm):
            raise AssertionError(f"version_gather != scan_at at {wm}")
    older = int((out != at).any(dim=1).sum())     # at: the newest commit
    if older == 0:
        raise AssertionError("no page read a previous version: the RSS "
                             "read never skipped a committed writer")
    sub_keys = check_keys[:5000]
    sub = gather_pages(store, [page_of[k] for k in sub_keys])
    got = snapshot_read_members(sub, members, snap.floor_seq).cpu().numpy()
    if [decode_value(r) for r in got[:len(sub_keys)]] != \
            [read[k] for k in sub_keys]:
        raise AssertionError("gather_pages sub-store read != whole read")
    lap("scan_at_and_sub_s")
    htap.prot.release(rid)
    gb = store["data"].numel() * 4 / 1e9
    print(f"path: {mirror.n_pages} pages ({gb:.3f} GB of pages on the "
          f"card), {commits} commits {aborts} aborts, "
          f"{in_flight} writers in flight, RSS floor {snap.floor_seq} with "
          f"{len(members)} members above it, newest commit "
          f"{mirror.watermark}; {len(check_keys)} keys held against the "
          f"engine; {older} pages read a previous version", flush=True)
    print("path times: " + " ".join(f"{k}={v:.3f}"
                                    for k, v in times.items()), flush=True)
    return times


# ------------------------------------------------------------- param store
def param_store_phase(torch, device: str = "cuda") -> None:
    """The bf16 embedding store on the card: publishes in three waves at
    rising ts, each under the gc_floor of the wave's start (the pinned
    readers' horizon), then reads at several watermarks at or above the
    last floor and one RSS member read, each held against a
    dict-of-versions oracle over every row."""
    from repro_torch.kernels.rss_gather.ops import snapshot_read_members
    from repro_torch.kernels.version_gather.ops import snapshot_read
    from repro_torch.tensorstore import init_store, publish_page

    t0 = time.perf_counter()
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    initial = torch.randn((EMBED_P, EMBED_E), generator=g, device=dev)
    store = init_store(EMBED_P, EMBED_K, EMBED_E, torch.bfloat16,
                       initial=initial, device=dev)
    rng = random.Random(2)
    versions = {}                       # row -> [(ts, bf16 payload)]
    ts = floor = 0
    for _wave in range(3):
        floor = ts                      # readers pinned at the wave's start
        for row in rng.sample(range(EMBED_P), 120):
            ts += rng.randint(1, 3)
            payload = torch.randn(EMBED_E, generator=g, device=dev)
            publish_page(store, row, payload, ts, gc_floor=floor)
            versions.setdefault(row, []).append(
                (ts, payload.to(torch.bfloat16)))
    members = sorted(rng.sample(range(floor + 1, ts + 1), (ts - floor) // 2))
    base = initial.to(torch.bfloat16)

    def expect(visible):
        want = base.clone()
        for row, vs in versions.items():
            seen = [p for t, p in vs if visible(t)]
            if seen:
                want[row] = seen[-1]
        return want

    n = 0
    for wm in (floor, (floor + ts) // 2, ts):
        got = snapshot_read(store, wm)
        if not torch.equal(got, expect(lambda t: t <= wm)):
            raise AssertionError(f"param store: snapshot_read at {wm}")
        n += 1
    mem = set(members)
    got = snapshot_read_members(store, members, floor)
    if not torch.equal(got, expect(lambda t: t <= floor or t in mem)):
        raise AssertionError("param store: snapshot_read_members")
    print(f"param store: {EMBED_P}x{EMBED_K}x{EMBED_E} bf16 "
          f"({store['data'].numel() * 2 / 1e9:.3f} GB), "
          f"{sum(len(v) for v in versions.values())} publishes over "
          f"{len(versions)} rows, gc_floor {floor}; {n} watermark reads + "
          f"1 member read ({len(members)} members) == oracle in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# -------------------------------------------------------- attention kernels
def _visible_pairs(np, S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask admits: the work this run's shapes
    need (the causal triangle, the window band)."""
    i = np.arange(S)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(S, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over the peak for the dtype, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_kernel_phase(torch, np, flush) -> dict:
    """flash_attention and decode_attention against their plain versions
    on the card, in the model's layout as the serve path hands it (q
    [B,S,H,hd], k/v or the cache [B,T,K,hd]), timed beside their bound
    and `scaled_dot_product_attention` on the same work (GQA heads
    expanded and masks built outside the timed region).  Returns
    {name: {"max_abs_err", "times": (ms, plain, bound, library, by)}}."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ops import decode_gqa
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import attention_bshd
    from repro_torch.kernels.flash_attention.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    tol = {"bfloat16": 3e-2, "float32": 2e-5}
    results = {"flash_attention": {"max_abs_err": 0.0},
               "decode_attention": {"max_abs_err": 0.0}}

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dtype))

    def check(name, label, got, want, dtype):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        bad = ~(err <= tol[dtype] * (1 + want.abs()))
        if not torch.isfinite(got).all() or bad.any():
            raise AssertionError(f"{name} {label}: kernel != plain "
                                 f"(max |d| {err.max().item()})")
        res = results[name]
        res["max_abs_err"] = max(res["max_abs_err"], err.max().item())

    def report(name, label, fn, plain, library, nbytes, flops, dtype):
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        library_ms = time_ms(torch, library, flush)
        bound_ms, by = _bound(nbytes, flops, dtype)
        print(f"kernel {name} {label}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
              f"library_ms={library_ms:.4f} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)", flush=True)
        return ms, plain_ms, bound_ms, library_ms, by

    def sdpa(q, k, v, causal, window):
        """SDPA in its own [B,H,S,hd] layout with K/V heads expanded."""
        G = q.shape[2] // k.shape[2]
        qh = q.transpose(1, 2).contiguous()
        kh, vh = (x.transpose(1, 2).repeat_interleave(G, 1).contiguous()
                  for x in (k, v))
        mask = None
        if window:
            i = torch.arange(q.shape[1], device=dev)[:, None]
            j = torch.arange(k.shape[1], device=dev)[None, :]
            mask = i - j < window
            if causal:
                mask &= i >= j
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal and not window)

    # (label, dtype, B, S, T, H, K, hd, causal, window, timed)
    flash_cases = [
        ("prefill", "bfloat16", 8, 1024, 1024, 16, 16, 64, True, 0, True),
        ("gqa+window", "bfloat16", 2, 2048, 2048, 32, 8, 128, True, 256,
         True),
        ("jamba prefill", "bfloat16", 8, 1024, 1024, 64, 8, 128, True, 0,
         True),
        ("ragged", "bfloat16", 2, 1000, 1000, 16, 16, 64, True, 0, False),
        ("ragged", "float32", 2, 1000, 1000, 8, 2, 32, False, 0, False)]
    for (label, dt, B, S, T, H, K, hd, causal, window, timed) in flash_cases:
        q = randn((B, S, H, hd), dt)
        k, v = randn((B, T, K, hd), dt), randn((B, T, K, hd), dt)
        fn = lambda: attention_bshd(q, k, v, causal=causal, window=window)
        plain = lambda: attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
        got = fn()
        shape = (f"{dt} B={B} S={S} T={T} H={H} K={K} hd={hd} "
                 f"causal={causal} window={window} "
                 f"route={FK.flash_attention.last_route}")
        check("flash_attention", shape, got, plain(), dt)
        if timed:
            esz = q.element_size()
            nbytes = esz * (2 * B * S * H * hd + 2 * B * T * K * hd)
            flops = 4 * B * H * hd * _visible_pairs(np, S, T, causal,
                                                    window)
            t = report("flash_attention", f"{label} {shape}", fn, plain,
                       sdpa(q, k, v, causal, window), nbytes, flops, dt)
            if label == "prefill":
                results["flash_attention"]["times"] = t
        del q, k, v

    # (label, B, T, H, K, hd): the cache [B,T,K,hd] read as it lies; the
    # last is the long-context serve run's (one sequence, 8,256 slots)
    clean = torch.empty_like(flush)
    for label, B, T, H, K, hd in (("G=1", 8, 1088, 16, 16, 64),
                                  ("G=4", 8, 1088, 32, 8, 128),
                                  ("G=8 jamba", 8, 1088, 64, 8, 128),
                                  ("G=1 long", 1, 8256, 16, 16, 64)):
        q = randn((B, H, hd), "bfloat16")
        kc, vc = (randn((B, T, K, hd), "bfloat16") for _ in range(2))
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        for vl in (1, 600, T):
            fn = lambda: decode_gqa(q, k, v, vl)
            plain = lambda: decode_attention_ref(q, k, v, vl)
            got = fn()
            chosen = DK.decode_attention.last_split
            shape = (f"bf16 B={B} T={T} H={H} K={K} hd={hd} valid_len={vl} "
                     f"n_split={chosen}")
            check("decode_attention", shape, got, plain(), "bfloat16")
            if vl != T:
                continue
            kx, vx = (x[:, :, :vl].repeat_interleave(H // K, 1).contiguous()
                      for x in (k, v))
            q4 = q[:, :, None].contiguous()
            library = lambda: F.scaled_dot_product_attention(q4, kx, vx)
            nbytes = 2 * (2 * B * H * hd + 2 * B * vl * K * hd)
            t = report("decode_attention", f"{label} {shape}", fn, plain,
                       library, nbytes, 4 * B * H * hd * vl, "bfloat16")
            print(f"kernel decode_attention {label} after a clean-L2 flush: "
                  f"kernel_ms={time_ms(torch, fn, flush, clean=clean):.4f} "
                  f"library_ms="
                  f"{time_ms(torch, library, flush, clean=clean):.4f}",
                  flush=True)
            if label == "G=1":
                results["decode_attention"]["times"] = t
            # every split of the bf16 route on this shape, each held
            # against plain (launches outside the main path)
            want, ms = plain(), {}
            for n in DK.SPLITS:
                check("decode_attention", f"{shape} forced n_split={n}",
                      DK.run_decode(q, k, v, vl, n), want, "bfloat16")
                ms[n] = time_ms(torch, lambda: DK.run_decode(q, k, v, vl, n),
                                flush)
            print(f"decode split sweep {label} B={B} valid_len={vl}: "
                  + " ".join(f"n_split={n} {t:.4f} ms" for n, t in
                             ms.items())
                  + f"; chosen {chosen}", flush=True)
        del q, kc, vc, k, v
    del clean
    return results


# -------------------------------------------------------------- WKV kernel
def _clean_l2_time(torch, label, fn, flush) -> None:
    """Print `fn`'s time after a flush that leaves L2 clean (a decode
    step's state is cold but L2 holds few dirty lines in the serve path;
    the usual flush leaves it full of them, which the step's reads must
    write back first)."""
    clean = torch.empty_like(flush)
    print(f"kernel {label} after a clean-L2 flush: kernel_ms="
          f"{time_ms(torch, fn, flush, clean=clean):.4f}", flush=True)
    del clean


def _launch_txt(launch) -> str:
    """A scan wrapper's `last_route` as printed: route, grid x block, and
    how its operands move."""
    grid = " x ".join(str(g) for g in launch.grid)
    return (f"route {launch.route}, grid {grid} of {launch.block} threads, "
            f"{'16-byte' if launch.vector else 'element'} "
            f"{'staging' if launch.route == 'chunked' else 'state access'}")


def _wkv_plain(r, k, v, w_log, u, s0=None, *, state_out=None):
    """`ops.wkv` on the plain version, on the tensors' own device: the
    model's [B,T,H,N] layout in and out, as the kernel path."""
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_plain

    B, T, H, N = r.shape
    o, S = wkv_scan_plain(*(x.transpose(1, 2) for x in (r, k, v, w_log)),
                          u[None].expand(B, H, N), s0, state_out=state_out)
    return o.transpose(1, 2), S


def _wkv_cost(B: int, T: int, H: int, N: int, itemsize: int, s0: bool):
    """Bytes the scan must move (r, k, v, w_log read once, u, s0 when
    given, o and the final state written once) and its f32 operations:
    per step and head N^2 FMAs for o and N^2 mul+FMA for the state."""
    nbytes = (4 * B * T * H * N * itemsize + H * N * 4 + B * T * H * N * 4
              + (2 if s0 else 1) * B * H * N * N * 4)
    return nbytes, 5 * B * H * T * N * N


def wkv_kernel_phase(torch, np, flush) -> dict:
    """wkv_scan against its plain version on the card, in the model's
    layout as the RWKV serve path hands it (r/k/v/w_log [B,T,H,N], u
    [H,N]), timed beside its bound; `library_ms` is None: no one PyTorch
    call computes the WKV6 recurrence.  Prints the route and launch shape
    of every call (`wkv_scan.last_route`).  Returns {"max_abs_err",
    "times": (ms, plain, bound, None, by)} of the prefill shape (the
    chunked route) and "times_step", the same of the decode shape (the
    step route); the decode is also timed on the chunked route, forced,
    and printed beside it."""
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ops import wkv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    res = {"max_abs_err": 0.0}
    tol = 1e-4

    def inputs(B, T, H, N, dtype, decay_scale):
        """Model layout.  "reference": the reference kernel test's scales
        (r, k 0.5 N(0,1), v N(0,1), decay exp(-exp(z - 2)), u 0.1 N(0,1));
        "rwkv6": RWKV6-3B's own (unit r/k/v, decay exp(-exp(-6 + z)) of
        w_base = -6, u 0.5 N(0,1))."""
        n = lambda: torch.randn((B, T, H, N), generator=g, device=dev)
        ref = decay_scale == "reference"
        s = 0.5 if ref else 1.0
        r, k, v = s * n(), s * n(), n()
        w_log = -torch.exp(n() - 2 if ref else n() - 6)
        u = (0.1 if ref else 0.5) * torch.randn((H, N), generator=g,
                                                device=dev)
        cast = getattr(torch, dtype)
        return [x.to(cast) for x in (r, k, v, w_log)] + [u]

    def check(label, got, want, normwise):
        torch.cuda.synchronize()
        seen = []
        for what, a, b in zip(("o", "S"), got, want):
            err = (a - b).abs()
            bound = tol * (1 + (b.abs().max() if normwise else b.abs()))
            if not torch.isfinite(a).all() or (err > bound).any():
                raise AssertionError(f"wkv_scan {label} {what}: kernel != "
                                     f"plain (max |d| {err.max().item()})")
            res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
            seen.append(f"{what} max |d| {err.max().item():.4g} (max "
                        f"|{what}| {b.abs().max().item():.4g})")
        print(f"kernel wkv_scan {label}: {', '.join(seen)}, held "
              f"{'norm-wise' if normwise else 'element-wise'}", flush=True)

    def report(label, fn, plain, cost):
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        nbytes, flops = cost
        bound_ms, by = _bound(nbytes, flops, "float32")
        print(f"kernel wkv_scan {label}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}; "
              f"ops at the f32 peak outside the tensor cores "
              f"{flops / PEAK_FLOPS['float32'] * 1e3:.4f} ms) "
              f"library_ms=null (no PyTorch call computes the WKV6 "
              f"recurrence) ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
              f"GFLOP)", flush=True)
        return ms, plain_ms, bound_ms, None, by

    # (label, dtype, B, T, H, N, s0 given, decay scale, timed)
    cases = [("prefill", "float32", 8, 1024, 40, 64, False, "reference",
              True),
             ("prefill", "float32", 8, 1024, 40, 64, False, "rwkv6", False),
             ("ragged T", "float32", 2, 37, 8, 64, False, "rwkv6", False),
             ("N=32", "float32", 2, 300, 4, 32, False, "reference", False),
             ("bf16", "bfloat16", 2, 256, 8, 64, False, "reference", False),
             ("f16", "float16", 2, 100, 8, 64, True, "reference", False),
             ("s0", "float32", 2, 50, 8, 64, True, "reference", False)]
    for label, dt, B, T, H, N, with_s0, scale, timed in cases:
        r, k, v, w_log, u = inputs(B, T, H, N, dt, scale)
        s0 = torch.randn((B, H, N, N), generator=g, device=dev) \
            if with_s0 else None
        shape = (f"{dt} B={B} T={T} H={H} N={N} s0={with_s0} "
                 f"decay={scale}")
        got = wkv(r, k, v, w_log, u, s0)
        shape += f" [{_launch_txt(WK.wkv_scan.last_route)}]"
        check(f"{label} {shape}", got, _wkv_plain(r, k, v, w_log, u, s0),
              normwise=scale == "rwkv6")
        if timed:
            res["times"] = report(
                f"{label} {shape}", lambda: wkv(r, k, v, w_log, u),
                lambda: _wkv_plain(r, k, v, w_log, u),
                _wkv_cost(B, T, H, N, r.element_size(), False))
        elif label == "prefill":
            state = got[1]            # decode from the prompt's state
    # decode: one token from that state, read and written in place
    r, k, v, w_log, u = inputs(8, 1, 40, 64, "float32", "rwkv6")
    want = _wkv_plain(r, k, v, w_log, u, state)
    got = wkv(r, k, v, w_log, u, state, state_out=state)
    if got[1] is not state:
        raise AssertionError("wkv_scan decode: the state was not written "
                             "in place")
    route = _launch_txt(WK.wkv_scan.last_route)
    check(f"decode [{route}]", got, want, normwise=True)
    step = lambda: wkv(r, k, v, w_log, u, state, state_out=state)
    res["times_step"] = report(
        f"decode f32 B=8 T=1 H=40 N=64 s0=state_out (in place) [{route}]",
        step, lambda: _wkv_plain(r, k, v, w_log, u, state, state_out=state),
        _wkv_cost(8, 1, 40, 64, 4, True))
    _clean_l2_time(torch, "wkv_scan decode", step, flush)
    # the same step on the chunked route (forced), which takes any T >= 1:
    # the step route must be the faster to be worth its kernel
    bhtn = [x.transpose(1, 2) for x in (r, k, v, w_log)] + \
        [u[None].expand(8, 40, 64)]
    chunked = lambda: WK.wkv_scan(*bhtn, state, state_out=state,
                                  route="chunked")
    want = _wkv_plain(r, k, v, w_log, u, state)
    o, S = chunked()
    route = _launch_txt(WK.wkv_scan.last_route)
    check(f"decode [{route}]", (o.transpose(1, 2), S), want, normwise=True)
    ms = report(f"decode f32 B=8 T=1 H=40 N=64 s0=state_out (in place) "
                f"[{route}]", chunked,
                lambda: _wkv_plain(r, k, v, w_log, u, state,
                                   state_out=state),
                _wkv_cost(8, 1, 40, 64, 4, True))[0]
    print(f"kernel wkv_scan decode: step route {res['times_step'][0]:.4f} "
          f"ms, chunked route {ms:.4f} ms", flush=True)
    print(f"kernel wkv_scan: {len(cases) + 2} shapes within {tol} of "
          f"plain, max |d| {res['max_abs_err']:.4g}", flush=True)
    return res


# -------------------------------------------------------------- SSM kernel
def _ssm_cost(Bb: int, T: int, Di: int, N: int, u_size: int, h0: bool):
    """Bytes the scan must move (u and dt read once, y written once, B
    and C read once, A and D, h0 when given, the final state written) and
    its f32 operations: 8 per (b, t, d, n) (dt·A, the exponential, the
    decay's product and the input's product and sum, C's product and
    sum) and 3 per (b, t, d) (dt·u, D·u and its sum)."""
    nbytes = (Bb * T * Di * (u_size + 4 + 4) + 2 * Bb * T * N * 4
              + Di * N * 4 + Di * 4 + (2 if h0 else 1) * Bb * Di * N * 4)
    return nbytes, 8 * Bb * T * Di * N + 3 * Bb * T * Di


def ssm_kernel_phase(torch, np, flush) -> dict:
    """ssm_scan against its plain version on the card, in the model's
    layout as the Mamba layers hand it (u, dt [Bb,T,Di]; B, C [Bb,T,N]),
    timed beside its bound; `library_ms` is None: no one PyTorch call
    computes the selective scan.  Element-wise rtol = atol = 2e-4, the
    reference's tolerance for its kernel.  Prints the route and launch
    shape of every call (`ssm_scan.last_route`).  Times the prefill at
    Jamba's scales and at the reference test's (A = -exp(z): the time
    must not rest on A's initial values) and the decode with f32 and
    bf16 u (bf16 is what Jamba's serve path passes).  Returns
    {"max_abs_err", "times": (ms, plain, bound, None, by)} of the prefill
    at Jamba's scales (the chunked route) and "times_step", the same of
    the bf16-u decode (the step route); that decode is also timed on the
    chunked route, forced, and printed beside it."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    res = {"max_abs_err": 0.0}
    tol = 2e-4
    F = torch.nn.functional

    def inputs(Bb, T, Di, N, u_dtype, scale):
        """"jamba": Jamba's own scales (dt = softplus(z) of its zero
        dt_bias, A = -(1..N) as A_log is initialised, D = 1, unit u, B,
        C); "reference": the reference kernel test's (dt = softplus(z -
        1), A = -exp(z), D = z)."""
        z = lambda *shape: torch.randn(shape, generator=g, device=dev)
        u, B, C = z(Bb, T, Di), z(Bb, T, N), z(Bb, T, N)
        if scale == "jamba":
            dt = F.softplus(z(Bb, T, Di))
            A = -torch.arange(1, N + 1, device=dev,
                              dtype=torch.float32).expand(Di, N).contiguous()
            D = torch.ones(Di, device=dev)
        else:
            dt = F.softplus(z(Bb, T, Di) - 1)
            A, D = -torch.exp(z(Di, N)), z(Di)
        return u.to(getattr(torch, u_dtype)), dt, B, C, A, D

    def check(label, got, want):
        torch.cuda.synchronize()
        seen = []
        for what, a, b in zip(("y", "h"), got, want):
            err = (a - b).abs()
            if not torch.isfinite(a).all() or \
                    (err > tol * (1 + b.abs())).any():
                raise AssertionError(f"ssm_scan {label} {what}: kernel != "
                                     f"plain (max |d| {err.max().item()})")
            res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
            seen.append(f"{what} max |d| {err.max().item():.4g} (max "
                        f"|{what}| {b.abs().max().item():.4g})")
        print(f"kernel ssm_scan {label}: {', '.join(seen)}", flush=True)

    def report(label, fn, plain, cost, n_exp):
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        nbytes, flops = cost
        bound_ms, by = _bound(nbytes, flops, "float32")
        print(f"kernel ssm_scan {label}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}; "
              f"ops at the f32 peak {flops / PEAK_FLOPS['float32'] * 1e3:.4f}"
              f" ms; {n_exp / 1e9:.3f} G exponentials on the SFU "
              f"{n_exp / SFU_PER_S * 1e3:.4f} ms) library_ms=null (no "
              f"PyTorch call computes the selective scan) ({nbytes / 1e6:.1f}"
              f" MB, {flops / 1e9:.2f} GFLOP)", flush=True)
        return ms, plain_ms, bound_ms, None, by

    # (label, u dtype, Bb, T, Di, N, h0 given, scale, timed)
    cases = [("prefill", "float32", 8, 1024, 16384, 16, False, "jamba", True),
             ("prefill", "float32", 8, 1024, 16384, 16, False, "reference",
              True),
             ("ragged T", "float32", 2, 37, 4096, 16, False, "jamba", False),
             ("ragged Di", "float32", 2, 100, 1000, 16, False, "reference",
              False),
             ("N=8", "float32", 2, 200, 2048, 8, False, "reference", False),
             ("bf16 u", "bfloat16", 2, 256, 4096, 16, False, "jamba", False),
             ("h0", "float32", 2, 50, 4096, 16, True, "reference", False),
             ("reference test", "float32", 2, 64, 128, 8, False, "reference",
              False),
             ("reference test", "float32", 1, 128, 256, 16, False,
              "reference", False)]
    for label, dt_, Bb, T, Di, N, with_h0, scale, timed in cases:
        u, dt, B, C, A, D = inputs(Bb, T, Di, N, dt_, scale)
        h0 = torch.randn((Bb, Di, N), generator=g, device=dev) \
            if with_h0 else None
        shape = (f"{dt_} u, Bb={Bb} T={T} Di={Di} N={N} h0={with_h0} "
                 f"scale={scale}")
        got = selective_scan(u, dt, B, C, A, D, h0)
        shape += f" [{_launch_txt(SK.ssm_scan.last_route)}]"
        check(f"{label} {shape}", got, ssm_scan_ref(u, dt, B, C, A, D, h0))
        if timed:
            times = report(
                f"{label} {shape}",
                lambda: selective_scan(u, dt, B, C, A, D),
                lambda: ssm_scan_ref(u, dt, B, C, A, D),
                _ssm_cost(Bb, T, Di, N, u.element_size(), False),
                Bb * T * Di * N)
            if scale == "jamba":
                res["times"] = times
                state = got[1]        # decode from the prompt's state
    # decode: one token from that state, read and written in place, with
    # f32 u and then bf16 u (the served case)
    for u_dtype in ("float32", "bfloat16"):
        u, dt, B, C, A, D = inputs(8, 1, 16384, 16, u_dtype, "jamba")
        want = ssm_scan_ref(u, dt, B, C, A, D, state)
        got = selective_scan(u, dt, B, C, A, D, state, state_out=state)
        if got[1] is not state:
            raise AssertionError("ssm_scan decode: the state was not "
                                 "written in place")
        label = (f"decode {u_dtype} u, Bb=8 T=1 Di=16384 N=16 h0=state_out "
                 f"(in place) [{_launch_txt(SK.ssm_scan.last_route)}]")
        check(label, got, want)
        step = lambda: selective_scan(u, dt, B, C, A, D, state,
                                      state_out=state)
        res["times_step"] = report(
            label, step,
            lambda: ssm_scan_ref(u, dt, B, C, A, D, state, state_out=state),
            _ssm_cost(8, 1, 16384, 16, u.element_size(), True),
            8 * 16384 * 16)
        _clean_l2_time(torch, f"ssm_scan decode {u_dtype} u", step, flush)
    # the served step on the chunked route (forced), which takes any
    # T >= 1: the step route must be the faster to be worth its kernel
    chunked = lambda: SK.ssm_scan(u, dt, B, C, A, D, state, state_out=state,
                                  route="chunked")
    want = ssm_scan_ref(u, dt, B, C, A, D, state)
    got = chunked()
    label = (f"decode {u_dtype} u, Bb=8 T=1 Di=16384 N=16 h0=state_out "
             f"(in place) [{_launch_txt(SK.ssm_scan.last_route)}]")
    check(label, got, want)
    ms = report(label, chunked,
                lambda: ssm_scan_ref(u, dt, B, C, A, D, state,
                                     state_out=state),
                _ssm_cost(8, 1, 16384, 16, u.element_size(), True),
                8 * 16384 * 16)[0]
    print(f"kernel ssm_scan decode {u_dtype} u: step route "
          f"{res['times_step'][0]:.4f} ms, chunked route {ms:.4f} ms",
          flush=True)
    print(f"kernel ssm_scan: {len(cases) + 3} shapes within {tol} of "
          f"plain, max |d| {res['max_abs_err']:.4g}", flush=True)
    return res


# ------------------------------------------------------------------ serving
@contextlib.contextmanager
def plain_attention():
    """Inside the block, the layers' attention runs on the plain PyTorch
    versions (the chunked online softmax and `decode_attention_ref`) on
    the tensors' own device: the plain path that check (a) holds the
    kernels against."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models import layers

    saved = layers.attention_bshd, layers.decode_gqa
    layers.attention_bshd = lambda q, k, v, *, causal, window: \
        layers.flash_attention_chunked(q, k, v, causal=causal, window=window)
    layers.decode_gqa = decode_attention_ref
    try:
        yield
    finally:
        layers.attention_bshd, layers.decode_gqa = saved


@contextlib.contextmanager
def plain_wkv():
    """Inside the block, the layers' WKV runs on the plain version
    (`wkv_scan_ref`) on the tensors' own device: with `plain_attention`,
    the plain path that check (a) holds the kernels against."""
    from repro_torch.models import layers

    saved = layers.wkv
    layers.wkv = _wkv_plain
    try:
        yield
    finally:
        layers.wkv = saved


@contextlib.contextmanager
def plain_ssm():
    """Inside the block, the layers' selective scan runs on the plain
    version (`ssm_scan_ref`) on the tensors' own device: with
    `plain_attention` and `plain_wkv`, the plain path of check (a)."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers

    saved = layers.selective_scan
    layers.selective_scan = ssm_scan_ref
    try:
        yield
    finally:
        layers.selective_scan = saved


@contextlib.contextmanager
def record_routing():
    """Inside the block, the experts every `layers.moe_route` call
    chooses (gate_idx [B,S,K]) are appended, in call order, to the
    yielded list."""
    from repro_torch.models import layers

    route, calls = layers.moe_route, []

    def recorded(p, x, cfg, **kw):
        out = route(p, x, cfg, **kw)
        calls.append(out[1])
        return out

    layers.moe_route = recorded
    try:
        yield calls
    finally:
        layers.moe_route = route


@contextlib.contextmanager
def replay_routing(torch, calls):
    """Inside the block, the i-th `layers.moe_route` call takes the
    experts calls[i] instead of its own top-k: its own router's softmax
    at those experts, renormalised, and its own slots for them.  A
    routing decision on a near tie can flip between two paths that round
    differently, and then moves the rest of the model by a whole expert;
    the replay keeps the comparison on the kernels.  Yields a dict whose
    "differ" (read after the block) counts the choices where a call's own
    top-k differed from the replayed one.  `calls` None: no replay."""
    from repro_torch.models import layers

    stats = {"calls": 0, "differ": 0}
    if calls is None:
        yield stats
        return
    route = layers.moe_route

    def replayed(p, x, cfg, *, capacity_factor=0.0):
        _, own, _ = route(p, x, cfg, capacity_factor=capacity_factor)
        idx = calls[stats["calls"]]
        stats["calls"] += 1
        stats["differ"] = stats["differ"] + (own != idx).sum()
        vals = torch.softmax(x.float() @ p["router"], -1).gather(-1, idx)
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
        C = layers.moe_capacity(cfg, x.shape[1], capacity_factor)
        return vals, idx, layers.moe_slots(idx, cfg.n_experts, C)

    layers.moe_route = replayed
    try:
        yield stats
    finally:
        layers.moe_route = route
    if stats["calls"] != len(calls):
        raise AssertionError(f"replayed {stats['calls']} of {len(calls)} "
                             "MoE calls")
    stats["differ"] = int(stats["differ"])


def _logits_close(torch, what: str, got, want, rel) -> float:
    """max |got - want| <= rel * max |want| (no bound when `rel` is None);
    raises on non-finite logits.  Returns the ratio."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    ratio = ((got - want).abs().max() / want.abs().max()).item()
    if rel is not None and not ratio <= rel:
        raise AssertionError(f"{what}: max |d| / max |logit| = {ratio:.4g}"
                             f" > {rel}")
    return ratio


def _teacher_forced(cfg, params, prompts, toks, S: int, N: int) -> list:
    """Logits of a prefill of `prompts` and N decode steps fed `toks`
    (a request replayed with its own tokens)."""
    from repro_torch.models import decode_step, prefill

    logits, cache = prefill(params, cfg, {"tokens": prompts},
                            cache_len=S + N)
    out = [logits]
    for k in range(N):
        logits, cache = decode_step(params, cfg, toks[:, k:k + 1], cache,
                                    S + k)
        out.append(logits)
    return out


def _check_a(torch, cfg, params, prompts, toks, logits, S, N, rel,
             routing=None) -> tuple[float, int]:
    """(a): a request's logits against the plain path's on the same
    params, teacher-forced with the request's tokens (and, for a MoE
    model, the request's recorded `routing` replayed).  Returns the worst
    ratio and the routing decisions the plain path would have flipped."""
    with plain_attention(), plain_wkv(), plain_ssm(), \
            replay_routing(torch, routing) as st:
        want = _teacher_forced(cfg, params, prompts, toks, S, N)
    return max(_logits_close(torch, f"(a) step {k}", got, w, rel)
               for k, (got, w) in enumerate(zip(logits, want))), \
        st["differ"]


def _check_b(torch, cfg, params, prompts, toks, logits, S, N, rel,
             routing=None) -> tuple[float, int]:
    """(b): prefill + decode logits against `forward` over the whole
    sequence, one prompt at a time, so [B, S + N, V] logits are never
    held at once.  For a MoE model, `routing` holds each MoE layer's
    recorded choices over the whole sequence ([B, S + N, K]), replayed
    into the forward.  Returns the worst ratio and the routing decisions
    the forward would have flipped."""
    from repro_torch.models import forward

    full = torch.cat([prompts, toks], dim=1)
    got = torch.stack(logits, dim=1)                   # [B, N + 1, V]
    worst, differ = 0.0, 0
    for b in range(full.shape[0]):
        calls = None if routing is None else [c[b:b + 1] for c in routing]
        with replay_routing(torch, calls) as st:
            fwd = forward(params, cfg, {"tokens": full[b:b + 1]})[
                0, S - 1:S + N]
        differ += st["differ"]
        worst = max(worst, _logits_close(torch, f"(b) prompt {b}", got[b],
                                         fwd, rel))
    return worst, differ


def _n_layers(cfg, **spec) -> int:
    """Layers whose LayerSpec has the given fields (e.g. mixer="attn")."""
    return cfg.n_periods * sum(all(getattr(s, k) == v
                                   for k, v in spec.items())
                               for s in cfg.pattern)


def _check_b_dropfree(torch, cfg, params, prompts, toks, S, N, rel):
    """(b) for a MoE model.  Its capacity depends on the sequence length
    (at 1.25: 160 slots per expert for the 1,024-token prefill, 170 for
    the 1,088-token forward, 1 in a decode step), so at the configured
    factor prefill + decode drops choices the forward keeps, in the
    reference as here.  So (b) runs both at capacity factor 8.0, where
    nothing is dropped (the reference's smoke configs' "decode/prefill ==
    forward" setting): a teacher-forced replay of the request on the
    kernel path records its routing, and the forward replays it."""
    cfg8 = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    with record_routing() as calls:
        logits = _teacher_forced(cfg8, params, prompts, toks, S, N)
    n_moe = _n_layers(cfg, mlp="moe")
    if len(calls) != n_moe * (N + 1):
        raise AssertionError(f"{len(calls)} MoE calls, expected "
                             f"{n_moe * (N + 1)}")
    per_layer = [torch.cat([calls[layer]] + [calls[n_moe * (1 + k) + layer]
                                             for k in range(N)], dim=1)
                 for layer in range(n_moe)]
    del calls
    return _check_b(torch, cfg8, params, prompts, toks, logits, S, N, rel,
                    per_layer)


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_float(v) for v in tree)
    return tree.float()


def _wkv_checks(torch, cfg, params, prompts, toks, S: int, N: int) -> str:
    """RWKV6's checks of the kernel in its path, where the bf16 logits
    cannot hold it at 3e-2 (the model's 32 bf16 layers turn f32-level
    differences of the WKV output into ~8% of the logits' max-abs):
    (a) per launch: every `wkv_scan` launch of a teacher-forced replay
    of request 1 against the plain version on the same inputs, o and S
    within 1e-4 of their max-abs; (a) and (b) end to end on the same
    weights widened to f32, within 1e-3 of the logits' max-abs; and the
    bf16 model's own noise floor: its plain prefill against itself with
    every layer's WKV output times (1 + 1e-6 z).  Returns the report."""
    from repro_torch.models import layers

    kernel_wkv, worst = layers.wkv, 0.0

    def checked(r, k, v, w_log, u, s0=None, *, state_out=None):
        nonlocal worst
        want = _wkv_plain(r, k, v, w_log, u, s0)  # before s0 is written
        got = kernel_wkv(r, k, v, w_log, u, s0, state_out=state_out)
        for what, a, b in zip(("o", "S"), got, want):
            ratio = ((a - b).abs().max() / b.abs().max()).item()
            if not ratio <= 1e-4:
                raise AssertionError(f"(a) wkv_scan launch, {what}: max |d|"
                                     f" / max = {ratio:.4g} > 1e-4")
            worst = max(worst, ratio)
        return got

    layers.wkv = checked
    try:
        _teacher_forced(cfg, params, prompts, toks, S, N)
    finally:
        layers.wkv = kernel_wkv
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = _tree_float(params)
    got = _teacher_forced(cfg32, p32, prompts, toks, S, N)
    a32 = _check_a(torch, cfg32, p32, prompts, toks, got, S, N, 1e-3)[0]
    b32 = _check_b(torch, cfg32, p32, prompts, toks, got, S, N, 1e-3)[0]
    del p32, got
    g = torch.Generator(device=prompts.device)
    g.manual_seed(5)

    def noisy(r, k, v, w_log, u, s0=None, *, state_out=None):
        o, S_ = _wkv_plain(r, k, v, w_log, u, s0, state_out=state_out)
        z = torch.randn(o.shape, generator=g, device=o.device)
        return o * (1 + 1e-6 * z), S_

    with plain_wkv():
        plain = _teacher_forced(cfg, params, prompts, toks, S, 0)[0]
        layers.wkv = noisy
        perturbed = _teacher_forced(cfg, params, prompts, toks, S, 0)[0]
    floor = _logits_close(torch, "noise floor", perturbed, plain, None)
    return (f"bf16 noise floor (plain prefill vs itself with its WKV output "
            f"x (1 + 1e-6 z)) {floor:.3g}; (a) per wkv_scan launch max |d| "
            f"/ max {worst:.3g} (<= 1e-4); f32 end to end (a) {a32:.3g}, "
            f"(b) {b32:.3g} (<= 1e-3)")


def _ssm_checks(torch, cfg, params, prompts, toks, S: int, N: int,
                routing) -> str:
    """Jamba's further checks of the kernel in its path: (a) per launch:
    every `ssm_scan` launch of a teacher-forced replay of request 1 (its
    routing replayed) against the plain version on the same inputs, y
    and h within 1e-4 of their max-abs; the bf16 model's own noise
    floor: its plain prefill against itself with every SSM output times
    (1 + 1e-6 z); and one full-width Mamba block in f32 (the layer of
    period 0, position 0, on the prompts' embeddings: a prefill and 4
    decode steps) through the kernel and the plain path, within 1e-3 of
    the output's max-abs.  A whole f32 copy of the period (104 GB) does
    not fit the card.  Returns the report."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers

    kernel_scan, worst, n = layers.selective_scan, 0.0, 0

    def checked(u, dt, B, C, A, D, h0=None, *, state_out=None):
        nonlocal worst, n
        want = ssm_scan_ref(u, dt, B, C, A, D, h0)   # before h0 is written
        got = kernel_scan(u, dt, B, C, A, D, h0, state_out=state_out)
        for what, a, b in zip(("y", "h"), got, want):
            ratio = ((a - b).abs().max() / b.abs().max()).item()
            if not ratio <= 1e-4:
                raise AssertionError(f"(a) ssm_scan launch {n}, {what}: max "
                                     f"|d| / max = {ratio:.4g} > 1e-4")
            worst = max(worst, ratio)
        n += 1
        return got

    layers.selective_scan = checked
    try:
        with replay_routing(torch, routing):
            _teacher_forced(cfg, params, prompts, toks, S, N)
    finally:
        layers.selective_scan = kernel_scan
    g = torch.Generator(device=prompts.device)
    g.manual_seed(5)

    def noisy(u, dt, B, C, A, D, h0=None, *, state_out=None):
        y, h = ssm_scan_ref(u, dt, B, C, A, D, h0, state_out=state_out)
        z = torch.randn(y.shape, generator=g, device=y.device)
        return y * (1 + 1e-6 * z), h

    n_pre = _n_layers(cfg, mlp="moe")            # the prefill's MoE calls
    with plain_attention(), plain_ssm():
        with replay_routing(torch, routing[:n_pre]):
            plain = _teacher_forced(cfg, params, prompts, toks, S, 0)[0]
        layers.selective_scan = noisy
        with replay_routing(torch, routing[:n_pre]):
            perturbed = _teacher_forced(cfg, params, prompts, toks, S, 0)[0]
    floor = _logits_close(torch, "noise floor", perturbed, plain, None)
    del plain, perturbed
    block = f"{_mamba_block_f32(torch, cfg, params, prompts, toks):.3g}"
    return (f"bf16 noise floor (plain prefill vs itself with its SSM output "
            f"x (1 + 1e-6 z)) {floor:.3g}; (a) {n} ssm_scan launches, max "
            f"|d| / max {worst:.3g} (<= 1e-4); f32 Mamba block kernel vs "
            f"plain {block} (<= 1e-3)")


def _mamba_block_f32(torch, cfg, params, prompts, toks) -> float:
    """One full-width Mamba block in f32 (norm1 and the mixer of period 0,
    position 0, weights widened): prefill on the prompts' embeddings and
    4 decode steps, kernel against plain.  Returns the worst ratio."""
    from repro_torch.models import layers

    pos = next(j for j, s in enumerate(cfg.pattern) if s.mixer == "mamba")
    blk = {k: {n: t[0].float() for n, t in v.items()}
           for k, v in params["blocks"][pos].items() if k != "mlp"}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")

    def run():
        h = layers.norm_apply(blk["norm1"], params["embed"][prompts].float(),
                              cfg.norm)
        y, st = layers.mamba_apply(blk["mixer"], h, cfg32)
        out = [y]
        for k in range(4):
            h = layers.norm_apply(blk["norm1"],
                                  params["embed"][toks[:, k:k + 1]].float(),
                                  cfg.norm)
            out.append(layers.mamba_decode(blk["mixer"], h, cfg32, st)[0])
        return out

    got = run()
    with plain_ssm():
        want = run()
    return max(_logits_close(torch, f"f32 Mamba block, call {k}", a, b, 1e-3)
               for k, (a, b) in enumerate(zip(got, want)))


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def _kernel_wrappers() -> dict:
    """name -> the kernel wrapper whose count (`launches`, or
    `route_launches` for the scans) counts its launches."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.wkv_scan import kernel as WK

    return {"flash_attention": FK.flash_attention,
            "decode_attention": DK.decode_attention,
            "wkv_scan": WK.wkv_scan, "ssm_scan": SK.ssm_scan}


def serve_phase(torch, np, device: str = "cuda",
                arch: str = "qwen1.5-0.5b", long: bool = False) -> dict:
    """`arch` served from RSS-pinned parameter snapshots, with checks
    (a)-(d) (see the module docstring), at the batch shape (SERVE_B x
    SERVE_S, SERVE_STEPS steps) or, with `long`, at its SERVE_LONG
    shape.  Returns the launches of the architecture's kernels over both
    requests, counted from 0 just before request 1.  (`device="cpu"`
    runs the plain versions, where no kernel launches: a rehearsal off
    the card.)"""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.cuda_build import launch_count, reset_counts
    from repro_torch.models import init_params
    from repro_torch.serve import ServingEngine
    from repro_torch.tensorstore import VersionedParamStore

    cfg = get_config(arch)
    cfg = smoke_variant(cfg) if SERVE_SMOKE else cfg
    if arch in SERVE_DEPTH:
        cfg = cfg.with_overrides(n_layers=SERVE_DEPTH[arch])
    experts = None
    cut = f"{cfg.n_layers} of {get_config(arch).n_layers} layers"
    if arch in SERVE_EXPERT_CARDS:
        cards = SERVE_EXPERT_CARDS[arch]
        experts = range(cfg.n_experts // cards)
        cut += (f", experts 0-{len(experts) - 1} of {cfg.n_experts} in "
                f"each MoE layer (the experts on {cards} cards by expert, "
                f"the other periods on further pipeline stages)")
    moe = any(s.mlp == "moe" for s in cfg.pattern)
    wrappers = {name: _kernel_wrappers()[name] for name in SERVE_KERNELS[arch]}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    B, S, N = SERVE_LONG[arch] if long else (SERVE_B, SERVE_S, SERVE_STEPS)
    run = cfg.name + (" long context" if long else "")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    v1 = init_params(cfg, g, dev, experts=experts)
    # the writer's v2: the embedding tuner of examples/htap_train_serve.py
    rows, d = cfg.vocab_size // 4, cfg.d_model
    g.manual_seed(1)
    v2 = dict(v1, embed=v1["embed"].clone(), lm_head=v1["lm_head"].clone())
    v2["embed"][:rows] += 0.02 * torch.randn(
        (rows, d), generator=g, device=dev).to(v1["embed"].dtype)
    v2["lm_head"][:, :rows] += d ** -0.5 * torch.randn(
        (d, rows), generator=g, device=dev).to(v1["lm_head"].dtype)
    store = VersionedParamStore(slots=2)
    store.publish(v1)
    eng = ServingEngine(cfg, store, max_seq=S + N, device=dev)
    eng.refresh()
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    sync()
    mem = (f", {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated"
           if on_card else "")
    print(f"serve: {run} {_numel(v1) / 1e9:.3f} B params "
          f"({cfg.param_dtype}, {cut}), init + publish in "
          f"{time.perf_counter() - t0:.1f} s{mem}", flush=True)

    # observe the engine's calls (the pinned params, logits, the prefill's
    # end) and let the writer publish v2 during request 1
    log: dict = {}
    prefill_fn, decode_fn = eng._prefill, eng._decode
    counts = lambda: {name: launch_count(fn)
                      for name, fn in wrappers.items()}
    dattn = wrappers.get("decode_attention")
    splits = lambda: dattn.split_launches if dattn else 0

    def rec_prefill(p, b):
        out = prefill_fn(p, b)
        sync()
        log["t_prefill"] = time.perf_counter()
        log["c_prefill"] = counts()
        log["params"].append(p)
        log["logits"].append(out[0])
        return out

    def rec_decode(p, t, c, n):
        out = decode_fn(p, t, c, n)
        log["params"].append(p)
        log["logits"].append(out[0])
        if log["writer"] and len(log["logits"]) == 1 + SERVE_PUBLISH_AT:
            tw = time.perf_counter()
            log["v2_txn"] = store.publish(v2)      # commit, never waits
            log["publish_us"] = (time.perf_counter() - tw) * 1e6
            held = [s for s in store.slots if s.params is v1]
            if not (held and held[0].valid and held[0].pins == 1) \
                    or store.stats["gc_blocked"]:
                raise AssertionError("the publish disturbed the pinned v1")
        return out

    eng._prefill, eng._decode = rec_prefill, rec_decode

    def request(writer: bool):
        """One request; its launches per kernel as (prefill, decode).
        The writer's request records its MoE routing (check (a) replays
        it)."""
        log.update(params=[], logits=[], writer=writer)
        sync()
        c0, s0 = counts(), splits()
        t = time.perf_counter()
        with record_routing() if writer and moe else \
                contextlib.nullcontext() as calls:
            res = eng.generate({"tokens": prompts}, N,
                               refresh_between_steps=True)
        log["routing"] = calls
        sync()
        t_end = time.perf_counter()
        prefill_s, decode_s = log["t_prefill"] - t, t_end - log["t_prefill"]
        c1, c2 = log["c_prefill"], counts()
        per = {name: (c1[name] - c0[name], c2[name] - c1[name])
               for name in wrappers}
        log["split"] = splits() - s0
        return res, per, list(log["logits"]), list(log["params"]), \
            (prefill_s, decode_s)

    reset_counts(wrappers.values())
    if dattn:
        dattn.split_launches = 0
    res1, per1, logits1, pinned1, t1 = request(writer=True)
    routing1, split1 = log["routing"], log["split"]
    visible_after_1 = store.visible_lsn()
    eng.refresh()
    res2, per2, _, pinned2, t2 = request(writer=False)
    split2 = log["split"]
    launches = counts()
    routes = {name: dict(fn.route_launches) for name, fn in wrappers.items()
              if hasattr(fn, "route_launches")}
    for name, by_route in routes.items():
        launches.update({f"{name} {r}": n for r, n in by_route.items()})
    for i, (res, (pre_s, dec_s)) in enumerate(((res1, t1), (res2, t2)), 1):
        print(f"serve request {i} ({run}): snapshot lsn "
              f"{res.snapshot_lsn} lag {res.freshness_lag}; prefill "
              f"{pre_s * 1e3:.1f} ms ({B}x{S} tokens), decode "
              f"{dec_s / N * 1e3:.2f} ms per step, {B * N / dec_s:.1f} "
              f"tokens/s ({B}x{N})", flush=True)

    # (c) launches: each kernel's launches per layer of its mixer in the
    # prefill and in every decode step, in each request
    want = {}
    for name, (pre, dec) in SERVE_KERNELS[arch].items():
        n_layers = _n_layers(cfg, mixer=KERNEL_MIXER[name])
        want[name] = (pre * n_layers, dec * n_layers * N)
    if on_card and not per1 == per2 == want:
        raise AssertionError(f"launches per request {per1}, {per2} != "
                             f"{want}")
    # ... the scans by route: every prefill launch chunked, every decode
    # launch one step
    for name, by_route in routes.items():
        pre, dec = (per1[name][i] + per2[name][i] for i in (0, 1))
        if on_card and by_route != {"chunked": pre, "step": dec}:
            raise AssertionError(f"{name} launches by route {by_route} != "
                                 f"chunked {pre}, step {dec}")
    # ... and the decode launches that split the cache: all of them in the
    # long run, none at the batch shape
    want_split = want["decode_attention"][1] if long and dattn else 0
    if on_card and not split1 == split2 == want_split:
        raise AssertionError(f"split decode launches {split1}, {split2} "
                             f"!= {want_split}")
    # (d) snapshots: request 1 served from v1 alone while v2 was published
    # and became visible; request 2 pinned v2
    if "v2_txn" not in log or not all(p is v1 for p in pinned1) \
            or not all(p is v2 for p in pinned2):
        raise AssertionError("a request was not served from one version")
    if not (visible_after_1 > res1.snapshot_lsn and
            res2.snapshot_lsn > res1.snapshot_lsn and
            res2.freshness_lag == 0):
        raise AssertionError(f"snapshot lsns {res1.snapshot_lsn} -> "
                             f"{res2.snapshot_lsn} (visible "
                             f"{visible_after_1})")
    for res in (res1, res2):
        if tuple(res.tokens.shape) != (B, N):
            raise AssertionError(f"tokens {tuple(res.tokens.shape)}")

    # (a) request 1's logits against the plain path on v1, teacher-forced
    # with request 1's tokens (and its MoE routing); (b) prefill + decode
    # against forward (for MoE drop-free, `_check_b_dropfree`).  On the
    # served bf16 model, bounded where its rounding noise allows
    # (SERVE_BF16_TOL); for RWKV6 the kernel is held by `_wkv_checks`
    tok1, rel = res1.tokens, SERVE_BF16_TOL[arch]
    worst_a, flips_a = _check_a(torch, cfg, v1, prompts, tok1, logits1, S,
                                N, rel, routing1)
    if moe:
        worst_b, flips_b = _check_b_dropfree(torch, cfg, v1, prompts, tok1,
                                             S, N, rel)
    else:
        worst_b, flips_b = _check_b(torch, cfg, v1, prompts, tok1, logits1,
                                    S, N, rel)
    bound = f"<= {rel}" if rel is not None else "not bounded"
    extra = f"; {_wkv_checks(torch, cfg, v1, prompts, tok1, S, N)}" \
        if "wkv_scan" in wrappers else ""
    if "ssm_scan" in wrappers:
        extra += "; " + _ssm_checks(torch, cfg, v1, prompts, tok1, S, N,
                                    routing1)
    if moe:
        n_dec = B * (S + N) * cfg.top_k * _n_layers(cfg, mlp="moe")
        extra += (f"; MoE routing replayed: of {n_dec} routing decisions "
                  f"per path, the plain path would have flipped {flips_a}, "
                  f"the drop-free forward {flips_b} (capacity factor 8.0 in "
                  f"(b), {cfg.moe_capacity_factor} served)")
    differ = int((res1.tokens != res2.tokens).sum())
    per_txt = ", ".join(f"{name} {pre} in prefill + {dec} in decode"
                        for name, (pre, dec) in per1.items())
    if dattn:
        per_txt += f" ({split1} of them split)"
    print(f"serve checks: (a) {run} kernel vs plain path max |d| / "
          f"max |logit| {worst_a:.3g}; (b) prefill + decode vs forward "
          f"{worst_b:.3g} (bf16, {bound}){extra}; (c) launches per "
          f"request {per_txt}; (d) v2 "
          f"(txn {log['v2_txn']}) published at step {SERVE_PUBLISH_AT} in "
          f"{log['publish_us']:.1f} us under request 1's pin, request 2 "
          f"lsn {res2.snapshot_lsn} > {res1.snapshot_lsn}, {differ} of "
          f"{B * N} tokens differ", flush=True)
    eng._prefill, eng._decode = prefill_fn, decode_fn
    if on_card:
        serve_profile(torch, lambda: eng.generate({"tokens": prompts}, N),
                      sum(t2), run)
    return launches


def serve_profile(torch, run, wall_unprofiled: float, model: str) -> None:
    """One more request (as request 2) under torch.profiler (CUDA
    activity): device busy time, and device time by kind — the two
    attention kernels, the WKV and SSM kernels, matrix products (cuBLAS), the
    rest (PyTorch's elementwise, copy and reduction kernels).  The
    profiler's callbacks slow the host several times over, so the idle
    share is taken against request 2's unprofiled wall (the device work
    is the same)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kinds: dict = {}
    top = []
    for e in prof.key_averages():
        us, name = e.self_device_time_total, e.key
        if us <= 0:
            continue
        low = name.lower()
        kind = ("flash_attention" if "flash_kernel" in name else
                "decode_attention" if "decode_kernel" in name else
                "wkv_scan" if "wkv_kernel" in name else
                "ssm_scan" if "ssm_kernel" in name else
                "matmul" if any(w in low for w in ("gemm", "gemv", "xmma",
                                                   "cutlass", "splitk",
                                                   "nvjet"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us
        top.append((us, e.count, name))
    busy = sum(kinds.values()) / 1e6
    print(f"serve {model} profile: device busy {busy:.4f} s; idle share "
          f"{1 - busy / wall_unprofiled:.4f} of request 2's "
          f"{wall_unprofiled:.3f} s (profiled wall {wall:.3f} s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; by kind: "
          + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1])),
          flush=True)
    for us, n, name in sorted(top, reverse=True)[:10]:
        print(f"serve {model} profile device: {us / 1e3:9.3f} ms x{n:6d} "
              f"{name[:80]}", flush=True)


def _ptxas_report(log: str) -> list:
    """nvcc's `-Xptxas -v` output as one line per kernel: its name
    (demangled by c++filt where the machine has it), registers, shared
    memory and spills; and any line that reports an error."""
    out, kernel, spill = [], "", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel, spill = entry.group(1), ""
            if shutil.which("c++filt"):
                kernel = subprocess.run(
                    ["c++filt", kernel], capture_output=True,
                    text=True).stdout.strip() or kernel
                kernel = re.sub(r"^void |\([^()]*\)$", "", kernel.replace(
                    "(anonymous namespace)::", ""))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[1].strip()
            out.append(f"{kernel}: {used}; {spill}")
        elif "error" in line:
            out.append(line.strip())
    return out


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

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.rss_gather import kernel as RG
    from repro_torch.kernels.rss_scan_agg import kernel as K_mod
    from repro_torch.kernels.version_gather import kernel as VG

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    libs = cuda_build.build()
    names = ", ".join(str(p.relative_to(ROOT)) for p in libs.values())
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in _ptxas_report(log):
            print(f"ptxas {name}: {line}", flush=True)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    results = kernel_phase(torch, np, K_mod, flush)
    results.update(attention_kernel_phase(torch, np, flush))
    results["wkv_scan"] = wkv_kernel_phase(torch, np, flush)
    results["ssm_scan"] = ssm_kernel_phase(torch, np, flush)
    del flush
    torch.cuda.empty_cache()
    small_driver_phase()
    launches = driver_phase(torch, K_mod, ROUNDS, args.profile)
    torch.cuda.empty_cache()

    # the snapshot-read paths: gather launches counted from 0 in each
    for label, phase in (("path", lambda: path_phase(torch, PATH_TXNS)),
                         ("param store",
                          lambda: param_store_phase(torch))):
        RG.reset_launches()
        VG.reset_launches()
        phase()
        for fn in (VG.version_gather, RG.rss_gather):
            n = cuda_build.launch_count(fn)
            if n == 0:
                raise AssertionError(f"{fn.__name__} never launched")
            launches[fn.__name__] = launches.get(fn.__name__, 0) + n
            print(f"{label} phase launches: {fn.__name__} {n} by route "
                  f"{fn.route_launches} (last: "
                  f"{_gather_launch_txt(fn.last_route)})", flush=True)
    print(f"path launches: version_gather {launches['version_gather']} "
          f"rss_gather {launches['rss_gather']}", flush=True)
    torch.cuda.empty_cache()
    # the serve paths, one per architecture and one per long-context
    # shape: each counts its kernels' launches from 0 over its two
    # requests (summed over the paths that share a kernel); each frees its
    # model before the next
    for arch, long in [*((a, False) for a in SERVE_KERNELS),
                       *((a, True) for a in SERVE_LONG)]:
        t0 = time.perf_counter()
        for name, n in serve_phase(torch, np, arch=arch, long=long).items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()
        print(f"serve phase {arch}{' long context' if long else ''}: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still "
              "allocated", flush=True)
    scan_rows = [(f"{name}{suffix}", name, key, launches[f"{name} {route}"])
                 for name in (*WKV_TPU, *SSM_TPU)
                 for suffix, key, route in (("", "times", "chunked"),
                                            (" step", "times_step", "step"))]
    for name in (*ATTN_TPU, *WKV_TPU, *SSM_TPU):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched")
    for row, _, _, n in scan_rows:
        if n == 0:
            raise AssertionError(f"{row} never launched")

    replaces = {"rss_scan_agg": f"{TPU_SRC}:189",
                "rss_scan_agg_grouped": f"{TPU_SRC}:260",
                "rss_scan_agg_chunked": f"{TPU_SRC}:405",
                "rss_delta_fold": f"{TPU_SRC}:524", **GATHER_TPU}
    rows = []
    for name, where in replaces.items():
        ms, plain_ms, bound_ms = results[name]["times"]
        rows.append({"name": name, "route": "cuda",
                     "source": GATHER_SRC if name in GATHER_TPU else SRC,
                     "replaces": where, "launches": launches[name],
                     "max_abs_err": results[name]["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": None})
    sources = {**{n: ATTN_SRC for n in ATTN_TPU},
               **{n: WKV_SRC for n in WKV_TPU},
               **{n: SSM_SRC for n in SSM_TPU}}
    # the scans have two kernels each: a row per kernel, with the
    # launches of its route
    rows_of = [(name, name, "times", launches[name]) for name in ATTN_TPU]
    for row, name, key, n in rows_of + scan_rows:
        ms, plain_ms, bound_ms, library_ms, by = results[name][key]
        rows.append({"name": row, "route": "cuda",
                     "source": sources[name],
                     "replaces": {**ATTN_TPU, **WKV_TPU, **SSM_TPU}[name],
                     "launches": n,
                     "max_abs_err": results[name]["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": by, "library_ms": library_ms})
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
