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
   groups), `rss_scan_agg` and `rss_scan_agg_chunked` on the route `plan`
   chose and on the other route forced (each call's route and launch
   shape printed, both routes timed, the chosen one also after a
   clean-L2 flush); `rss_scan_agg_grouped` (BP 8) at the same G and M
   and at the driver phase's largest shapes (P 920,008 at G 43, P
   120,016 at G 2, M 0) and `rss_delta_fold` at the flush buffer's 256
   rows into 64 lanes and at the driver's 1,048,576 rows into 8, each on
   every route, timed beside `fill_only_ms` or `sector_only_ms`, and
   counted as one device operation a call in a profiler trace; the chunked call
   at a G over the cluster route's shared-memory cap (global route; group
   ids over 48 groups and spread over all G, both timed), and
   K in {9, 33} with BP 3 and 8, and the two gather
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
   prints how many launches each made at which (P, G, M, BP) and route;
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
   route at each timed shape (each held against plain); the flash times
   at Qwen's and Jamba's prefill beside PR 16's (`FLASH_PR16_MS`); then
   the flash backward, `flash_attention_bwd` (`fa_flash_bwd`), on
   numpy-seeded inputs at `BWD_CASES` (Qwen's train shape bf16 B = 8,
   S = T = 1,024, H = K = 16, hd = 64, causal; GQA + window 256 at H 32,
   K 8, hd 128; MQA at H 48, K 1, hd 128; ragged S = T = 1,000 in bf16
   and f32), from the forward kernel's o and lse, against
   `attention_bwd_ref` on the same inputs (bf16 within 3e-2 of each
   gradient's max-abs, f32 2e-5), two launches bitwise equal, timed
   beside plain, the bound and SDPA's backward on its flash route
   (null where that route does not take the mask), printing the launch
   `plan_bwd` chose (the head ranges of a KV head's dK/dV, `hsplit`);
   the bound counts 10·hd operations a visible pair, not the 14·hd the
   kernels issue (the dQ kernel computes S and dP again);
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
   then the scans' backward kernels (`scan_bwd_phase`): `wkv_scan_bwd`
   at RWKV6-3B's train shape (f32, B = TRAIN_BATCH 4, T = 1,024, H = 40,
   N = 64, from the forward kernel's chunk states; the reference test's
   decays and RWKV6-3B's own) and `ssm_scan_bwd` at Jamba's train
   microbatch (bf16 u, Bb = 1, T = 1,024, Di = 16,384, N = 16, Jamba's
   scales), each gradient within 1e-4 of its max-abs of the plain
   backward (bf16 du: + 2^-7), two launches bitwise equal, timed beside
   plain and the bound (bytes, f32 operations, exponentials on the SFU:
   the least work, not what the kernels recompute; WKV's recomputes S
   from the saved states with each segment's state from zero beside it,
   and runs the adjoint twice, see `_wkv_bwd_cost`);
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
   busy time, idle share, peak memory and time by kernel kind;
12. train phase, once per architecture of TRAIN_ARCH: Qwen1.5-0.5B at
   full width and depth, RWKV6-3B at full width and depth (32 layers,
   d 2,560, f32 moments, batch 4: `TRAIN_BATCH`), and Jamba-1.5-Large's
   Mamba layers (`TRAIN_CUT`: the period's first position, Mamba with a
   dense MLP, 2 layers at the published widths, bf16 moments, 8
   microbatches), each bf16 from torch.Generator seed 0 with remat
   "dots" as its config says.  RWKV6 and Jamba run checks (a)-(c) as
   below (check (a) at 2 layers, the plain path the plain forwards and
   the plain backwards' explicit reverse scans), and (a) also holds every
   scan backward launch of one full-depth bf16 step against the plain
   backward on the same inputs (`checked_scan_bwd`); (c) counts each
   scan's forward and backward launches.  Qwen1.5-0.5B (8 x 1,024 tokens
   a step):  (a) one step's loss and gradients on the
   kernels against the plain path (`plain_attention`) on the card at
   batch 2 (`TRAIN_CHECK_B`): in f32 with TF32 off the loss within 1e-5
   relative and every leaf within 1e-3 of its max-abs; in bf16 on the
   same weights the loss within 3e-2, each leaf's ratio printed beside
   the bf16 model's own distance from the f32 one; (b) a `Trainer`
   publishing every step into a `VersionedParamStore(slots=2)` for 8
   steps, a reader pinned at v1 before step 1 reading v1 bitwise after
   step 8, a `ServingEngine` request answered from a pinned snapshot
   between steps with rising snapshot LSNs, no abort in the WAL; (c)
   each step launches the flash forward and backward as the remat
   setting implies (24 each under "dots") and calls no plain attention
   version; one more step profiled (step ms, tokens/s, device busy time
   and idle share, peak memory, time by kind and the top kernels); (d)
   `run(6, inject_failure_at=4)` with a save every 2 steps lands on an
   uninterrupted `run(6)`'s parameters (rtol 1e-5, atol 1e-6) at 2 of
   the 24 layers (`TRAIN_CRASH_LAYERS`), full width.

It prints one `{"kernels": [...]}` JSON line (a row per kernel: the
scans' two routes are two kernels each, `wkv_scan` / `ssm_scan` for the
chunked prefill and `wkv_scan step` / `ssm_scan step` for the decode,
each with its route's launches), the card line, and last
`{"ok": true, "device": {...}}`; the flash backward's row counts its
launches in the train phase's steps, the scans' backwards theirs
(`wkv_scan bwd`, `ssm_scan bwd`).  It imports neither jax nor the JAX
package `repro`.  Without a card, or outside a checkout (no
`src/repro_torch` beside it), it exits 2 and prints nothing on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
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
# the backward of that TPU kernel (the JAX package has no backward kernel:
# its gradients are autodiff of flash_attention_xla, models/layers.py:149)
ATTN_BWD_TPU = {
    "flash_attention_bwd": "src/repro/kernels/flash_attention/kernel.py:75"}
# the forward's times at Qwen's and Jamba's prefill shapes when PR 16
# redesigned it (CHANGES.md, PR 16 and its follow-up; H100 80GB HBM3,
# 700 W): the lse output must not slow serving
FLASH_PR16_MS = {"prefill": 0.0641, "jamba prefill": 0.4108}
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
# train phase, once per architecture: bf16, TRAIN_B x TRAIN_S tokens a
# step, TRAIN_STEPS steps published while a request of TRAIN_SERVE
# (batch, prompt, decode steps) is served between steps
TRAIN_ARCH = ("qwen1.5-0.5b", "rwkv6-3b", "jamba-1.5-large-398b")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 8
TRAIN_SERVE = (1, 64, 8)
# RWKV6-3B at batch 8: parameters, AdamW's f32 moments, the pinned v1
# and the gradients take ~50 GB before activations, and remat "dots"
# keeps ~1.4 GB of f32 product outputs a layer at batch 8 (45 GB over
# 32 layers): the card forces a cut of the batch to 4 (widths and depth
# as published)
TRAIN_BATCH = {"rwkv6-3b": 4}
# Jamba-1.5-Large cannot train a period on one card (one MoE layer is
# 9.7 B parameters, ~78 GB at 8 bytes a parameter): its cut is the
# period's first position alone (Mamba with a dense MLP, as positions 0
# and 2 are), this many layers deep, at the published widths
TRAIN_CUT = {"jamba-1.5-large-398b": 2}
# check (a)'s depth where it is not the whole model: 2 layers at full
# width (the plain backwards' explicit reverse scans at full length)
TRAIN_CHECK_LAYERS = {"rwkv6-3b": 2}
# check (d) runs on this architecture only
TRAIN_CRASH_ARCH = "qwen1.5-0.5b"
# check (a)'s batch: the plain path's attention keeps [B, H, S, T] f32
# scores a layer for its backward (B 2: 128 MB a layer)
TRAIN_CHECK_B = 2
# check (d)'s depth cut: 2 of 24 layers at full width (336 M parameters,
# a 3.4 GB state a save, three saves)
TRAIN_CRASH_LAYERS = 2
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
TRAIN_SMOKE = False


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


def scan_store(torch, np, P=400_000, K=8, E=32):
    """The kernel phase's store on the card (`make_store`, seed 0), its
    floor (6,000) and member sets of M 0, 64 and 4,096 above it; and the
    generator, for the draws after them."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    data_np, ts_np = make_store(np, P, K, E, rng)
    data = torch.from_numpy(data_np).to(dev)
    ts = torch.from_numpy(ts_np).to(dev)
    floor = 6_000
    members = {m: torch.from_numpy(np.sort(rng.choice(
        np.arange(floor + 1, 12_000, dtype=np.int32), m, replace=False)))
        .to(dev) for m in (0, 64, 4096)}
    return data, ts, members, floor, rng


def kernel_phase(torch, np, K_mod, flush, P=400_000, K=8, E=32):
    from repro_torch.kernels.rss_gather import ref as RGR
    from repro_torch.kernels.rss_scan_agg import ref as R

    dev = torch.device("cuda")
    data, ts, members, floor, rng = scan_store(torch, np, P, K, E)
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

    def other_route(fn, args, kw, plain, timed):
        """`fn` on each route that takes the call beside the one `plan`
        chose, forced, == plain; printed, and timed when `timed`."""
        name, chosen = fn.__name__, fn.last_route
        members = args[2 if fn is K_mod.rss_scan_agg else 3].numel()
        label = (f"P={args[0].shape[0]} K={args[0].shape[1]} M={members} "
                 + (f"BP={kw['block_pages']}" if "block_pages" in kw
                    else f"G={kw['n_groups']}"))
        for route in K_mod.routes_for(name, members=members,
                                      block_pages=kw.get("block_pages", 8),
                                      n_groups=kw.get("n_groups", 1)):
            if route == chosen.route:
                continue
            check(name, fn(*args, route=route, **kw), plain)
            txt = _scan_launch_txt(fn.last_route)
            if timed:
                ms = time_ms(torch, lambda: fn(*args, route=route, **kw),
                             flush)
                print(f"kernel {name} {label} [{txt}, forced]: "
                      f"kernel_ms={ms:.4f}", flush=True)
            else:
                print(f"kernel {name} {label} [{txt}, forced] == plain",
                      flush=True)

    # rss_scan_agg: every M, timed at the main path's block size (BP=8)
    for m, mem in members.items():
        args = (data, ts, mem, floor, 1, 0, 50)
        got = K_mod.rss_scan_agg(*args, block_pages=8)
        want = R.rss_scan_agg_ref(*args, block_pages=8)
        check("rss_scan_agg", got, want)
        nbytes = P * page_bytes + m * 4 + got.numel() * 4
        t = report("rss_scan_agg", f"P={P} M={m} BP=8 "
                   f"[{_scan_launch_txt(K_mod.rss_scan_agg.last_route)}]",
                   lambda: K_mod.rss_scan_agg(*args, block_pages=8),
                   lambda: R.rss_scan_agg_ref(*args, block_pages=8), nbytes)
        other_route(K_mod.rss_scan_agg, args,
                    dict(block_pages=8), want, timed=True)
        # a yardstick of the scattered half: PyTorch's generic indexing
        # reading the chosen slots' tag and field alone (slots and row
        # index built first); no lower bound on those reads
        slot64 = RGR.rss_visible_slots_ref(ts, mem, floor).long()
        rows, tag_x = torch.arange(P, device=dev), data[:, :, :2]
        print(f"kernel rss_scan_agg P={P} M={m}: sector_only_ms="
              f"{time_ms(torch, lambda: tag_x[rows, slot64], flush):.4f} "
              "(tag and field of the chosen slots by indexing)", flush=True)
        if m == 64:
            results["rss_scan_agg"]["times"] = t
            _clean_l2_time(torch, f"rss_scan_agg P={P} M={m} BP=8",
                           lambda: K_mod.rss_scan_agg(*args, block_pages=8),
                           flush)
    for bp in (1, 2, 4):          # the shrink ladder's block sizes
        args = (data, ts, members[64], floor, 1, 0, 50)
        want = R.rss_scan_agg_ref(*args, block_pages=bp)
        check("rss_scan_agg", K_mod.rss_scan_agg(*args, block_pages=bp),
              want)
        print(f"kernel rss_scan_agg P={P} M=64 BP={bp} [" +
              _scan_launch_txt(K_mod.rss_scan_agg.last_route) + "] == plain",
              flush=True)
        other_route(K_mod.rss_scan_agg, args,
                    dict(block_pages=bp), want, timed=False)

    # chunked: every G with M = 64, plus every M at G=40
    gid_full = rng.integers(-1, 48, (P, 1), dtype=np.int32)

    def group_inputs(g, r=rng):
        gid_np = np.where(gid_full >= 0, gid_full % g, -1).astype(np.int32)
        prm = torch.from_numpy(np.stack([
            r.choice(np.array([1, 3], np.int32), g),
            r.choice(np.array([0, -2], np.int32), g),
            r.integers(-500, 500, g, dtype=np.int32)], 1)).to(dev)
        return torch.from_numpy(gid_np).to(dev), prm, int((gid_np >= 0).sum())

    for g in (1, 16, 40, 256):
        gid, prm, n_active = group_inputs(g)
        for m in ((0, 64, 4096) if g == 40 else (64,)):
            mem = members[m]
            kw = dict(n_groups=g, group_params=prm)
            gargs = (data, ts, gid, mem, floor)
            got_c = K_mod.rss_scan_agg_chunked(*gargs, **kw)
            want_c = R.rss_scan_agg_chunked_ref(*gargs, **kw)
            check("rss_scan_agg_chunked", got_c, want_c)
            chosen = _scan_launch_txt(K_mod.rss_scan_agg_chunked.last_route)
            base = P * 4 + n_active * page_bytes + m * 4 + g * 12
            tc = report("rss_scan_agg_chunked", f"P={P} G={g} M={m} "
                        f"[{chosen}]",
                        lambda: K_mod.rss_scan_agg_chunked(*gargs, **kw),
                        lambda: R.rss_scan_agg_chunked_ref(*gargs, **kw),
                        base + got_c.numel() * 4)
            other_route(K_mod.rss_scan_agg_chunked,
                        gargs, kw, want_c, timed=True)
            if g == 40 and m == 64:
                results["rss_scan_agg_chunked"]["times"] = tc
                _clean_l2_time(torch, f"rss_scan_agg_chunked P={P} G={g} "
                               f"M={m}", lambda: K_mod.rss_scan_agg_chunked(
                                   *gargs, **kw), flush)

    # grouped and the delta fold: every route at every timed shape
    for name, t in grouped_and_fold(torch, np, K_mod, flush, check, data,
                                    ts, members, floor).items():
        results[name]["times"] = t

    # the chunked call over the cluster route's shared-memory cap: the
    # global-atomic route, as `plan` chooses it
    chunked_groups(torch, np, K_mod, flush, data, ts, members[64], floor,
                   (K_mod.MAX_SMEM - K_mod.STAGE_BYTES) //
                   (K_mod.LANES * 4) + 1, check)

    # its own seed
    erng = np.random.default_rng(4)
    # K over the 8 timestamps a lane holds (walked 8 at a time), an odd E
    # (tag and field loaded one by one) and BP 3 (segment route only), at
    # a P over two rounds of the persistent grids
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_round = K_mod.WARP_BLOCKS_PER_SM * sms * K_mod.WARP_THREADS
    p_edge = -(-(2 * per_round + 17) // 24) * 24
    for k, e in ((9, 3), (33, 2)):
        d_np, t_np = make_store(np, p_edge, k, e, erng)
        d, t = torch.from_numpy(d_np).to(dev), torch.from_numpy(t_np).to(dev)
        gid, prm, _ = group_inputs(40, erng)
        gid = gid[:p_edge].contiguous()
        for bp in (3, 8):
            args = (d, t, members[64], floor, 1, 0, 50)
            want = R.rss_scan_agg_ref(*args, block_pages=bp)
            check("rss_scan_agg", K_mod.rss_scan_agg(*args, block_pages=bp),
                  want)
            other_route(K_mod.rss_scan_agg, args,
                        dict(block_pages=bp), want, timed=False)
        gargs = (d, t, gid, members[64], floor)
        kw = dict(n_groups=40, group_params=prm)
        want = R.rss_scan_agg_chunked_ref(*gargs, **kw)
        check("rss_scan_agg_chunked", K_mod.rss_scan_agg_chunked(*gargs,
                                                                 **kw), want)
        other_route(K_mod.rss_scan_agg_chunked,
                    gargs, kw, want, timed=False)
        print(f"kernel rss_scan_agg family P={p_edge} K={k} E={e}: BP 3 and "
              "8, and G 40 chunked, == plain on every route", flush=True)

    gather_kernels(torch, np, check, results, data, ts, members, floor,
                   flush)
    return results


def chunked_groups(torch, np, K_mod, flush, data, ts, mem, floor, g,
                   check) -> None:
    """`rss_scan_agg_chunked` at `g` groups, its group ids over 48 groups,
    as the smaller-G calls draw them, and spread over all `g`: each ==
    plain, its route printed where the wrapper reports one, timed beside
    its bound.  Only the wrappers' common contract is used, so
    `scripts/kernel_phase.py --groups G` runs it on an earlier tree's
    wrapper too."""
    from repro_torch.kernels.rss_scan_agg import ref as R

    rng = np.random.default_rng(5)
    P, K = ts.shape
    prm = torch.from_numpy(np.stack([
        rng.choice(np.array([1, 3], np.int32), g),
        rng.choice(np.array([0, -2], np.int32), g),
        rng.integers(-500, 500, g, dtype=np.int32)], 1)).to(data.device)
    fn = K_mod.rss_scan_agg_chunked
    for spread, hi in (("48 groups", 48), ("spread", g)):
        gid_np = rng.integers(-1, hi, (P, 1), dtype=np.int32)
        gid = torch.from_numpy(gid_np).to(data.device)
        gargs, kw = (data, ts, gid, mem, floor), dict(n_groups=g,
                                                      group_params=prm)
        got = fn(*gargs, **kw)
        check("rss_scan_agg_chunked", got,
              R.rss_scan_agg_chunked_ref(*gargs, **kw))
        launch = getattr(fn, "last_route", None)
        nbytes = (P * 4 + int((gid_np >= 0).sum()) * (K * 4 + 32)
                  + mem.numel() * 4 + g * 12 + got.numel() * 4)
        ms = time_ms(torch, lambda: fn(*gargs, **kw), flush)
        print(f"kernel rss_scan_agg_chunked P={P} G={g} M={mem.numel()} "
              f"gid {spread} ["
              f"{_scan_launch_txt(launch) if launch else 'one route'}]: "
              f"kernel_ms={ms:.4f} "
              f"bound_ms={nbytes / HBM_BYTES_PER_S * 1e3:.4f}", flush=True)


# rss_scan_agg_grouped (P, G, M, BP): the kernel phase's store at every G
# (M 64) and every M (G 40) at BP 8, at BP 3 (P cut to a multiple of 3;
# a warp tile of 10 segments) and at BP 64 (the segment route's), then
# every shape of the driver phase (a store of their own, made at the
# first and largest; M 0); rss_delta_fold (Lp, Dp): the flush buffer's
# shapes, Lp 8 on both sides of the sliced and grid routes' switch and at
# every larger Dp of the driver phase, Lp 64 and 2,048 at 131,072 rows
# (the grid route's cap on partials), and Lp over a block's shared memory
GROUPED_SHAPES = ((400_000, 1, 64, 8), (400_000, 16, 64, 8),
                  (400_000, 40, 64, 8), (400_000, 256, 64, 8),
                  (400_000, 40, 0, 8), (400_000, 40, 4096, 8),
                  (399_999, 40, 64, 3), (400_000, 40, 64, 64),
                  (920_008, 43, 0, 8), (800_016, 3, 0, 8),
                  (400_016, 2, 0, 8), (120_016, 2, 0, 8))
FOLD_SHAPES = ((64, 256), (8, 256), (8, 1024), (8, 2048), (8, 4096),
               (8, 8192), (8, 32_768), (8, 131_072), (8, 262_144),
               (8, 524_288), (8, 1_048_576), (64, 131_072), (2048, 131_072),
               (16_384, 256))


def _device_ops(torch, fn) -> int:
    """Device operations (kernels, copies, fills) of one `fn()` call in a
    torch.profiler trace: the most of three traces, since a trace may
    drop an event (a two-operation call once showed one) but never adds
    one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen.append(sum(e.device_type == DeviceType.CUDA
                        for e in prof.events()))
    return max(seen)


def grouped_and_fold(torch, np, K_mod, flush, check, data, ts, members,
                     floor) -> dict:
    """`rss_scan_agg_grouped` at GROUPED_SHAPES and `rss_delta_fold` at
    FOLD_SHAPES, each on every route that takes the call where the
    wrapper plans routes (else the one it has): == plain, timed beside
    its byte bound and a yardstick (`fill_only_ms`: PyTorch's `fill_` of
    a tensor the size of the grouped output, the floor for writing it
    once; `sector_only_ms`: `delta[:, :8].sum()`, PyTorch reading the
    first sector of every delta row), and its device operations a call
    counted in a profiler trace (one, where it plans routes).  Only the
    wrappers' common contract is used, so `scripts/kernel_phase.py TREE
    --shapes` runs it on an earlier tree's wrappers.  Returns {name: (ms,
    plain_ms, bound_ms)} at P 400,000 G 40 M 64 and at Lp 64 Dp 256, on
    the route `plan` gives."""
    from repro_torch.kernels.rss_scan_agg import ref as R

    dev = data.device
    rng = np.random.default_rng(6)
    planned = getattr(K_mod, "ROUTES", {})
    times = {}

    def routes(name, **kw):
        return K_mod.routes_for(name, **kw) if name in planned else (None,)

    def timed(name, label, fn, plain, nbytes, want, kw, extra):
        """fn on each route == plain, each timed (the route `plan` takes
        last); plain timed once.  Returns the times on `plan`'s route."""
        plain_ms = time_ms(torch, plain, flush, reps=5)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        note = extra()
        for route in routes(name, **kw):
            call = (fn if route is None else
                    lambda route=route: fn(route=route))
            check(name, call(), want)
            launch = getattr(getattr(K_mod, name), "last_route", None)
            ops = _device_ops(torch, call)
            if route is not None and ops != 1:
                raise AssertionError(f"{name} {label} route {route}: "
                                     f"{ops} device operations a call")
            ms = time_ms(torch, call, flush)
            txt = _scan_launch_txt(launch) if launch else "one route"
            print(f"kernel {name} {label} [{txt}]: kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} {note} bound_ms="
                  f"{bound_ms:.4f} ({nbytes / 1e6:.1f} MB), {ops} device "
                  "operation(s) a call", flush=True)
        return ms, plain_ms, bound_ms

    big = None
    for P, g, m, bp in GROUPED_SHAPES:
        if P > data.shape[0] and big is None:
            d_np, t_np = make_store(np, P, 8, 32, np.random.default_rng(7))
            big = torch.from_numpy(d_np).to(dev), torch.from_numpy(t_np).to(
                dev)
            del d_np, t_np
        d, t = ((data[:P], ts[:P]) if P <= data.shape[0]
                else (big[0][:P], big[1][:P]))
        k = t.shape[1]
        gid_np = rng.integers(-1, g, (P, 1), dtype=np.int32)
        gid = torch.from_numpy(gid_np).to(dev)
        prm = torch.from_numpy(np.stack([
            rng.choice(np.array([1, 3], np.int32), g),
            rng.choice(np.array([0, -2], np.int32), g),
            rng.integers(-500, 500, g, dtype=np.int32)], 1)).to(dev)
        a = (d, t, gid, members[m], floor)
        kw = dict(n_groups=g, group_params=prm, block_pages=bp)
        want = R.rss_scan_agg_grouped_ref(*a, **kw)
        shell = torch.empty_like(want)
        nbytes = (P * 4 + int((gid_np >= 0).sum()) * (k * 4 + 32) + m * 4
                  + g * 12 + want.numel() * 4)
        t_ = timed("rss_scan_agg_grouped", f"P={P} G={g} M={m} BP={bp}",
                   lambda route=None, a=a, kw=kw:
                   K_mod.rss_scan_agg_grouped(
                       *a, **kw, **({} if route is None else
                                    {"route": route})),
                   lambda a=a, kw=kw: R.rss_scan_agg_grouped_ref(*a, **kw),
                   nbytes, want, dict(block_pages=bp, n_groups=g, members=m),
                   lambda: "fill_only_ms="
                   f"{time_ms(torch, lambda: shell.fill_(0), flush)}")
        if (P, g, m, bp) == (400_000, 40, 64, 8):
            times["rss_scan_agg_grouped"] = t_
    del big
    for lp, dp in FOLD_SHAPES:
        acc = torch.from_numpy(np.concatenate([
            rng.integers(-2**20, 2**20, (lp, 3), dtype=np.int32),
            rng.integers(-100, 100, (lp, 2), dtype=np.int32),
            rng.integers(-2**20, 2**20, (lp, 123), dtype=np.int32)],
            1)).to(dev)
        cols = np.stack([rng.integers(-1, lp, dp),
                         rng.integers(-2**20, 2**20, dp),
                         rng.integers(0, 2, dp),
                         rng.integers(-2**20, 2**20, dp),
                         rng.integers(0, 2, dp),
                         rng.integers(-1000, 1000, dp)], 1).astype(np.int32)
        delta = torch.zeros((dp, 128), dtype=torch.int32, device=dev)
        delta[:, :6] = torch.from_numpy(cols).to(dev)
        want = R.rss_delta_fold_ref(acc, delta)
        t_ = timed("rss_delta_fold", f"Lp={lp} Dp={dp}",
                   lambda route=None, acc=acc, delta=delta:
                   K_mod.rss_delta_fold(acc, delta, **(
                       {} if route is None else {"route": route})),
                   lambda acc=acc, delta=delta:
                   R.rss_delta_fold_ref(acc, delta),
                   dp * 32 + 2 * lp * 128 * 4, want,
                   dict(lanes=lp, rows=dp),
                   lambda delta=delta: "sector_only_ms=" + (
                       f"{time_ms(torch, lambda: delta[:, :8].sum(), flush)}"
                       if dp > 4096 else "-"))
        if (lp, dp) == (64, 256):
            times["rss_delta_fold"] = t_
    return times


def _scan_launch_txt(launch) -> str:
    """A scan+aggregate wrapper's `last_route` as printed: route, grid x
    block, cluster and dynamic shared memory."""
    grid = " x ".join(str(g) for g in launch.grid)
    return (f"route {launch.route}, grid {grid} of {launch.block} threads, "
            f"cluster {launch.cluster}, {launch.smem} B shared")


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


@contextlib.contextmanager
def record_scan_shapes(K_mod):
    """Count the calls of each `rss_scan_agg` kernel that the ops layer
    makes, by shape: (P, M, BP) for `rss_scan_agg`, (P, G, M, BP) for
    `rss_scan_agg_grouped`, (P, G, M) for `rss_scan_agg_chunked`, (Lp,
    Dp) for `rss_delta_fold`, each with the route it took.  Wraps the
    names `kernels.rss_scan_agg.ops` calls; yields the Counter."""
    from collections import Counter

    from repro_torch.kernels.rss_scan_agg import ops

    shapes = Counter()

    def route_of(fn):
        return f" route={fn.last_route.route}" if fn.last_route else ""

    def scan(fn):
        def call(data, ts, member_ts, *a, block_pages=8, **kw):
            out = fn(data, ts, member_ts, *a, block_pages=block_pages, **kw)
            P = data.shape[0]
            shapes[(fn.__name__, f"P={P} M={member_ts.numel()} "
                    f"BP={min(block_pages, P)}{route_of(fn)}")] += 1
            return out
        return call

    def grouped(fn):
        def call(data, ts, gid, member_ts, *a, n_groups=1, **kw):
            out = fn(data, ts, gid, member_ts, *a, n_groups=n_groups, **kw)
            bp = min(kw.get("block_pages", 8), data.shape[0])
            tail = (f" BP={bp}" if fn is K_mod.rss_scan_agg_grouped
                    else "") + route_of(fn)
            shapes[(fn.__name__, f"P={data.shape[0]} G={n_groups} "
                    f"M={member_ts.numel()}{tail}")] += 1
            return out
        return call

    def fold(fn):
        def call(acc, delta):
            out = fn(acc, delta)
            shapes[(fn.__name__, f"Lp={acc.shape[0]} Dp={delta.shape[0]}"
                    f"{route_of(fn)}")] += 1
            return out
        return call

    wraps = {"rss_scan_agg": scan, "rss_scan_agg_grouped": grouped,
             "rss_scan_agg_chunked": grouped, "rss_delta_fold": fold}
    saved = {name: getattr(ops, name) for name in wraps}
    for name, wrap in wraps.items():
        setattr(ops, name, wrap(getattr(K_mod, name)))
    try:
        yield shapes
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def driver_phase(torch, K_mod, rounds: int,
                 profile_dir: Path | None = None) -> dict:
    from repro_torch.kernels.cuda_build import launch_count
    from repro_torch.mvcc import Scale, run_single_node

    scale = Scale(**TPCC)
    run = lambda: run_single_node(
        olap_mode="ssi+rss", oltp_clients=8, olap_clients=4, rounds=rounds,
        seed=0, scale=scale, olap_scan=True, paged_olap=True,
        batch_plans=True, materialize=True, check_scans=True, device="cuda")
    K_mod.reset_launches()
    t0 = time.perf_counter()
    with record_scan_shapes(K_mod) as shapes:
        m = run() if profile_dir is None else _profiled(torch, run,
                                                         profile_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: launch_count(fn) for fn in K_mod.KERNELS}
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
    for (name, shape), n in sorted(shapes.items()):
        print(f"driver launch shape: {name} {shape}: {n}", flush=True)
    for name in ("rss_scan_agg", "rss_scan_agg_grouped",
                 "rss_scan_agg_chunked", "rss_delta_fold"):
        print(f"driver launches by route: {name} "
              f"{getattr(K_mod, name).route_launches}", flush=True)
    if sum(shapes.values()) != sum(launches.values()):
        raise AssertionError(f"shapes {sum(shapes.values())} != launches "
                             f"{sum(launches.values())}")
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
            if label in FLASH_PR16_MS:
                print(f"kernel flash_attention {label}: {t[0]:.4f} ms "
                      f"(PR 16: {FLASH_PR16_MS[label]} ms)", flush=True)
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


# flash backward phase: (label, dtype, B, S, T, H, K, hd, causal, window,
# timed): Qwen1.5-0.5B's train shape, GQA + window, MQA (granite-34b's
# 48 heads on one KV head), ragged S = T = 1,000 in bf16 and f32
BWD_CASES = [
    ("train", "bfloat16", 8, 1024, 1024, 16, 16, 64, True, 0, True),
    ("gqa+window", "bfloat16", 2, 2048, 2048, 32, 8, 128, True, 256, True),
    ("mqa", "bfloat16", 2, 1024, 1024, 48, 1, 128, True, 0, True),
    ("ragged", "bfloat16", 2, 1000, 1000, 16, 16, 64, True, 0, False),
    ("ragged", "float32", 2, 1000, 1000, 8, 2, 32, False, 0, False)]


def _sdpa_bwd(torch, q, k, v, do, causal: bool, window: int):
    """The backward alone of `scaled_dot_product_attention` on its flash
    route (is_causal, enable_gqa) over the same inputs, or None where
    that route does not take the call (a window needs a mask; f32)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if window or q.dtype == torch.float32:
        return None
    qh, kh, vh = (x.detach().contiguous().requires_grad_() for x in (q, k, v))
    dh = do.contiguous()
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                                 enable_gqa=True)
    except RuntimeError:
        return None
    return lambda: torch.autograd.grad(out, (qh, kh, vh), dh,
                                       retain_graph=True)


def attention_bwd_phase(torch, np, flush, device: str = "cuda") -> dict:
    """`fa_flash_bwd` (`flash_attention_bwd`) on numpy-seeded inputs at
    `BWD_CASES`, in the model's layout, from the forward kernel's o and
    lse: held against `attention_bwd_ref` on the same inputs (bf16 within
    3e-2 of each gradient's max-abs, f32 within 2e-5), two launches
    bitwise equal, and the timed shapes timed beside the plain version,
    the bound (10·pairs·hd·B·H operations against the bytes of q, k, v,
    o, dO, dq, dk, dv) and SDPA's backward on its flash route.  Returns
    {"max_abs_err", "times" (the train shape's)}.  Off the card the
    wrapper is the plain version and nothing is timed."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in f32
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    rng = np.random.default_rng(21)
    tol = {"bfloat16": 3e-2, "float32": 2e-5}
    res = {"max_abs_err": 0.0}
    for (label, dt, B, S, T, H, K, hd, causal, window, timed) in BWD_CASES:
        def arr(*shape):
            x = rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(x).to(device, getattr(torch, dt))
        q, do = (arr(B, S, H, hd).transpose(1, 2) for _ in range(2))
        k, v = (arr(B, T, K, hd).transpose(1, 2) for _ in range(2))
        o, lse = FK.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
        fn = lambda: FK.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, window=window)
        plain = lambda: attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                          window=window)
        got, again = fn(), fn()
        if on_card:
            torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label} {dt}: two "
                                 "launches differ")
        ratios = []
        for name, a, b in zip("qkv", got, plain()):
            a, b = a.float(), b.float()
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if not torch.isfinite(a).all() or not err <= tol[dt] * scale:
                raise AssertionError(
                    f"flash_attention_bwd {label} {dt} d{name}: kernel != "
                    f"plain (max |d| {err:.4g}, max-abs {scale:.4g})")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            ratios.append(f"d{name} {err / scale:.3g}")
        shape = (f"{dt} B={B} S={S} T={T} H={H} K={K} hd={hd} causal={causal}"
                 f" window={window} route={FK.flash_attention_bwd.last_route}")
        print(f"kernel flash_attention_bwd {label} {shape}: within "
              f"{tol[dt]} of plain (max |d| / max-abs {', '.join(ratios)}), "
              "two launches bitwise equal", flush=True)
        if timed and on_card:
            ms = time_ms(torch, fn, flush)
            plain_ms = time_ms(torch, plain, flush, reps=5)
            lib = _sdpa_bwd(torch, q, k, v, do, causal, window)
            library_ms = None if lib is None else time_ms(torch, lib, flush)
            nbytes = q.element_size() * 4 * (B * S * H * hd + B * T * K * hd)
            flops = 10 * B * H * hd * _visible_pairs(np, S, T, causal, window)
            bound_ms, by = _bound(nbytes, flops, dt)
            lib_txt = "null (no flash route)" if library_ms is None \
                else f"{library_ms:.4f}"
            print(f"kernel flash_attention_bwd {label}: kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
                  f"library_ms={lib_txt} ({nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP)", flush=True)
            if label == "train":
                res["times"] = (ms, plain_ms, bound_ms, library_ms, by)
        del q, k, v, o, lse, do, got, again
    return res


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
    if launch.route == "reverse":
        return f"route reverse, grid {grid} of {launch.block} threads"
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


# --------------------------------------------------------- scan backwards
def _wkv_bwd_cost(B: int, T: int, H: int, N: int, itemsize: int):
    """Bytes the WKV backward must move (r, k, v, w_log and dO read once,
    the forward's chunk states and u, the four gradients written once,
    du) and its f32 operations: per step and head S^T dO, G v and G^T k
    (N^2 FMAs each) and G advanced (N^2 mul + FMA), 9 N^2 flops.  Not
    counted, so that the bound stays the least work and does not move
    with the kernel's design: what the kernel does beyond it (the state
    recomputed from the saved states with the segment's state from zero
    beside it, 6 N^2 flops a step, and the adjoint run twice, from zero
    and then from its true value, in f64), its further reads of the
    inputs and its ~300 MB of scratch (a, the jumps, e, gin)."""
    elems = B * T * H * N
    nbytes = (elems * (4 * itemsize + 4 + 4 * itemsize)
              + B * H * -(-T // 64) * N * N * 4 + 2 * H * N * 4)
    return nbytes, 9 * B * H * T * N * N


def _ssm_bwd_cost(Bb: int, T: int, Di: int, N: int, u_size: int):
    """Bytes the selective scan's backward must move (u, dt, dy read once,
    B, C, A, D, the forward's chunk states; du, ddt, dB, dC, dA, dD
    written once), its f32 operations, 17 per (b, t, d, n) (the adjoint's
    FMA, the dB and dC products, ddt's two products and two FMAs, du's
    FMA, dA's product and FMA, the carry's product, the decay's argument
    and its product with h_{t-1}; the state's recompute not counted), and
    its exponentials, one per (b, t, d, n)."""
    elems = Bb * T * Di
    nbytes = (elems * (2 * u_size + 4 + 4 + 4) + 4 * Bb * T * N * 4
              + 2 * Di * N * 4 + 2 * Di * 4
              + Bb * -(-T // 8) * Di * N * 4)
    return nbytes, 17 * elems * N, elems * N


def _kernel_split(torch, fn, calls: int = 5) -> dict:
    """Device time in us of one `fn()` call by kernel name (all launches
    of a name summed), from a torch.profiler trace of `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "", e.key):
            e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


def _grads_close(torch, label, got, want, names, tol, tol16=None):
    """Each gradient within `tol` of its max-abs (a 16-bit one within
    `tol16`: both sides round it to its type); returns the largest
    |d| over them."""
    worst, seen = 0.0, []
    for name, a, b in zip(names, got, want):
        if b is None:
            continue
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        ratio = err / max(b.abs().max().item(), 1e-30)
        t = tol16 if tol16 is not None and got[names.index(name)].dtype \
            != torch.float32 else tol
        if not (torch.isfinite(a).all() and ratio <= t):
            raise AssertionError(f"{label} {name}: kernel != plain (max |d| "
                                 f"/ max = {ratio:.3g} > {t})")
        worst = max(worst, err)
        seen.append(f"{name} {ratio:.3g}")
    print(f"{label}: max |d| / max per gradient {', '.join(seen)}",
          flush=True)
    return worst


def scan_bwd_phase(torch, np, flush) -> dict:
    """The two scan backward kernels, `wkv_scan_bwd` and `ssm_scan_bwd`,
    on numpy-seeded inputs at the train phase's shapes (RWKV6-3B: f32
    r/k/v/w_log B = TRAIN_BATCH x 1,024 x 40 x 64 from the forward
    kernel's chunk states, at the reference test's decays and at
    RWKV6-3B's own; Jamba's Mamba layer: one microbatch, bf16 u, 1 x
    1,024 x 16,384 x 16 at Jamba's scales), against the plain backwards
    on the same inputs (each gradient within 1e-4 of its max-abs; bf16
    du within that plus one bf16 step, 2^-7), two launches bitwise equal,
    timed beside plain and the bound (bytes at 3.35 TB/s; f32 operations
    at 67 TFLOP/s and exponentials on the SFU); `library_ms` None: no
    PyTorch call computes either.  The SSM backward's device time is also
    split by kernel (the reverse scan, the sums of its partials) from a
    profiler trace.  Returns {"wkv_scan bwd": {...}, "ssm_scan bwd":
    {...}}, each {"max_abs_err", "times"}."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_bwd_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    put = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev)
    res = {}
    B, T, H, N = TRAIN_BATCH.get("rwkv6-3b", TRAIN_B), TRAIN_S, 40, 64
    names = ("dr", "dk", "dv", "dw_log", "du")
    res["wkv_scan bwd"] = {"max_abs_err": 0.0}
    for scale in ("reference", "rwkv6"):
        ref = scale == "reference"
        s = 0.5 if ref else 1.0
        x = [(s * put(B, T, H, N)).transpose(1, 2) for _ in range(2)]
        x.append(put(B, T, H, N).transpose(1, 2))
        x.append((-torch.exp(put(B, T, H, N) - (2 if ref else 6)))
                 .transpose(1, 2))
        u = ((0.1 if ref else 0.5) * put(H, N))[None].expand(B, H, N)
        _, _, states = WK.wkv_scan(*x, u, return_states=True)
        do = put(B, T, H, N).transpose(1, 2)
        call = lambda: WK.wkv_scan_bwd(*x, u, do, None, None, states)
        got, again = call(), call()
        label = (f"kernel wkv_scan bwd f32 B={B} T={T} H={H} N={N} "
                 f"decay={scale} [{_launch_txt(WK.wkv_scan_bwd.last_route)}"
                 "]")
        if not all(torch.equal(a, b) for a, b in zip(got[:5], again[:5])):
            raise AssertionError("wkv_scan bwd: two launches differ")
        want = wkv_scan_bwd_ref(*x, u, do, None, None, states)
        err = _grads_close(torch, label + ", two launches bitwise equal",
                           got, want, names, 1e-4)
        res["wkv_scan bwd"]["max_abs_err"] = max(
            res["wkv_scan bwd"]["max_abs_err"], err)
        if ref:
            ms = time_ms(torch, call, flush)
            plain_ms = time_ms(torch, lambda: wkv_scan_bwd_ref(
                *x, u, do, None, None, states), flush, reps=3)
            nbytes, flops = _wkv_bwd_cost(B, T, H, N, 4)
            bound_ms, by = _bound(nbytes, flops, "float32")
            print(f"{label}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP) library_ms=null (no PyTorch "
                  "call computes the WKV6 backward)", flush=True)
            res["wkv_scan bwd"]["times"] = (ms, plain_ms, bound_ms, None, by)
        del x, u, states, do, got, again, want
    Bb, Di, Ns = 1, 16384, 16
    F = torch.nn.functional
    u = put(Bb, T, Di).to(torch.bfloat16)
    dt = F.softplus(put(Bb, T, Di))
    Bm, C = put(Bb, T, Ns), put(Bb, T, Ns)
    A = -torch.arange(1, Ns + 1, device=dev,
                      dtype=torch.float32).expand(Di, Ns).contiguous()
    D = torch.ones(Di, device=dev)
    _, _, states = SK.ssm_scan(u, dt, Bm, C, A, D, return_states=True)
    dy = put(Bb, T, Di)
    call = lambda: SK.ssm_scan_bwd(u, dt, Bm, C, A, D, dy, None, None,
                                   states)
    got, again = call(), call()
    if not all(torch.equal(a, b) for a, b in zip(got[:6], again[:6])):
        raise AssertionError("ssm_scan bwd: two launches differ")
    label = (f"kernel ssm_scan bwd bf16 u Bb={Bb} T={T} Di={Di} N={Ns} "
             f"scale=jamba [{_launch_txt(SK.ssm_scan_bwd.last_route)}]")
    want = ssm_scan_bwd_ref(u, dt, Bm, C, A, D, dy, None, None, states)
    err = _grads_close(torch, label + ", two launches bitwise equal", got,
                       want, ("du", "ddt", "dB", "dC", "dA", "dD"), 1e-4,
                       1e-4 + 2 ** -7)
    ms = time_ms(torch, call, flush)
    plain_ms = time_ms(torch, lambda: ssm_scan_bwd_ref(
        u, dt, Bm, C, A, D, dy, None, None, states), flush, reps=3)
    nbytes, flops, n_exp = _ssm_bwd_cost(Bb, T, Di, Ns, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FLOPS["float32"], n_exp / SFU_PER_S) * 1e3
    bound_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops \
        else (t_ops, "operations")
    print(f"{label}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({by}; {nbytes / 1e6:.1f} MB "
          f"{t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP "
          f"{flops / PEAK_FLOPS['float32'] * 1e3:.4f} ms, {n_exp / 1e9:.3f} "
          f"G exponentials {n_exp / SFU_PER_S * 1e3:.4f} ms) "
          "library_ms=null (no PyTorch call computes the selective scan's "
          "backward)", flush=True)
    print(f"{label}: device time by kernel "
          + ", ".join(f"{name} {us / 1e3:.4f} ms" for name, us in
                      _kernel_split(torch, call).items()), flush=True)
    res["ssm_scan bwd"] = {"max_abs_err": err,
                           "times": (ms, plain_ms, bound_ms, None, by)}
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
    from repro_torch.tree import tree_map

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
    p32 = tree_map(lambda x: x.float(), params)
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
    from repro_torch.tree import leaves

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
    n_params = sum(x.numel() for x in leaves(v1))
    print(f"serve: {run} {n_params / 1e9:.3f} B params "
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


# ------------------------------------------------------------------ training
@contextlib.contextmanager
def count_plain():
    """Inside the block, calls of the plain versions the train path could
    fall back on (the layers' chunked softmax, `attention_ref`,
    `attention_bwd_ref`, the scans' plain forwards and backwards) are
    counted in the yielded dict; on the card the train path makes
    none."""
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import ref as WR
    from repro_torch.models import layers

    calls = {"calls": 0}
    sites = [(layers, "flash_attention_chunked"), (FR, "attention_ref"),
             (FO, "attention_bwd_ref"), (WR, "wkv_scan_plain"),
             (WR, "wkv_scan_bwd_ref"), (SR, "ssm_scan_ref"),
             (SR, "ssm_scan_bwd_ref")]
    saved = [getattr(m, n) for m, n in sites]

    def counted(fn):
        def wrapper(*a, **kw):
            calls["calls"] += 1
            return fn(*a, **kw)
        return wrapper

    for (m, n), fn in zip(sites, saved):
        setattr(m, n, counted(fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(sites, saved):
            setattr(m, n, fn)


@contextlib.contextmanager
def plain_train_scans():
    """Inside the block, the scan ops (`WKVScan`, `SSMScan` and the serve
    path) call the plain forwards and the plain backwards (the explicit
    reverse scans) on the tensors' own device: with `plain_attention`,
    the plain path of the train phase's check (a)."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    sites = [(WK, "wkv_scan", WR.wkv_scan_plain),
             (WK, "wkv_scan_bwd", WR.wkv_scan_bwd_ref),
             (SK, "ssm_scan", SR.ssm_scan_ref),
             (SK, "ssm_scan_bwd", SR.ssm_scan_bwd_ref)]
    saved = [getattr(m, n) for m, n, _ in sites]
    for m, n, fn in sites:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for (m, n, _), fn in zip(sites, saved):
            setattr(m, n, fn)


@contextlib.contextmanager
def checked_scan_bwd():
    """Inside the block, every scan backward launch (`wkv_scan_bwd`,
    `ssm_scan_bwd`) is held against the plain backward on the same
    inputs, run in f64 (so the comparison measures the kernel's f32
    rounding, not the plain version's: at RWKV6-3B's slow decays both
    carry recurrences over 1,024 steps): each gradient within 1e-4 of
    its max-abs (a bf16 du within that plus one bf16 step, 2^-7).  The
    yielded dict counts the launches and keeps the worst ratio."""
    import torch

    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    seen = {"launches": 0, "worst": 0.0}

    def checked(kernel, plain, names):
        wide = lambda x: x.double() if isinstance(x, torch.Tensor) \
            and x.is_floating_point() else x

        def call(*a, **kw):
            got = kernel(*a, **kw)
            want = plain(*map(wide, a), **{k: wide(x) for k, x in kw.items()})
            for name, x, y in zip(names, got, want):
                if y is None:
                    continue
                ratio = ((x.float() - y.float()).abs().max()
                         / y.float().abs().max().clamp_min(1e-30)).item()
                tol = 1e-4 if x.dtype == torch.float32 else 1e-4 + 2 ** -7
                if not ratio <= tol:
                    raise AssertionError(
                        f"train (a) {kernel.__name__} launch "
                        f"{seen['launches']}, {name}: max |d| / max = "
                        f"{ratio:.4g} > {tol}")
                seen["worst"] = max(seen["worst"], ratio)
            seen["launches"] += 1
            return got
        # the kernel wrapper counts through its module-level name, which
        # is this function while the block runs: share its dict
        call.route_launches = kernel.route_launches
        return call

    saved = WK.wkv_scan_bwd, SK.ssm_scan_bwd
    WK.wkv_scan_bwd = checked(WK.wkv_scan_bwd, WR.wkv_scan_bwd_ref,
                              ("dr", "dk", "dv", "dw_log", "du", "ds0"))
    SK.ssm_scan_bwd = checked(SK.ssm_scan_bwd, SR.ssm_scan_bwd_ref,
                              ("du", "ddt", "dB", "dC", "dA", "dD", "dh0"))
    try:
        yield seen
    finally:
        WK.wkv_scan_bwd, SK.ssm_scan_bwd = saved


@contextlib.contextmanager
def timed_saves():
    """Inside the block, each checkpoint save's wall seconds are appended
    to the yielded list."""
    from repro_torch.checkpoint import manager

    save, times = manager.save, []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = save(*a, **kw)
        times.append(time.perf_counter() - t0)
        return out

    manager.save = timed
    try:
        yield times
    finally:
        manager.save = save


def _leaf_ratios(torch, got, want) -> dict:
    """path -> max |got - want| / max |want| over the float leaves."""
    from repro_torch.tree import leaves_with_path

    out = {}
    for (path, a), b in zip(leaves_with_path(got), [
            x for _, x in leaves_with_path(want)]):
        if a.is_floating_point():
            a, b = a.float(), b.float()
            out["/".join(map(str, path))] = (
                (a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
    return out


def train_config(arch: str):
    """The train phase's config of `arch`: published (or its smoke variant
    with TRAIN_SMOKE), cut as TRAIN_CUT says."""
    from repro_torch.configs import get_config, smoke_variant

    cfg = get_config(arch)
    cfg = smoke_variant(cfg) if TRAIN_SMOKE else cfg
    if arch in TRAIN_CUT:
        cfg = cfg.with_overrides(pattern=cfg.pattern[:1],
                                 n_layers=TRAIN_CUT[arch])
    return cfg


def _train_check_a(torch, cfg, device) -> str:
    """Check (a): one step's loss and gradients on the kernels against
    the plain path (`plain_attention`, `plain_train_scans`: the plain
    forwards and the plain backwards) on the card, at TRAIN_CHECK_B x
    TRAIN_S: in f32 with TF32 off (loss 1e-5 relative, each leaf within
    1e-3 of its max-abs), and in bf16 on the same weights rounded to the
    bf16 model's dtypes (loss
    3e-2 relative; each leaf's ratio printed beside the bf16 model's own
    distance from the f32 one, the noise floor)."""
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import init_params
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.with_overrides(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    p32 = init_params(cfg32, gen, device)
    # the same weights in the bf16 model's own dtypes (its f32 leaves,
    # Mamba's A_log, D and dt_bias among them, stay f32)
    p16 = tree_map(lambda x, like: x.to(like.dtype), p32,
                   init_params(cfg, None, "meta"))
    batch = SyntheticPipeline(cfg, batch=TRAIN_CHECK_B, seq_len=TRAIN_S,
                              device=device).batch_at(0)

    def run(c, p, plain):
        with plain_attention() if plain else contextlib.nullcontext(), \
                plain_train_scans() if plain else contextlib.nullcontext():
            loss, grads = _value_and_grad(p, c, batch)
        return loss.item(), grads

    out = []
    for label, c, p, tol_loss, tol_leaf in (
            ("f32", cfg32, p32, 1e-5, 1e-3), ("bf16", cfg, p16, 3e-2, None)):
        lk, gk = run(c, p, False)
        lp, gp = run(c, p, True)
        rel = abs(lk - lp) / abs(lp)
        if not (math.isfinite(lk) and rel <= tol_loss):
            raise AssertionError(f"train (a) {label}: loss {lk} != plain "
                                 f"{lp} ({rel:.3g} > {tol_loss})")
        ratios = _leaf_ratios(torch, gk, gp)
        bad = {k: r for k, r in ratios.items()
               if not (tol_leaf is None or r <= tol_leaf)}
        if bad or not all(math.isfinite(r) for r in ratios.values()):
            raise AssertionError(f"train (a) {label}: gradients off plain "
                                 f"beyond {tol_leaf}: {bad}")
        if label == "f32":
            g32 = gp
        else:
            floor = _leaf_ratios(torch, gp, g32)
            for k in ratios:
                print(f"train (a) bf16 leaf {k}: kernel vs plain "
                      f"{ratios[k]:.4g}, bf16 vs f32 noise floor "
                      f"{floor[k]:.4g}", flush=True)
        worst = max(ratios, key=ratios.get)
        out.append(f"{label} loss {lk:.6f} vs plain {lp:.6f} ({rel:.3g} <= "
                   f"{tol_loss}), worst leaf {worst} {ratios[worst]:.3g}"
                   + (f" (<= {tol_leaf})" if tol_leaf else " (printed)"))
        del gk, gp
    del p32, p16, g32
    return "; ".join(out)


def _train_profile(torch, tr, B: int, at: int) -> None:
    """One more step (of the trainer's state, on batch `at`) timed on the
    host clock, then again under torch.profiler: step ms, tokens/s,
    device busy time and idle share (against the unprofiled step), peak
    memory, device time by kind."""
    from torch.profiler import ProfilerActivity, profile

    batch = tr.pipeline.batch_at(at)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = tr.step_fn(tr.state, batch)[1]     # the new state dropped at once
    float(m["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m = tr.step_fn(tr.state, batch)[1]     # the new state dropped at once
        float(m["loss"])
        torch.cuda.synchronize()
    kinds: dict = {}
    top = []
    for e in prof.key_averages():
        us, name = e.self_device_time_total, e.key
        if us <= 0:
            continue
        top.append((us, e.count, name))
        low = name.lower()
        kind = ("flash backward" if "flash_bwd" in name else
                "flash forward" if "flash_kernel" in name else
                "scan backward" if any(w in name for w in (
                    "wkv_bwd", "ssm_bwd", "sum_leading")) else
                "scan forward" if any(w in name for w in (
                    "wkv_kernel", "ssm_kernel")) else
                "matmul" if any(w in low for w in ("gemm", "gemv", "xmma",
                                                   "cutlass", "splitk",
                                                   "nvjet"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us
    busy = sum(kinds.values()) / 1e6
    S = TRAIN_S
    print(f"train profile {tr.cfg.name}: step {step_s * 1e3:.1f} ms, "
          f"{B * S / step_s:.1f} tokens/s ({B}x{S}); device busy "
          f"{busy * 1e3:.1f} ms, idle share {1 - busy / step_s:.4f}; peak "
          f"memory {peak:.2f} GB; by kind: "
          + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1])),
          flush=True)
    ours = {re.search(r"(flash|wkv|ssm)_\w+", n).group(0): c
            for _, c, n in top if re.search(r"(flash|wkv|ssm)_\w+", n)}
    print("train profile: hand-written kernels in the step (launches): "
          + ", ".join(f"{k} x{c}" for k, c in sorted(ours.items())),
          flush=True)
    for us, n, name in sorted(top, reverse=True)[:12]:
        print(f"train profile device: {us / 1e3:9.3f} ms x{n:6d} "
              f"{name[:90]}", flush=True)


def _train_wrappers(cfg):
    """(forward wrapper, backward wrapper, the key of each in the kernels
    line, the layers that launch them) of the architecture's kernel."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.wkv_scan import kernel as WK

    mixers = {s.mixer for s in cfg.pattern}
    if "rwkv" in mixers:
        return (WK.wkv_scan, WK.wkv_scan_bwd, "wkv_scan chunked",
                "wkv_scan bwd", _n_layers(cfg, mixer="rwkv"))
    if "mamba" in mixers:
        return (SK.ssm_scan, SK.ssm_scan_bwd, "ssm_scan chunked",
                "ssm_scan bwd", _n_layers(cfg, mixer="mamba"))
    return (FK.flash_attention, FK.flash_attention_bwd, "flash_attention",
            "flash_attention_bwd", _n_layers(cfg, mixer="attn"))


def train_phase(torch, np, device: str = "cuda",
                arch: str = "qwen1.5-0.5b") -> dict:
    """`arch` trained at full width (`train_config`: Jamba cut to its
    Mamba layers; bf16, random weights from torch.Generator seed 0,
    TRAIN_B (or TRAIN_BATCH) x TRAIN_S tokens a step; remat and
    microbatches as its config says), with checks (a)-(c), (d) for
    TRAIN_CRASH_ARCH, and a profiled step (see the module docstring).
    Returns the launches of its kernel's forward and backward over the
    TRAIN_STEPS steps of (b), counted from 0 before each step and read
    after it, under the kernels line's keys.  (`device="cpu"` is a
    rehearsal: the plain versions run, nothing launches, nothing is
    profiled.)"""
    from repro_torch.kernels.cuda_build import launch_count, reset_counts
    from repro_torch.serve import ServingEngine
    from repro_torch.tensorstore import VersionedParamStore
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    on_card = device == "cuda"
    cfg = train_config(arch)
    B = TRAIN_BATCH.get(arch, TRAIN_B)
    t0 = time.perf_counter()
    cfg_a = cfg.with_overrides(n_layers=TRAIN_CHECK_LAYERS[arch]) \
        if arch in TRAIN_CHECK_LAYERS else cfg
    print(f"train (a) {arch}: {_train_check_a(torch, cfg_a, device)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if on_card:
        torch.cuda.empty_cache()

    # (b) train while serving, (c) launches per step
    fwd, bwd, fwd_key, bwd_key, n = _train_wrappers(cfg)
    wrappers = (fwd, bwd)
    A = max(cfg.microbatches, 1)
    want = {fwd_key: n * A * (2 if cfg.remat == "full" else 1),
            bwd_key: n * A}
    store = VersionedParamStore(slots=2)
    tr = Trainer(cfg, batch=B, seq_len=TRAIN_S, seed=0, store=store,
                 publish_every=1, device=device)
    pin_us, pin_fn = [], store.pin_snapshot

    def timed_pin():                               # every reader's pin
        t = time.perf_counter()
        out = pin_fn()
        pin_us.append((time.perf_counter() - t) * 1e6)
        return out

    store.pin_snapshot = timed_pin
    pin, v1 = store.pin_snapshot()                 # a reader pins v1
    # its copy on the host: RWKV6-3B's 6.2 GB would not fit the card
    # beside the trainer's two versions of the moments
    v1_copy = [x.to("cpu", copy=True) for x in leaves(v1)]
    Bq, Sq, Nq = TRAIN_SERVE
    eng = ServingEngine(cfg, store, max_seq=Sq + Nq, device=device)
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (Bq, Sq))).to(device)
    per_step, lsns = [], []

    def after_step(i, metrics):
        per_step.append({fwd_key: launch_count(fwd),
                         bwd_key: launch_count(bwd)})
        eng.refresh()
        lsns.append(eng.generate({"tokens": prompts}, Nq).snapshot_lsn)
        reset_counts(wrappers)                     # serving is not the step

    reset_counts(wrappers)
    t0 = time.perf_counter()
    with count_plain() as plain:
        log = tr.run(TRAIN_STEPS, after_step=after_step)
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in log]
    same_v1 = all(torch.equal(a.cpu(), b)
                  for a, b in zip(leaves(v1), v1_copy))
    store.release(pin)
    aborts = sum(r.type == "abort" for r in store.wal.records)
    if not (same_v1 and all(math.isfinite(x) for x in losses)
            and all(b > a for a, b in zip(lsns, lsns[1:])) and aborts == 0
            and store.stats["publishes"] == TRAIN_STEPS + 1):
        raise AssertionError(
            f"train (b) {arch}: v1 unchanged {same_v1}, losses {losses}, "
            f"snapshot lsns {lsns}, aborts {aborts}, publishes "
            f"{store.stats['publishes']}")
    if on_card and (any(c != want for c in per_step) or plain["calls"]):
        raise AssertionError(f"train (c) {arch}: launches per step "
                             f"{per_step} != {want}, plain calls "
                             f"{plain['calls']}")
    n_params = sum(x.numel() for x in leaves(tr.state["params"]))
    print(f"train (b) {arch}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters, {A} microbatch(es); {TRAIN_STEPS} steps of "
          f"{B}x{TRAIN_S} in {wall:.1f} s with a {Bq}x{Sq} + {Nq}-step "
          f"request served between steps; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; reader "
          f"pinned at v1 reads v1 bitwise after step {TRAIN_STEPS}; snapshot "
          f"lsns {lsns}; store {store.stats['publishes']} publishes, "
          f"{store.stats['gc_blocked']} of them grew the ring instead of "
          f"waiting; {len(pin_us)} reader pins, the longest "
          f"{max(pin_us):.1f} us (a pin selects a slot: no wait path); "
          f"{aborts} aborts in the WAL", flush=True)
    print(f"train (c) {arch}: launches per step {per_step[0]} (remat "
          f"{cfg.remat!r}, {A} microbatch(es): {want}), plain calls "
          f"{plain['calls']}", flush=True)
    del store.pin_snapshot         # the timed pin holds the store: a cycle
    launches = {k: sum(c[k] for c in per_step) for k in want}
    del eng, v1, v1_copy
    if on_card:
        torch.cuda.empty_cache()
    if fwd_key != "flash_attention":
        # (a) per launch: every scan backward of one full-depth bf16 step
        with checked_scan_bwd() as seen:
            # the new state is dropped at once: a second one would not fit
            m = tr.step_fn(tr.state, tr.pipeline.batch_at(TRAIN_STEPS))[1]
            float(m["loss"])
        if seen["launches"] != want[bwd_key]:
            raise AssertionError(f"train (a) {arch}: {seen['launches']} "
                                 f"backward launches held, {want[bwd_key]} "
                                 "expected")
        print(f"train (a) {arch}: {seen['launches']} {bwd.__name__} "
              f"launches of a full-depth bf16 step, each gradient within "
              f"1e-4 of its max-abs of the plain backward (bf16 du: + "
              f"2^-7), worst {seen['worst']:.3g}", flush=True)
    if on_card:
        _train_profile(torch, tr, B, TRAIN_STEPS)
    del tr, store
    gc.collect()                   # the trainer's closures hold cycles
    if on_card:
        torch.cuda.empty_cache()
    if arch != TRAIN_CRASH_ARCH:
        return launches

    # (d) crash and restore at a depth cut, full width
    cfg_d = cfg.with_overrides(n_layers=TRAIN_CRASH_LAYERS)
    ckdir = TRAIN_CKPT
    shutil.rmtree(ckdir, ignore_errors=True)
    t1 = Trainer(cfg_d, batch=TRAIN_B, seq_len=TRAIN_S, seed=0,
                 device=device)
    t1.run(6)
    t2 = Trainer(cfg_d, batch=TRAIN_B, seq_len=TRAIN_S, seed=0,
                 ckpt_dir=str(ckdir), ckpt_every=2, device=device)
    t0 = time.perf_counter()
    with timed_saves() as saves:
        t2.run(6, inject_failure_at=4)
    wall = time.perf_counter() - t0
    shutil.rmtree(ckdir, ignore_errors=True)
    for a, b in zip(leaves(t1.state["params"]), leaves(t2.state["params"])):
        if not torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-6):
            raise AssertionError("train (d): the restored run's parameters "
                                 "differ from the uninterrupted run's")
    n_params = sum(x.numel() for x in leaves(t2.state["params"]))
    del t1, t2
    gc.collect()
    print(f"train (d): {TRAIN_CRASH_LAYERS} of {cfg.n_layers} layers at "
          f"full width ({n_params / 1e6:.1f} M parameters): run(6, "
          f"inject_failure_at=4) with a save every 2 steps ({len(saves)} "
          f"saves, {', '.join(f'{s:.1f}' for s in saves)} s) == run(6) "
          f"(rtol 1e-5, atol 1e-6); {wall:.1f} s", flush=True)
    return launches


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

    # RWKV6-3B's train phase holds three published versions, two versions
    # of the f32 moments in AdamW's update and the gradients (~69 GiB):
    # segments that grow in place keep the freed activations' memory from
    # staying split around live tensors
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'}"
              ": run it from the root of a checkout", file=sys.stderr)
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
    results["flash_attention_bwd"] = attention_bwd_phase(torch, np, flush)
    results["wkv_scan"] = wkv_kernel_phase(torch, np, flush)
    results["ssm_scan"] = ssm_kernel_phase(torch, np, flush)
    results.update(scan_bwd_phase(torch, np, flush))
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
    # the train paths: launches of each one's kernels over its steps
    for arch in TRAIN_ARCH:
        t0 = time.perf_counter()
        for name, n in train_phase(torch, np, arch=arch).items():
            launches[name] = launches.get(name, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
        print(f"train phase {arch}: {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still "
              "allocated", flush=True)
    scan_rows = [(f"{name}{suffix}", name, key, launches[f"{name} {route}"])
                 for name in (*WKV_TPU, *SSM_TPU)
                 for suffix, key, route in (("", "times", "chunked"),
                                            (" step", "times_step", "step"))]
    for name in (*ATTN_TPU, *ATTN_BWD_TPU, *WKV_TPU, *SSM_TPU):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched")
    bwd_rows = [(name, name, "times", launches[name])
                for name in ("wkv_scan bwd", "ssm_scan bwd")]
    for row, _, _, n in scan_rows + bwd_rows:
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
    sources = {**{n: ATTN_SRC for n in (*ATTN_TPU, *ATTN_BWD_TPU)},
               **{n: WKV_SRC for n in (*WKV_TPU, "wkv_scan bwd")},
               **{n: SSM_SRC for n in (*SSM_TPU, "ssm_scan bwd")}}
    tpu = {**ATTN_TPU, **ATTN_BWD_TPU, **WKV_TPU, **SSM_TPU,
           "wkv_scan bwd": WKV_TPU["wkv_scan"],
           "ssm_scan bwd": SSM_TPU["ssm_scan"]}
    # the scans have two kernels each: a row per kernel, with the
    # launches of its route
    rows_of = [(name, name, "times", launches[name])
               for name in (*ATTN_TPU, *ATTN_BWD_TPU)]
    for row, name, key, n in rows_of + scan_rows + bwd_rows:
        ms, plain_ms, bound_ms, library_ms, by = results[name][key]
        rows.append({"name": row, "route": "cuda",
                     "source": sources[name],
                     "replaces": tpu[name],
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
