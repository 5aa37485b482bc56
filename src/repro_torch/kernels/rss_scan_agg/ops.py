"""Public ops: fused scan+aggregate (scalar, grouped flat-lane, grouped
chunked), plus the shape dispatcher that picks the grouped strategy and
the host-side int32 overflow guard.

Device choice: the reference's `use_kernel=` and `interpret=` arguments
are gone.  The device of the store's tensors decides: a CUDA store goes
to the CUDA kernels, a CPU store to their plain PyTorch versions
(`kernel.py` wrappers).  Small host inputs (member timestamps, group ids,
group params) are uploaded to the store's device here.

Dispatch (`select_grouped_mode`): small scans go "host" (the mirror
decodes and aggregates in Python), few groups go "flat" (all-G
accumulator lanes per page block), many groups go "chunked" (per-chunk
partials folded on the device).  Thresholds are the reference's and are
overridable — per call, or globally via the REPRO_GROUPED_MODE env var.

Overflow guard: device partials are int32.  The flat path only needs one
BP-page block's partial to fit (|field| max * BP < 2**31) — when the
store's field magnitude violates that, the block size is SHRUNK until it
fits (BP=1 always does), keeping the int64 fold exact.  The chunked path
folds with int32 wraparound, so it needs the whole-scan bound (|field|
max * P < 2**31) and falls back to flat-lane when violated.
`LAUNCH_STATS` counts dispatches, device calls, chosen modes, shrinks and
fallbacks at the reference's call sites, whatever the device, so the
driver's metrics compare with the reference's (`device_calls` is the
reference's `pallas_calls`)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ...obs import REGISTRY, StatsView
from ..rss_gather.ops import member_tensor as _members
from .kernel import (rss_delta_fold, rss_scan_agg, rss_scan_agg_chunked,
                     rss_scan_agg_grouped, tree_fold_partials)

_I32_MAX = 2 ** 31 - 1
_I32_MIN = -2 ** 31

BLOCK_PAGES = 8                   # default flat/scalar block

# --- shape dispatch ---------------------------------------------------------

GROUPED_MODE_ENV = "REPRO_GROUPED_MODE"
GROUPED_MODES = ("host", "flat", "chunked")
# the reference's thresholds (kept so dispatch decisions match it one for
# one): below HOST_MODE_MAX_PAGES a single plan aggregates on host; flat
# lanes up to FLAT_MODE_MAX_GROUPS groups, chunked beyond
HOST_MODE_MAX_PAGES = 64
FLAT_MODE_MAX_GROUPS = 32

# process-wide launch accounting — a registry view (series
# kernel_launch_*) of this package's own registry
LAUNCH_STATS = StatsView(REGISTRY, "kernel_launch",
                         ("dispatches", "device_calls", "host", "flat",
                          "chunked", "block_shrinks", "overflow_fallbacks",
                          "delta_folds"))


def reset_launch_stats() -> dict:
    """Atomically zero LAUNCH_STATS and return the pre-reset snapshot."""
    return LAUNCH_STATS.reset()


def select_grouped_mode(n_pages: int, n_groups: int, n_plans: int = 1, *,
                        override: Optional[str] = None) -> str:
    """Pick the grouped execution strategy for a (P, G, n_plans) shape:
    "host" (decode + Python aggregate), "flat" (all-G accumulator lanes),
    or "chunked" (per-chunk partials).  `override` (or the
    REPRO_GROUPED_MODE env var) forces a mode; "auto" defers to the
    shape heuristic.  Fused batches (n_plans > 1) never pick "host" —
    one device launch is the point of batching."""
    mode = override or os.environ.get(GROUPED_MODE_ENV) or "auto"
    if mode != "auto":
        assert mode in GROUPED_MODES, mode
        return mode
    if n_pages < HOST_MODE_MAX_PAGES and n_plans == 1:
        return "host"
    if n_groups <= FLAT_MODE_MAX_GROUPS:
        return "flat"
    return "chunked"


# --- device inputs ----------------------------------------------------------

def _device_i32(x, dev: torch.device) -> torch.Tensor:
    """Upload a host array-like as an int32 tensor on `dev`."""
    return torch.as_tensor(np.ascontiguousarray(x, np.int32), device=dev)


# --- overflow guard ---------------------------------------------------------

def field_maxabs(store: dict) -> int:
    """Largest |aggregable field| (payload element 1) across every slot of
    the store — the input to the int32 partial bounds.  Computed on the
    store's device in int64 (so |INT32_MIN| does not wrap); one scalar
    comes back."""
    col = store["data"][:, :, 1]
    if not col.numel():
        return 0
    return int(col.to(torch.int64).abs().max())


def safe_block_pages(maxabs: int, n_pages: int,
                     preferred: int = BLOCK_PAGES) -> int:
    """Largest block size <= preferred whose per-block partial provably
    fits int32 (maxabs * BP < 2**31).  Halving keeps P % BP == 0 (stores
    are padded to multiples of 8); BP=1 always fits — a single int32
    value cannot overflow its own sum."""
    bp = max(1, min(preferred, n_pages))
    while bp > 1 and maxabs > (2**31 - 1) // bp:
        bp //= 2
    return bp


def check_block_bound(maxabs: int, block_pages: int) -> None:
    """Raise OverflowError when a BP-page block partial could wrap int32
    — the guard for callers that pin an explicit block size."""
    if block_pages > 1 and maxabs > (2**31 - 1) // block_pages:
        raise OverflowError(
            f"int32 partial overflow: |field| max {maxabs} * "
            f"block_pages {block_pages} exceeds 2**31-1; shrink the "
            f"block (safe_block_pages) or aggregate on host")


def scan_bound_ok(maxabs: int, n_pages: int) -> bool:
    """True when a whole-scan int32 sum provably cannot wrap — the bound
    the chunked path's device fold needs (the int64 folds are exact and
    only need the per-block bound)."""
    return n_pages == 0 or maxabs <= (2**31 - 1) // max(1, n_pages)


# --- scalar path ------------------------------------------------------------

def fold_partials(partials: torch.Tensor) -> list[int]:
    """Fold [n_blocks, 7] per-block partials into the final [sum, count,
    count_below, min, max, count_above, sum_below] — int64 on the
    partials' device (int32 partials cannot wrap an int64 sum below 2**32
    blocks), seven scalars back."""
    rows = partials.to(torch.int64)
    if not rows.shape[0]:
        return [0, 0, 0, _I32_MAX, _I32_MIN, 0, 0]
    s = rows.sum(dim=0)
    folded = torch.stack([s[0], s[1], s[2], rows[:, 3].min(),
                          rows[:, 4].max(), s[5], s[6]])
    return folded.tolist()


def snapshot_agg_members(store: dict, member_ts, floor=0, *,
                         tag_main: int, tag_alt: int = -2,
                         threshold: Optional[int] = None) -> list[int]:
    """Fused RSS membership scan + aggregate over a paged store
    {'data': [P,K,E] int32, 'ts': [P,K]} (torch tensors; their device
    picks the CUDA kernel or the plain version): resolve visibility (ts
    <= floor or ts in member_ts — an empty member array with floor =
    watermark gives SI-V prefix visibility) and reduce payload element 1
    over visible pages tagged tag_main/tag_alt in ONE device pass.

    Returns the folded [sum, count, count_below, min, max, count_above,
    sum_below] as Python ints; `tensorstore.version_store.finalize_agg`
    picks the requested statistic.  The block size shrinks automatically
    when the store's field magnitude could wrap a block partial."""
    thresh = _I32_MAX if threshold is None else int(threshold)
    P = int(store["ts"].shape[0])
    bp = safe_block_pages(field_maxabs(store), P)
    if bp != min(BLOCK_PAGES, P):
        LAUNCH_STATS["block_shrinks"] += 1
    LAUNCH_STATS["device_calls"] += 1
    dev = store["data"].device
    partials = rss_scan_agg(store["data"], store["ts"],
                            _members(member_ts, dev), floor, tag_main,
                            tag_alt, thresh, block_pages=bp)
    return fold_partials(partials)


# --- grouped paths ----------------------------------------------------------

def fold_group_partials(partials: torch.Tensor) -> list[list[int]]:
    """Fold [n_blocks, G, 7] per-block per-group partials into G final
    rows — int64 on the partials' device, [G, 7] back; same overflow
    discipline as `fold_partials`."""
    rows = partials.to(torch.int64)
    n_groups = rows.shape[1]
    if not rows.shape[0]:
        return [[0, 0, 0, _I32_MAX, _I32_MIN, 0, 0]
                for _ in range(n_groups)]
    folded = torch.cat([rows[:, :, :3].sum(dim=0),
                        rows[:, :, 3].amin(dim=0)[:, None],
                        rows[:, :, 4].amax(dim=0)[:, None],
                        rows[:, :, 5:7].sum(dim=0)], dim=1)
    return folded.tolist()


def _group_inputs(store, gid, group_params):
    dev = store["data"].device
    gid = _device_i32(gid, dev).reshape(-1, 1)
    if group_params is not None:
        group_params = _device_i32(group_params, dev)
    return dev, gid, group_params


def snapshot_group_agg_members(store: dict, gid, n_groups: int,
                               member_ts, floor=0, *,
                               tag_main: int = 1, tag_alt: int = -2,
                               threshold: Optional[int] = None,
                               group_params=None) -> list[list[int]]:
    """GROUP BY variant of `snapshot_agg_members` (flat-lane strategy):
    `gid` maps each page of the store to an accumulator lane
    (0..n_groups-1; -1 = no group), and ONE fused device pass resolves
    visibility AND reduces every group.  group_params [n_groups, 3] int32
    rows of (tag_main, tag_alt, threshold) give each lane its own config
    (fused multi-plan batches); None broadcasts the scalar args.

    Returns n_groups folded rows as Python ints; a group no visible page
    maps to is [0, 0, 0, INT32_MAX, INT32_MIN, 0, 0].  Block size shrinks
    automatically under the overflow bound."""
    thresh = _I32_MAX if threshold is None else int(threshold)
    dev, gid, group_params = _group_inputs(store, gid, group_params)
    P = int(store["ts"].shape[0])
    bp = safe_block_pages(field_maxabs(store), P)
    if bp != min(BLOCK_PAGES, P):
        LAUNCH_STATS["block_shrinks"] += 1
    LAUNCH_STATS["device_calls"] += 1
    partials = rss_scan_agg_grouped(
        store["data"], store["ts"], gid, _members(member_ts, dev), floor,
        tag_main, tag_alt, thresh, n_groups=n_groups, block_pages=bp,
        group_params=group_params)
    return fold_group_partials(partials)


def snapshot_group_agg_chunked(store: dict, gid, n_groups: int,
                               member_ts, floor=0, *,
                               tag_main: int = 1, tag_alt: int = -2,
                               threshold: Optional[int] = None,
                               group_params=None,
                               group_tile: int = 8) -> list[list[int]]:
    """Chunked GROUP BY: per-chunk partials + device fold ([G, 7] back).
    Same semantics as `snapshot_group_agg_members`; requires the
    whole-scan int32 bound — callers should go through
    `grouped_agg_auto`, which checks it and falls back to flat-lane.
    Counts two device calls, as the reference's two-stage pipeline
    does."""
    thresh = _I32_MAX if threshold is None else int(threshold)
    dev, gid, group_params = _group_inputs(store, gid, group_params)
    LAUNCH_STATS["device_calls"] += 2          # reference: select + reduce
    partials = rss_scan_agg_chunked(
        store["data"], store["ts"], gid, _members(member_ts, dev), floor,
        tag_main, tag_alt, thresh, n_groups=n_groups,
        group_params=group_params, group_tile=group_tile)
    return tree_fold_partials(partials).tolist()


# --- incremental delta fold (materialized aggregates) -----------------------

def delta_fold(acc: torch.Tensor, delta) -> torch.Tensor:
    """Advance a materialized-aggregate accumulator tile by a dense delta
    buffer: acc [Lp, 128] int32 lane rows on the view's device (lanes
    0..6 = sum, count, count_below, min, max, count_above, sum_below),
    delta [Dp, 128] int32 host change rows (uploaded to acc's device) —
    col 0
    = target lane (-1 = padding), 1 = retracted old value, 2 = old-valid,
    3 = applied new value, 4 = new-valid, 5 = threshold.  O(delta)
    regardless of table size.  The caller owns the int32 overflow ladder;
    min/max lanes only tighten here."""
    delta = _device_i32(delta, acc.device)
    LAUNCH_STATS["delta_folds"] += 1
    LAUNCH_STATS["device_calls"] += 1
    return rss_delta_fold(acc, delta)


def grouped_agg_auto(store: dict, gid, n_groups: int, member_ts, floor=0,
                     *, group_params=None, n_plans: int = 1,
                     mode: Optional[str] = None):
    """Shape-dispatched grouped aggregate: pick flat / chunked by
    (P, G, n_plans) — or honor `mode` / REPRO_GROUPED_MODE — run it, and
    return (rows, mode_used).  mode_used == "host" returns (None,
    "host"): the caller (the mirror) owns the decode-and-aggregate
    fallback.  A chunked pick that violates the whole-scan int32 bound
    demotes to flat (exact int64 fold) and counts an overflow_fallback."""
    P = int(store["ts"].shape[0])
    m = select_grouped_mode(P, n_groups, n_plans, override=mode)
    if m == "chunked" and not scan_bound_ok(field_maxabs(store), P):
        LAUNCH_STATS["overflow_fallbacks"] += 1
        m = "flat"
    LAUNCH_STATS["dispatches"] += 1
    LAUNCH_STATS[m] += 1
    if m == "host":
        return None, m
    if m == "chunked":
        rows = snapshot_group_agg_chunked(
            store, gid, n_groups, member_ts, floor,
            group_params=group_params)
    else:
        rows = snapshot_group_agg_members(
            store, gid, n_groups, member_ts, floor,
            group_params=group_params)
    return rows, m
