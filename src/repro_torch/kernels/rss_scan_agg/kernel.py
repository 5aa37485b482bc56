"""CUDA kernels for Hopper: fused RSS visibility resolve + aggregate.

The wrappers below bind the C entry points of
`src/repro_torch/csrc/rss_scan_agg.cu` (built with nvcc for sm_90a into
`build/repro_torch/` at first use, loaded with ctypes).  Each replaces one
Pallas TPU kernel of `repro.kernels.rss_scan_agg.kernel` and returns what
it returns, bitwise:

    rss_scan_agg           [P/BP, 7]      per-block partials
    rss_scan_agg_grouped   [P/BP, G, 7]   per-block per-group partials
    rss_scan_agg_chunked   [chunks, G, 7] per-chunk per-group partials
    rss_delta_fold         [Lp, 128]      advanced accumulator tile

Contract (as the reference's): data [P, K, E] int32 page payloads
(element 0 the codec tag, element 1 the aggregable field), ts [P, K]
int32 commit timestamps, member_ts [M] int32 member timestamps above
`floor`, sorted ascending.  Visibility:
ts <= floor or ts in member_ts, newest wins, ties toward the lowest slot.
The seven lanes are sum, count, count_below, min (INT32_MAX when nothing
matched), max (INT32_MIN), count_above, sum_below; additive lanes wrap
like int32.

Routes (`plan`, the one owner of the launch shape; the C entries refuse
any other):
- `rss_scan_agg` and `rss_scan_agg_grouped`: "warp" where BP divides 32
  (the main path's 8 and its shrink ladder; for the grouped scan any BP
  up to 32, preferred over GROUPED_SEGMENT_GROUPS groups): a persistent
  grid whose warps walk tiles of whole segments, one lane a page, each
  BP-lane segment reduced in the warp; "segment" for any BP up to
  1,024: whole segments a block, folded in shared memory.  The grouped
  kernels store each segment's G rows themselves, with plain stores: no
  fill, no atomics.
- `rss_scan_agg_chunked`: "cluster" where the [G, 7] tile and the
  member stage fit a block's shared memory: a thread-block cluster a
  chunk, folded over distributed shared memory, one launch; "global"
  for any G: an identity fill, then device-memory atomics.
- `rss_delta_fold`: "sliced" for few delta rows and for any Lp (a block
  an SM, each a slice of the lane rows, reading every delta row);
  "grid" for many delta rows while the [Lp, 7] tile fits a block's
  shared memory (a cooperative launch, a block for each FOLD_BLOCK_ROWS
  rows, at most one an SM; after a grid barrier every block folds a
  slice of the blocks' partials).  One launch writes all of out.
The scans resolve one lane a page with the members staged once a block
in shared memory, by the gathers' rule (`rss_gather.kernel.member_staging`
reports it); `route=` forces a route on the card.

Device choice: a wrapper given CUDA tensors launches its kernel (and
raises when it cannot); given CPU tensors it returns its plain version
from `ref.py`.  Nothing else picks between them.  The wrappers count
real kernel launches only, by route (`route_launches`, summed by
`cuda_build.launch_count`; the last launch's `ScanAggLaunch` in
`last_route`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..cuda_build import check as _check
from ..cuda_build import i32 as _i32
from ..cuda_build import load
from ..cuda_build import on_cuda as _on_cuda
from ..cuda_build import reset_counts
from ..cuda_build import stream as _stream
from ..cuda_build import tensor_arg as _arg

_I32_MAX = 2 ** 31 - 1

# chunk geometry unit of the reference's select stage: 64 pages per row
SELECT_BLOCK = 64

# launch plan (rss_scan_agg.cu holds the same numbers)
ROUTES = {"rss_scan_agg": ("segment", "warp"),
          "rss_scan_agg_grouped": ("segment", "warp"),
          "rss_scan_agg_chunked": ("global", "cluster"),
          "rss_delta_fold": ("sliced", "grid")}
ROUTE_CODES = {"rss_scan_agg": {"warp": 0, "segment": 1},
               "rss_scan_agg_grouped": {"warp": 0, "segment": 1},
               "rss_scan_agg_chunked": {"cluster": 0, "global": 1},
               "rss_delta_fold": {"sliced": 0, "grid": 1}}
H100_SMS = 132
TILE = 32                        # pages a warp's tile, one a lane
WARP_THREADS, WARP_BLOCKS_PER_SM = 512, 2
SEGMENT_THREADS, SEGMENT_THREADS_PER_SM = 256, 2048
MAX_BLOCK_PAGES = 1024
CLUSTER_BLOCKS, CLUSTER_THREADS = 8, 1024
GLOBAL_THREADS, GLOBAL_BLOCKS_PER_SM = 256, 4
FOLD_THREADS = 1024
FOLD_BLOCK_ROWS = 1024           # delta rows a fold grid-route block takes
GROUPED_SEGMENT_GROUPS = 16      # grouped calls the segment route takes
FOLD_SLICED_ROWS = 2048          # delta rows the fold's sliced route takes
MAX_SMEM = 232_448               # opt-in shared memory a block (H100)
FOLD_TILE_ROWS = MAX_SMEM // 28  # lane rows a block's [rows, 7] tile holds
STAGE_BYTES = 32_768             # the members' stage (rss_resolve.cuh)
LANES = 7


class ScanAggLaunch(NamedTuple):
    """A scan+aggregate launch: the route (which kernel), its grid
    (blocks along x, and y: the chunks of a chunked call, else 1), block
    (threads), blocks a cluster (1: none) and dynamic shared memory."""
    route: str
    grid: tuple[int, int]
    block: int
    cluster: int
    smem: int


def routes_for(kernel: str, *, block_pages: int = 8, n_groups: int = 1,
               members: int = 0, lanes: int = 8,
               rows: int = 8) -> tuple[str, ...]:
    """The routes that take a call of `kernel`, the one `plan` prefers
    last: for "rss_scan_agg" the warp route where BP divides 32, for
    "rss_scan_agg_grouped" where BP is at most 32, preferred over
    GROUPED_SEGMENT_GROUPS groups (the segment route was faster at G 1 to
    16, the warp route from G 40); for "rss_scan_agg_chunked" the cluster
    route where [G, 7] and the members' stage fit a block's shared
    memory; for
    "rss_delta_fold" (`lanes` Lp, `rows` Dp) the grid route where [Lp, 7]
    fits it (FOLD_TILE_ROWS), preferred over more than FOLD_SLICED_ROWS
    delta rows; the sliced route takes every call."""
    if kernel == "rss_delta_fold":
        if lanes > FOLD_TILE_ROWS:
            return ("sliced",)
        return ("grid", "sliced") if rows <= FOLD_SLICED_ROWS else \
            ("sliced", "grid")
    fallback, preferred = ROUTES[kernel]
    if kernel == "rss_scan_agg_grouped":
        if block_pages > TILE:
            return (fallback,)
        return ((preferred, fallback) if n_groups <= GROUPED_SEGMENT_GROUPS
                else (fallback, preferred))
    stage = STAGE_BYTES if members > 0 else 0
    fits = (n_groups * LANES * 4 + stage <= MAX_SMEM
            if kernel == "rss_scan_agg_chunked" else
            32 % block_pages == 0)
    return (fallback, preferred) if fits else (fallback,)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pick(kernel: str, route: Optional[str], **kw) -> str:
    admissible = routes_for(kernel, **kw)
    if route is None:
        return admissible[-1]
    if route not in admissible:
        raise ValueError(f"route {route!r} does not take {kernel} with "
                         f"{kw}; these do: {admissible}")
    return route


def plan(kernel: str, P: int, K: int, *, members: int = 0,
         block_pages: int = 8, n_groups: int = 1, rows_per_step: int = 8,
         fold_chunks: int = 8, route: Optional[str] = None,
         sms: int = H100_SMS) -> ScanAggLaunch:
    """The launch of `kernel` over P pages of K slots with `members`
    member timestamps: `route` when given (it must take the call), else
    the last of `routes_for`.  `block_pages` is the effective BP of an
    `rss_scan_agg` or `rss_scan_agg_grouped` call, `n_groups` G of a
    grouped or chunked call; `rows_per_step` and `fold_chunks` those of
    an `rss_scan_agg_chunked` call (chunk geometry by `_chunk_shape`).
    For "rss_delta_fold", P is Lp (accumulator lanes) and K is Dp (delta
    rows).  Grids are persistent, at most a few blocks an SM of `sms`;
    the cluster route runs one cluster of `CLUSTER_BLOCKS` a chunk.  K
    changes no scan launch: more than 8 slots are walked 8 at a time in
    the same kernels."""
    if kernel == "rss_delta_fold":
        lp, dp = P, K
        if lp < 1 or dp < 0:
            raise ValueError(f"no route takes Lp={lp} Dp={dp}")
        route = _pick(kernel, route, lanes=lp, rows=dp)
        if route == "sliced":
            grid, tile = sms, min(_cdiv(lp, sms), FOLD_TILE_ROWS)
        else:
            grid, tile = min(max(1, _cdiv(dp, FOLD_BLOCK_ROWS)), sms), lp
        return ScanAggLaunch(route, (grid, 1), FOLD_THREADS, 1,
                             tile * LANES * 4)
    if K < 1 or members < 0:
        raise ValueError(f"no route takes K={K} members={members}")
    stage = STAGE_BYTES if members > 0 else 0
    if kernel in ("rss_scan_agg", "rss_scan_agg_grouped"):
        bp = block_pages
        if P < 1 or not 1 <= bp <= MAX_BLOCK_PAGES or P % bp:
            raise ValueError(f"no route takes P={P} block_pages={bp}")
        if n_groups < 1:
            raise ValueError(f"no route takes n_groups={n_groups}")
    elif kernel == "rss_scan_agg_chunked":
        if P < 0 or n_groups < 1:
            raise ValueError(f"no route takes P={P} n_groups={n_groups}")
    else:
        raise ValueError(f"no plan for {kernel!r}")
    route = _pick(kernel, route, block_pages=block_pages,
                  n_groups=n_groups, members=members)
    # rows a block stages beside the members: the scan's warp route its
    # warps' partial rows (the grouped one none), the segment routes 5
    # (scan) or 8 (grouped) bytes a page
    grouped = kernel == "rss_scan_agg_grouped"
    if route == "warp":
        warps = WARP_THREADS // 32
        # a grouped tile: 32 // BP whole segments
        tile = (TILE // bp) * bp if grouped else TILE
        grid = min(_cdiv(_cdiv(P, tile), warps), WARP_BLOCKS_PER_SM * sms)
        return ScanAggLaunch(route, (grid, 1), WARP_THREADS, 1,
                             stage + (0 if grouped
                                      else warps * LANES * TILE * 4))
    if route == "segment":
        block = bp * max(1, SEGMENT_THREADS // bp)
        per_sm = max(1, SEGMENT_THREADS_PER_SM // block)
        return ScanAggLaunch(route, (min(_cdiv(P, block), per_sm * sms), 1),
                             block, 1, stage + block * (8 if grouped else 5))
    _rows, _r, nc, Pp = _chunk_shape(P, rows_per_step, fold_chunks)
    if route == "cluster":
        return ScanAggLaunch(route, (CLUSTER_BLOCKS, nc), CLUSTER_THREADS,
                             CLUSTER_BLOCKS, stage + n_groups * LANES * 4)
    per_chunk = max(1, GLOBAL_BLOCKS_PER_SM * sms // nc)
    grid = min(_cdiv(_cdiv(Pp // nc, TILE), GLOBAL_THREADS // 32), per_chunk)
    return ScanAggLaunch(route, (max(1, grid), nc), GLOBAL_THREADS, 1, stage)


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rsa_scan_agg.argtypes = [p, p, p, i, ll, i, i, i, i, i, i, i, p, i,
                                 ll, i, p]
    lib.rsa_scan_agg_grouped.argtypes = [p, p, p, p, i, ll, i, i, i, p, i,
                                         i, p, i, ll, i, p]
    lib.rsa_scan_agg_chunked.argtypes = [p, p, p, p, i, ll, i, i, i, p, i,
                                         ll, i, p, i, ll, i, i, p]
    lib.rsa_delta_fold.argtypes = [p, p, i, ll, p, p, i, ll, i, p]
    for fn in (lib.rsa_scan_agg, lib.rsa_scan_agg_grouped,
               lib.rsa_scan_agg_chunked, lib.rsa_delta_fold):
        fn.restype = ctypes.c_int


def _lib():
    return load("rss_scan_agg", _bind)


def _store_args(data, ts, member_ts):
    """Validated (pointers, P, K, E) of the shared scan inputs."""
    dev = data.device
    P, K, E = data.shape
    if ts.shape != (P, K):
        raise ValueError(f"ts {tuple(ts.shape)} != {(P, K)}")
    if K < 1 or E < 2:
        raise ValueError(f"need K >= 1 and E >= 2, got {(K, E)}")
    ptrs = (_arg(data, "data", dev, 3), _arg(ts, "ts", dev, 2),
            _arg(member_ts, "member_ts", dev, 1))
    return ptrs, P, K, E


def _require(cond: bool, msg: str) -> None:
    """Shape checks that guard the kernels' indexing (not asserts: they
    must hold under -O too)."""
    if not cond:
        raise ValueError(msg)


def _block(P: int, block_pages: int) -> int:
    bp = min(block_pages, P)
    _require(bp >= 1 and P % bp == 0, f"P={P} not a multiple of block {bp}")
    return bp


def _group_params(n_groups, tag_main, tag_alt, threshold, group_params,
                  dev) -> torch.Tensor:
    """[G, 3] int32 (tag_main, tag_alt, threshold) rows on `dev`; the
    scalar args broadcast when group_params is None."""
    if group_params is None:
        row = [_i32(tag_main, "tag_main"), _i32(tag_alt, "tag_alt"),
               _i32(threshold, "threshold")]
        return torch.tensor([row] * n_groups, dtype=torch.int32, device=dev)
    if tuple(group_params.shape) != (n_groups, 3):
        raise ValueError(f"group_params {tuple(group_params.shape)} != "
                         f"{(n_groups, 3)}")
    return group_params


def rss_scan_agg(data: torch.Tensor, ts: torch.Tensor,
                 member_ts: torch.Tensor, floor=0, tag_main=1, tag_alt=-2,
                 threshold=_I32_MAX, *, block_pages: int = 8,
                 route: Optional[str] = None) -> torch.Tensor:
    """Fused RSS membership scan + aggregate; returns [P/BP, 7] int32
    per-block partials of [sum, count, count_below, min, max,
    count_above, sum_below] over member-visible payloads whose tag is
    tag_main or tag_alt (fold the block axis: lanes 0-2 and 5-6 add, 3
    min, 4 max).  Replaces the TPU `rss_scan_agg`.  `route` forces a
    route on the card (see `plan`); None takes `plan`'s."""
    bp = _block(data.shape[0], block_pages)
    if not _on_cuda(data):
        from .ref import rss_scan_agg_ref
        return rss_scan_agg_ref(data, ts, member_ts, floor, tag_main,
                                tag_alt, threshold, block_pages=bp)
    (dp, tp, mp), P, K, E = _store_args(data, ts, member_ts)
    launch = plan("rss_scan_agg", P, K, members=member_ts.numel(),
                  block_pages=bp, route=route, sms=_sms(data.device))
    out = torch.empty((P // bp, 7), dtype=torch.int32, device=data.device)
    _check(_lib().rsa_scan_agg(
        dp, tp, mp, member_ts.numel(), P, K, E, _i32(floor, "floor"),
        _i32(tag_main, "tag_main"), _i32(tag_alt, "tag_alt"),
        _i32(threshold, "threshold"), bp, out.data_ptr(),
        ROUTE_CODES["rss_scan_agg"][launch.route], launch.grid[0],
        launch.block, _stream()), "rss_scan_agg")
    rss_scan_agg.route_launches[launch.route] += 1
    rss_scan_agg.last_route = launch
    return out


def rss_scan_agg_grouped(data: torch.Tensor, ts: torch.Tensor,
                         gid: torch.Tensor, member_ts: torch.Tensor,
                         floor=0, tag_main=1, tag_alt=-2, threshold=_I32_MAX,
                         *, n_groups: int = 1, block_pages: int = 8,
                         group_params: torch.Tensor | None = None,
                         route: Optional[str] = None) -> torch.Tensor:
    """Fused RSS membership scan + GROUPED aggregate (flat-lane): `gid`
    [P, 1] int32 group id per page (0..n_groups-1; -1 = no group).
    Returns [P/BP, n_groups, 7] int32 per-block per-group partials;
    group_params [n_groups, 3] int32 (tag_main, tag_alt, threshold per
    lane) overrides the scalar args per group.  Replaces the TPU
    `rss_scan_agg_grouped`.  `route` forces a route on the card (see
    `plan`); None takes `plan`'s."""
    P = data.shape[0]
    _require(gid.shape == (P, 1) and n_groups >= 1,
             f"gid {tuple(gid.shape)} / n_groups {n_groups}")
    bp = _block(P, block_pages)
    if not _on_cuda(data):
        from .ref import rss_scan_agg_grouped_ref
        return rss_scan_agg_grouped_ref(
            data, ts, gid, member_ts, floor, tag_main, tag_alt, threshold,
            n_groups=n_groups, group_params=group_params, block_pages=bp)
    (dp, tp, mp), P, K, E = _store_args(data, ts, member_ts)
    dev = data.device
    prm = _group_params(n_groups, tag_main, tag_alt, threshold,
                        group_params, dev)
    launch = plan("rss_scan_agg_grouped", P, K, members=member_ts.numel(),
                  block_pages=bp, n_groups=n_groups, route=route,
                  sms=_sms(dev))
    out = torch.empty((P // bp, n_groups, 7), dtype=torch.int32, device=dev)
    _check(_lib().rsa_scan_agg_grouped(
        dp, tp, _arg(gid, "gid", dev, 2), mp, member_ts.numel(), P, K, E,
        _i32(floor, "floor"), _arg(prm, "group_params", dev, 2), n_groups,
        bp, out.data_ptr(),
        ROUTE_CODES["rss_scan_agg_grouped"][launch.route], launch.grid[0],
        launch.block, _stream()), "rss_scan_agg_grouped")
    rss_scan_agg_grouped.route_launches[launch.route] += 1
    rss_scan_agg_grouped.last_route = launch
    return out


def _chunk_shape(P: int, rows_per_step: int, fold_chunks: int):
    """Chunk geometry shared with the reference: pad P to rows *
    SELECT_BLOCK pages where rows divides evenly into `fold_chunks`-or-
    fewer chunks of `rows_per_step`-row steps.  Returns (rows,
    rows_per_step, chunks, padded pages)."""
    sb = SELECT_BLOCK
    rows0 = max(1, -(-P // sb))
    r = max(1, min(rows_per_step, rows0))
    nc = max(1, min(fold_chunks, rows0 // r))
    unit = r * nc
    rows = -(-rows0 // unit) * unit
    return rows, r, nc, rows * sb


def rss_scan_agg_chunked(data: torch.Tensor, ts: torch.Tensor,
                         gid: torch.Tensor, member_ts: torch.Tensor,
                         floor=0, tag_main=1, tag_alt=-2, threshold=_I32_MAX,
                         *, n_groups: int = 1,
                         group_params: torch.Tensor | None = None,
                         group_tile: int = 8, rows_per_step: int = 8,
                         fold_chunks: int = 8,
                         route: Optional[str] = None) -> torch.Tensor:
    """Chunked grouped scan+agg: returns [chunks, n_groups, 7] int32
    per-chunk per-group partials over the `_chunk_shape` chunk boundaries
    (fold with `tree_fold_partials`).  Same lane semantics and
    group_params contract as `rss_scan_agg_grouped`; exact only when the
    whole-scan sum fits int32 (`ops` enforces the bound).  `group_tile`
    is the reference's VMEM tiling knob: checked, and without effect on
    the result.  Replaces the TPU `rss_scan_agg_chunked` (select +
    chunk-reduce).  `route` forces a route on the card (see `plan`);
    None takes `plan`'s."""
    P = data.shape[0]
    _require(gid.shape == (P, 1) and n_groups >= 1,
             f"gid {tuple(gid.shape)} / n_groups {n_groups}")
    _require(group_tile >= 8 and group_tile % 8 == 0,
             f"group_tile {group_tile}")
    _rows, _r, nc, Pp = _chunk_shape(P, rows_per_step, fold_chunks)
    if not _on_cuda(data):
        from .ref import rss_scan_agg_chunked_ref
        return rss_scan_agg_chunked_ref(
            data, ts, gid, member_ts, floor, tag_main, tag_alt, threshold,
            n_groups=n_groups, group_params=group_params,
            rows_per_step=rows_per_step, fold_chunks=fold_chunks)
    (dp, tp, mp), P, K, E = _store_args(data, ts, member_ts)
    dev = data.device
    prm = _group_params(n_groups, tag_main, tag_alt, threshold,
                        group_params, dev)
    launch = plan("rss_scan_agg_chunked", P, K, members=member_ts.numel(),
                  n_groups=n_groups, rows_per_step=rows_per_step,
                  fold_chunks=fold_chunks, route=route, sms=_sms(dev))
    out = torch.empty((nc, n_groups, 7), dtype=torch.int32, device=dev)
    _check(_lib().rsa_scan_agg_chunked(
        dp, tp, _arg(gid, "gid", dev, 2), mp, member_ts.numel(), P, K, E,
        _i32(floor, "floor"), _arg(prm, "group_params", dev, 2), n_groups,
        Pp // nc, nc, out.data_ptr(),
        ROUTE_CODES["rss_scan_agg_chunked"][launch.route],
        launch.grid[0], launch.block, launch.cluster, _stream()),
        "rss_scan_agg_chunked")
    rss_scan_agg_chunked.route_launches[launch.route] += 1
    rss_scan_agg_chunked.last_route = launch
    return out


def rss_delta_fold(acc: torch.Tensor, delta: torch.Tensor, *,
                   route: Optional[str] = None) -> torch.Tensor:
    """Advance a materialized-aggregate accumulator tile by a dense delta
    buffer: acc [Lp, 128] int32 lane rows, delta [Dp, 128] int32 change
    rows (col 0 target lane, -1 = padding; 1 old, 2 old-valid, 3 new, 4
    new-valid, 5 threshold).  Returns the advanced [Lp, 128] tile: the
    additive lanes retract old and apply new, min/max only tighten.
    Replaces the TPU `rss_delta_fold`.  On the card acc and delta must
    start on 16 bytes (any row of a tensor the allocator made does);
    `route` forces a route (see `plan`), None takes `plan`'s."""
    lp, dp = acc.shape[0], delta.shape[0]
    _require(acc.shape == (lp, 128) and delta.shape == (dp, 128)
             and lp % 8 == 0 and dp % 8 == 0,
             f"acc {tuple(acc.shape)} / delta {tuple(delta.shape)}")
    if not _on_cuda(acc):
        from .ref import rss_delta_fold_ref
        return rss_delta_fold_ref(acc, delta)
    dev = acc.device
    a_ptr, d_ptr = _arg(acc, "acc", dev, 2), _arg(delta, "delta", dev, 2)
    _require(a_ptr % 16 == 0 and d_ptr % 16 == 0,
             "acc and delta must start on 16 bytes")
    launch = plan("rss_delta_fold", lp, dp, route=route, sms=_sms(dev))
    out = torch.empty_like(acc)
    # the grid route's per-block partials (held until the launch is
    # enqueued, so the allocator hands their memory to nothing else)
    part = None
    if launch.route == "grid":
        part = torch.empty((launch.grid[0], lp, LANES), dtype=torch.int32,
                           device=dev)
    _check(_lib().rsa_delta_fold(
        a_ptr, d_ptr, lp, dp, None if part is None else part.data_ptr(),
        out.data_ptr(), ROUTE_CODES["rss_delta_fold"][launch.route],
        launch.grid[0], launch.block, _stream()), "rss_delta_fold")
    rss_delta_fold.route_launches[launch.route] += 1
    rss_delta_fold.last_route = launch
    return out


KERNELS = (rss_scan_agg, rss_scan_agg_grouped, rss_scan_agg_chunked,
           rss_delta_fold)
# kernel launches, by route
for _fn in KERNELS:
    _fn.route_launches = dict.fromkeys(ROUTES[_fn.__name__], 0)
    _fn.last_route = None            # `ScanAggLaunch` of the last launch


def reset_launches() -> dict:
    """Zero every wrapper's `route_launches`; returns the launches
    before."""
    return reset_counts(KERNELS)


def tree_fold_partials(partials: torch.Tensor) -> torch.Tensor:
    """Fold [chunks, G, 7] chunked partials into the final [G, 7] rows on
    their device (lanes 0-2 and 5-6 add with int32 wraparound, 3 min, 4
    max) — the reference's pairwise int32 fold, bitwise; exact only under
    the whole-scan bound the chunked path already requires."""
    from .ref import _wrap32

    p = partials.long()
    add = _wrap32(p.sum(dim=0))
    return torch.stack([add[:, 0], add[:, 1], add[:, 2],
                        p[:, :, 3].amin(dim=0).to(torch.int32),
                        p[:, :, 4].amax(dim=0).to(torch.int32),
                        add[:, 5], add[:, 6]], dim=1)
