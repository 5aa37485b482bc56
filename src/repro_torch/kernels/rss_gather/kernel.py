"""CUDA kernel for Hopper: RSS set-membership resolve + page gather.

`rss_gather` binds `vg_rss_gather` of `src/repro_torch/csrc/gather.cu`
(built with nvcc for sm_90a into `build/repro_torch/` at first use,
loaded with ctypes; the source's header states the design and its bound
on the card).  It replaces the Pallas TPU kernel
`repro.kernels.rss_gather.kernel.rss_gather` and returns what that
kernel's plain reference returns, bit for bit:

    data      [P, K, E]  page payloads, any dtype (copied as raw bytes)
    ts        [P, K]     int32 commit timestamp per slot (0 = initial)
    member_ts [M]        int32 member timestamps above `floor`, sorted
                         ascending (duplicates and values at or below
                         the floor are allowed)
    floor     scalar     compressed-snapshot watermark
    out       [P, E]     payload of the newest slot whose ts is <= floor
                         or a member (ties: lowest slot; none: slot 0)

Unlike the Pallas kernel there is no `P % 8` or `E % 512` limit: any
P >= 0, K >= 1, E >= 0.  The Pallas kernel sums a one-hot product over
K, which turns a NaN or Inf in an unselected slot into NaN and a
selected -0.0 into +0.0; this kernel copies bits, as the reference's
`take_along_axis` does.

Routes (`plan`; one launch per call):
- "tile": rows of at most 512 bytes, on 16 bytes and a multiple of 16
  bytes long, K <= 8 (the mirror's): a persistent grid; a warp resolves
  a tile of pages, one lane a page, then copies the tile's rows with all
  32 lanes in 16-byte units;
- "warp": any store (wide rows such as the param store's, rows off 16
  bytes or of odd length, K > 8): one warp a page, a grid over every
  page.
On the tile route each block stages the members in shared memory
(`member_staging` reports how); the warp route searches them in device
memory.
The source's header gives the design and the H100 figures behind it.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
return the plain version from `ref.py`.  `rss_gather.route_launches`
counts real kernel launches only, by route (`cuda_build.launch_count`
sums them), and `rss_gather.last_route` is the last launch's
`GatherLaunch`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..cuda_build import (check, i32, load, on_cuda, reset_counts, stream,
                          tensor_arg)

ROUTES = ("tile", "warp")
ROUTE_CODES = {"tile": 0, "warp": 1}
H100_SMS = 132
THREADS = 256                   # a block, both routes (as gather.cu)
TILE_BLOCKS_PER_SM = 3          # tile route: the persistent grid's cap
WARP_MAX_GRID = 1 << 20         # warp route: grid-stride beyond this
TILE_BYTES = 4096               # bytes of rows in a warp's tile
TILE_MAX_ROW = 512              # rows one warp-wide 16-byte access covers
TILE_MAX_K = 8                  # timestamps a lane holds
STAGINGS = ("none", "bitmap", "array", "global")   # gather.cu `Staging`


class GatherLaunch(NamedTuple):
    """A gather launch: the route (which kernel), its grid (blocks) and
    block (threads), and the pages a warp takes at a time."""
    route: str
    grid: tuple[int]
    block: int
    pages_per_warp: int


def routes_for(K: int, row_bytes: int, aligned: bool) -> tuple[str, ...]:
    """The routes that take a store: `aligned` says data and out start on
    16 bytes (so, with rows a multiple of 16 bytes, every row does)."""
    if aligned and row_bytes % 16 == 0 and row_bytes <= TILE_MAX_ROW \
            and K <= TILE_MAX_K:
        return ("warp", "tile")
    return ("warp",)


def plan(P: int, K: int, row_bytes: int, aligned: bool,
         route: Optional[str] = None, sms: int = H100_SMS) -> GatherLaunch:
    """The launch of a gather over P pages of K slots with rows of
    `row_bytes`: `route` when given (it must take the store), else the
    tile route where it takes the store and the warp route otherwise.
    The tile route's grid is persistent: enough blocks for the tiles, at
    most `TILE_BLOCKS_PER_SM` an SM of `sms`; the warp route's covers
    every page up to `WARP_MAX_GRID` blocks.  The C entries refuse any
    other grid, block or pages a warp."""
    if P < 1 or K < 1 or row_bytes < 1:
        raise ValueError(f"no route takes P={P} K={K} row_bytes="
                         f"{row_bytes}: the wrappers launch nothing for "
                         "an empty output, and K >= 1")
    admissible = routes_for(K, row_bytes, aligned)
    if route is None:
        route = admissible[-1]
    elif route not in admissible:
        raise ValueError(f"route {route!r} does not take K={K} row_bytes="
                         f"{row_bytes} aligned={aligned}; these do: "
                         f"{admissible}")
    warps = THREADS // 32
    if route == "tile":
        ppw = min(32, TILE_BYTES // row_bytes)
        cap = TILE_BLOCKS_PER_SM * sms
    else:
        ppw, cap = 1, WARP_MAX_GRID
    tiles = -(-P // ppw)
    grid = min(-(-tiles // warps), cap)
    return GatherLaunch(route, (grid,), THREADS, ppw)


def member_staging(m: int, lo: int = 0, hi: int = 0) -> str:
    """How a tile-route block keeps M members whose first and last are lo
    and hi, as gather.cu's rule says (`vg_member_staging`; the kernel
    reads lo and hi itself): "none" (M = 0), "bitmap" (the span
    hi - lo + 1, in 64 bits, within the bitmap's cap), "array" (M within
    the array's cap) or "global" (binary search in device memory, as the
    warp route always does).  Needs the built library (`staging_caps`
    gives the caps)."""
    return STAGINGS[gather_lib().vg_member_staging(m, lo, hi)]


def staging_caps() -> tuple[int, int]:
    """gather.cu's (bitmap bits, array cap) of the member staging."""
    lib = gather_lib()
    return lib.vg_bitmap_bits(), lib.vg_array_cap()


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vg_version_gather.argtypes = [p, p, ll, i, ll, i, p, i, ll, i, i, p]
    lib.vg_rss_gather.argtypes = [p, p, p, i, ll, i, ll, i, p, i, ll, i, i,
                                  p]
    lib.vg_member_staging.argtypes = [i, i, i]
    lib.vg_bitmap_bits.argtypes = []
    lib.vg_array_cap.argtypes = []
    for f in ("vg_version_gather", "vg_rss_gather", "vg_member_staging",
              "vg_array_cap"):
        getattr(lib, f).restype = ctypes.c_int
    lib.vg_bitmap_bits.restype = ll


def gather_lib():
    return load("gather", _bind)


def gather_args(data: torch.Tensor, ts: torch.Tensor):
    """Validated (data ptr, ts ptr, P, K, row bytes, empty output) of a
    gather launch; the output is [P, E] of data's dtype on its device."""
    if data.dim() != 3:
        raise ValueError(f"data must be [P, K, E], got {tuple(data.shape)}")
    P, K, E = data.shape
    if tuple(ts.shape) != (P, K):
        raise ValueError(f"ts {tuple(ts.shape)} != {(P, K)}")
    if K < 1:
        raise ValueError("need K >= 1 version slots")
    dev = data.device
    ptrs = (tensor_arg(data, "data", dev, 3, dtype=None),
            tensor_arg(ts, "ts", dev, 2))
    out = torch.empty((P, E), dtype=data.dtype, device=dev)
    return ptrs, P, K, E * data.element_size(), out


def launch_plan(data: torch.Tensor, out: torch.Tensor, P: int, K: int,
                row_bytes: int, route: Optional[str]) -> GatherLaunch:
    """`plan` for a launch into `out` on the card of `data`."""
    aligned = data.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    return plan(P, K, row_bytes, aligned, route, sms)


def launch_args(launch: GatherLaunch) -> tuple[int, int, int, int]:
    """The C entries' (route code, grid, block, pages a warp)."""
    return (ROUTE_CODES[launch.route], launch.grid[0], launch.block,
            launch.pages_per_warp)


def rss_gather(data: torch.Tensor, ts: torch.Tensor,
               member_ts: torch.Tensor, floor=0, *,
               route: Optional[str] = None) -> torch.Tensor:
    """RSS membership read: [P, E] payloads of the newest member-visible
    slot per page.  Replaces the TPU `rss_gather`.  `route` forces a
    route on the card (see `plan`); None takes `plan`'s."""
    if not on_cuda(data):
        from .ref import rss_gather_ref
        return rss_gather_ref(data, ts, member_ts, floor)
    (dp, tp), P, K, row_bytes, out = gather_args(data, ts)
    mp = tensor_arg(member_ts, "member_ts", data.device, 1)
    floor = i32(floor, "floor")
    if out.numel() == 0:
        return out
    launch = launch_plan(data, out, P, K, row_bytes, route)
    check(gather_lib().vg_rss_gather(dp, tp, mp, member_ts.numel(), P, K,
                                     row_bytes, floor, out.data_ptr(),
                                     *launch_args(launch), stream()),
          "rss_gather")
    rss_gather.route_launches[launch.route] += 1
    rss_gather.last_route = launch
    return out


rss_gather.last_route = None        # `GatherLaunch` of the last launch
# kernel launches by route: the wrapper's one count (`launch_count`)
rss_gather.route_launches = dict.fromkeys(ROUTES, 0)
KERNELS = (rss_gather,)


def reset_launches() -> dict:
    """Zero `rss_gather.route_launches`; returns the launches before."""
    return reset_counts(KERNELS)
