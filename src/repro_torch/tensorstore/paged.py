"""Device-resident page-granular multiversion store (SI-V on the GPU).

Layout (shared with `mirror.PagedMirror.torch_store_for`):
  data [P, K, page_elems]   — K version slots per page, any dtype
  ts   [P, K] int32         — commit timestamp per slot (0 = initial)

Snapshot read (the paper's SI-V read protocol, vectorized): for each page,
select the slot with the largest `ts <= watermark` and gather its payload.
This is the memory-bound hot spot of wait-free snapshot reads over
fine-grained state (embedding rows, adapter pages, KV pages):
  * `visible_slots` + `snapshot_read_ref`: plain PyTorch oracle,
  * `kernels.version_gather.ops.snapshot_read`: the CUDA kernel (same
    contract; its plain version on a CPU store),
  * `snapshot_read_members`: RSS-set membership variant (watermark set,
    not prefix) — newest slot whose ts is at or below the floor or in a
    sorted member-ts array; the `rss_gather` CUDA kernel on a CUDA store.

Writes go to the LRU slot (`publish_page`, in place); GC floor = the
minimum pinned watermark (hot_standby_feedback analogue), enforced by the
caller.  Stores live on the device `init_store` / `store_from_numpy` are
given: "cuda" by default (raises without a GPU), or "cpu"
(`kernels.config.resolve_device`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.config import resolve_device
# snapshot_read_members (RSS membership read) is the rss_gather op itself:
# the CUDA kernel on a CUDA store, its plain version on a CPU store
from ..kernels.rss_gather.ops import snapshot_read_members  # noqa: F401
from ..kernels.rss_gather.ref import gather_slots

_I32_MAX = 2 ** 31 - 1


def init_store(n_pages: int, n_slots: int, page_elems: int,
               dtype=torch.bfloat16, initial=None, device=None) -> dict:
    """A fresh store: every slot at ts 0 with a zero payload; `initial`
    ([n_pages, page_elems]) fills slot 0."""
    dev = resolve_device(device)
    data = torch.zeros((n_pages, n_slots, page_elems), dtype=dtype,
                       device=dev)
    if initial is not None:
        data[:, 0, :] = torch.as_tensor(initial).to(dev, dtype)
    ts = torch.zeros((n_pages, n_slots), dtype=torch.int32, device=dev)
    return {"data": data, "ts": ts}


def _torch_from_numpy(arr) -> torch.Tensor:
    """A copy of a numpy array as a CPU tensor; ml_dtypes bfloat16 arrays
    (what `np.asarray` gives for a bf16 JAX array) are reinterpreted bit
    for bit through int16."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def store_from_numpy(store: dict, device=None) -> dict:
    """Carry a store given as numpy arrays (`{'data','ts'}`, e.g. a JAX
    store through `np.asarray`) into the port, on `device`."""
    dev = resolve_device(device)
    return {"data": _torch_from_numpy(store["data"]).to(dev),
            "ts": _torch_from_numpy(store["ts"]).to(dev, torch.int32)}


def as_page_range(pages) -> Optional[tuple[int, int]]:
    """Dense key-range -> page-range resolution: when a page-index array is
    a contiguous ascending run, return its (start, stop) so multi-page
    scans can slice the store instead of gathering (the columnar fast
    path); None otherwise (holes, missing keys, or arbitrary order)."""
    arr = np.asarray(pages)
    if arr.size == 0 or arr[0] < 0:
        return None
    start = int(arr[0])
    if np.array_equal(arr, np.arange(start, start + arr.size)):
        return start, start + int(arr.size)
    return None


def gather_pages(store: dict, pages) -> dict:
    """Columnar multi-page gather on the store's device: the
    `{'data','ts'}` sub-store for a key-range of pages (one
    `index_select` per buffer), sliced instead when the range is dense
    (`as_page_range`).  Padded, like the reference's, to a multiple of 8
    pages with initial (ts == 0, zero-payload) pages, which resolve to
    the initial value."""
    rng = as_page_range(pages)
    if rng is not None:
        data = store["data"][rng[0]:rng[1]]
        ts = store["ts"][rng[0]:rng[1]]
    else:
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=store["ts"].device)
        data = store["data"].index_select(0, idx)
        ts = store["ts"].index_select(0, idx)
    pad = (-data.shape[0]) % 8
    if pad:
        data = torch.cat([data, data.new_zeros((pad,) + data.shape[1:])])
        ts = torch.cat([ts, ts.new_zeros((pad,) + ts.shape[1:])])
    return {"data": data, "ts": ts}


def visible_slots(ts: torch.Tensor, watermark) -> torch.Tensor:
    """[P,K] ts, scalar watermark -> [P] int32 slot index of the newest
    visible version (largest ts <= watermark; ties: the first slot, as
    `argmax` picks the first maximum)."""
    masked = torch.where(ts <= int(watermark), ts, -1)
    return masked.argmax(dim=-1).to(torch.int32)


def snapshot_read_ref(store: dict, watermark) -> torch.Tensor:
    """Plain SI-V gather: [P, page_elems] visible payloads."""
    return gather_slots(store["data"], visible_slots(store["ts"], watermark))


def visible_slots_members(ts: torch.Tensor, member_ts: torch.Tensor,
                          floor=0) -> torch.Tensor:
    """RSS-set variant: member_ts is a [M] int32 array of commit timestamps
    of RSS members ABOVE the snapshot's floor, sorted ascending; a slot is
    visible iff its ts is at-or-below `floor` (0 = initial versions only)
    or an explicit member.  Returns the newest visible slot per page.  An
    empty member array (M == 0) degenerates to the floor test alone."""
    if member_ts.numel() == 0:
        is_member = ts <= int(floor)
    else:
        pos = torch.searchsorted(member_ts, ts).clamp_(0, member_ts.numel()
                                                       - 1)
        is_member = (member_ts[pos] == ts) | (ts <= int(floor))
    masked = torch.where(is_member, ts, -1)
    return masked.argmax(dim=-1).to(torch.int32)


def publish_page(store: dict, page: int, payload, commit_ts, *,
                 gc_floor=0) -> dict:
    """Install a new version of one page into its oldest recyclable slot,
    IN PLACE, and return the (same) store.  The reference's JAX arrays
    are immutable, so it returns new arrays; the values are the same.

    The slot that is the newest visible at gc_floor is protected (a
    pinned reader may still need it); of the others the one with the
    smallest ts (the first, on ties) is recycled.  With K slots and
    publishers outrunning readers by at most K-1 versions this is
    wait-free."""
    data, ts = store["data"], store["ts"]
    ts_row = ts[page]                                  # [K] view
    protected = visible_slots(ts_row[None], gc_floor)[0]
    slots = torch.arange(ts_row.shape[0], device=ts.device)
    order = torch.where(slots == protected, _I32_MAX, ts_row)
    victim = order.argmin().view(1)
    row = torch.as_tensor(payload).to(data.device, data.dtype)
    data[page].index_copy_(0, victim, row.view(1, -1))
    ts_row.index_fill_(0, victim, int(commit_ts))
    return store
