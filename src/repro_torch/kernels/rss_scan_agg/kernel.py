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
`floor`, sorted ascending (the kernels binary-search it).  Visibility:
ts <= floor or ts in member_ts, newest wins, ties toward the lowest slot.
The seven lanes are sum, count, count_below, min (INT32_MAX when nothing
matched), max (INT32_MIN), count_above, sum_below; additive lanes wrap
like int32.

Device choice: a wrapper given CUDA tensors launches its kernel (and
raises when it cannot); given CPU tensors it returns its plain version
from `ref.py`.  Nothing else picks between them.  `launches` on each
wrapper counts real kernel launches only.
"""

from __future__ import annotations

import ctypes

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


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rsa_scan_agg.argtypes = [p, p, p, i, ll, i, i, i, i, i, i, i, p, p]
    lib.rsa_scan_agg_grouped.argtypes = [p, p, p, p, i, ll, i, i, i, p, i,
                                         i, p, p]
    lib.rsa_scan_agg_chunked.argtypes = [p, p, p, p, i, ll, i, i, i, p, i,
                                         ll, i, p, p]
    lib.rsa_delta_fold.argtypes = [p, p, i, ll, p, p]
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
                 threshold=_I32_MAX, *, block_pages: int = 8) -> torch.Tensor:
    """Fused RSS membership scan + aggregate; returns [P/BP, 7] int32
    per-block partials of [sum, count, count_below, min, max,
    count_above, sum_below] over member-visible payloads whose tag is
    tag_main or tag_alt (fold the block axis: lanes 0-2 and 5-6 add, 3
    min, 4 max).  Replaces the TPU `rss_scan_agg`."""
    bp = _block(data.shape[0], block_pages)
    if not _on_cuda(data):
        from .ref import rss_scan_agg_ref
        return rss_scan_agg_ref(data, ts, member_ts, floor, tag_main,
                                tag_alt, threshold, block_pages=bp)
    if not 1 <= bp <= 1024:
        raise ValueError(f"block_pages {bp} outside [1, 1024]")
    (dp, tp, mp), P, K, E = _store_args(data, ts, member_ts)
    out = torch.empty((P // bp, 7), dtype=torch.int32, device=data.device)
    _check(_lib().rsa_scan_agg(
        dp, tp, mp, member_ts.numel(), P, K, E, _i32(floor, "floor"),
        _i32(tag_main, "tag_main"), _i32(tag_alt, "tag_alt"),
        _i32(threshold, "threshold"), bp, out.data_ptr(), _stream()),
        "rss_scan_agg")
    rss_scan_agg.launches += 1
    return out


def rss_scan_agg_grouped(data: torch.Tensor, ts: torch.Tensor,
                         gid: torch.Tensor, member_ts: torch.Tensor,
                         floor=0, tag_main=1, tag_alt=-2, threshold=_I32_MAX,
                         *, n_groups: int = 1, block_pages: int = 8,
                         group_params: torch.Tensor | None = None) \
        -> torch.Tensor:
    """Fused RSS membership scan + GROUPED aggregate (flat-lane): `gid`
    [P, 1] int32 group id per page (0..n_groups-1; -1 = no group).
    Returns [P/BP, n_groups, 7] int32 per-block per-group partials;
    group_params [n_groups, 3] int32 (tag_main, tag_alt, threshold per
    lane) overrides the scalar args per group.  Replaces the TPU
    `rss_scan_agg_grouped`."""
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
    out = torch.empty((P // bp, n_groups, 7), dtype=torch.int32, device=dev)
    _check(_lib().rsa_scan_agg_grouped(
        dp, tp, _arg(gid, "gid", dev, 2), mp, member_ts.numel(), P, K, E,
        _i32(floor, "floor"), _arg(prm, "group_params", dev, 2), n_groups,
        bp, out.data_ptr(), _stream()), "rss_scan_agg_grouped")
    rss_scan_agg_grouped.launches += 1
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
                         fold_chunks: int = 8) -> torch.Tensor:
    """Chunked grouped scan+agg: returns [chunks, n_groups, 7] int32
    per-chunk per-group partials over the `_chunk_shape` chunk boundaries
    (fold with `tree_fold_partials`).  Same lane semantics and
    group_params contract as `rss_scan_agg_grouped`; exact only when the
    whole-scan sum fits int32 (`ops` enforces the bound).  `group_tile`
    is the reference's VMEM tiling knob: checked, and without effect on
    the result.  Replaces the TPU `rss_scan_agg_chunked` (select +
    chunk-reduce)."""
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
    out = torch.empty((nc, n_groups, 7), dtype=torch.int32, device=dev)
    _check(_lib().rsa_scan_agg_chunked(
        dp, tp, _arg(gid, "gid", dev, 2), mp, member_ts.numel(), P, K, E,
        _i32(floor, "floor"), _arg(prm, "group_params", dev, 2), n_groups,
        Pp // nc, nc, out.data_ptr(), _stream()), "rss_scan_agg_chunked")
    rss_scan_agg_chunked.launches += 1
    return out


def rss_delta_fold(acc: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Advance a materialized-aggregate accumulator tile by a dense delta
    buffer: acc [Lp, 128] int32 lane rows, delta [Dp, 128] int32 change
    rows (col 0 target lane, -1 = padding; 1 old, 2 old-valid, 3 new, 4
    new-valid, 5 threshold).  Returns the advanced [Lp, 128] tile: the
    additive lanes retract old and apply new, min/max only tighten.
    Replaces the TPU `rss_delta_fold`."""
    lp, dp = acc.shape[0], delta.shape[0]
    _require(acc.shape == (lp, 128) and delta.shape == (dp, 128)
             and lp % 8 == 0 and dp % 8 == 0,
             f"acc {tuple(acc.shape)} / delta {tuple(delta.shape)}")
    if not _on_cuda(acc):
        from .ref import rss_delta_fold_ref
        return rss_delta_fold_ref(acc, delta)
    dev = acc.device
    out = torch.empty_like(acc)
    _check(_lib().rsa_delta_fold(
        _arg(acc, "acc", dev, 2), _arg(delta, "delta", dev, 2), lp, dp,
        out.data_ptr(), _stream()), "rss_delta_fold")
    rss_delta_fold.launches += 1
    return out


KERNELS = (rss_scan_agg, rss_scan_agg_grouped, rss_scan_agg_chunked,
           rss_delta_fold)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> dict:
    """Zero every wrapper's `launches` count; returns the counts before."""
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
