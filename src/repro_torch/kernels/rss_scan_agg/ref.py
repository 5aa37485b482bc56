"""Plain PyTorch versions of the rss_scan_agg kernels.

Each function computes, bitwise, what its CUDA kernel (and its Pallas
twin in the reference) returns.  They run on the CPU (the tests, and the
wrappers for CPU tensors) and on CUDA (`chip_smoke.py` holds every kernel
against them on the card), so they use only ops CUDA has for integers:
comparisons, gathers, `index_add_` and `scatter_reduce_` — no integer
matmul/einsum.  Sums run in int64 and wrap back to int32 at the end,
which equals int32 two's-complement accumulation in any order.
"""

from __future__ import annotations

import torch

from ..rss_gather.ref import gather_slots, rss_visible_slots_ref
from .kernel import _chunk_shape

_I32_MAX = 2 ** 31 - 1
_I32_MIN = -2 ** 31


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (jnp int32 sums)."""
    return (((x + 2 ** 31) & (2 ** 32 - 1)) - 2 ** 31).to(torch.int32)


def _resolve_tag_x(data, ts, member_ts, floor):
    sel = gather_slots(data, rss_visible_slots_ref(ts, member_ts, floor))
    return sel[:, 0], sel[:, 1]


def rss_scan_agg_ref(data: torch.Tensor, ts: torch.Tensor,
                     member_ts: torch.Tensor, floor=0, tag_main=1,
                     tag_alt=-2, threshold=_I32_MAX, *,
                     block_pages: int = 8) -> torch.Tensor:
    """data [P,K,E] int32, ts [P,K], member_ts [M], scalars -> [P/BP, 7]
    int32 per-block partials of [sum, count, count_below, min, max,
    count_above, sum_below] of payload element 1 over member-visible
    pages whose tag (element 0) is tag_main or tag_alt; min/max carry
    INT32_MAX/INT32_MIN for blocks where nothing matched."""
    P = data.shape[0]
    bp = min(block_pages, P)
    assert P % bp == 0, (P, bp)
    tag, x = _resolve_tag_x(data, ts, member_ts, floor)
    tag = tag.reshape(P // bp, bp)
    x = x.reshape(P // bp, bp)
    x64 = x.long()
    valid = (tag == tag_main) | (tag == tag_alt)
    below = valid & (x < threshold)
    return torch.stack([
        _wrap32(torch.where(valid, x64, 0).sum(dim=1)),
        valid.sum(dim=1).to(torch.int32),
        below.sum(dim=1).to(torch.int32),
        torch.where(valid, x, _I32_MAX).min(dim=1).values,
        torch.where(valid, x, _I32_MIN).max(dim=1).values,
        (valid & (x > threshold)).sum(dim=1).to(torch.int32),
        _wrap32(torch.where(below, x64, 0).sum(dim=1)),
    ], dim=1).to(torch.int32)


def _group_param_cols(n_groups, tag_main, tag_alt, threshold, group_params,
                      device):
    """Per-group (tag_main, tag_alt, threshold) columns [G]; the scalar
    args broadcast when group_params is None."""
    if group_params is None:
        full = lambda v: torch.full((n_groups,), int(v), dtype=torch.int32,
                                    device=device)
        return full(tag_main), full(tag_alt), full(threshold)
    prm = group_params.to(device=device, dtype=torch.int32)
    return prm[:, 0], prm[:, 1], prm[:, 2]


def _segment_rows(tag, x, gid, seg, n_segs, n_groups, tag_main, tag_alt,
                  threshold, group_params):
    """[n_segs, G, 7] int32 rows: page i adds into row (seg[i], gid[i])
    when its gid names a group and its tag matches that group's config."""
    dev = x.device
    tmain, talt, thr = _group_param_cols(n_groups, tag_main, tag_alt,
                                         threshold, group_params, dev)
    g = gid.reshape(-1).long()
    gc = g.clamp(0, n_groups - 1)
    valid = (((tag == tmain[gc]) | (tag == talt[gc])) & (g >= 0) &
             (g < n_groups))
    below = valid & (x < thr[gc])
    above = valid & (x > thr[gc])
    # invalid pages land in one spill row past the end
    n_rows = n_segs * n_groups
    flat = torch.where(valid, seg * n_groups + gc, n_rows)
    x64 = x.long()

    def add(v):
        out = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
        return out.index_add_(0, flat, v.long())[:n_rows]

    def red(v, ident, how):
        out = torch.full((n_rows + 1,), ident, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, flat, v, reduce=how)[:n_rows]

    lanes = torch.stack([
        add(torch.where(valid, x64, 0)), add(valid), add(below),
        red(torch.where(valid, x64, _I32_MAX), _I32_MAX, "amin"),
        red(torch.where(valid, x64, _I32_MIN), _I32_MIN, "amax"),
        add(above), add(torch.where(below, x64, 0)),
    ], dim=1)
    return _wrap32(lanes).reshape(n_segs, n_groups, 7)


def rss_scan_agg_grouped_ref(data: torch.Tensor, ts: torch.Tensor,
                             gid: torch.Tensor, member_ts: torch.Tensor,
                             floor=0, tag_main=1, tag_alt=-2,
                             threshold=_I32_MAX, *, n_groups: int = 1,
                             group_params: torch.Tensor | None = None,
                             block_pages: int = 8) -> torch.Tensor:
    """GROUP BY twin of `rss_scan_agg_ref` (flat-lane blocking): `gid`
    [P, 1] int32 group id per page (-1 = no group) -> [P/BP, n_groups, 7]
    per-block per-group partials.  group_params [n_groups, 3] gives each
    lane its own (tag_main, tag_alt, threshold)."""
    P = data.shape[0]
    bp = min(block_pages, P)
    assert P % bp == 0, (P, bp)
    assert gid.shape == (P, 1)
    tag, x = _resolve_tag_x(data, ts, member_ts, floor)
    seg = torch.arange(P, device=data.device) // bp
    return _segment_rows(tag, x, gid, seg, P // bp, n_groups, tag_main,
                         tag_alt, threshold, group_params)


def rss_scan_agg_chunked_ref(data: torch.Tensor, ts: torch.Tensor,
                             gid: torch.Tensor, member_ts: torch.Tensor,
                             floor=0, tag_main=1, tag_alt=-2,
                             threshold=_I32_MAX, *, n_groups: int = 1,
                             group_params: torch.Tensor | None = None,
                             rows_per_step: int = 8,
                             fold_chunks: int = 8) -> torch.Tensor:
    """Chunked twin: the same `_chunk_shape` boundaries (chunk c holds
    padded pages [c*cp, (c+1)*cp), cp = Pp / chunks; padding pages match
    no group) -> [chunks, n_groups, 7] int32."""
    P = data.shape[0]
    assert gid.shape == (P, 1)
    _rows, _r, nc, Pp = _chunk_shape(P, rows_per_step, fold_chunks)
    tag, x = _resolve_tag_x(data, ts, member_ts, floor)
    seg = torch.arange(P, device=data.device) // (Pp // nc)
    return _segment_rows(tag, x, gid, seg, nc, n_groups, tag_main, tag_alt,
                         threshold, group_params)


def rss_delta_fold_ref(acc: torch.Tensor, delta: torch.Tensor) \
        -> torch.Tensor:
    """acc [Lp, 128] lane rows, delta [Dp, 128] change rows (col 0 =
    target lane / -1 pad, 1 = old, 2 = old-valid, 3 = new, 4 = new-valid,
    5 = threshold) -> advanced [Lp, 128] tile.  Additive lanes retract old
    and apply new; min/max only tighten with applied (new-valid == 1)
    values."""
    lp = acc.shape[0]
    d = delta[:, :6].long()
    tgt, old, ov, new, nv, thr = d.unbind(1)
    old_b, new_b = (old < thr).long(), (new < thr).long()
    adds = _wrap32(torch.stack([
        new * nv - old * ov,
        nv - ov,
        nv * new_b - ov * old_b,
        nv * (new > thr).long() - ov * (old > thr).long(),
        new * nv * new_b - old * ov * old_b,
    ], dim=1)).long()                                       # [Dp, 5]
    hit = (tgt >= 0) & (tgt < lp)
    row = torch.where(hit, tgt, lp)                         # spill row lp
    s = torch.zeros((lp + 1, 5), dtype=torch.int64, device=acc.device)
    s = s.index_add_(0, row, adds)[:lp]
    applied = hit & (nv == 1)
    row_m = torch.where(applied, tgt, lp)
    s_min = torch.full((lp + 1,), _I32_MAX, dtype=torch.int64,
                       device=acc.device).scatter_reduce_(
        0, row_m, new, reduce="amin")[:lp]
    s_max = torch.full((lp + 1,), _I32_MIN, dtype=torch.int64,
                       device=acc.device).scatter_reduce_(
        0, row_m, new, reduce="amax")[:lp]
    a = acc.long()
    out = acc.clone()
    out[:, 0] = _wrap32(a[:, 0] + s[:, 0])
    out[:, 1] = _wrap32(a[:, 1] + s[:, 1])
    out[:, 2] = _wrap32(a[:, 2] + s[:, 2])
    out[:, 3] = torch.minimum(a[:, 3], s_min).to(torch.int32)
    out[:, 4] = torch.maximum(a[:, 4], s_max).to(torch.int32)
    out[:, 5] = _wrap32(a[:, 5] + s[:, 3])
    out[:, 6] = _wrap32(a[:, 6] + s[:, 4])
    return out
