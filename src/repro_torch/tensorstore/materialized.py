"""Incremental materialized aggregates: commit-time delta folds make hot
OLAP O(delta), not O(table).

A `MaterializedView` pins one registered aggregate plan (`AggPlan` /
`MultiAggPlan` / `GroupByPlan`) to a live device-resident accumulator
tile: `[Lp, 128]` int32, one sublane-aligned row per accumulator lane of
the plan's `_lane_layout` (the same lane decomposition the fused grouped
kernels use), lanes 0..6 = [sum, count, count_below, min, max,
count_above, sum_below].  Every commit the mirror applies is folded into
the tile AT COMMIT TIME by the `rss_delta_fold` kernel — one dense
`[Dp, 128]` buffer of (retract old, apply new) change rows — so serving
the plan costs O(pending delta), independent of how many pages the plan
scans.  The fused full scan stays as the always-correct fallback.

Version supersession without reading old page versions: the view keeps a
host-side contribution shadow (`contrib[lane][key]` = the value currently
folded in, or None when the key's visible value does not participate in
the lane's field).  A commit overwriting a key emits a delta row that
retracts the shadowed old contribution and applies the new one, then
advances the shadow — the mirror's K-slot recycling can drop the old
version whenever it likes, the view never needs it again.

Subtractability split: sum / count / count_below / count_above /
sum_below are linear, so retract-then-apply is exact.  min / max are NOT
subtractable — the fold only TIGHTENS them.  Retracting a value equal to
the lane's attained bound sets a per-lane dirty bit; a serve that needs a
dirty lane's min/max DEMOTES just that lane to a partial rescan of its
own pages (one fused `rss_scan_agg` pass over the affected key range at
the view's watermark), replaces the bound, and clears the bit.

Consistency: views fold every applied commit synchronously, so the tile
always equals the SI prefix at the mirror's watermark.  The mirror's
`view_gate` proves a requested snapshot equals that prefix (every applied
above-floor commit seq is a snapshot member — tracked in
`PagedMirror._recent_seqs`); when it can't, the serve falls back to the
fused scan.  `check_scans` keeps asserting materialized == fused == chain
oracle in-run at every facade.

Overflow ladder (the tile is int32): |contribution| is bounded by
`MAX_CONTRIB` and the pending buffer flushes at `FLUSH_ROWS`, so neither
a fold's row deltas nor their sum can wrap; host int64 shadow sums bound
every additive accumulator lane by `MAX_ACC`.  Any violation permanently
degrades the view to fused-scan fallback (counted) — wrong is worse than
slow.
"""

from __future__ import annotations

import numpy as np
import torch

_I32 = np.iinfo(np.int32)

# overflow ladder: |contribution| bound, pending-buffer flush threshold,
# additive-accumulator bound.  MAX_CONTRIB * 2 * FLUSH_ROWS and
# MAX_ACC + MAX_CONTRIB * 2 * FLUSH_ROWS both fit int32.
MAX_CONTRIB = 2 ** 20
FLUSH_ROWS = 256
MAX_ACC = 2 ** 30

_EMPTY_LANE = (0, 0, 0, int(_I32.max), int(_I32.min), 0, 0)


def _pad_dim(n: int, floor: int = 8) -> int:
    """Next power-of-two >= max(n, floor): the (Lp, Dp) shapes the fold
    sees (kept from the reference, whose jitted fold recompiles per
    shape)."""
    p = floor
    while p < n:
        p *= 2
    return p


class MaterializedView:
    """Live incremental accumulator for ONE registered aggregate plan over
    a `PagedMirror`.  Construct via `PagedMirror.register_view` — the
    mirror owns the commit hook, the serve gate, and the hit/fallback
    accounting; the view owns the tile, the contribution shadow, the
    dirty-bit demotion ladder, and the overflow guard."""

    def __init__(self, mirror, plan) -> None:
        from .mirror import _lane_layout, _op_config
        from .version_store import AggPlan, GroupByPlan, MultiAggPlan

        assert isinstance(plan, (AggPlan, MultiAggPlan, GroupByPlan)), plan
        self.mirror = mirror
        self.plan = plan
        lane_groups, lane_params, lane_of = _lane_layout([plan])
        for grp in lane_groups:
            if len(set(grp)) != len(grp):
                raise ValueError(
                    "materialized plans need duplicate-free key groups "
                    "(the contribution shadow is keyed per key)")
        self.lane_groups = lane_groups
        self.lane_params = lane_params          # (field, tag_main, tag_alt, thr)
        self.lane_of = lane_of
        self.n_lanes = len(lane_groups)
        self.lp = _pad_dim(self.n_lanes)
        # key -> [(lane, field, effective threshold)]
        self.key_lanes: dict[str, list] = {}
        for lane, (grp, prm) in enumerate(zip(lane_groups, lane_params)):
            field, _tm, _ta, thr = prm
            thr_eff = int(_I32.max) if thr is None else int(thr)
            for k in grp:
                self.key_lanes.setdefault(k, []).append((lane, field, thr_eff))
        # lanes whose plan ops actually read min/max (only these demote)
        ops = plan.ops if hasattr(plan, "ops") else (plan.op,)
        n_groups = len(lane_groups) // max(
            1, len(dict.fromkeys(_op_config(op) for op in ops)))
        self.minmax_lanes = frozenset(
            lane_of[(0, _op_config(op), g)]
            for op in ops if op.kind in ("min", "max")
            for g in range(n_groups))
        # serve/fold state (filled by reseed)
        self.acc = None            # [Lp, 128] int32 on the mirror's device
        self.shadow = None                      # host int64 [n_lanes, 7]
        self.contrib: list[dict] = []
        self._key_seq: dict = {}       # key -> highest folded commit seq
        self.pending: list[tuple] = []
        self.dirty_min: set[int] = set()
        self.dirty_max: set[int] = set()
        self.degraded = False
        self.seed_seq = 0                       # watermark floor of the tile
        self.last_lsn = 0
        self.reseed()

    # ------------------------------------------------------------- seeding
    def reseed(self) -> None:
        """(Re-)materialize the tile from a full SI-prefix scan of the
        mirror at its current watermark — the registration path, and the
        recovery path after anything that invalidates incremental state
        (late registration behind WAL truncation, overflow degradation a
        caller wants to retry after a workload change)."""
        from .version_store import agg_value

        wm = self.mirror.watermark
        flat_keys = [k for grp in self.lane_groups for k in grp]
        vals = self.mirror._scan(
            flat_keys, lambda ts: np.where(ts <= wm, ts, -1))
        self.contrib = []
        self.shadow = np.zeros((self.n_lanes, 7), np.int64)
        tile = np.zeros((self.lp, 128), np.int32)
        tile[:, :7] = _EMPTY_LANE
        self.degraded = False
        off = 0
        for lane, (grp, prm) in enumerate(zip(self.lane_groups,
                                              self.lane_params)):
            field, _tm, _ta, thr = prm
            thr_eff = int(_I32.max) if thr is None else int(thr)
            contrib = {k: agg_value(v, field)
                       for k, v in zip(grp, vals[off:off + len(grp)])}
            off += len(grp)
            self.contrib.append(contrib)
            xs = [x for x in contrib.values() if x is not None]
            if any(abs(x) > MAX_CONTRIB for x in xs):
                self.degraded = True
            row = [sum(xs), len(xs), sum(1 for x in xs if x < thr_eff),
                   min(xs, default=int(_I32.max)),
                   max(xs, default=int(_I32.min)),
                   sum(1 for x in xs if x > thr_eff),
                   sum(x for x in xs if x < thr_eff)]
            if abs(row[0]) > MAX_ACC or abs(row[6]) > MAX_ACC:
                self.degraded = True
            self.shadow[lane] = row
            if not self.degraded:
                tile[lane, :7] = row
        self.acc = torch.as_tensor(tile, device=self.mirror.device)
        self._key_seq.clear()
        self.pending = []
        self.dirty_min.clear()
        self.dirty_max.clear()
        self.seed_seq = wm
        self.last_lsn = self.mirror.applied_lsn

    # -------------------------------------------------------- commit fold
    def on_commit(self, rec, seq: int) -> None:
        """Fold one applied commit record: per written key per lane, emit
        a delta row retracting the shadowed old contribution and applying
        the new one, advance the shadow/bounds/dirty-bits, and flush the
        pending buffer through the fold kernel when it fills.  O(writes),
        never O(table)."""
        if self.degraded:
            return
        from .version_store import agg_value

        for key, value in rec.writes:
            lanes = self.key_lanes.get(key)
            if not lanes:
                continue
            if seq < self._key_seq.get(key, 0):
                # a same-key fold arriving below an already-folded seq
                # would retract the newer version; RSS dependency closure
                # should forbid this — degrade rather than serve it
                self.degraded = True
                return
            self._key_seq[key] = seq
            for lane, field, thr_eff in lanes:
                new = agg_value(value, field)
                old = self.contrib[lane].get(key)
                if new == old:
                    continue
                self.contrib[lane][key] = new
                ov, oldv = (0, 0) if old is None else (1, int(old))
                nv, newv = (0, 0) if new is None else (1, int(new))
                if abs(newv) > MAX_CONTRIB:
                    self.degraded = True
                    return
                self.pending.append((lane, oldv, ov, newv, nv, thr_eff))
                sh = self.shadow[lane]
                sh[0] += newv * nv - oldv * ov
                sh[1] += nv - ov
                sh[2] += nv * (newv < thr_eff) - ov * (oldv < thr_eff)
                sh[5] += nv * (newv > thr_eff) - ov * (oldv > thr_eff)
                sh[6] += (newv * nv * (newv < thr_eff)
                          - oldv * ov * (oldv < thr_eff))
                if abs(sh[0]) > MAX_ACC or abs(sh[6]) > MAX_ACC:
                    self.degraded = True
                    return
                # min/max only tighten on device: retracting the attained
                # bound makes the lane's bound stale -> dirty
                if ov and oldv == sh[3]:
                    self.dirty_min.add(lane)
                if ov and oldv == sh[4]:
                    self.dirty_max.add(lane)
                if nv:
                    sh[3] = min(sh[3], newv)
                    sh[4] = max(sh[4], newv)
        self.seed_seq = seq
        self.last_lsn = rec.lsn
        if len(self.pending) >= FLUSH_ROWS:
            self._flush()

    def _flush(self) -> None:
        """Fold the pending delta rows into the device tile — ONE
        `rss_delta_fold` launch over a dense padded [Dp, 128] buffer."""
        if not self.pending:
            return
        from ..kernels.rss_scan_agg import ops as kops

        dp = _pad_dim(len(self.pending))
        delta = np.zeros((dp, 128), np.int32)
        delta[:, 0] = -1                        # padding rows fold nowhere
        delta[:len(self.pending), :6] = np.asarray(self.pending, np.int32)
        self.acc = kops.delta_fold(self.acc, delta)
        self.pending = []

    # -------------------------------------------------------------- serve
    def _demote(self, lanes: list[int]) -> None:
        """Dirty-bit demotion: partial rescan of ONLY the dirty lanes'
        pages (one fused member-ts pass per lane at the view's fold
        visibility — floor plus folded member seqs), replacing the
        lane's min/max and clearing its bits.  Counted per lane on the
        mirror's exec stats."""
        from ..kernels.rss_scan_agg.ops import snapshot_agg_members

        floor = self.mirror._seqs_floor
        members = np.asarray(self.mirror._folded_seqs, np.int32)
        for lane in lanes:
            field, tag_main, tag_alt, thr = self.lane_params[lane]
            pages = self.mirror.page_index(self.lane_groups[lane])
            raw = snapshot_agg_members(
                self.mirror.torch_store_for(pages), members, floor,
                tag_main=tag_main, tag_alt=tag_alt, threshold=thr)
            self.shadow[lane, 3], self.shadow[lane, 4] = raw[3], raw[4]
            # in place: the tile is this view's own tensor (the reference
            # rebuilds an immutable jnp array with .at[].set)
            self.acc[lane, 3] = raw[3]
            self.acc[lane, 4] = raw[4]
            self.dirty_min.discard(lane)
            self.dirty_max.discard(lane)
            self.mirror.exec_stats["view_demotions"] += 1

    def serve_rows(self) -> list[list[int]]:
        """The tile's lane rows as Python ints — only valid AFTER the
        mirror's `view_gate` proved the requested snapshot equals the SI
        prefix at the watermark.  Flushes pending deltas, demotes any
        dirty lane whose min/max the plan actually reads, and returns
        [lane][sum, count, count_below, min, max, count_above,
        sum_below]."""
        assert not self.degraded
        self._flush()
        dirty = sorted((self.dirty_min | self.dirty_max)
                       & self.minmax_lanes)
        if dirty:
            self._demote(dirty)
        return self.acc[:self.n_lanes, :7].tolist()

    def result(self):
        """Serve the registered plan from the tile (post-gate): assembled
        exactly like the fused path's finalize stage, so results are
        indistinguishable from a full scan."""
        from .mirror import _op_config
        from .version_store import (AggPlan, GroupByPlan, MultiAggPlan,
                                    finalize_agg)

        rows = self.serve_rows()
        plan = self.plan
        if isinstance(plan, GroupByPlan):
            return tuple(
                tuple(finalize_agg(rows[self.lane_of[(0, _op_config(op), g)]],
                                   op) for op in plan.ops)
                for g in range(len(plan.key_groups)))
        if isinstance(plan, MultiAggPlan):
            return tuple(finalize_agg(rows[self.lane_of[(0, _op_config(op),
                                                         0)]], op)
                         for op in plan.ops)
        assert isinstance(plan, AggPlan), plan
        return finalize_agg(rows[self.lane_of[(0, _op_config(plan.op), 0)]],
                            plan.op)

    # ---------------------------------------------------------------- misc
    @property
    def watermark(self) -> tuple[int, int]:
        """(commit seq, lsn) horizon of the tile — every commit the mirror
        applied through this point is folded in."""
        return (self.seed_seq, self.last_lsn)
