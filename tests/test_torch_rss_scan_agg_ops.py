"""rss_scan_agg ops-layer parity: the port's public ops (CPU tensors, so
the plain versions run) against the reference's ops (Pallas kernels in
interpret mode), with equal results and equal launch accounting — the
port's `device_calls` series is the reference's `pallas_calls`.

Covers the block-size shrink ladder, the chunked -> flat overflow
demotion, host/flat/chunked dispatch, the folds and the delta fold entry
point.  Inputs are numpy-seeded and every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rss_scan_agg import ops as jops  # noqa: E402
from repro_torch.kernels.rss_scan_agg import ops as tops  # noqa: E402
from test_torch_rss_scan_agg import (_eq, _gparams, _j, _members,  # noqa: E402
                                     _store, _t)

# ---------------------------------------------------------------- ops level
def _stats(view, rename=False):
    d = dict(view)
    if rename:
        d["device_calls"] = d.pop("pallas_calls")
    return d


def _stores(data, ts):
    return ({"data": _j(data), "ts": _j(ts)},
            {"data": _t(data), "ts": _t(ts)})


@pytest.mark.parametrize("maxabs", [100, 2**28 + 7, 2**30 + 1, 2**31 - 1])
def test_ops_scalar_shrink_ladder(maxabs):
    """The block-size shrink ladder (BP 8 -> 4 -> 2 -> 1) picks the same
    block and the folds agree past int32, with equal launch stats."""
    rng = np.random.default_rng(maxabs % 97)
    data, ts = _store(rng, 48, maxabs=maxabs, pad_pages=3)
    data[0, :, 1] = maxabs                  # attain the bound
    mem = _members(rng, 5, 9)
    js, ts_ = _stores(data, ts)
    jops.reset_launch_stats()
    tops.reset_launch_stats()
    for tag_main, tag_alt, thr in [(1, 0, None), (3, -2, 17)]:
        want = jops.snapshot_agg_members(js, mem, 9, tag_main=tag_main,
                                         tag_alt=tag_alt, threshold=thr)
        got = tops.snapshot_agg_members(ts_, mem, 9, tag_main=tag_main,
                                        tag_alt=tag_alt, threshold=thr)
        assert want == got
    assert tops.field_maxabs(ts_) == jops.field_maxabs(js) == maxabs
    assert _stats(tops.LAUNCH_STATS) == _stats(jops.LAUNCH_STATS, True)


def test_field_maxabs_int32_min_does_not_wrap():
    data = np.zeros((8, 2, 3), np.int32)
    data[3, 1, 1] = -2**31
    store = {"data": _t(data), "ts": _t(np.zeros((8, 2), np.int32))}
    assert tops.field_maxabs(store) == 2**31


@pytest.mark.parametrize("P,G,mode,maxabs", [
    (40, 4, None, 100),          # < 64 pages, one plan: host
    (72, 4, None, 100),          # flat
    (72, 40, None, 100),         # chunked
    (72, 40, None, 2**26),       # chunked bound violated -> flat
    (136, 40, "chunked", 50),    # forced chunked, padded chunk space
    (72, 6, "flat", 2**29),      # forced flat with a shrunk block
])
def test_ops_grouped_auto(P, G, mode, maxabs):
    rng = np.random.default_rng(P * G)
    data, ts = _store(rng, P, maxabs=maxabs, pad_pages=5)
    mem = _members(rng, 6, 11)
    gid = rng.integers(-1, G, P).astype(np.int32)
    prm = _gparams(rng, G)
    js, ts_ = _stores(data, ts)
    jops.reset_launch_stats()
    tops.reset_launch_stats()
    for n_plans in (1, 3):
        want = jops.grouped_agg_auto(js, gid, G, mem, 11, group_params=prm,
                                     n_plans=n_plans, mode=mode)
        got = tops.grouped_agg_auto(ts_, gid, G, mem, 11, group_params=prm,
                                    n_plans=n_plans, mode=mode)
        assert want == got
    assert _stats(tops.LAUNCH_STATS) == _stats(jops.LAUNCH_STATS, True)


def test_ops_grouped_members_and_chunked_entry_points():
    rng = np.random.default_rng(5)
    P, G = 96, 12
    data, ts = _store(rng, P, pad_pages=6)
    gid = rng.integers(-1, G, P).astype(np.int32)
    js, ts_ = _stores(data, ts)
    jops.reset_launch_stats()
    tops.reset_launch_stats()
    for mem, floor in [(np.zeros(0, np.int32), 0),
                       (np.zeros(0, np.int32), 33),
                       (_members(rng, 8, 20), 20)]:
        for fn in ("snapshot_group_agg_members",
                   "snapshot_group_agg_chunked"):
            want = getattr(jops, fn)(js, gid, G, mem, floor, tag_main=1,
                                     tag_alt=0, threshold=7)
            got = getattr(tops, fn)(ts_, gid, G, mem, floor, tag_main=1,
                                    tag_alt=0, threshold=7)
            assert want == got, (fn, floor)
    assert _stats(tops.LAUNCH_STATS) == _stats(jops.LAUNCH_STATS, True)


def test_ops_delta_fold_entry_point():
    rng = np.random.default_rng(9)
    acc = np.zeros((8, 128), np.int32)
    acc[:, 3], acc[:, 4] = 2**31 - 1, -2**31
    delta = np.zeros((16, 128), np.int32)
    delta[:, 0] = -1
    rows = [(0, 5, 1, 7, 1, 6), (0, 0, 0, 3, 1, 6), (2, 4, 1, 0, 0, 6),
            (5, -9, 1, 12, 1, 0), (7, 0, 0, -2**20, 1, 100)]
    delta[:len(rows), :6] = rows
    jops.reset_launch_stats()
    tops.reset_launch_stats()
    want = jops.delta_fold(_j(acc), _j(delta))
    got = tops.delta_fold(_t(acc), delta)
    _eq(want, got.numpy())
    # fold a second buffer on top (padding only at the end)
    delta2 = delta.copy()
    delta2[:, 0] = rng.integers(-1, 8, 16)
    _eq(jops.delta_fold(want, _j(delta2)),
        tops.delta_fold(got, delta2).numpy())
    assert _stats(tops.LAUNCH_STATS) == _stats(jops.LAUNCH_STATS, True)


def test_fold_partials_match_reference():
    rng = np.random.default_rng(3)
    parts = rng.integers(-2**31, 2**31, (9, 7), dtype=np.int64) \
        .astype(np.int32)
    assert tops.fold_partials(_t(parts)) == jops.fold_partials(parts)
    gparts = rng.integers(-2**31, 2**31, (5, 4, 7), dtype=np.int64) \
        .astype(np.int32)
    assert tops.fold_group_partials(_t(gparts)) == \
        jops.fold_group_partials(gparts)
    assert tops.fold_partials(torch.zeros((0, 7), dtype=torch.int32)) == \
        jops.fold_partials(np.zeros((0, 7), np.int32))


def test_select_grouped_mode_and_bounds_match_reference():
    for P in (0, 8, 63, 64, 4096):
        for G in (1, 32, 33, 256):
            for n_plans in (1, 2):
                assert tops.select_grouped_mode(P, G, n_plans) == \
                    jops.select_grouped_mode(P, G, n_plans)
    for maxabs in (0, 1, 2**28, 2**29 + 1, 2**31):
        for P in (1, 3, 8, 64):
            assert tops.safe_block_pages(maxabs, P) == \
                jops.safe_block_pages(maxabs, P)
            assert tops.scan_bound_ok(maxabs, P) == \
                jops.scan_bound_ok(maxabs, P)
            raised = []
            for mod in (jops, tops):
                try:
                    mod.check_block_bound(maxabs, P)
                    raised.append(False)
                except OverflowError:
                    raised.append(True)
            assert raised[0] == raised[1]
