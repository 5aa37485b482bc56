"""rss_scan_agg port parity: the PyTorch plain versions (what the port's
wrappers run for CPU tensors) against the reference's Pallas kernels in
interpret mode and its jnp refs, bitwise.

Inputs are made with numpy from a seed and handed to both packages.  Every
output is int32, so every comparison is exact.  The ops layer has its own
file, `test_torch_rss_scan_agg_ops.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rss_scan_agg import kernel as jk  # noqa: E402
from repro.kernels.rss_scan_agg import ref as jr  # noqa: E402
from repro_torch.kernels.rss_scan_agg import kernel as tk  # noqa: E402
from repro_torch.kernels.rss_scan_agg import ref as tr  # noqa: E402

TAG_PAD = -1


def _store(rng, P, K=4, E=4, maxabs=100, pad_pages=0, ts_hi=60):
    """Random paged store: tags in {TAG_PAD, init, int, district, order},
    fields in [-maxabs, maxabs], the last `pad_pages` pages TAG_PAD."""
    data = np.zeros((P, K, E), np.int32)
    data[:, :, 0] = rng.integers(-1, 4, (P, K))
    data[:, :, 1] = rng.integers(-maxabs, maxabs + 1, (P, K))
    data[:, :, 2:] = rng.integers(0, 9, (P, K, E - 2))
    if pad_pages:
        data[P - pad_pages:] = 0
        data[P - pad_pages:, :, 0] = TAG_PAD
    ts = rng.integers(0, ts_hi, (P, K)).astype(np.int32)
    if pad_pages:
        ts[P - pad_pages:] = 0
    return data, ts


def _members(rng, m, floor, hi=60):
    pool = np.arange(floor + 1, hi)
    return np.sort(rng.choice(pool, size=min(m, pool.size),
                              replace=False)).astype(np.int32)


def _gparams(rng, g):
    return np.stack([rng.choice([1, 3], g), rng.choice([0, -2, 2], g),
                     rng.integers(-50, 50, g)], 1).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _eq(*arrays):
    base = np.asarray(arrays[0])
    for a in arrays[1:]:
        np.testing.assert_array_equal(np.asarray(a), base)


# ------------------------------------------------------------- kernel level
SCAN_CASES = [
    # (P, M, floor, block_pages, pad_pages)
    (16, 0, 0, 8, 3),        # empty member set, floor 0: initial slots only
    (24, 0, 23, 8, 0),       # floor-only (SI-V prefix) snapshot
    (40, 7, 10, 1, 5),       # shrink ladder block sizes, TAG_PAD pages
    (40, 7, 10, 2, 0),
    (40, 7, 10, 4, 0),
    (64, 30, 5, 8, 8),
]


@pytest.mark.parametrize("P,M,floor,bp,pad", SCAN_CASES)
def test_scan_agg_plain_equals_pallas(P, M, floor, bp, pad):
    rng = np.random.default_rng(P * 100 + M + bp)
    data, ts = _store(rng, P, pad_pages=pad)
    mem = _members(rng, M, floor)
    for tag_main, tag_alt, thr in [(1, 0, 50), (3, -2, 10)]:
        args = (data, ts, mem, floor, tag_main, tag_alt, thr)
        pal = jk.rss_scan_agg(*map(_j, args[:3]), *args[3:],
                              block_pages=bp, interpret=True)
        ref = jr.rss_scan_agg_ref(*map(_j, args[:3]), *args[3:],
                                  block_pages=bp)
        port = tk.rss_scan_agg(*map(_t, args[:3]), *args[3:],
                               block_pages=bp)
        plain = tr.rss_scan_agg_ref(*map(_t, args[:3]), *args[3:],
                                    block_pages=bp)
        assert port.dtype == torch.int32 and port.shape == (P // bp, 7)
        _eq(pal, ref, port.numpy(), plain.numpy())


GROUP_CASES = [
    # (P, G, M, floor, block_pages, per-group params)
    (32, 3, 0, 0, 8, False),
    (32, 5, 6, 12, 2, True),
    (48, 40, 9, 20, 8, True),      # G > 32 (chunked demotion / forced)
]


@pytest.mark.parametrize("P,G,M,floor,bp,per_group", GROUP_CASES)
def test_grouped_plain_equals_pallas(P, G, M, floor, bp, per_group):
    rng = np.random.default_rng(P + G * 7 + bp)
    data, ts = _store(rng, P, pad_pages=2)
    mem = _members(rng, M, floor)
    gid = rng.integers(-1, G + 2, (P, 1)).astype(np.int32)   # -1 and >= G
    prm = _gparams(rng, G) if per_group else None
    kw = dict(n_groups=G, block_pages=bp)
    pal = jk.rss_scan_agg_grouped(
        _j(data), _j(ts), _j(gid), _j(mem), floor, 1, 0, 40,
        group_params=None if prm is None else _j(prm), interpret=True, **kw)
    ref = jr.rss_scan_agg_grouped_ref(
        _j(data), _j(ts), _j(gid), _j(mem), floor, 1, 0, 40,
        group_params=None if prm is None else _j(prm), **kw)
    port = tk.rss_scan_agg_grouped(
        _t(data), _t(ts), _t(gid), _t(mem), floor, 1, 0, 40,
        group_params=None if prm is None else _t(prm), **kw)
    assert port.shape == (P // bp, G, 7)
    _eq(pal, ref, port.numpy())


CHUNK_CASES = [
    # (P, G, M, group_tile): P not a multiple of 64 pads the chunk space;
    # G not a multiple of the tile pads the group tiles
    (100, 5, 4, 8),
    (136, 40, 11, 16),
    (200, 40, 0, 8),
    (64, 1, 3, 8),
]


@pytest.mark.parametrize("P,G,M,tile", CHUNK_CASES)
def test_chunked_plain_equals_pallas(P, G, M, tile):
    rng = np.random.default_rng(P + G + tile)
    data, ts = _store(rng, P, pad_pages=4)
    floor = 15
    mem = _members(rng, M, floor)
    gid = rng.integers(-1, G + 1, (P, 1)).astype(np.int32)
    prm = _gparams(rng, G)
    pal = jk.rss_scan_agg_chunked(
        _j(data), _j(ts), _j(gid), _j(mem), floor, n_groups=G,
        group_params=_j(prm), group_tile=tile, interpret=True)
    ref = jr.rss_scan_agg_chunked_ref(
        _j(data), _j(ts), _j(gid), _j(mem), floor, n_groups=G,
        group_params=_j(prm))
    port = tk.rss_scan_agg_chunked(
        _t(data), _t(ts), _t(gid), _t(mem), floor, n_groups=G,
        group_params=_t(prm), group_tile=tile)
    _eq(pal, ref, port.numpy())
    _eq(jk.tree_fold_partials(pal), tk.tree_fold_partials(port).numpy())


@pytest.mark.parametrize("seed", range(3))
def test_delta_fold_plain_equals_pallas(seed):
    """Padding rows, retractions (old-valid rows), wrapping sums and
    min/max tightening only for new-valid == 1."""
    rng = np.random.default_rng(seed)
    lp, dp = 16, 64
    acc = rng.integers(-2**31, 2**31, (lp, 128), dtype=np.int64) \
        .astype(np.int32)
    delta = rng.integers(-2**31, 2**31, (dp, 128), dtype=np.int64) \
        .astype(np.int32)
    delta[:, 0] = rng.integers(-1, lp + 2, dp)          # -1 pad, >= lp
    delta[:, 2] = rng.integers(0, 3, dp)
    delta[:, 4] = rng.integers(0, 3, dp)
    delta[:8, 0] = -1
    pal = jk.rss_delta_fold(_j(acc), _j(delta), interpret=True)
    ref = jr.rss_delta_fold_ref(_j(acc), _j(delta))
    port = tk.rss_delta_fold(_t(acc), _t(delta))
    _eq(pal, ref, port.numpy())


def test_wrappers_take_plain_version_on_cpu_only():
    """CPU tensors never launch: the wrappers' launch counts stay 0."""
    before = tk.reset_launches()
    rng = np.random.default_rng(0)
    data, ts = _store(rng, 16)
    mem = _members(rng, 3, 5)
    tk.rss_scan_agg(_t(data), _t(ts), _t(mem), 5)
    tk.rss_delta_fold(torch.zeros((8, 128), dtype=torch.int32),
                      torch.full((8, 128), -1, dtype=torch.int32))
    assert all(v == 0 for v in tk.reset_launches().values())
    assert set(before) == {"rss_scan_agg", "rss_scan_agg_grouped",
                           "rss_scan_agg_chunked", "rss_delta_fold"}
