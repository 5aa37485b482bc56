"""The scan+aggregate kernels' launch plan, on the CPU:
`rss_scan_agg.kernel.plan` (route, grid, block, cluster and shared
memory: the one owner of the launch shape that the C entries check) and
`routes_for`, the persistent walks covering every page once with no tile
crossing a chunk boundary, and CPU stores of each planned case going to
the plain versions without a launch, equal to the JAX package's refs and
to its Pallas kernels in interpret mode on the same numpy-seeded inputs.
The kernels themselves are held against plain on the card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rss_scan_agg import kernel as jk  # noqa: E402
from repro.kernels.rss_scan_agg import ref as jr  # noqa: E402
from repro_torch.kernels.cuda_build import launch_count  # noqa: E402
from repro_torch.kernels.rss_scan_agg import kernel as K  # noqa: E402

SCAN, CHUNKED = "rss_scan_agg", "rss_scan_agg_chunked"
# [G, 7] int32 and the members' 32 KB stage within a block's 227 KB
CAP_MEMBERS = (232_448 - 32_768) // 28          # 7,131 groups
CAP_NO_MEMBERS = 232_448 // 28                  # 8,301


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("K_slots", [1, 3, 8, 9, 33])
@pytest.mark.parametrize("bp", [1, 2, 3, 4, 8, 32, 64, 1024])
def test_plan_scan_route_and_launch_shape(bp, K_slots):
    """The warp route where BP divides 32 (2 blocks of 512 an SM, 32
    pages a warp's tile), the segment route otherwise (whole segments a
    block, 2,048 threads an SM); K changes nothing."""
    P = bp * 1000
    for members, stage in ((0, 0), (64, 32_768)):
        launch = K.plan(SCAN, P, K_slots, members=members, block_pages=bp)
        if 32 % bp == 0:
            assert launch == ("warp", (min(_cdiv(_cdiv(P, 32), 16), 264), 1),
                              512, 1, stage + 16 * 7 * 32 * 4)
            assert K.routes_for(SCAN, block_pages=bp) == ("segment", "warp")
        else:
            block = bp * max(1, 256 // bp)
            grid = min(_cdiv(P, block), max(1, 2048 // block) * 132)
            assert launch == ("segment", (grid, 1), block, 1,
                              stage + block * 5)
            assert K.routes_for(SCAN, block_pages=bp) == ("segment",)
        # the segment route takes every BP and can be forced
        forced = K.plan(SCAN, P, K_slots, members=members, block_pages=bp,
                        route="segment")
        assert forced.route == "segment" and forced.block % bp == 0


@pytest.mark.parametrize("P, kw, want", [
    # the kernel phase's store (P 400,000, BP 8, M 64): 12,500 tiles
    (400_000, dict(members=64), ("warp", (264, 1), 512, 1, 47_104)),
    (400_000, dict(members=0), ("warp", (264, 1), 512, 1, 14_336)),
    (400_000, dict(members=64, route="segment"),
     ("segment", (1056, 1), 256, 1, 34_048)),
    # tile edges: 1 page, a tile, a tile and one page, a block's tiles
    (1, dict(block_pages=1), ("warp", (1, 1), 512, 1, 14_336)),
    (32, dict(), ("warp", (1, 1), 512, 1, 14_336)),
    (40, dict(), ("warp", (1, 1), 512, 1, 14_336)),
    (512, dict(), ("warp", (1, 1), 512, 1, 14_336)),
    (520, dict(), ("warp", (2, 1), 512, 1, 14_336)),
    # two rounds of the persistent grid (264 blocks x 16 warps x 32
    # pages) and 17 more, rounded up to BP
    (270_352, dict(), ("warp", (264, 1), 512, 1, 14_336)),
    (270_354, dict(block_pages=3), ("segment", (1056, 1), 255, 1, 1275)),
    (3 * 1024, dict(block_pages=1024), ("segment", (3, 1), 1024, 1, 5120)),
])
def test_plan_scan_launch_shapes(P, kw, want):
    assert tuple(K.plan(SCAN, P, 8, **kw)) == want


@pytest.mark.parametrize("G, members, route", [
    (1, 64, "cluster"), (40, 64, "cluster"), (256, 0, "cluster"),
    (2000, 64, "cluster"),
    (CAP_MEMBERS, 64, "cluster"), (CAP_MEMBERS + 1, 64, "global"),
    (CAP_MEMBERS + 1, 0, "cluster"),
    (CAP_NO_MEMBERS, 0, "cluster"), (CAP_NO_MEMBERS + 1, 0, "global"),
])
def test_plan_chunked_route_around_the_shared_memory_cap(G, members, route):
    """The cluster route while [G, 7] and the members' stage fit a
    block's opt-in shared memory: a cluster of 8 blocks of 1,024 a chunk;
    beyond it the global-atomic route, a persistent grid a chunk."""
    stage = 32_768 if members else 0
    launch = K.plan(CHUNKED, 400_000, 8, members=members, n_groups=G)
    assert launch.route == route
    assert K.routes_for(CHUNKED, n_groups=G, members=members) == (
        ("global", "cluster") if route == "cluster" else ("global",))
    if route == "cluster":
        assert launch == ("cluster", (8, 8), 1024, 8, stage + G * 28)
        assert launch.smem <= K.MAX_SMEM
    else:
        # 50,176 pages a chunk: 1,568 tiles, 8 warps a block, at most
        # 4 x 132 / 8 blocks a chunk
        assert launch == ("global", (66, 8), 256, 1, stage)
    forced = K.plan(CHUNKED, 400_000, 8, members=members, n_groups=G,
                    route="global")
    assert forced.route == "global" and forced.cluster == 1


@pytest.mark.parametrize("P, want_cluster, want_global", [
    (0, ((8, 1), 1024, 8), ((1, 1), 256, 1)),
    (1, ((8, 1), 1024, 8), ((1, 1), 256, 1)),
    (64, ((8, 1), 1024, 8), ((1, 1), 256, 1)),
    (100, ((8, 1), 1024, 8), ((1, 1), 256, 1)),
    (4096, ((8, 8), 1024, 8), ((2, 8), 256, 1)),     # 512 pages a chunk
    (270_353, ((8, 8), 1024, 8), ((66, 8), 256, 1)),
])
def test_plan_chunked_launch_shapes_at_chunk_edges(P, want_cluster,
                                                   want_global):
    for route, want in (("cluster", want_cluster), ("global", want_global)):
        launch = K.plan(CHUNKED, P, 8, members=5, n_groups=40, route=route)
        assert (launch.grid, launch.block, launch.cluster) == want


def test_plan_grid_follows_the_card():
    assert K.plan(SCAN, 400_000, 8, sms=78).grid == (2 * 78, 1)
    assert K.plan(CHUNKED, 400_000, 8, n_groups=9000,
                  sms=78).grid == (4 * 78 // 8, 8)


@pytest.mark.parametrize("kernel, P, kw", [
    (SCAN, 0, dict()),                          # nothing to scan
    (SCAN, 10, dict(block_pages=0)),
    (SCAN, 2048, dict(block_pages=2048)),       # BP over 1,024
    (SCAN, 10, dict(block_pages=4)),            # P % BP
    (SCAN, 12, dict(block_pages=3, route="warp")),   # BP not dividing 32
    (SCAN, 10, dict(K_slots=0)),
    (SCAN, 10, dict(members=-1)),
    (SCAN, 10, dict(route="cluster")),          # another kernel's route
    (CHUNKED, 10, dict(n_groups=0)),
    (CHUNKED, 10, dict(n_groups=CAP_MEMBERS + 1, members=3,
                       route="cluster")),
    (CHUNKED, -1, dict()),
    ("rss_scan_agg_grouped", 10, dict()),       # planned by no `plan`
])
def test_plan_refuses_what_no_route_takes(kernel, P, kw):
    k = kw.pop("K_slots", 8)
    with pytest.raises(ValueError):
        K.plan(kernel, P, k, **kw)


def _scan_walk(launch, P, bp):
    """Pages each warp resolves and out rows it writes, walking tiles
    w, w + warps, ... of 32 pages (warp route) or each block's pages
    b * block + i, then + grid * block (segment route)."""
    pages = np.zeros(P, np.int64)
    rows = np.zeros(P // bp, np.int64)
    if launch.route == "warp":
        warps = launch.grid[0] * launch.block // 32
        for w in range(warps):
            for tile in range(w, _cdiv(P, 32), warps):
                lo, hi = tile * 32, min(P, tile * 32 + 32)
                pages[lo:hi] += 1
                assert lo % bp == 0 and (hi - lo) % bp == 0
                rows[lo // bp:hi // bp] += 1
    else:
        grid, block = launch.grid[0], launch.block
        assert block % bp == 0
        for b in range(grid):
            for base in range(b * block, P, grid * block):
                hi = min(P, base + block)
                pages[base:hi] += 1
                rows[base // bp:hi // bp] += 1
    return pages, rows


@pytest.mark.parametrize("route, bp", [("warp", 1), ("warp", 8),
                                       ("warp", 32), ("segment", 3),
                                       ("segment", 8), ("segment", 64)])
@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_plan_scan_walk_covers_every_page_once(route, bp, rounds):
    """Every page resolved once and every partial row written once, over
    a persistent grid that takes zero, one or two full rounds and 17
    pages more (rounded up to BP); a tile holds whole segments."""
    full = K.plan(SCAN, bp * 10**6, 8, block_pages=bp, route=route)
    per_round = full.grid[0] * full.block      # pages, either route
    P = _cdiv(rounds * per_round + 17, bp) * bp
    launch = K.plan(SCAN, P, 8, block_pages=bp, route=route)
    pages, rows = _scan_walk(launch, P, bp)
    assert (pages == 1).all() and (rows == 1).all()


@pytest.mark.parametrize("route", ["cluster", "global"])
@pytest.mark.parametrize("P, rows_per_step, fold_chunks", [
    (1, 8, 8), (100, 8, 8), (4096, 8, 8), (4097, 1, 8), (270_353, 8, 8),
    (400_000, 8, 8), (5000, 1, 3),
])
def test_plan_chunked_walk_no_tile_crosses_a_chunk(route, P, rows_per_step,
                                                   fold_chunks):
    """Each chunk's warps walk tiles of 32 pages counted from the chunk's
    first page: every page of 0..P-1 once, each in its own chunk (the
    `_chunk_shape` boundaries the plain version uses)."""
    _rows, _r, nc, Pp = K._chunk_shape(P, rows_per_step, fold_chunks)
    cp = Pp // nc
    launch = K.plan(CHUNKED, P, 8, n_groups=40, rows_per_step=rows_per_step,
                    fold_chunks=fold_chunks, route=route)
    assert launch.grid[1] == nc and cp * nc >= P
    warps = launch.grid[0] * launch.block // 32
    pages = np.zeros(P, np.int64)
    for c in range(nc):
        lo, n = c * cp, max(0, min(cp, P - c * cp))
        for w in range(warps):
            for tile in range(w, _cdiv(n, 32), warps):
                a, b = lo + tile * 32, lo + min(n, tile * 32 + 32)
                assert lo <= a < b <= lo + cp
                pages[a:b] += 1
    assert (pages == 1).all()


# ------------------------------------------- CPU stores: plain, no launch
def _store(rng, P, K_slots, E=3, maxabs=2**31 - 1):
    data = rng.integers(-9, 9, (P, K_slots, E)).astype(np.int32)
    data[:, :, 0] = rng.integers(-1, 4, (P, K_slots))
    data[:, :, 1] = rng.integers(-maxabs, maxabs, (P, K_slots),
                                 dtype=np.int64)
    ts = rng.integers(0, 60, (P, K_slots)).astype(np.int32)
    return data, ts


def _untouched():
    return (launch_count(K.rss_scan_agg), launch_count(K.rss_scan_agg_chunked),
            K.rss_scan_agg.last_route, K.rss_scan_agg_chunked.last_route)


@pytest.mark.parametrize("K_slots", [1, 3, 8, 9, 33])
@pytest.mark.parametrize("bp", [1, 2, 3, 4, 8])
def test_cpu_scan_store_returns_plain_without_launch(bp, K_slots):
    """Every planned case (BP on the warp and segment routes, K held in
    registers or walked 8 at a time) on CPU tensors: the plain version,
    equal to the JAX ref, with no launch and no route recorded."""
    rng = np.random.default_rng(bp * 100 + K_slots)
    P = 24 * bp
    data, ts = _store(rng, P, K_slots)
    mem = np.array([21, 25, 25, 33, 47, 59], np.int32)
    before = _untouched()
    for floor, args in ((20, (1, 0, 5)), (0, (3, -2, -7))):
        got = K.rss_scan_agg(torch.from_numpy(data), torch.from_numpy(ts),
                             torch.from_numpy(mem), floor, *args,
                             block_pages=bp)
        want = jr.rss_scan_agg_ref(jnp.asarray(data), jnp.asarray(ts),
                                   jnp.asarray(mem), floor, *args,
                                   block_pages=bp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _untouched() == before


@pytest.mark.parametrize("K_slots, bp", [(3, 3), (9, 8), (33, 1)])
def test_cpu_scan_store_equals_pallas_interpret(K_slots, bp):
    rng = np.random.default_rng(K_slots + bp)
    data, ts = _store(rng, 8 * bp, K_slots, maxabs=1000)
    mem = np.array([21, 25, 33, 47, 59], np.int32)
    got = K.rss_scan_agg(torch.from_numpy(data), torch.from_numpy(ts),
                         torch.from_numpy(mem), 20, 1, 0, 5, block_pages=bp)
    want = jk.rss_scan_agg(jnp.asarray(data), jnp.asarray(ts),
                           jnp.asarray(mem), 20, 1, 0, 5, block_pages=bp,
                           interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# member sets like those that drive each staging on the card
MEMBER_SETS = {
    "none": [],
    "bitmap": [0, 5, 20, 21, 21, 40, 40, 59],
    "array": [0, 5, 20, 21, 21, 40, 40, 59, 10**7],
    "int32 span": [-2**31, -7, 21, 40, 59, 2**31 - 1, 2**31 - 1],
    "global": list(range(21, 60, 2)) + list(range(10**6, 10**6 + 9000)),
}


@pytest.mark.parametrize("K_slots", [3, 9])
@pytest.mark.parametrize("label", list(MEMBER_SETS))
@pytest.mark.parametrize("G", [1, 40])
def test_cpu_chunked_store_returns_plain_without_launch(G, label, K_slots):
    """The chunked call on CPU tensors for each member staging: the plain
    version, equal to the JAX ref over the same chunk boundaries, with
    no launch."""
    rng = np.random.default_rng(G + len(label) + K_slots)
    P = 300
    data, ts = _store(rng, P, K_slots, maxabs=2**20)
    gid = rng.integers(-1, G + 2, (P, 1)).astype(np.int32)
    prm = np.stack([rng.choice([1, 3], G), rng.choice([0, -2], G),
                    rng.integers(-2**19, 2**19, G)], 1).astype(np.int32)
    mem = np.sort(np.array(MEMBER_SETS[label], np.int64)).astype(np.int32)
    before = _untouched()
    got = K.rss_scan_agg_chunked(
        torch.from_numpy(data), torch.from_numpy(ts), torch.from_numpy(gid),
        torch.from_numpy(mem), 20, n_groups=G,
        group_params=torch.from_numpy(prm), rows_per_step=1, fold_chunks=4)
    want = jr.rss_scan_agg_chunked_ref(
        jnp.asarray(data), jnp.asarray(ts), jnp.asarray(gid),
        jnp.asarray(mem), 20, n_groups=G, group_params=jnp.asarray(prm),
        rows_per_step=1, fold_chunks=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (4, G, 7)
    assert _untouched() == before


@pytest.mark.parametrize("K_slots", [1, 9])
def test_cpu_chunked_store_equals_pallas_interpret(K_slots):
    rng = np.random.default_rng(K_slots)
    P, G = 200, 40
    data, ts = _store(rng, P, K_slots, maxabs=1000)
    gid = rng.integers(-1, G + 1, (P, 1)).astype(np.int32)
    prm = np.stack([rng.choice([1, 3], G), rng.choice([0, -2], G),
                    rng.integers(-500, 500, G)], 1).astype(np.int32)
    mem = np.array([21, 33, 47], np.int32)
    got = K.rss_scan_agg_chunked(
        torch.from_numpy(data), torch.from_numpy(ts), torch.from_numpy(gid),
        torch.from_numpy(mem), 20, n_groups=G,
        group_params=torch.from_numpy(prm))
    want = jk.rss_scan_agg_chunked(
        jnp.asarray(data), jnp.asarray(ts), jnp.asarray(gid),
        jnp.asarray(mem), 20, n_groups=G, group_params=jnp.asarray(prm),
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
