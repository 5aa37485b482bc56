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
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

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
    ("rss_scan_agg_grouped", 10, dict()),       # P % BP
    ("rss_scan_agg_grouped", 16, dict(n_groups=0)),
    ("rss_scan_agg_grouped", 66, dict(block_pages=33, route="warp")),
    ("rss_scan_agg_grouped", 16, dict(route="cluster")),
    ("rss_delta_fold", 0, dict(K_slots=8)),     # Lp 0
    ("rss_delta_fold", 8, dict(K_slots=-8)),    # Dp < 0
    ("rss_delta_fold", 8302, dict(route="grid")),    # [Lp, 7] over the cap
    ("rss_delta_fold", 64, dict(route="block")),
    ("rss_delta_fold", 64, dict(route="warp")),
    ("no_such_kernel", 10, dict()),
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
    return tuple((launch_count(fn), fn.last_route) for fn in K.KERNELS)


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


# ------------------------------------------- grouped scan and delta fold
GROUPED = "rss_scan_agg_grouped"


@pytest.mark.parametrize("bp", [1, 2, 3, 4, 8, 32, 64, 1024])
@pytest.mark.parametrize("G", [1, 16, 17, 43, 2000])
def test_plan_grouped_route_and_launch_shape(bp, G):
    """The grouped scan's warp route takes every BP up to 32 (a tile of
    32 // BP whole segments, 2 blocks of 512 an SM, nothing staged but
    the members) and is preferred over 16 groups; the segment route
    takes any BP (the scan's blocks, 8 bytes a page staged); G changes
    no launch."""
    P = bp * 1000
    for members, stage in ((0, 0), (64, 32_768)):
        launch = K.plan(GROUPED, P, 8, members=members, block_pages=bp,
                        n_groups=G)
        assert launch.route == ("warp" if bp <= 32 and G > 16
                                else "segment")
        assert K.routes_for(GROUPED, block_pages=bp, n_groups=G) == (
            ("segment",) if bp > 32 else ("segment", "warp") if G > 16
            else ("warp", "segment"))
        if bp <= 32:
            launch = K.plan(GROUPED, P, 8, members=members, block_pages=bp,
                            n_groups=G, route="warp")
            tiles = _cdiv(P, (32 // bp) * bp)
            assert launch == ("warp", (min(_cdiv(tiles, 16), 264), 1), 512,
                              1, stage)
        forced = K.plan(GROUPED, P, 8, members=members, block_pages=bp,
                        n_groups=G, route="segment")
        scan = K.plan(SCAN, P, 8, members=members, block_pages=bp,
                      route="segment")
        assert forced == ("segment", scan.grid, scan.block, 1,
                          stage + scan.block * 8)


@pytest.mark.parametrize("P, kw, want", [
    # the kernel phase's shape and the driver's (BP 8)
    (400_000, dict(members=64, n_groups=40), ("warp", (264, 1), 512, 1,
                                              32_768)),
    (920_008, dict(n_groups=43), ("warp", (264, 1), 512, 1, 0)),
    # the driver's at few groups: the segment route, 8 blocks of 256 an SM
    (800_016, dict(n_groups=3), ("segment", (1056, 1), 256, 1, 2048)),
    (400_016, dict(n_groups=2), ("segment", (1056, 1), 256, 1, 2048)),
    (120_016, dict(n_groups=2), ("segment", (469, 1), 256, 1, 2048)),
    (120_016, dict(n_groups=2, route="warp"), ("warp", (235, 1), 512, 1,
                                               0)),
    # P 6 at BP 6: one tile of 5 segments (30 pages), 6 pages of it
    (6, dict(block_pages=6, n_groups=43), ("warp", (1, 1), 512, 1, 0)),
    # BP 3: tiles of 30 pages
    (399_999, dict(block_pages=3, members=64, n_groups=40),
     ("warp", (264, 1), 512, 1, 32_768)),
    (3_000, dict(block_pages=3, n_groups=40), ("warp", (7, 1), 512, 1, 0)),
    (400_000, dict(block_pages=64, members=64, n_groups=40),
     ("segment", (1056, 1), 256, 1, 32_768 + 2048)),
])
def test_plan_grouped_launch_shapes(P, kw, want):
    assert tuple(K.plan(GROUPED, P, 8, **kw)) == want


def test_plan_grouped_and_fold_grids_follow_the_card():
    assert K.plan(GROUPED, 400_000, 8, n_groups=40, sms=78).grid == \
        (2 * 78, 1)
    assert K.plan("rss_delta_fold", 8, 2**20, sms=78) == \
        ("grid", (78, 1), 1024, 1, 8 * 28)
    assert K.plan("rss_delta_fold", 8, 8192, sms=78) == \
        ("grid", (8, 1), 1024, 1, 8 * 28)
    assert K.plan("rss_delta_fold", 64, 256, sms=78) == \
        ("sliced", (78, 1), 1024, 1, 1 * 28)
    assert K.plan("rss_delta_fold", 16_384, 256, sms=78) == \
        ("sliced", (78, 1), 1024, 1, 211 * 28)


def _grouped_warp_stores(launch, P, G, bp, gid):
    """The warp route's stores as the kernel makes them: warp w walks
    tiles w, w + warps, ... of 32 // BP whole segments (lanes past them
    idle), each owning G * 7 contiguous words of out; its lane l stores
    identity words l, l + 32, ... of the tile, then the lowest lane of
    each (segment, group) that a page of the tile reached stores that
    row's 7 words.  Returns the identity stores a word and the row stores
    a row of [P/BP, G]."""
    seg_words, spt = G * 7, 32 // bp
    tp = spt * bp                              # pages a tile
    ident = np.zeros(P // bp * seg_words, np.int64)
    rows = np.zeros((P // bp, G), np.int64)
    warps = launch.grid[0] * launch.block // 32
    for w in range(warps):
        for tile in range(w, _cdiv(P, tp), warps):
            segs = min(tp, P - tile * tp) // bp
            base = tile * spt * seg_words
            # lane l stores words l, l + 32, ...: one store a word
            np.add.at(ident, base + np.arange(segs * seg_words), 1)
            lanes = np.arange(segs * bp)
            pages = tile * tp + lanes
            g = gid[pages]
            hit = g >= 0
            first = {}                  # the lowest lane of each row
            for lane, s_, g_ in zip(lanes[hit], pages[hit] // bp, g[hit]):
                first.setdefault((s_, g_), lane)
            for (s_, g_) in first:
                rows[s_, g_] += 1
    return ident, rows


@pytest.mark.parametrize("bp", [1, 2, 3, 8, 24, 32])
@pytest.mark.parametrize("P_of", ["below a tile", "not a multiple of 32",
                                  "two rounds"])
def test_grouped_warp_walk_stores_every_word_once(bp, P_of):
    """Every word of [P/BP, G, 7] gets exactly one identity store from one
    lane, and every (segment, group) row that a page reached exactly one
    row store (from one lane, after the identity stores): below one
    tile, at P not a multiple of 32, and over two rounds of the
    persistent grid and 24 pages more (rounded up to BP)."""
    G = 3
    full = K.plan(GROUPED, bp * 10**6, 8, block_pages=bp, n_groups=G,
                  route="warp")
    per_round = full.grid[0] * full.block // 32 * (32 // bp) * bp
    P = {"below a tile": bp * max(1, 16 // bp),
         "not a multiple of 32": _cdiv(1000 + 8, bp) * bp,
         "two rounds": _cdiv(2 * per_round + 24, bp) * bp}[P_of]
    if P_of == "not a multiple of 32":
        assert P % 32 or bp == 32
    launch = K.plan(GROUPED, P, 8, block_pages=bp, n_groups=G,
                    route="warp")
    if P_of == "two rounds":
        assert _cdiv(P, (32 // bp) * bp) > 2 * launch.grid[0] * 16
    rng = np.random.default_rng(P + bp)
    gid = rng.integers(-1, G, P)
    ident, rows = _grouped_warp_stores(launch, P, G, bp, gid)
    assert (ident == 1).all()
    reached = np.zeros((P // bp, G), bool)
    ok = gid >= 0
    reached[np.arange(P)[ok] // bp, gid[ok]] = True
    assert (rows == reached).all()


@pytest.mark.parametrize("lp, dp, route", [
    (8, 8, "sliced"), (64, 256, "sliced"), (8, 2048, "sliced"),
    (8301, 2048, "sliced"), (8, 2056, "grid"), (8, 4096, "grid"),
    (8301, 4096, "grid"), (8, 4104, "grid"), (2048, 131_072, "grid"),
    (64, 131_072, "grid"), (128, 131_072, "grid"), (129, 131_072, "grid"),
    (8, 1_048_576, "grid"), (8301, 4104, "grid"), (8302, 8, "sliced"),
    (16_384, 1_048_576, "sliced"),
])
def test_plan_delta_fold_route_by_rows_and_the_lane_cap(lp, dp, route):
    """The sliced route for at most 2,048 delta rows, else the grid route
    while [Lp, 7] fits a block's opt-in shared memory (8,301 lanes); past
    it the sliced route alone.  Blocks of 1,024 threads: the sliced route
    a block an SM, the grid route a block for each 1,024 delta rows, at
    most one an SM (a cooperative launch: every block resident)."""
    launch = K.plan("rss_delta_fold", lp, dp)
    routes = K.routes_for("rss_delta_fold", lanes=lp, rows=dp)
    assert launch.route == route == routes[-1]
    assert routes == (("sliced",) if lp > 8301 else
                      ("grid", "sliced") if dp <= 2048 else
                      ("sliced", "grid"))
    if route == "sliced":
        want = ((132, 1), min(_cdiv(lp, 132), 8301) * 28)
    else:
        want = ((min(_cdiv(dp, 1024), 132), 1), lp * 28)
    assert launch == (route, want[0], 1024, 1, want[1])
    assert launch.smem <= K.MAX_SMEM
    forced = K.plan("rss_delta_fold", lp, dp, route="sliced")
    assert forced.smem == min(_cdiv(lp, 132), 8301) * 28


@pytest.mark.parametrize("bp", [1, 2, 4, 8])
@pytest.mark.parametrize("G", [3, 40])
def test_cpu_grouped_store_equals_pallas_interpret(bp, G):
    """The grouped call on CPU tensors at the shrink ladder's BP with
    G > 1: the plain version, equal to the Pallas kernel in interpret
    mode, with no launch."""
    rng = np.random.default_rng(bp * 10 + G)
    P = 8 * bp
    data, ts = _store(rng, P, 8, maxabs=1000)
    gid = rng.integers(-1, G + 2, (P, 1)).astype(np.int32)
    prm = np.stack([rng.choice([1, 3], G), rng.choice([0, -2], G),
                    rng.integers(-500, 500, G)], 1).astype(np.int32)
    mem = np.array([21, 25, 33, 47, 59], np.int32)
    before = _untouched()
    got = K.rss_scan_agg_grouped(
        torch.from_numpy(data), torch.from_numpy(ts), torch.from_numpy(gid),
        torch.from_numpy(mem), 20, n_groups=G, block_pages=bp,
        group_params=torch.from_numpy(prm), route="warp")
    want = jk.rss_scan_agg_grouped(
        jnp.asarray(data), jnp.asarray(ts), jnp.asarray(gid),
        jnp.asarray(mem), 20, n_groups=G, block_pages=bp,
        group_params=jnp.asarray(prm), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (P // bp, G, 7)
    assert _untouched() == before


@pytest.mark.parametrize("lp, dp", [(8, 64), (64, 256)])
def test_cpu_delta_fold_equals_pallas_interpret(lp, dp):
    """The delta fold on CPU tensors (any route asked for): the plain
    version, equal to the Pallas kernel in interpret mode, targets past
    Lp and new-valid in {0, 1, 2} included, with no launch."""
    rng = np.random.default_rng(lp + dp)
    acc = rng.integers(-2**31, 2**31, (lp, 128), dtype=np.int64) \
        .astype(np.int32)
    delta = rng.integers(-2**31, 2**31, (dp, 128), dtype=np.int64) \
        .astype(np.int32)
    delta[:, 0] = rng.integers(-1, lp + 2, dp)
    delta[:, 2] = rng.integers(0, 3, dp)
    delta[:, 4] = rng.integers(0, 3, dp)
    before = _untouched()
    for route in (None, "grid", "sliced"):
        got = K.rss_delta_fold(torch.from_numpy(acc), torch.from_numpy(delta),
                               route=route)
        want = jk.rss_delta_fold(jnp.asarray(acc), jnp.asarray(delta),
                                 interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _untouched() == before
