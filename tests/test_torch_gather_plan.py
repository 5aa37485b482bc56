"""The gather kernels' launch plan, on the CPU: `rss_gather.kernel.plan`
(route, grid, block and pages a warp, the one owner of the launch shape
that the C entries check), the routes that take a store (`routes_for`),
and CPU stores of each planned case, and of member sets of each staging,
going to the plain versions without a launch, equal to the JAX
package's refs on the same numpy-seeded inputs.  The members' staging
rule lives in gather.cu alone and is tested on the card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rss_gather.ref import rss_gather_ref as jax_rss  # noqa
from repro.kernels.version_gather.ref import \
    version_gather_ref as jax_vg  # noqa: E402
from repro_torch.kernels.cuda_build import launch_count  # noqa: E402
from repro_torch.kernels.rss_gather import kernel as RG  # noqa: E402
from repro_torch.kernels.version_gather import kernel as VG  # noqa: E402

# (K, row bytes, aligned) -> (route, pages a warp) that `plan` chooses:
# the tile route for rows of at most 512 bytes on 16 bytes, of 16-byte
# multiples, at K <= 8, 4 KB of rows a tile (at most 32 pages); the warp
# route otherwise (one page a warp)
ROW_BYTES = [1, 128, 2048, 1282]
CHOSEN = {(1, 128, True): ("tile", 32), (3, 128, True): ("tile", 32),
          (8, 128, True): ("tile", 32)}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("row_bytes", ROW_BYTES)
@pytest.mark.parametrize("K", [1, 3, 8, 33])
def test_plan_route_and_pages_per_warp(K, row_bytes, aligned):
    route, ppw = CHOSEN.get((K, row_bytes, aligned), ("warp", 1))
    launch = RG.plan(10_000, K, row_bytes, aligned)
    assert (launch.route, launch.pages_per_warp) == (route, ppw)
    assert launch.block == 256
    # 8 warps a block; the tile route's grid at most 3 blocks an SM
    assert launch.grid == ((-(-10_000 // 32) + 7) // 8 if route == "tile"
                           else 1250,)
    # the warp route takes every store and can be forced where the tile
    # route is chosen
    admissible = RG.routes_for(K, row_bytes, aligned)
    assert admissible == (("warp", "tile") if route == "tile"
                          else ("warp",))
    for r in admissible:
        assert RG.plan(10_000, K, row_bytes, aligned, route=r).route == r


@pytest.mark.parametrize("P, K, row_bytes, route, want", [
    # the mirror (int32, K 8, E 32): persistent, 3 blocks an SM of 132
    (400_000, 8, 128, None, ("tile", (396,), 256, 32)),
    (400_000, 8, 128, "warp", ("warp", (50_000,), 256, 1)),
    # 512-byte rows: the widest the tile route takes, 8 pages a tile
    (10_000, 8, 512, None, ("tile", (157,), 256, 8)),
    (10_000, 4, 256, None, ("tile", (79,), 256, 16)),
    # the bf16 embedding store (K 2, E 1,024): 2 KB rows, a warp a page
    (151_936, 2, 2048, None, ("warp", (18_992,), 256, 1)),
    # grid-stride beyond 2^20 blocks
    (10_000_000, 33, 128, None, ("warp", (1 << 20,), 256, 1)),
    # a small store takes fewer blocks than the cap
    (100, 8, 128, None, ("tile", (1,), 256, 32)),
    (33, 8, 128, None, ("tile", (1,), 256, 32)),
    (17, 33, 128, None, ("warp", (3,), 256, 1)),
    # over two rounds of the persistent grid (396 blocks x 8 warps x 32
    # pages), ending part way through a tile
    (202_769, 3, 128, None, ("tile", (396,), 256, 32)),
    (202_769, 8, 512, None, ("tile", (396,), 256, 8)),
    (202_769, 8, 128, "warp", ("warp", (25_347,), 256, 1)),
    (202_769, 3, 512, "warp", ("warp", (25_347,), 256, 1)),
])
def test_plan_launch_shapes(P, K, row_bytes, route, want):
    assert tuple(RG.plan(P, K, row_bytes, True, route=route)) == want


def test_plan_grid_follows_the_card():
    assert RG.plan(400_000, 8, 128, True, sms=78).grid == (3 * 78,)


@pytest.mark.parametrize("P, K, row_bytes, aligned, route", [
    (0, 8, 128, True, None),            # empty output: nothing to launch
    (10, 0, 128, True, None),           # no slot
    (10, 8, 0, True, None),             # empty rows
    (10, 8, 128, False, "tile"),        # rows off 16 bytes
    (10, 8, 1282, True, "tile"),        # rows not 16-byte multiples
    (10, 33, 128, True, "tile"),        # more ts than a lane holds
    (10, 8, 528, True, "tile"),         # wider than one 16-byte access
    (10, 2, 2048, True, "tile"),
    (10, 8, 128, True, "bulk"),         # no such route
])
def test_plan_refuses_what_no_route_takes(P, K, row_bytes, aligned, route):
    with pytest.raises(ValueError):
        RG.plan(P, K, row_bytes, aligned, route=route)


@pytest.mark.parametrize("route", ["tile", "warp"])
@pytest.mark.parametrize("P", [1, 31, 32, 33, 101_376, 101_377, 202_769])
def test_plan_walk_covers_every_page_once(P, route):
    """The pages each warp takes (tile w, w + warps, ... of `ppw` pages)
    cover 0..P-1 once: a persistent grid walks several tiles a warp."""
    launch = RG.plan(P, 8, 128, True, route=route)
    ppw, warps = launch.pages_per_warp, launch.grid[0] * launch.block // 32
    tiles = -(-P // ppw)
    assert warps <= tiles + launch.block // 32 - 1
    rounds = -(-tiles // warps)
    covered = np.zeros(P, np.int64)
    for w in range(warps):
        for tile in range(w, tiles, warps):
            covered[tile * ppw:min(P, (tile + 1) * ppw)] += 1
    assert (covered == 1).all()
    # 101,376 pages a round of the tile route's grid
    assert rounds == (1 if route == "warp" else -(-P // 101_376))


# a store of each planned case: row bytes -> (dtype, E)
STORE = {1: (torch.uint8, np.uint8, jnp.uint8, 1),
         128: (torch.int32, np.int32, jnp.int32, 32),
         2048: (torch.bfloat16, np.float32, jnp.bfloat16, 1024),
         1282: (torch.bfloat16, np.float32, jnp.bfloat16, 641)}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("row_bytes", ROW_BYTES)
@pytest.mark.parametrize("K", [1, 3, 8, 33])
def test_cpu_store_of_each_case_returns_plain_without_launch(
        K, row_bytes, aligned):
    tdt, ndt, jdt, E = STORE[row_bytes]
    P, offset = 37, 0 if aligned else 1
    rng = np.random.default_rng(K * 7919 + row_bytes)
    flat = rng.integers(0, 100, P * K * E + offset).astype(ndt)
    data = torch.from_numpy(flat).to(tdt)[offset:].view(P, K, E)
    ts_np = rng.integers(0, 60, (P, K)).astype(np.int32)
    ts = torch.from_numpy(ts_np)
    mem_np = np.array([0, 31, 34, 34, 40, 47, 59], np.int32)
    mem = torch.from_numpy(mem_np)
    RG.reset_launches(), VG.reset_launches()
    before = (RG.rss_gather.last_route, VG.version_gather.last_route)
    got_rss = RG.rss_gather(data, ts, mem, 20)
    got_vg = VG.version_gather(data, ts, 33)
    d = jnp.asarray(flat[offset:].reshape(P, K, E)).astype(jdt)
    want_rss = jax_rss(d, jnp.asarray(ts_np), jnp.asarray(mem_np), 20)
    want_vg = jax_vg(d, jnp.asarray(ts_np), 33)
    for got, want in ((got_rss, want_rss), (got_vg, want_vg)):
        assert got.dtype == tdt and tuple(got.shape) == (P, E)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert launch_count(RG.rss_gather) == launch_count(VG.version_gather) \
        == 0
    assert (RG.rss_gather.last_route, VG.version_gather.last_route) \
        == before


# member sets like those that drive each staging on the card: (members,
# floor)
_DUPS = [0, 5, 20, 31, 31, 40, 40, 59]
MEMBER_SETS = {
    "duplicates, at or below the floor": (_DUPS, 20),
    "span over the bitmap": (_DUPS + [10**7], 20),
    "span overflows int32": ([-2**31, -7] + _DUPS + [2**31 - 1] * 3, 20),
    "M over the array": (list(range(21, 60, 2))
                         + list(range(10**6, 10**6 + 9000)), 20),
    "no member above the floor": ([-3, 0, 10, 20], 20),
}


@pytest.mark.parametrize("K", [3, 8])
@pytest.mark.parametrize("label", list(MEMBER_SETS))
def test_cpu_member_sets_return_plain_without_launch(label, K):
    members, floor = MEMBER_SETS[label]
    P, E = 41, 32
    rng = np.random.default_rng(K + len(members))
    data_np = rng.integers(-2**31, 2**31 - 1, (P, K, E), dtype=np.int64) \
        .astype(np.int32)
    ts_np = rng.integers(0, 60, (P, K)).astype(np.int32)
    mem_np = np.sort(np.array(members, np.int64)).astype(np.int32)
    RG.reset_launches()
    got = RG.rss_gather(torch.from_numpy(data_np), torch.from_numpy(ts_np),
                        torch.from_numpy(mem_np), floor)
    want = jax_rss(jnp.asarray(data_np), jnp.asarray(ts_np),
                   jnp.asarray(mem_np), floor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert launch_count(RG.rss_gather) == 0
