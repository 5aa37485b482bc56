"""On-card checks of the port's CUDA kernels: each kernel == its plain
PyTorch version on the GPU (bitwise), the shared-memory and global-atomic
reduction paths both, plus the wrappers' input checks and a small driver
run on "cuda" against the same run on "cpu".

Marked `cuda`: they skip without a GPU (a CUDA kernel has no CPU mode).
On the GPU machine: PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cuda_build import launch_count  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, P, K=8, E=6, M=40, G=5, seed=0, maxabs=2**31 - 1):
    rng = np.random.default_rng(seed)
    data = rng.integers(-9, 9, (P, K, E)).astype(np.int32)
    data[:, :, 0] = rng.integers(-1, 4, (P, K))
    data[:, :, 1] = rng.integers(-maxabs, maxabs, (P, K), dtype=np.int64)
    ts = rng.integers(0, 300, (P, K)).astype(np.int32)
    mem = np.sort(rng.choice(np.arange(101, 300), M, replace=False))
    gid = rng.integers(-1, G + 2, (P, 1)).astype(np.int32)
    prm = np.stack([rng.choice([1, 3], G), rng.choice([0, -2], G),
                    rng.integers(-2**30, 2**30, G)], 1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.astype(np.int32))).to(dev)
    return t(data), t(ts), t(mem), t(gid), t(prm)


@pytest.mark.parametrize("P,bp,M", [(1000, 8, 40), (1000, 4, 0),
                                    (1002, 2, 40), (999, 1, 7), (6, 3, 2)])
def test_scan_agg_kernel_equals_plain(dev, P, bp, M):
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    data, ts, mem, _, _ = _inputs(dev, P, M=M, seed=P + bp)
    args = (data, ts, mem, 100, 1, 0, 12345)
    got = K.rss_scan_agg(*args, block_pages=bp)
    assert torch.equal(got, R.rss_scan_agg_ref(*args, block_pages=bp))


@pytest.mark.parametrize("G", [1, 5, 40, 2000])
def test_grouped_and_chunked_kernels_equal_plain(dev, G):
    """Every G here, 2000 included, fits the chunked kernel's [G, 7]
    shared-memory tile, so the chunked call takes the cluster route;
    `test_chunked_every_route_equals_plain` forces the global-atomic
    route and passes the cap."""
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    data, ts, mem, gid, prm = _inputs(dev, 4000, G=G, seed=G)
    a = (data, ts, gid, mem, 100)
    kw = dict(n_groups=G, group_params=prm)
    assert torch.equal(K.rss_scan_agg_grouped(*a, block_pages=8, **kw),
                       R.rss_scan_agg_grouped_ref(*a, block_pages=8, **kw))
    got = K.rss_scan_agg_chunked(*a, **kw)
    assert torch.equal(got, R.rss_scan_agg_chunked_ref(*a, **kw))
    assert torch.equal(K.tree_fold_partials(got),
                       K.tree_fold_partials(got.cpu()).to(dev))
    nop = K.rss_scan_agg_grouped(*a, n_groups=G, block_pages=8,
                                 tag_main=1, tag_alt=0, threshold=7)
    assert torch.equal(nop, R.rss_scan_agg_grouped_ref(
        *a, n_groups=G, block_pages=8, tag_main=1, tag_alt=0, threshold=7))


@pytest.mark.parametrize("lp,dp", [(8, 8), (64, 256), (2048, 4096)])
def test_delta_fold_kernel_equals_plain(dev, lp, dp):
    """On the route `plan` gives: the sliced route up to FOLD_SLICED_ROWS
    delta rows, the grid route over it (2,048 lanes at 4,096 rows);
    `test_delta_fold_every_route_equals_plain` forces each route."""
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    rng = np.random.default_rng(lp)
    acc = rng.integers(-2**31, 2**31, (lp, 128), dtype=np.int64)
    delta = rng.integers(-2**31, 2**31, (dp, 128), dtype=np.int64)
    delta[:, 0] = rng.integers(-1, lp + 1, dp)
    delta[:, 2] = rng.integers(0, 3, dp)
    delta[:, 4] = rng.integers(0, 3, dp)
    acc_t = torch.from_numpy(acc.astype(np.int32)).to(dev)
    delta_t = torch.from_numpy(delta.astype(np.int32)).to(dev)
    assert torch.equal(K.rss_delta_fold(acc_t, delta_t),
                       R.rss_delta_fold_ref(acc_t, delta_t))
    assert K.rss_delta_fold.last_route.route == (
        "sliced" if dp <= K.FOLD_SLICED_ROWS else "grid")


def test_wrappers_reject_bad_inputs_and_count_launches(dev):
    from repro_torch.kernels.rss_scan_agg import kernel as K

    data, ts, mem, gid, _ = _inputs(dev, 64)
    K.reset_launches()
    K.rss_scan_agg(data, ts, mem, 0)
    assert launch_count(K.rss_scan_agg) == 1
    with pytest.raises(TypeError):
        K.rss_scan_agg(data.long(), ts, mem, 0)
    with pytest.raises(ValueError):
        K.rss_scan_agg(data, ts, mem.cpu(), 0)
    with pytest.raises(ValueError):
        K.rss_scan_agg_grouped(data, ts, torch.cat([gid, gid], 1)[:, :1],
                               mem, 0, n_groups=5)      # strided gid
    with pytest.raises(OverflowError):
        K.rss_scan_agg(data, ts, mem, 2**31)
    assert launch_count(K.rss_scan_agg) == 1


# ------------------------------------------- scan+aggregate launch routes
def _round_pages(dev, K):
    """The card's SMs, and the pages a round of the larger persistent
    grid takes: the warp route's (32 pages a warp) or the segment
    route's at BP 3 (a page a thread)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warp = K.WARP_BLOCKS_PER_SM * sms * (K.WARP_THREADS // 32) * K.TILE
    seg = (K.SEGMENT_THREADS_PER_SM // 255) * sms * 255
    return sms, max(warp, seg)


# member sets of each staging (rss_gather.kernel.member_staging): none,
# a bitmap (with duplicates and members at or below the floor), the
# sorted array (span over the bitmap), device memory (M over the array)
SCAN_MEMBERS = {
    "none": [],
    "bitmap": [0, 5, 100, 101, 101, 150, 150, 299],
    "array": [0, 5, 100, 101, 101, 150, 150, 299, 10**7],
    "global": list(range(101, 300, 2)) + list(range(10**6, 10**6 + 9000)),
}


@pytest.mark.parametrize("bp", [1, 2, 3, 4, 8, 32, 64])
@pytest.mark.parametrize("k", [1, 3, 8, 9, 33])
def test_scan_agg_every_route_equals_plain(dev, k, bp):
    """Each route that takes the call (warp where BP divides 32, segment
    always), forced, == plain bitwise over P pages of two rounds of the
    larger persistent grid plus 17 (rounded up to BP), fields at the
    int32 extremes: K 1 and 3 load timestamps one by one, K 8 as 16-byte
    vectors, K 9 and 33 walk them 8 at a time with a running best."""
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    sms, per_round = _round_pages(dev, K)
    P = -(-(2 * per_round + 17) // bp) * bp
    data, ts, mem, _, _ = _inputs(dev, P, K=k, E=2 + k % 3, M=40,
                                  seed=k * 100 + bp)
    K.reset_launches()
    routes = K.routes_for("rss_scan_agg", block_pages=bp)
    assert routes == (("segment", "warp") if 32 % bp == 0 else ("segment",))
    for route in routes:
        launch = K.plan("rss_scan_agg", P, k, members=40, block_pages=bp,
                        route=route, sms=sms)
        if route == "warp":
            assert -(-P // 32) > 2 * launch.grid[0] * launch.block // 32
        for floor, args in ((100, (1, 0, 12345)), (0, (3, -2, -7))):
            got = K.rss_scan_agg(data, ts, mem, floor, *args, block_pages=bp,
                                 route=route)
            want = R.rss_scan_agg_ref(data, ts, mem, floor, *args,
                                      block_pages=bp)
            assert torch.equal(got, want), (route, floor)
            assert K.rss_scan_agg.last_route == launch
        assert K.rss_scan_agg.route_launches[route] == 2
    assert launch_count(K.rss_scan_agg) == 2 * len(routes)


@pytest.mark.parametrize("route", ["warp", "segment"])
@pytest.mark.parametrize("staging", list(SCAN_MEMBERS))
def test_scan_agg_member_stagings_equal_plain(dev, staging, route):
    """The three scan kernels on each staging of the members, as
    gather.cu's rule reports it for the set; every route of each
    kernel."""
    from repro_torch.kernels.rss_gather import kernel as RG
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    mem_np = np.sort(np.array(SCAN_MEMBERS[staging], np.int64)) \
        .astype(np.int32)
    lo, hi = (int(mem_np[0]), int(mem_np[-1])) if mem_np.size else (0, 0)
    assert RG.member_staging(mem_np.size, lo, hi) == staging
    data, ts, _, gid, prm = _inputs(dev, 40_000, G=40, seed=len(staging))
    mem = torch.from_numpy(mem_np).to(dev)
    chunked_route = {"warp": "cluster", "segment": "global"}[route]
    for floor in (0, 100):
        a = (data, ts, mem, floor, 1, 0, 5)
        assert torch.equal(K.rss_scan_agg(*a, route=route),
                           R.rss_scan_agg_ref(*a)), (staging, floor)
        g = (data, ts, gid, mem, floor)
        kw = dict(n_groups=40, group_params=prm)
        assert torch.equal(
            K.rss_scan_agg_chunked(*g, route=chunked_route, **kw),
            R.rss_scan_agg_chunked_ref(*g, **kw)), (staging, floor)
        assert torch.equal(
            K.rss_scan_agg_grouped(*g, route=route, **kw),
            R.rss_scan_agg_grouped_ref(*g, **kw)), (staging, floor)


@pytest.mark.parametrize("k", [3, 8, 33])
@pytest.mark.parametrize("G", [1, 40, 256, 2000, "cap+1"])
def test_chunked_every_route_equals_plain(dev, G, k):
    """Each chunked route that takes the call, forced, == plain bitwise,
    at P over two rounds of the persistent grids plus 17 and fields at
    the int32 extremes; "cap+1" is one group over what the cluster
    route's shared memory holds (with members staged), so only the
    global-atomic route takes it."""
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    if G == "cap+1":
        G = (K.MAX_SMEM - K.STAGE_BYTES) // (K.LANES * 4) + 1
    sms, per_round = _round_pages(dev, K)
    P = 2 * per_round + 17
    data, ts, mem, gid, prm = _inputs(dev, P, K=k, M=40, G=G, seed=G + k)
    routes = K.routes_for("rss_scan_agg_chunked", n_groups=G, members=40)
    assert routes == (("global", "cluster") if G < 7132 else ("global",))
    K.reset_launches()
    a = (data, ts, gid, mem, 100)
    kw = dict(n_groups=G, group_params=prm)
    want = R.rss_scan_agg_chunked_ref(*a, **kw)
    for route in routes:
        got = K.rss_scan_agg_chunked(*a, route=route, **kw)
        assert torch.equal(got, want), route
        launch = K.rss_scan_agg_chunked.last_route
        assert launch == K.plan("rss_scan_agg_chunked", P, k, members=40,
                                n_groups=G, route=route, sms=sms)
        if route == "global":      # two rounds of a chunk's warps and more
            _rows, _r, nc, Pp = K._chunk_shape(P, 8, 8)
            assert -(-(Pp // nc) // 32) > 2 * launch.grid[0] * 8
    assert K.rss_scan_agg_chunked.route_launches == \
        dict.fromkeys(routes, 1) | ({"cluster": 0} if len(routes) == 1
                                    else {})


def test_scan_agg_entries_refuse_a_launch_plan_did_not_give(dev):
    """The C entries hold their own copy of `plan`: another grid, block
    or cluster is cudaErrorInvalidConfiguration (9), a route that does
    not take the call (or arguments no route takes)
    cudaErrorInvalidValue (1)."""
    from repro_torch.kernels.cuda_build import stream
    from repro_torch.kernels.rss_scan_agg import kernel as K

    P = 4096
    data, ts, mem, gid, prm = _inputs(dev, P, M=40, G=40)
    out = torch.empty((P, 40, 7), dtype=torch.int32, device=dev)
    lib = K._lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def scan(bp, route, grid, block):
        return lib.rsa_scan_agg(data.data_ptr(), ts.data_ptr(),
                                mem.data_ptr(), 40, P, 8, 6, 100, 1, 0, 5,
                                bp, out.data_ptr(),
                                K.ROUTE_CODES["rss_scan_agg"][route],
                                grid, block, stream())

    for bp in (8, 4, 1):
        for route in ("warp", "segment"):
            L = K.plan("rss_scan_agg", P, 8, members=40, block_pages=bp,
                       route=route, sms=sms)
            assert scan(bp, route, L.grid[0], L.block) == 0
            assert scan(bp, route, L.grid[0] + 1, L.block) == 9
            assert scan(bp, route, L.grid[0], L.block * 2) == 9
    seg = K.plan("rss_scan_agg", 4095, 8, members=40, block_pages=3,
                 route="segment", sms=sms)
    assert lib.rsa_scan_agg(data.data_ptr(), ts.data_ptr(), mem.data_ptr(),
                            40, 4095, 8, 6, 100, 1, 0, 5, 3, out.data_ptr(),
                            K.ROUTE_CODES["rss_scan_agg"]["warp"],
                            seg.grid[0], seg.block,
                            stream()) == 1           # BP 3 on the warp route
    assert scan(3, "segment", seg.grid[0], seg.block) == 1   # P % BP
    assert scan(2048, "segment", 1, 2048) == 1               # BP > 1,024

    _rows, _r, nc, Pp = K._chunk_shape(P, 8, 8)

    def chunked(G, route, grid, block, cluster):
        return lib.rsa_scan_agg_chunked(
            data.data_ptr(), ts.data_ptr(), gid.data_ptr(), mem.data_ptr(),
            40, P, 8, 6, 100, prm.data_ptr(), G, Pp // nc, nc,
            out.data_ptr(), K.ROUTE_CODES["rss_scan_agg_chunked"][route],
            grid, block, cluster, stream())

    for route in ("cluster", "global"):
        L = K.plan("rss_scan_agg_chunked", P, 8, members=40, n_groups=40,
                   route=route, sms=sms)
        g, b, c = L.grid[0], L.block, L.cluster
        assert chunked(40, route, g, b, c) == 0
        assert chunked(40, route, g + 8, b, c) == 9
        assert chunked(40, route, g, b // 2, c) == 9
        assert chunked(40, route, g, b, c * 2) == 9
    big = (K.MAX_SMEM - K.STAGE_BYTES) // 28 + 1
    assert chunked(big, "cluster", 8, 1024, 8) == 1
    torch.cuda.synchronize()


# ------------------------------------ grouped scan and delta fold routes
def _grouped_store(dev, P, K, E, M, G, seed):
    """A store with fields at the int32 extremes, timestamps in [0,
    12,000) around a floor of 6,000, M members above it (a bitmap
    staging), group ids in [-1, G + 2) and per-group params."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-9, 9, (P, K, E)).astype(np.int32)
    data[:, :, 0] = rng.integers(-1, 4, (P, K))
    data[:, :, 1] = rng.integers(-2**31, 2**31, (P, K), dtype=np.int64)
    ts = rng.integers(0, 12_000, (P, K)).astype(np.int32)
    mem = np.sort(rng.choice(np.arange(6_001, 12_000), M, replace=False))
    gid = rng.integers(-1, G + 2, (P, 1)).astype(np.int32)
    prm = np.stack([rng.choice([1, 3], G), rng.choice([0, -2], G),
                    rng.integers(-2**30, 2**30, G)], 1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.astype(np.int32))).to(dev)
    return t(data), t(ts), t(mem), t(gid), t(prm)


# (P, G, M, K, E): P 6, 1,000 or two rounds of the larger persistent
# grid plus 17 ("rounds"), each rounded up to BP; K 9 and 33 walk the
# timestamps 8 at a time, odd E loads tag and field one by one.  "rounds
# G 43" at BP 1 (325 MB of output) takes the warp route's writes-first
# kernel, every other case its interleaved one
GROUPED_CASES = {
    "P 6": (6, 43, 64, 8, 6),
    "P 1000 G 2000 M 4096": (1000, 2000, 4096, 9, 3),
    "P 1000 G 256 M 0": (1000, 256, 0, 33, 5),
    "rounds G 1": ("rounds", 1, 64, 8, 32),
    "rounds G 43": ("rounds", 43, 0, 9, 3),
}


@pytest.mark.parametrize("case", list(GROUPED_CASES))
@pytest.mark.parametrize("bp", [1, 2, 3, 4, 8])
def test_grouped_every_route_equals_plain(dev, bp, case):
    """`rss_scan_agg_grouped` forced on each route that takes the call
    (warp for BP up to 32, segment always) == plain bitwise, with
    per-group params and with the scalar args; the launch is `plan`'s.
    At P 6 a BP of 8 is 6 (a warp tile of 5 segments)."""
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    P, G, M, k, e = GROUPED_CASES[case]
    sms, per_round = _round_pages(dev, K)
    if P == "rounds":
        P = 2 * per_round + 17
    P = -(-P // min(bp, P)) * min(bp, P)
    data, ts, mem, gid, prm = _grouped_store(dev, P, k, e, M, G,
                                             seed=P + bp + G)
    eff = min(bp, P)
    routes = K.routes_for("rss_scan_agg_grouped", block_pages=eff,
                          n_groups=G)
    assert set(routes) == {"segment", "warp"}    # every BP here is <= 32
    K.reset_launches()
    a = (data, ts, gid, mem, 6_000)
    for route in routes:
        kw = dict(n_groups=G, block_pages=bp)
        got = K.rss_scan_agg_grouped(*a, group_params=prm, route=route, **kw)
        assert torch.equal(got, R.rss_scan_agg_grouped_ref(
            *a, group_params=prm, **kw)), route
        assert K.rss_scan_agg_grouped.last_route == K.plan(
            "rss_scan_agg_grouped", P, k, members=M, block_pages=eff,
            n_groups=G, route=route, sms=sms)
        scal = (1, 0, 12345)
        assert torch.equal(
            K.rss_scan_agg_grouped(*a, *scal, route=route, **kw),
            R.rss_scan_agg_grouped_ref(*a, *scal, **kw)), route
    assert K.rss_scan_agg_grouped.route_launches == \
        {r: (2 if r in routes else 0) for r in ("segment", "warp")}


def _fold_inputs(dev, lp, dp, seed):
    """acc and delta at the int32 extremes; targets in [-1, Lp + 2)
    (-1 pads, >= Lp folds nowhere), old- and new-valid in {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.randint(-2**31, 2**31 - 1, (lp, 128), dtype=torch.int32,
                        device=dev, generator=gen)
    delta = torch.randint(-2**31, 2**31 - 1, (dp, 128), dtype=torch.int32,
                          device=dev, generator=gen)
    cols = np.stack([rng.integers(-1, lp + 2, dp),
                     rng.integers(0, 3, dp), rng.integers(0, 3, dp)], 1)
    delta[:, [0, 2, 4]] = torch.from_numpy(cols.astype(np.int32)).to(dev)
    return acc, delta


@pytest.mark.parametrize("dp", [8, 256, 8192, 24_576, 131_072, 1_048_576])
@pytest.mark.parametrize("lp", [8, 64, 2048, 16_384])
def test_delta_fold_every_route_equals_plain(dev, lp, dp):
    """`rss_delta_fold` forced on each route that takes the call == plain
    bitwise: grid while [Lp, 7] fits a block's shared memory (one block
    at up to 1,024 rows, else several), sliced always (Lp 16,384 is over
    the cap: sliced only).  Lp 8 folds in the lanes' registers, the
    others with shared atomics."""
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    acc, delta = _fold_inputs(dev, lp, dp, seed=lp + dp)
    want = R.rss_delta_fold_ref(acc, delta)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    routes = K.routes_for("rss_delta_fold", lanes=lp, rows=dp)
    assert set(routes) == ({"sliced"} if lp == 16_384
                           else {"sliced", "grid"})
    assert K.plan("rss_delta_fold", lp, dp, sms=sms).route == (
        "sliced" if lp == 16_384 or dp <= K.FOLD_SLICED_ROWS else "grid")
    K.reset_launches()
    held = []     # each result kept, so no route's out reuses another's
    for route in routes:
        held.append(K.rss_delta_fold(acc, delta, route=route))
        assert torch.equal(held[-1], want), route
        assert K.rss_delta_fold.last_route == K.plan(
            "rss_delta_fold", lp, dp, route=route, sms=sms)
    assert sum(K.rss_delta_fold.route_launches.values()) == len(routes)


def test_grouped_and_fold_entries_refuse_a_launch_plan_did_not_give(dev):
    """The C entries of the grouped scan and the delta fold hold their own
    copy of `plan`: another grid or block is
    cudaErrorInvalidConfiguration (9); a route that does not take the
    call, arguments no route takes or a pointer off 16 bytes (the fold)
    cudaErrorInvalidValue (1)."""
    from repro_torch.kernels.cuda_build import stream
    from repro_torch.kernels.rss_scan_agg import kernel as K

    P = 4096
    data, ts, mem, gid, prm = _inputs(dev, P, M=40, G=40)
    out = torch.empty((P, 40, 7), dtype=torch.int32, device=dev)
    lib = K._lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    codes = K.ROUTE_CODES["rss_scan_agg_grouped"]

    def grouped(bp, route, grid, block, n_pages=P, G=40):
        return lib.rsa_scan_agg_grouped(
            data.data_ptr(), ts.data_ptr(), gid.data_ptr(), mem.data_ptr(),
            40, n_pages, 8, 6, 100, prm.data_ptr(), G, bp, out.data_ptr(),
            codes[route], grid, block, stream())

    for bp, n in ((8, P), (4, P), (3, 4095), (1, P)):
        for route in ("warp", "segment"):
            L = K.plan("rss_scan_agg_grouped", n, 8, members=40,
                       block_pages=bp, n_groups=40, route=route, sms=sms)
            assert grouped(bp, route, L.grid[0], L.block, n) == 0
            assert grouped(bp, route, L.grid[0] + 1, L.block, n) == 9
            assert grouped(bp, route, L.grid[0], L.block * 2, n) == 9
    seg = K.plan("rss_scan_agg_grouped", 4092, 8, members=40, block_pages=33,
                 n_groups=40, route="segment", sms=sms)
    assert grouped(33, "segment", seg.grid[0], seg.block, 4092) == 0
    assert grouped(33, "warp", 1, 512, 4092) == 1    # BP over 32 on warp
    assert grouped(3, "segment", seg.grid[0], seg.block) == 1   # P % BP
    assert grouped(3, "segment", seg.grid[0], seg.block, 4095, 0) == 1

    lp, dp = 64, 256
    acc, delta = _fold_inputs(dev, lp, dp, seed=1)
    fout = torch.empty_like(acc)
    part = torch.empty((sms, lp, 7), dtype=torch.int32, device=dev)
    fcodes = K.ROUTE_CODES["rss_delta_fold"]

    def fold(route, grid, block, a=acc, p=part, n=lp):
        return lib.rsa_delta_fold(a.data_ptr(), delta.data_ptr(), n, dp,
                                  None if p is None else p.data_ptr(),
                                  fout.data_ptr(), fcodes[route], grid,
                                  block, stream())

    for route in ("grid", "sliced"):
        L = K.plan("rss_delta_fold", lp, dp, route=route, sms=sms)
        assert fold(route, L.grid[0], L.block) == 0
        assert fold(route, L.grid[0] + 1, L.block) == 9
        assert fold(route, L.grid[0], L.block // 2) == 9
    assert fold("sliced", sms, 1024, p=None) == 0   # needs no partials
    assert fold("grid", 1, 1024, p=None) == 1
    assert fold("grid", 1, 1024, n=8302) == 1      # [Lp, 7] over the cap
    off = torch.empty(lp * 128 + 4, dtype=torch.int32,
                      device=dev)[1:1 + lp * 128].view(lp, 128)
    assert fold("sliced", sms, 1024, a=off) == 1
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        K.rss_delta_fold(off, delta)


def test_delta_fold_grid_on_two_streams_equals_plain(dev):
    """Grid-route folds (cooperative launches) on two streams at once,
    each queued behind a long kernel on its own stream: every result ==
    plain."""
    from repro_torch.kernels.rss_scan_agg import kernel as K
    from repro_torch.kernels.rss_scan_agg import ref as R

    lp, dp = 64, 131_072
    inputs = [_fold_inputs(dev, lp, dp, seed=s) for s in (3, 4)]
    wants = [R.rss_delta_fold_ref(a, d) for a, d in inputs]
    assert K.plan("rss_delta_fold", lp, dp).route == "grid"
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    spin = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    gots = [[] for _ in inputs]
    for _ in range(4):
        for s, (a, d), got in zip(streams, inputs, gots):
            with torch.cuda.stream(s):
                spin @ spin                   # holds the stream a while
                got.append(K.rss_delta_fold(a, d, route="grid"))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        assert all(torch.equal(g, want) for g in got)


def test_grouped_and_fold_are_one_device_operation(dev, monkeypatch):
    """Each call of the grouped scan and of the delta fold, on every
    route (the fold's grid route at one block and at several), is one
    kernel on the card: no fill, no copy, no memset (counted in a
    torch.profiler trace by `chip_smoke._device_ops`)."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from chip_smoke import _device_ops
    from repro_torch.kernels.rss_scan_agg import kernel as K

    data, ts, mem, gid, prm = _inputs(dev, 4096, M=40, G=40)
    acc, delta = _fold_inputs(dev, 64, 256, seed=2)
    big = _fold_inputs(dev, 64, 3 * 8192, seed=5)[1]
    calls = {f"grouped {r}": (lambda r=r: K.rss_scan_agg_grouped(
        data, ts, gid, mem, 100, n_groups=40, group_params=prm, route=r))
        for r in ("warp", "segment")}
    calls.update({f"fold {r} Dp {d.shape[0]}": (
        lambda r=r, d=d: K.rss_delta_fold(acc, d, route=r))
        for r in ("grid", "sliced") for d in (delta, big)})
    for name, call in calls.items():
        call()                                      # built and warm
        assert _device_ops(torch, call) == 1, name


def test_plan_copies_match_the_library(dev):
    """`plan` runs on the CPU too, so it keeps copies of numbers the
    library owns: the members' stage (rss_resolve.cuh's bitmap) and the
    cluster route's shared-memory cap, which the C entry takes at the
    last G it fits and refuses one over."""
    from repro_torch.kernels.cuda_build import stream
    from repro_torch.kernels.rss_gather.kernel import staging_caps
    from repro_torch.kernels.rss_scan_agg import kernel as K

    assert K.STAGE_BYTES == staging_caps()[0] // 8
    P = 4096
    _rows, _r, nc, Pp = K._chunk_shape(P, 8, 8)
    cap = (K.MAX_SMEM - K.STAGE_BYTES) // (K.LANES * 4)
    data, ts, mem, gid, prm = _inputs(dev, P, M=40, G=cap + 1)
    out = torch.empty((nc, cap + 1, 7), dtype=torch.int32, device=dev)
    for G, want in ((cap, 0), (cap + 1, 1)):
        assert K.routes_for("rss_scan_agg_chunked", n_groups=G,
                            members=40)[-1] == ("cluster", "global")[want]
        assert K._lib().rsa_scan_agg_chunked(
            data.data_ptr(), ts.data_ptr(), gid.data_ptr(), mem.data_ptr(),
            40, P, 8, 6, 100, prm.data_ptr(), G, Pp // nc, nc,
            out.data_ptr(), K.ROUTE_CODES["rss_scan_agg_chunked"]["cluster"],
            K.CLUSTER_BLOCKS,
            K.CLUSTER_THREADS, K.CLUSTER_BLOCKS, stream()) == want
    torch.cuda.synchronize()


def test_small_driver_cuda_equals_cpu(dev):
    import dataclasses

    from repro_torch.mvcc import Scale, run_single_node

    kw = dict(olap_mode="ssi+rss", oltp_clients=4, olap_clients=3,
              rounds=120, seed=7, olap_scan=True, paged_olap=True,
              check_scans=True, batch_plans=True, materialize=True,
              scale=Scale(warehouses=2, districts=20, customers=10,
                          items=200, order_capacity=10))
    a = dataclasses.asdict(run_single_node(device="cuda", **kw))
    b = dataclasses.asdict(run_single_node(device="cpu", **kw))
    for k in ("serve_latency", "oltp_commit_latency",
              "serve_latency_by_plan", "serve_stage_latency"):
        a.pop(k), b.pop(k)
    assert a == b


# ------------------------------------------------------------ gather kernels
GATHER_DTYPES = ["bfloat16", "float16", "float32", "int32"]


def _gather_inputs(dev, P, K, E, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        data = torch.from_numpy(rng.integers(-2**31, 2**31, (P, K, E),
                                             dtype=np.int64).astype(np.int32))
    else:
        data = torch.from_numpy(rng.standard_normal((P, K, E)).astype(
            np.float32)).to(getattr(torch, dtype))
    ts = torch.from_numpy(rng.integers(0, 9000, (P, K)).astype(np.int32))
    return data.to(dev), ts.to(dev), rng


@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("K", [1, 2, 8, 33])
@pytest.mark.parametrize("E", [1, 3, 32, 640, 1024])
def test_gather_kernels_equal_plain(dev, dtype, K, E):
    """Both gather kernels == their plain versions, bitwise, for every
    element size, slot count (K = 33 loops past one warp) and row width
    (E = 1 and 3 give rows that are not 16-byte multiples)."""
    from repro_torch.kernels.rss_gather import kernel as RK
    from repro_torch.kernels.rss_gather import ref as RR
    from repro_torch.kernels.version_gather import kernel as VK
    from repro_torch.kernels.version_gather import ref as VR

    data, ts, rng = _gather_inputs(dev, 301, K, E, dtype, seed=K * E)
    for M in (0, 7, 4096):
        mem = torch.from_numpy(np.sort(rng.choice(
            np.arange(4001, 9000), M, replace=False)).astype(np.int32)).to(dev)
        for floor in (0, 4000):
            assert torch.equal(RK.rss_gather(data, ts, mem, floor),
                               RR.rss_gather_ref(data, ts, mem, floor))
    for wm in (0, 4000, 9000):
        assert torch.equal(VK.version_gather(data, ts, wm),
                           VR.version_gather_ref(data, ts, wm))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gather_kernels_on_unaligned_rows(dev, offset):
    """A contiguous store that starts `offset` elements into its storage:
    row addresses are not 16-byte aligned, so the copy takes the narrow
    path."""
    from repro_torch.kernels.rss_gather import kernel as RK
    from repro_torch.kernels.rss_gather import ref as RR
    from repro_torch.kernels.version_gather import kernel as VK
    from repro_torch.kernels.version_gather import ref as VR

    P, K, E = 97, 3, 40
    flat, ts, _ = _gather_inputs(dev, 1, 1, P * K * E + offset, "bfloat16")
    data = flat.view(-1)[offset:].view(P, K, E)
    ts = ts.new_tensor(np.random.default_rng(offset).integers(
        0, 50, (P, K)).astype(np.int32))
    mem = torch.tensor([31, 40, 47], dtype=torch.int32, device=dev)
    assert data.is_contiguous() and data.data_ptr() % 16
    assert torch.equal(RK.rss_gather(data, ts, mem, 20),
                       RR.rss_gather_ref(data, ts, mem, 20))
    assert torch.equal(VK.version_gather(data, ts, 33),
                       VR.version_gather_ref(data, ts, 33))


def test_gather_kernels_copy_bits_and_empty_shapes(dev):
    """NaN in an unselected slot and a selected -0.0 come through bit for
    bit; P = 0 and E = 0 return empty outputs without a launch."""
    from repro_torch.kernels.rss_gather import kernel as RK
    from repro_torch.kernels.version_gather import kernel as VK

    data = torch.ones((64, 3, 17), device=dev)
    data[:, 1] = float("nan")
    data[:, 0, 0] = -0.0
    ts = torch.zeros((64, 3), dtype=torch.int32, device=dev)
    ts[:, 1:] = 50
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    for out in (VK.version_gather(data, ts, 10),
                RK.rss_gather(data, ts, empty, 0)):
        assert torch.equal(out.view(torch.int32),
                           data[:, 0].contiguous().view(torch.int32))
    RK.reset_launches(), VK.reset_launches()
    assert RK.rss_gather(data[:0], ts[:0], empty).shape == (0, 17)
    assert VK.version_gather(data[:, :, :0].contiguous(), ts, 5).shape \
        == (64, 0)
    assert launch_count(RK.rss_gather) == \
        launch_count(VK.version_gather) == 0


def test_gather_wrappers_reject_bad_inputs_and_count_launches(dev):
    from repro_torch.kernels.rss_gather import kernel as RK
    from repro_torch.kernels.version_gather import kernel as VK

    data, ts, _ = _gather_inputs(dev, 64, 4, 16, "float32")
    mem = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    RK.reset_launches(), VK.reset_launches()
    RK.rss_gather(data, ts, mem, 0)
    VK.version_gather(data, ts, 100)
    assert launch_count(RK.rss_gather) == \
        launch_count(VK.version_gather) == 1
    with pytest.raises(ValueError):          # sliced, non-contiguous
        RK.rss_gather(data[:, :, ::2], ts, mem, 0)
    with pytest.raises(ValueError):
        VK.version_gather(data, ts[:, ::2], 0)
    with pytest.raises(ValueError):          # member_ts on the wrong device
        RK.rss_gather(data, ts, mem.cpu(), 0)
    with pytest.raises(TypeError):
        RK.rss_gather(data, ts, mem.long(), 0)
    with pytest.raises(ValueError):
        VK.version_gather(data, ts[:-1], 0)
    with pytest.raises(OverflowError):
        VK.version_gather(data, ts, 2**31)
    assert launch_count(RK.rss_gather) == \
        launch_count(VK.version_gather) == 1


@pytest.mark.parametrize("route", ["tile", "warp"])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
@pytest.mark.parametrize("K, E", [(1, 8), (3, 64), (8, 32), (8, 128),
                                  (4, 256), (2, 1024), (8, 512)])
def test_gather_every_route_equals_plain(dev, route, dtype, K, E):
    """Each route, forced, == plain bitwise wherever it takes the store
    (P = 1,003 pages: a last tile that ends part way, at most one tile a
    warp; `test_gather_routes_over_several_tiles_a_warp` takes the walk
    further), and refused where it does not (the tile route above
    512-byte rows)."""
    from repro_torch.kernels.rss_gather import kernel as RK
    from repro_torch.kernels.rss_gather import ref as RR
    from repro_torch.kernels.version_gather import kernel as VK
    from repro_torch.kernels.version_gather import ref as VR

    data, ts, rng = _gather_inputs(dev, 1003, K, E, dtype, seed=K + E)
    mem = torch.from_numpy(np.sort(rng.choice(
        np.arange(4001, 9000), 64, replace=False)).astype(np.int32)).to(dev)
    RK.reset_launches(), VK.reset_launches()
    if route not in RK.routes_for(K, E * data.element_size(), True):
        assert E * data.element_size() > 512
        with pytest.raises(ValueError):
            RK.rss_gather(data, ts, mem, 0, route=route)
        with pytest.raises(ValueError):
            VK.version_gather(data, ts, 0, route=route)
        assert launch_count(RK.rss_gather) == \
            launch_count(VK.version_gather) == 0
        return
    for floor in (0, 4000):
        assert torch.equal(RK.rss_gather(data, ts, mem, floor, route=route),
                           RR.rss_gather_ref(data, ts, mem, floor))
        assert RK.rss_gather.last_route.route == route
    for wm in (0, 4000, 9000):
        assert torch.equal(VK.version_gather(data, ts, wm, route=route),
                           VR.version_gather_ref(data, ts, wm))
        assert VK.version_gather.last_route.route == route
    assert RK.rss_gather.route_launches[route] == 2
    assert VK.version_gather.route_launches[route] == 3


@pytest.mark.parametrize("route", ["tile", "warp"])
@pytest.mark.parametrize("K, E", [(3, 32), (8, 32), (3, 128), (8, 128)])
def test_gather_routes_over_several_tiles_a_warp(dev, route, K, E):
    """Over two rounds of the tile route's persistent grid and 17 pages
    more (int32 rows of 128 and 512 bytes: 32 and 8 pages a tile), so
    each warp walks three tiles or more, the next tile's timestamps
    loaded under the copy; K 3 loads them one by one, K 8 as vectors;
    the last tile ends part way.  Each route, forced, == plain."""
    from repro_torch.kernels.rss_gather import kernel as RK
    from repro_torch.kernels.rss_gather import ref as RR
    from repro_torch.kernels.version_gather import kernel as VK
    from repro_torch.kernels.version_gather import ref as VR

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P = 2 * RK.TILE_BLOCKS_PER_SM * sms * (RK.THREADS // 32) * 32 + 17
    g = torch.Generator(device=dev)
    g.manual_seed(K * E)
    data = torch.randint(-2**31, 2**31 - 1, (P, K, E), generator=g,
                         device=dev, dtype=torch.int32)
    ts = torch.randint(0, 9000, (P, K), generator=g, device=dev,
                       dtype=torch.int32)
    mem = torch.arange(4001, 9000, 7, dtype=torch.int32, device=dev)
    launch = RK.plan(P, K, E * 4, True, route=route, sms=sms)
    if route == "tile":
        tiles = -(-P // launch.pages_per_warp)
        assert tiles > 2 * launch.grid[0] * launch.block // 32
    RK.reset_launches(), VK.reset_launches()
    for floor in (0, 4000):
        assert torch.equal(RK.rss_gather(data, ts, mem, floor, route=route),
                           RR.rss_gather_ref(data, ts, mem, floor))
        assert RK.rss_gather.last_route == launch
    for wm in (0, 4000):
        assert torch.equal(VK.version_gather(data, ts, wm, route=route),
                           VR.version_gather_ref(data, ts, wm))
        assert VK.version_gather.last_route == launch
    assert RK.rss_gather.route_launches[route] == 2
    assert VK.version_gather.route_launches[route] == 2


# member sets for each staging: (label, members, the tile route's staging;
# the warp route searches device memory for every set)
_DUPS = [0, 5, 4000, 4001, 4001, 4500, 4500, 8999]


@pytest.mark.parametrize("route", ["tile", "warp"])
@pytest.mark.parametrize("label, members, staging", [
    ("bitmap, duplicates, at or below the floor", _DUPS, "bitmap"),
    ("span over the bitmap", _DUPS + [10**7], "array"),
    ("span overflows int32", [-2**31, -7] + _DUPS + [2**31 - 1] * 3,
     "array"),
    ("M over the array", list(range(4001, 9000, 2))
     + list(range(10**6, 10**6 + 9000)), "global"),
])
def test_gather_member_stagings_equal_plain(dev, route, label, members,
                                            staging):
    """The staging is the one gather.cu's rule reports
    (`member_staging`)."""
    from repro_torch.kernels.rss_gather import kernel as RK
    from repro_torch.kernels.rss_gather import ref as RR

    mem_np = np.sort(np.array(members, np.int64)).astype(np.int32)
    assert RK.member_staging(mem_np.size, int(mem_np[0]),
                             int(mem_np[-1])) == staging
    data, ts, _ = _gather_inputs(dev, 2000, 4, 32, "int32", seed=5)
    mem = torch.from_numpy(mem_np).to(dev)
    for floor in (0, 4000):
        assert torch.equal(RK.rss_gather(data, ts, mem, floor, route=route),
                           RR.rss_gather_ref(data, ts, mem, floor)), label


@pytest.mark.parametrize("m, lo, hi, want", [
    (0, 0, 0, "none"),
    (64, 6001, 11_999, "bitmap"),
    (3, 5, 5, "bitmap"),                        # duplicates: span 1
    (2, 0, lambda bits, cap: bits - 1, "bitmap"),   # span at the cap
    (2, 0, lambda bits, cap: bits, "array"),        # one over it
    (lambda bits, cap: cap, 0, 10**7, "array"),
    (lambda bits, cap: cap + 1, 0, 10**7, "global"),
    (5, -2**31, 2**31 - 1, "array"),            # span overflows int32
    (10**5, -2**31, 2**31 - 1, "global"),
])
def test_member_staging_rule(dev, m, lo, hi, want):
    """gather.cu's staging rule, as its host export reports it, at and
    across its caps (which it reports too)."""
    from repro_torch.kernels.rss_gather import kernel as RK

    bits, cap = RK.staging_caps()
    assert (bits, cap) == (1 << 18, 1 << 13)
    m, hi = (x(bits, cap) if callable(x) else x for x in (m, hi))
    assert RK.member_staging(m, lo, hi) == want


def test_gather_entries_refuse_a_launch_plan_did_not_give(dev):
    """The C entries check the grid, block and pages a warp against their
    own copy of `plan`, and a route against the store: 9 is
    cudaErrorInvalidConfiguration, 1 cudaErrorInvalidValue."""
    from repro_torch.kernels.cuda_build import stream
    from repro_torch.kernels.rss_gather import kernel as RK

    data, ts, _ = _gather_inputs(dev, 5000, 8, 32, "int32")
    out = torch.empty((5000, 32), dtype=torch.int32, device=dev)
    mem = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    lib = RK.gather_lib()

    def vg(route, grid, block, ppw):
        return lib.vg_version_gather(data.data_ptr(), ts.data_ptr(), 5000,
                                     8, 128, 100, out.data_ptr(),
                                     RK.ROUTE_CODES[route], grid, block,
                                     ppw, stream())

    def rss(route, grid, block, ppw):
        return lib.vg_rss_gather(data.data_ptr(), ts.data_ptr(),
                                 mem.data_ptr(), 2, 5000, 8, 128, 0,
                                 out.data_ptr(), RK.ROUTE_CODES[route],
                                 grid, block, ppw, stream())

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for entry in (vg, rss):
        for route in RK.ROUTES:
            launch = RK.plan(5000, 8, 128, True, route=route, sms=sms)
            g, b, p = launch.grid[0], launch.block, launch.pages_per_warp
            assert entry(route, g, b, p) == 0
            assert entry(route, g + 1, b, p) == 9
            assert entry(route, g, b * 2, p) == 9
            assert entry(route, g, b, p + 1) == 9
        torch.cuda.synchronize()
        # the warp route's shape, asked of the tile route, and a store the
        # tile route does not take (rows off 16 bytes)
        warp = RK.plan(5000, 8, 128, True, route="warp", sms=sms)
        assert entry("tile", warp.grid[0], warp.block, 1) == 9
        data_off = data.view(-1)[1:]
        assert lib.vg_version_gather(
            data_off.data_ptr(), ts.data_ptr(), 4999, 8, 128, 100,
            out.data_ptr(), 0, 1, 256, 32, stream()) == 1
    torch.cuda.synchronize()


# --------------------------------------------------------- attention kernels
ATTN_DTYPES = ["bfloat16", "float16", "float32"]
# kernel vs plain on the card: f32 to summation order (TF32 off); bf16 and
# f16 to one rounding of the output in the working type
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 1e-2}


@pytest.fixture
def no_tf32(dev):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield dev
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _attn_close(got, want, dtype):
    tol = ATTN_TOL[dtype]
    assert got.dtype == want.dtype == getattr(torch, dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _attn_close_spread(got, want, dtype):
    """`_attn_close`, and every element within tol of the output's
    max-abs: an output averaged over many keys (T = 1,500, unit-normal
    q, k, v) lies well under 1, where atol = tol would be as large as a
    value."""
    _attn_close(got, want, dtype)
    err = (got.float() - want.float()).abs().max()
    assert err <= ATTN_TOL[dtype] * want.float().abs().max(), err.item()


def _randn(dev, shape, dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(getattr(torch,
                                                                  dtype))


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_kernel_equals_plain(no_tf32, dtype, G, hd):
    """Every mask (causal or not, window 0 or 64) at S = T = 256, ragged
    S = T = 130 and ragged S != T; model layout through strides too."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.flash_attention.ops import attention_bshd

    dev, K = no_tf32, 2
    for S, T in ((256, 256), (130, 130), (70, 201), (201, 70)):
        q = _randn(dev, (2, K * G, S, hd), dtype, S + hd)
        k = _randn(dev, (2, K, T, hd), dtype, T + 1)
        v = _randn(dev, (2, K, T, hd), dtype, T + 2)
        for causal, window in ((True, 0), (True, 64), (False, 0),
                               (False, 64)):
            if S > T and window:
                continue      # rows past T + window see no key: no contract
            want = FR.attention_ref(q, k, v, causal=causal, window=window)
            got = FK.flash_attention(q, k, v, causal=causal, window=window)
            _attn_close(got, want, dtype)
        qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        got = attention_bshd(qm, km, vm, causal=True)
        assert got.is_contiguous()           # back in the model's layout
        _attn_close(got.transpose(1, 2), FR.attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_decode_kernel_equals_plain(no_tf32, dtype, G, hd):
    """valid_len edges (1, 2, one short of a 4-row step, T - 1, T) at the
    serving cache length T = 1,088 and a ragged T = 100, over a
    [B, T, K, hd] cache read through a transposed view."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.decode_attention.ops import decode_gqa

    dev, K = no_tf32, 2
    for T in (1088, 100):
        q = _randn(dev, (3, K * G, hd), dtype, T)
        kc = _randn(dev, (3, T, K, hd), dtype, T + 1)
        vc = _randn(dev, (3, T, K, hd), dtype, T + 2)
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        for vl in (1, 2, 3, 7, T // 2, T - 1, T):
            want = DR.decode_attention_ref(q, k, v, vl)
            _attn_close(decode_gqa(q, k, v, vl), want, dtype)
            _attn_close(DK.decode_attention(q, k.contiguous(), v.contiguous(),
                                            vl), want, dtype)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("S", [4, 77])
def test_flash_cross_attention_equals_plain(no_tf32, dtype, S):
    """Whisper's cross-attention prefill: S query rows (less than one
    64-row tile, and one ragged tile past it) non-causal over T = 1,500
    keys (ragged against the key tiles), H = K = 6, hd 64, in the
    model's layout (the cross cache [B, T, K, hd] read through
    strides)."""
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.flash_attention.ops import attention_bshd

    dev, T = no_tf32, 1500
    q = _randn(dev, (4, S, 6, 64), dtype, S)
    k = _randn(dev, (4, T, 6, 64), dtype, S + 1)
    v = _randn(dev, (4, T, 6, 64), dtype, S + 2)
    got = attention_bshd(q, k, v, causal=False)
    want = FR.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False)
    _attn_close_spread(got.transpose(1, 2), want, dtype)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
def test_decode_over_the_cross_cache_equals_plain(no_tf32, dtype):
    """Whisper's cross-attention decode: B 32 over the immutable cache of
    T = valid_len = 1,500 slots (not a multiple of a block), G 1, hd 64,
    unsplit (B 32 x K 6 = 192 blocks), and at shorter valid lengths."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.decode_attention.ops import decode_gqa

    dev, T = no_tf32, 1500
    q = _randn(dev, (32, 6, 64), dtype, 7)
    kc = _randn(dev, (32, T, 6, 64), dtype, 8)
    vc = _randn(dev, (32, T, 6, 64), dtype, 9)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    for vl in (T, T - 1, 1, 750):
        _attn_close_spread(decode_gqa(q, k, v, vl),
                           DR.decode_attention_ref(q, k, v, vl), dtype)
        assert DK.decode_attention.last_split == 1


def test_attention_kernels_on_large_gqa_and_sliced_heads(no_tf32):
    """G = 48 (MQA, several decode blocks per kv-head) and q given as a
    slice of a wider head axis (strides that are not a plain layout)."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    dev = no_tf32
    q = _randn(dev, (2, 48, 300), "bfloat16", 1)[..., :128]
    k = _randn(dev, (2, 1, 300, 128), "bfloat16", 2)
    v = _randn(dev, (2, 1, 300, 128), "bfloat16", 3)
    for vl in (1, 150, 300):
        _attn_close(DK.decode_attention(q, k, v, vl),
                    DR.decode_attention_ref(q, k, v, vl), "bfloat16")
    wide = _randn(dev, (2, 96, 200, 64), "float32", 4)
    qs = wide[:, 10:58]                      # 48 heads out of 96
    ks, vs = (_randn(dev, (2, 6, 200, 64), "float32", s) for s in (5, 6))
    _attn_close(FK.flash_attention(qs, ks, vs, causal=True, window=32),
                FR.attention_ref(qs, ks, vs, causal=True, window=32),
                "float32")


def test_attention_wrappers_reject_bad_inputs_and_count_launches(dev):
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK

    q = _randn(dev, (2, 4, 64, 64), "bfloat16", 0)
    k = _randn(dev, (2, 2, 64, 64), "bfloat16", 1)
    FK.reset_launches(), DK.reset_launches()
    FK.flash_attention(q, k, k)
    DK.decode_attention(q[:, :, 0], k, k, 64)
    assert FK.flash_attention.launches == DK.decode_attention.launches == 1
    with pytest.raises(ValueError):              # k on the wrong device
        FK.flash_attention(q, k.cpu(), k)
    with pytest.raises(TypeError):               # dtypes differ
        FK.flash_attention(q, k.float(), k.float())
    with pytest.raises(TypeError):               # no float64 kernel
        FK.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):              # rank
        FK.flash_attention(q[0], k, k)
    with pytest.raises(ValueError):              # head dim not contiguous
        FK.flash_attention(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError):              # head dim 48
        FK.flash_attention(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(ValueError):              # H % K != 0
        FK.flash_attention(q[:, :3], k, k)
    with pytest.raises(ValueError):
        FK.flash_attention(q, k, k, window=-1)
    for vl in (0, 65):
        with pytest.raises(ValueError):          # valid_len outside [1, T]
            DK.decode_attention(q[:, :, 0], k, k, vl)
    flat = _randn(dev, (2 * 2 * 64 * 64 + 1,), "bfloat16", 2)
    unaligned = flat[1:].view(2, 2, 64, 64)
    with pytest.raises(ValueError):              # cache not on 16 bytes
        DK.decode_attention(q[:, :, 0], unaligned, k, 64)
    assert FK.flash_attention.launches == DK.decode_attention.launches == 1


@pytest.mark.parametrize("H,K,hd", [(16, 16, 64), (64, 8, 128)],
                         ids=["qwen", "jamba"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_kernel_at_serve_shapes(no_tf32, H, K, hd, dtype):
    """The tensor-core route at the serve paths' prefill heads (Qwen
    H = K = 16, hd 64; Jamba H 64, K 8, hd 128), S = T = 1,024, causal,
    in the model's layout, against `attention_ref`."""
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.flash_attention.ops import attention_bshd

    dev = no_tf32
    q = _randn(dev, (2, 1024, H, hd), dtype, H)
    k = _randn(dev, (2, 1024, K, hd), dtype, H + 1)
    v = _randn(dev, (2, 1024, K, hd), dtype, H + 2)
    got = attention_bshd(q, k, v, causal=True)
    want = FR.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2)).transpose(1, 2)
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("window", [20, 40, 100])
def test_flash_kernel_tiles_across_diagonal_and_window_edge(no_tf32, hd,
                                                            window):
    """Windows narrower than, near and wider than a 64-row tile: query
    tiles whose KV tiles cross the diagonal and a window edge at once,
    tiles a warp sees nothing of, ragged S = T = 300; causal and not."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    dev = no_tf32
    q = _randn(dev, (2, 4, 300, hd), "bfloat16", window)
    k = _randn(dev, (2, 2, 300, hd), "bfloat16", window + 1)
    v = _randn(dev, (2, 2, 300, hd), "bfloat16", window + 2)
    for causal in (True, False):
        _attn_close(FK.flash_attention(q, k, v, causal=causal, window=window),
                    FR.attention_ref(q, k, v, causal=causal, window=window),
                    "bfloat16")


def test_flash_kernel_refuses_rows_off_16_bytes(dev):
    """bf16 / f16 rows move in 16-byte pieces: a q whose row stride (68
    elements, 136 bytes) or start is off 16 bytes raises, as does k; f32
    takes any strides."""
    from repro_torch.kernels.flash_attention import kernel as FK

    k = _randn(dev, (1, 2, 64, 64), "bfloat16", 1)
    wide = _randn(dev, (1, 2, 64, 68), "bfloat16", 0)
    FK.reset_launches()
    with pytest.raises(ValueError, match="16 bytes"):
        FK.flash_attention(wide[..., :64], k, k)
    flat = _randn(dev, (2 * 64 * 64 + 1,), "bfloat16", 2)
    with pytest.raises(ValueError, match="16 bytes"):
        FK.flash_attention(flat[1:].view(1, 2, 64, 64), k, k)
    with pytest.raises(ValueError, match="16 bytes"):
        FK.flash_attention(k, flat[1:].view(1, 2, 64, 64), k)
    assert FK.flash_attention.launches == 0
    FK.flash_attention(wide.float()[..., :64], k.float(), k.float())
    assert FK.flash_attention.launches == 1


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
def test_decode_kernel_at_each_split(no_tf32, n_split):
    """Every split, forced, at valid_len on a range boundary (a multiple
    of the split) and one either side, below the split (empty ranges)
    and at T; one launch per call; two calls bitwise equal (the merge
    order is fixed)."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR

    dev = no_tf32
    for G, hd in ((1, 64), (8, 128)):
        q = _randn(dev, (2, 2 * G, hd), "bfloat16", G)
        kc, vc = (_randn(dev, (2, 1088, 2, hd), "bfloat16", G + s)
                  for s in (1, 2))
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        for vl in (1, 7, 8 * 68 - 1, 8 * 68, 8 * 68 + 1, 1088):
            DK.reset_launches()
            got = DK.run_decode(q, k, v, vl, n_split)
            again = DK.run_decode(q, k, v, vl, n_split)
            assert DK.decode_attention.launches == 2
            assert DK.decode_attention.split_launches == 2 * (n_split > 1)
            assert DK.decode_attention.last_split == n_split
            assert torch.equal(got, again)
            _attn_close(got, DR.decode_attention_ref(q, k, v, vl),
                        "bfloat16")


def test_decode_kernel_f32_never_splits(no_tf32):
    """f32 runs unsplit whatever the grid (one sequence of 8,192 slots,
    which splits in bf16) and refuses a forced split before launching."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR

    dev = no_tf32
    q = _randn(dev, (1, 16, 64), "float32", 0)
    kc, vc = (_randn(dev, (1, 8192, 16, 64), "float32", s) for s in (1, 2))
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    DK.reset_launches()
    _attn_close(DK.decode_attention(q, k, v, 8192),
                DR.decode_attention_ref(q, k, v, 8192), "float32")
    assert DK.decode_attention.last_split == 1
    assert DK.decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                               8192) is not None
    assert DK.decode_attention.last_split > 1
    with pytest.raises(ValueError, match="n_split"):
        DK.run_decode(q, k, v, 8192, 2)
    assert DK.decode_attention.launches == 2


def test_decode_kernel_where_the_split_changes(no_tf32):
    """valid_len either side of each threshold of `decode_splits` (M =
    SPLIT_MIN_ROWS) at one sequence of the serve shapes (B 1: Qwen's 16
    blocks, Jamba's 8), unforced, over a cache of 8·M slots."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR

    dev, M = no_tf32, DK.SPLIT_MIN_ROWS
    for K, G, hd, splits in ((16, 1, 64, {2 * M - 1: 1, 2 * M: 2,
                                          4 * M - 1: 2, 4 * M: 4,
                                          8 * M - 1: 4, 8 * M: 8}),
                             (8, 8, 128, {2 * M - 1: 1, 2 * M: 2,
                                          4 * M: 4, 8 * M - 1: 4,
                                          8 * M: 8})):
        q = _randn(dev, (1, K * G, hd), "bfloat16", K)
        kc, vc = (_randn(dev, (1, 8 * M, K, hd), "bfloat16", K + s)
                  for s in (1, 2))
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        for vl, n in splits.items():
            assert DK.decode_splits(vl, K) == n
            _attn_close(DK.decode_attention(q, k, v, vl),
                        DR.decode_attention_ref(q, k, v, vl), "bfloat16")


def test_qwen_smoke_kernel_path_equals_plain_path(no_tf32, monkeypatch):
    """The Qwen1.5-0.5B smoke variant (bf16) on the card: prefill and
    decode through the kernels against the same run with the layers'
    attention on the plain versions; logits within 3e-2 of their
    max-abs; one flash launch per layer per prefill, one decode launch
    per layer per step."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import layers

    dev = no_tf32
    cfg = smoke_variant(get_config("qwen1.5-0.5b"))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 100))).to(dev)

    def run():
        out = []
        logits, cache = prefill(params, cfg, {"tokens": toks[:, :90]},
                                cache_len=100)
        out.append(logits)
        for n in range(90, 99):
            logits, cache = decode_step(params, cfg, toks[:, n:n + 1],
                                        cache, n)
            out.append(logits)
        return torch.stack(out).float()

    FK.reset_launches(), DK.reset_launches()
    got = run()
    assert FK.flash_attention.launches == cfg.n_layers
    assert DK.decode_attention.launches == cfg.n_layers * 9
    monkeypatch.setattr(layers, "attention_bshd",
                        lambda q, k, v, *, causal, window:
                        layers.flash_attention_chunked(
                            q, k, v, causal=causal, window=window))
    monkeypatch.setattr(layers, "decode_gqa", decode_attention_ref)
    want = run()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()


# --------------------------------------------------------------- wkv_scan
# kernel vs plain on the card: both widen the inputs to f32 and run the
# recurrence in f32, in other summation orders; the reference's own
# tolerance for its kernel (tests/test_kernels.py)
WKV_TOL = 1e-4


def _wkv_inputs(dev, B, T, H, N, dtype, seed):
    """r, k, v, w_log [B,T,H,N] in `dtype` and u [H,N] f32 on `dev`, at
    the reference test's scales, from a numpy seed."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, tdt)
    r, k = (put(0.5 * rng.standard_normal((B, T, H, N))) for _ in range(2))
    v = put(rng.standard_normal((B, T, H, N)))
    w_log = put(-np.exp(rng.standard_normal((B, T, H, N)) - 2))
    u = put(0.1 * rng.standard_normal((H, N))).float()
    return r, k, v, w_log, u


def _wkv_plain(r, k, v, w_log, u, s0=None):
    """The plain version on the card, in the model's layout."""
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_plain

    B, T, H, N = r.shape
    o, S = wkv_scan_plain(*(x.transpose(1, 2) for x in (r, k, v, w_log)),
                          u[None].expand(B, H, N), s0)
    return o.transpose(1, 2), S


def _wkv_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=WKV_TOL, atol=WKV_TOL)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("T", [1, 16, 37, 200])
def test_wkv_kernel_equals_plain(no_tf32, dtype, N, T):
    """Ragged T (not a multiple of the 16-step chunk), T = 1, both head
    sizes, every input dtype, from a zero state and from a given s0."""
    from repro_torch.kernels.wkv_scan.ops import wkv

    dev = no_tf32
    r, k, v, w_log, u = _wkv_inputs(dev, 3, T, 5, N, dtype, T + N)
    _wkv_close(wkv(r, k, v, w_log, u), _wkv_plain(r, k, v, w_log, u))
    s0 = torch.randn((3, 5, N, N), generator=torch.Generator(
        device=dev).manual_seed(T), device=dev)
    _wkv_close(wkv(r, k, v, w_log, u, s0), _wkv_plain(r, k, v, w_log, u, s0))


def _off_16b(x):
    """The same values one element into a fresh buffer: a tensor that
    does not start on 16 bytes."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def test_wkv_routes_at_the_serve_shapes(no_tf32):
    """RWKV6-3B's prefill (B 8, T 1,024, H 40, N 64, f32) takes the
    chunked route, a block of 128 threads a head, staged by cp.async; one
    decode token from its state, in place, the step route (a block of
    512 a head, the state in float4s); both equal the plain version."""
    from repro_torch.kernels.cuda_build import Launch
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ops import wkv

    dev = no_tf32
    x = _wkv_inputs(dev, 8, 1024, 40, 64, "float32", 11)
    got = wkv(*x)
    assert WK.wkv_scan.last_route == Launch("chunked", (320,), 128, True)
    _wkv_close(got, _wkv_plain(*x))
    state = got[1]
    step = _wkv_inputs(dev, 8, 1, 40, 64, "float32", 12)
    want = _wkv_plain(*step, state.clone())
    o, S = wkv(*step, state, state_out=state)
    assert S is state
    assert WK.wkv_scan.last_route == Launch("step", (320,), 512, True)
    _wkv_close((o, state), want)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("T", [1, 20])
def test_wkv_kernel_on_operands_off_16_bytes(no_tf32, dtype, T):
    """r, k, v, w_log and a state (s0 is state_out) that do not start on
    16 bytes: the chunked route stages by element loads, the step route
    moves the state element by element; both equal the plain version."""
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ops import wkv

    dev = no_tf32
    r, k, v, w_log, u = _wkv_inputs(dev, 2, T, 3, 64, dtype, 5 + T)
    state = _off_16b(torch.randn((2, 3, 64, 64), generator=torch.Generator(
        device=dev).manual_seed(T), device=dev))
    want = _wkv_plain(r, k, v, w_log, u, state.clone())
    o, S = wkv(*(_off_16b(x) for x in (r, k, v, w_log)), u, state,
               state_out=state)
    assert S is state
    assert WK.wkv_scan.last_route.route == ("step" if T == 1 else "chunked")
    assert WK.wkv_scan.last_route.vector is False
    _wkv_close((o, state), want)


def test_wkv_kernel_reads_strided_views_and_updates_state_in_place(no_tf32):
    """Slices of a wider head axis and a state that is both s0 and
    state_out: three one-token steps and a 40-step scan from it equal
    the plain version's sequence; the buffer is the one written."""
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ops import wkv

    dev = no_tf32
    r, k, v, w_log, u = _wkv_inputs(dev, 2, 43, 9, 64, "float32", 1)
    r, k, v, w_log = (x[:, :, 2:7] for x in (r, k, v, w_log))
    u = u[2:7]
    assert not r.is_contiguous()
    state = torch.zeros((2, 5, 64, 64), device=dev)
    want_S = state.clone()
    WK.reset_launches()
    for t in range(3):
        sl = [x[:, t:t + 1] for x in (r, k, v, w_log)]
        o, S = wkv(*sl, u, state, state_out=state)
        want_o, want_S = _wkv_plain(*sl, u, want_S)
        assert S is state
        _wkv_close((o, state), (want_o, want_S))
    sl = [x[:, 3:] for x in (r, k, v, w_log)]
    o, _ = wkv(*sl, u, state, state_out=state)
    _wkv_close((o, state), _wkv_plain(*sl, u, want_S))
    assert WK.wkv_scan.route_launches == {"chunked": 1, "step": 3}


@pytest.mark.parametrize("N", [32, 64])
def test_wkv_chunked_route_takes_one_token_in_place(no_tf32, N):
    """The chunked route forced at T = 1 (the comparison chip_smoke.py
    times against the step route), s0 is state_out: equals the plain
    version and counts as a chunked launch."""
    from repro_torch.kernels.wkv_scan import kernel as WK

    dev = no_tf32
    r, k, v, w_log, u = (x.transpose(1, 2) if x.dim() == 4 else x
                         for x in _wkv_inputs(dev, 8, 1, 5, N, "float32", 3))
    ub = u[None].expand(8, 5, N)
    state = torch.randn((8, 5, N, N), generator=torch.Generator(
        device=dev).manual_seed(N), device=dev)
    want = _wkv_plain(*(x.transpose(1, 2) for x in (r, k, v, w_log)), u,
                      state.clone())
    WK.reset_launches()
    o, S = WK.wkv_scan(r, k, v, w_log, ub, state, state_out=state,
                       route="chunked")
    assert S is state and WK.wkv_scan.last_route.route == "chunked"
    assert WK.wkv_scan.route_launches == {"chunked": 1, "step": 0}
    _wkv_close((o.transpose(1, 2), state), want)
    with pytest.raises(ValueError, match="route"):
        WK.wkv_scan(*(torch.cat([x, x], 2) for x in (r, k, v, w_log)), ub,
                    route="step")


@pytest.mark.parametrize("scan", ["wkv", "ssm"])
@pytest.mark.parametrize("route", ["chunked", "step"])
def test_scan_entry_rejects_a_launch_not_its_routes(dev, monkeypatch, scan,
                                                    route):
    """A grid or block that is not the route's never launches: the C
    entry checks both and the wrapper raises."""
    from repro_torch.kernels.cuda_build import Launch
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.wkv_scan import kernel as WK

    T = 1 if route == "step" else 8
    if scan == "wkv":
        mod = WK
        x = [t.transpose(1, 2) if t.dim() == 4 else t
             for t in _wkv_inputs(dev, 2, T, 3, 64, "float32", 0)]
        args = (*x[:4], x[4][None].expand(2, 3, 64))
        call = lambda: WK.wkv_scan(*args)
    else:
        mod = SK
        args = _ssm_inputs(dev, 2, T, 300, 16, "float32", 0)
        call = lambda: SK.ssm_scan(*args)
    good = mod.plan

    def wider(*a) -> Launch:
        launch = good(*a)
        return launch._replace(grid=(launch.grid[0] + 1, *launch.grid[1:]))

    def bigger(*a) -> Launch:
        launch = good(*a)
        return launch._replace(block=launch.block * 2)

    for bad in (wider, bigger):
        monkeypatch.setattr(mod, "plan", bad)
        mod.reset_launches()
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
        assert launch_count(getattr(mod, f"{scan}_scan")) == 0


def test_wkv_wrapper_rejects_bad_inputs_and_counts_launches(dev):
    from repro_torch.kernels.wkv_scan import kernel as WK

    r, k, v, w_log, u = (x.transpose(1, 2) if x.dim() == 4 else x
                         for x in _wkv_inputs(dev, 2, 8, 3, 64, "float32", 0))
    ub = u[None].expand(2, 3, 64)
    WK.reset_launches()
    WK.wkv_scan(r, k, v, w_log, ub)
    assert launch_count(WK.wkv_scan) == 1
    for n in (16, 48, 128):                      # head size not 32 or 64
        x = torch.zeros((2, 3, 8, n), device=dev)
        with pytest.raises(ValueError, match="head size"):
            WK.wkv_scan(x, x, x, x, torch.zeros((2, 3, n), device=dev))
    with pytest.raises(TypeError):               # no float64 kernel
        WK.wkv_scan(*(x.double() for x in (r, k, v, w_log)), ub)
    with pytest.raises(TypeError):               # dtypes differ
        WK.wkv_scan(r, k.bfloat16(), v, w_log, ub)
    with pytest.raises(ValueError):              # shapes differ
        WK.wkv_scan(r, k[:, :, :4], v, w_log, ub)
    with pytest.raises(ValueError):              # N not contiguous
        WK.wkv_scan(r.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                    w_log, ub)
    with pytest.raises(ValueError):              # T = 0
        WK.wkv_scan(*(x[:, :, :0] for x in (r, k, v, w_log)), ub)
    with pytest.raises(ValueError):              # s0 not f32
        WK.wkv_scan(r, k, v, w_log, ub,
                    torch.zeros((2, 3, 64, 64), device=dev).bfloat16())
    with pytest.raises(ValueError):              # state_out on the CPU
        WK.wkv_scan(r, k, v, w_log, ub, state_out=torch.zeros((2, 3, 64, 64)))
    assert launch_count(WK.wkv_scan) == 1


def test_rwkv_smoke_kernel_path_equals_plain_path(no_tf32, monkeypatch):
    """RWKV6-3B's smoke variant (bf16) on the card: prefill and decode
    through `wkv_scan` against the same run with the layers' WKV on the
    plain version; logits within 3e-2 of their max-abs; one launch per
    layer per prefill and per decode step."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.models import decode_step, init_params, layers, prefill

    dev = no_tf32
    cfg = smoke_variant(get_config("rwkv6-3b"))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 100))).to(dev)

    def run():
        out = []
        logits, cache = prefill(params, cfg, {"tokens": toks[:, :90]},
                                cache_len=100)
        out.append(logits)
        for n in range(90, 99):
            logits, cache = decode_step(params, cfg, toks[:, n:n + 1],
                                        cache, n)
            out.append(logits)
        return torch.stack(out).float()

    WK.reset_launches()
    got = run()
    assert launch_count(WK.wkv_scan) == cfg.n_layers * 10
    monkeypatch.setattr(layers, "wkv", _wkv_plain_op)
    want = run()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()


def _wkv_plain_op(r, k, v, w_log, u, s0=None, *, state_out=None):
    """`ops.wkv` on the plain version (for swapping into the layers)."""
    o, S = _wkv_plain(r, k, v, w_log, u, s0)
    return o, S if state_out is None else state_out.copy_(S)


# --------------------------------------------------------------- ssm_scan
# kernel vs plain on the card: both run the recurrence in f32, the kernel
# with exp2f and fused multiply-adds; the reference's own tolerance for
# its kernel (tests/test_kernels.py)
SSM_TOL = 2e-4


def _ssm_inputs(dev, Bb, T, Di, N, u_dtype, seed):
    """u (in `u_dtype`), dt, B, C, A, D on `dev` at the reference test's
    scales, from a numpy seed."""
    rng = np.random.default_rng(seed)
    z = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    u = z(Bb, T, Di).to(getattr(torch, u_dtype))
    dt = torch.nn.functional.softplus(z(Bb, T, Di) - 1)
    return u, dt, z(Bb, T, N), z(Bb, T, N), -torch.exp(z(Di, N)), z(Di)


def _ssm_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=SSM_TOL, atol=SSM_TOL)


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("T,Di", [(1, 256), (16, 128), (37, 1000),
                                  (200, 384)])
def test_ssm_kernel_equals_plain(dev, u_dtype, N, T, Di):
    """Ragged T (not a multiple of the 8-step chunk), T = 1, Di not a
    multiple of the 256-channel block, both state sizes, f32 and bf16 u,
    from a zero state and from a given h0."""
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    x = _ssm_inputs(dev, 3, T, Di, N, u_dtype, T + Di + N)
    _ssm_close(selective_scan(*x), ssm_scan_ref(*x))
    h0 = torch.randn((3, Di, N), generator=torch.Generator(
        device=dev).manual_seed(T), device=dev)
    _ssm_close(selective_scan(*x, h0), ssm_scan_ref(*x, h0))


def test_ssm_kernel_at_jambas_prefill_and_decode_shapes(dev):
    """Jamba's own shapes (Bb = 8, Di = 16,384, N = 16): the 1,024-token
    prefill from a zero state with bf16 u (the chunked route, 64 x 8
    blocks of 256 staged by cp.async), then one decode step from its
    state, in place (the step route, 2,048 blocks of 256, float4 state)."""
    from repro_torch.kernels.cuda_build import Launch
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    x = _ssm_inputs(dev, 8, 1024, 16384, 16, "bfloat16", 7)
    got = selective_scan(*x)
    assert SK.ssm_scan.last_route == Launch("chunked", (64, 8), 256, True)
    _ssm_close(got, ssm_scan_ref(*x))
    state = got[1]
    step = _ssm_inputs(dev, 8, 1, 16384, 16, "bfloat16", 8)
    want = ssm_scan_ref(*step, state)
    y, h = selective_scan(*step, state, state_out=state)
    assert h is state
    assert SK.ssm_scan.last_route == Launch("step", (2048,), 256, True)
    _ssm_close((y, state), want)


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("T", [1, 20])
def test_ssm_kernel_on_operands_off_16_bytes(dev, u_dtype, N, T):
    """u, dt, B, C, A and a state (h0 is state_out) that do not start on
    16 bytes, at Di = 1,001 (a partial last block on both routes, rows of
    u and dt off 16 bytes): the chunked route stages by element loads,
    the step route moves h0, A, B, C and h element by element; both equal
    the plain version."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    u, dt, B, C, A, D = _ssm_inputs(dev, 2, T, 1001, N, u_dtype, T + N)
    state = _off_16b(torch.randn((2, 1001, N), generator=torch.Generator(
        device=dev).manual_seed(T), device=dev))
    want = ssm_scan_ref(u, dt, B, C, A, D, state.clone())
    y, h = selective_scan(*(_off_16b(x) for x in (u, dt, B, C, A)), D, state,
                          state_out=state)
    assert h is state
    assert SK.ssm_scan.last_route.route == ("step" if T == 1 else "chunked")
    assert SK.ssm_scan.last_route.vector is False
    _ssm_close((y, state), want)


def test_ssm_kernel_reads_strided_views_and_updates_state_in_place(dev):
    """B and C as slices of one wider buffer (the model's x_proj output)
    and a state that is both h0 and state_out: three one-token steps and
    a 40-step scan from it equal the plain version's sequence; the
    buffer is the one written."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    u, dt, B, C, A, D = _ssm_inputs(dev, 2, 43, 300, 16, "bfloat16", 1)
    wide = torch.cat([torch.zeros((2, 43, 5), device=dev), B, C], dim=-1)
    B, C = wide[..., 5:21], wide[..., 21:]
    assert not B.is_contiguous()
    state = torch.zeros((2, 300, 16), device=dev)
    want_h = state.clone()
    SK.reset_launches()
    for t in range(3):
        sl = [x[:, t:t + 1] for x in (u, dt, B, C)]
        y, h = selective_scan(*sl, A, D, state, state_out=state)
        want_y, want_h = ssm_scan_ref(*sl, A, D, want_h)
        assert h is state
        _ssm_close((y, state), (want_y, want_h))
    sl = [x[:, 3:] for x in (u, dt, B, C)]
    y, _ = selective_scan(*sl, A, D, state, state_out=state)
    _ssm_close((y, state), ssm_scan_ref(*sl, A, D, want_h))
    assert SK.ssm_scan.route_launches == {"chunked": 1, "step": 3}


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
def test_ssm_chunked_route_takes_one_token_in_place(dev, u_dtype):
    """The chunked route forced at T = 1 (the comparison chip_smoke.py
    times against the step route), h0 is state_out, a ragged Di: equals
    the plain version and counts as a chunked launch."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    u, dt, B, C, A, D = _ssm_inputs(dev, 8, 1, 1000, 16, u_dtype, 4)
    state = torch.randn((8, 1000, 16), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)
    want = ssm_scan_ref(u, dt, B, C, A, D, state.clone())
    SK.reset_launches()
    y, h = SK.ssm_scan(u, dt, B, C, A, D, state, state_out=state,
                       route="chunked")
    assert h is state and SK.ssm_scan.last_route.route == "chunked"
    assert SK.ssm_scan.route_launches == {"chunked": 1, "step": 0}
    _ssm_close((y, state), want)


def test_ssm_wrapper_rejects_bad_inputs_and_counts_launches(dev):
    from repro_torch.kernels.ssm_scan import kernel as SK

    u, dt, B, C, A, D = _ssm_inputs(dev, 2, 8, 64, 16, "float32", 0)
    SK.reset_launches()
    SK.ssm_scan(u, dt, B, C, A, D)
    assert launch_count(SK.ssm_scan) == 1
    for n in (4, 32):                            # state size not 8 or 16
        with pytest.raises(ValueError, match="state size"):
            SK.ssm_scan(u, dt, B[..., :1].expand(2, 8, n).contiguous(),
                        C[..., :1].expand(2, 8, n).contiguous(),
                        A[:, :1].expand(64, n).contiguous(), D)
    with pytest.raises(TypeError):               # no float64 kernel
        SK.ssm_scan(u.double(), dt, B, C, A, D)
    with pytest.raises(TypeError):               # dt must be f32
        SK.ssm_scan(u, dt.bfloat16(), B, C, A, D)
    with pytest.raises(ValueError):              # shapes differ
        SK.ssm_scan(u, dt[:, :4], B, C, A, D)
    with pytest.raises(ValueError):              # Di not contiguous
        SK.ssm_scan(u.transpose(1, 2).contiguous().transpose(1, 2), dt, B,
                    C, A, D)
    with pytest.raises(ValueError):              # T = 0
        SK.ssm_scan(u[:, :0], dt[:, :0], B[:, :0], C[:, :0], A, D)
    with pytest.raises(TypeError):               # h0 not f32
        SK.ssm_scan(u, dt, B, C, A, D,
                    torch.zeros((2, 64, 16), device=dev).bfloat16())
    with pytest.raises(ValueError):              # state_out on the CPU
        SK.ssm_scan(u, dt, B, C, A, D, state_out=torch.zeros((2, 64, 16)))
    assert launch_count(SK.ssm_scan) == 1


def test_jamba_smoke_kernel_path_equals_plain_path(no_tf32, monkeypatch):
    """Jamba-1.5-Large's smoke variant in f32 on the card: prefill and
    decode through `ssm_scan` and the attention kernels against the same
    run with the layers' selective scan and attention on their plain
    versions (the MoE routing is the same code on both paths); logits
    within 1e-3 of their max-abs; one `ssm_scan` launch per Mamba layer
    per prefill and per decode step."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import decode_step, init_params, layers, prefill

    dev = no_tf32
    cfg = smoke_variant(get_config("jamba-1.5-large-398b")).with_overrides(
        param_dtype="float32", compute_dtype="float32")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev, experts=[0, 1])
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 100))).to(dev)

    def run():
        out = []
        logits, cache = prefill(params, cfg, {"tokens": toks[:, :90]},
                                cache_len=100)
        out.append(logits)
        for n in range(90, 99):
            logits, cache = decode_step(params, cfg, toks[:, n:n + 1],
                                        cache, n)
            out.append(logits)
        return torch.stack(out)

    SK.reset_launches()
    got = run()
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.n_periods
    assert launch_count(SK.ssm_scan) == n_mamba * 10
    monkeypatch.setattr(layers, "selective_scan", ssm_scan_ref)
    monkeypatch.setattr(layers, "attention_bshd",
                        lambda q, k, v, *, causal, window:
                        layers.flash_attention_chunked(q, k, v, causal=causal,
                                                       window=window))
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    monkeypatch.setattr(layers, "decode_gqa", decode_attention_ref)
    want = run()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


# ------------------------------------------------- flash attention backward
def _bwd_close(got, want, dtype):
    """Each gradient within ATTN_TOL of its max-abs (f32 summation order;
    bf16 / f16 P and dS rounded once to the working type)."""
    tol = ATTN_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == getattr(torch, dtype)
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max() <= tol * w.abs().max()


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_bwd_kernel_equals_plain(no_tf32, dtype, G, hd):
    """Every mask (causal or not, window 0 or 64) at S = T = 256, ragged
    S = T = 130 and ragged S != T (rows past T + window see no key: lse
    -inf, no gradient); the lse the forward returns; two launches bitwise
    equal; one launch a call, on `plan_bwd`'s launch (at these small grids
    bf16 / f16 split every G > 1 into G head ranges: the partials' sum)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    dev, K = no_tf32, 2
    FK.reset_launches()
    calls = 0
    for S, T in ((256, 256), (130, 130), (70, 201), (201, 70)):
        q, do = (_randn(dev, (2, K * G, S, hd), dtype, S + hd + i)
                 for i in range(2))
        k, v = (_randn(dev, (2, K, T, hd), dtype, T + i) for i in (1, 2))
        for causal, window in ((True, 0), (True, 64), (False, 0),
                               (False, 64)):
            o, lse = FK.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
            _, want_lse = FR.attention_ref(q, k, v, causal=causal,
                                           window=window, return_lse=True)
            assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
            fin = torch.isfinite(want_lse)
            torch.testing.assert_close(lse[fin], want_lse[fin], rtol=1e-5,
                                       atol=1e-4)
            got = FK.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window)
            again = FK.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=window)
            calls += 2
            assert FK.flash_attention_bwd.last_route == FK.plan_bwd(
                2, K * G, K, S, T, hd, causal=causal, window=window,
                f32=dtype == "float32")
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            _bwd_close(got, FR.attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal, window=window), dtype)
    assert FK.flash_attention_bwd.launches == calls


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("S,T", [(1500, 1500), (448, 1500), (4, 1500)])
def test_flash_cross_and_encoder_bwd_equals_plain(no_tf32, dtype, S, T):
    """Whisper's training shapes through autograd in the model's layout:
    the encoder (S = T = 1,500, non-causal: 23 full 64-key tiles and a
    ragged one of 28) and the cross-attention (448 or 4 decoder queries
    over 1,500 frames: dQ, dK and dV all ragged against their tiles),
    H = K = 6, hd 64; each gradient within ATTN_TOL of its max-abs
    (`_bwd_close`), one forward and one backward launch on `plan_bwd`'s
    launch."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.flash_attention.ops import attention_bshd

    dev = no_tf32
    q = _randn(dev, (4, S, 6, 64), dtype, S).requires_grad_()
    k = _randn(dev, (4, T, 6, 64), dtype, S + 1).requires_grad_()
    v = _randn(dev, (4, T, 6, 64), dtype, S + 2).requires_grad_()
    do = _randn(dev, (4, S, 6, 64), dtype, S + 3)
    FK.reset_launches()
    got = torch.autograd.grad(attention_bshd(q, k, v, causal=False),
                              (q, k, v), do)
    assert FK.flash_attention.launches == FK.flash_attention_bwd.launches == 1
    assert FK.flash_attention_bwd.last_route == FK.plan_bwd(
        4, 6, 6, S, T, 64, causal=False, f32=dtype == "float32")
    qt, kt, vt = (x.detach().transpose(1, 2) for x in (q, k, v))
    o, lse = FK.flash_attention(qt, kt, vt, causal=False, return_lse=True)
    want = FR.attention_bwd_ref(qt, kt, vt, o, lse, do.transpose(1, 2),
                                causal=False)
    _bwd_close([g.transpose(1, 2) for g in got], want, dtype)


def test_flash_bwd_through_autograd_in_the_model_layout(no_tf32):
    """`attention_bshd` on CUDA tensors that require grad: the Function
    launches the forward once and the backward once; dO arrives through
    strides (a transposed view), or copied where its head dim is not
    contiguous; the gradients come back in the inputs' layout."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.flash_attention.ops import attention_bshd

    dev = no_tf32
    q = _randn(dev, (2, 200, 8, 64), "bfloat16", 1).requires_grad_()
    k = _randn(dev, (2, 200, 2, 64), "bfloat16", 2).requires_grad_()
    v = _randn(dev, (2, 200, 2, 64), "bfloat16", 3).requires_grad_()
    do = _randn(dev, (2, 200, 8, 64), "bfloat16", 4)
    o_ref, lse = FR.attention_ref(*(x.detach().transpose(1, 2)
                                    for x in (q, k, v)), causal=True,
                                  return_lse=True)
    want = FR.attention_bwd_ref(*(x.detach().transpose(1, 2)
                                  for x in (q, k, v)), o_ref, lse,
                                do.transpose(1, 2), causal=True)
    for grad in (do, do.transpose(2, 3).contiguous().transpose(2, 3)):
        FK.reset_launches()
        out = attention_bshd(q, k, v, causal=True)
        got = torch.autograd.grad(out, (q, k, v), grad)
        assert FK.flash_attention.launches == 1
        assert FK.flash_attention_bwd.launches == 1
        assert all(g.shape == x.shape and g.stride() == x.stride()
                   for g, x in zip(got, (q, k, v)))
        _bwd_close([g.transpose(1, 2) for g in got], want, "bfloat16")


def test_kernels_without_a_backward_raise_under_grad(no_tf32):
    """decode_attention has no backward kernel: with an input that
    requires grad it raises on the card instead of returning an output
    without a gradient; under no_grad it runs.  (wkv_scan and ssm_scan
    have backward kernels: `test_*_scan_bwd_*` below.)"""
    from repro_torch.kernels.decode_attention.ops import decode_gqa

    dev = no_tf32
    q = _randn(dev, (2, 4, 64), "bfloat16", 0)
    kc = _randn(dev, (2, 2, 64, 64), "bfloat16", 1)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        decode_gqa(q.clone().requires_grad_(), kc, kc, 64)
    with torch.no_grad():
        decode_gqa(q.clone().requires_grad_(), kc, kc, 64)


def test_qwen_smoke_train_step_kernel_path_equals_plain_path(no_tf32):
    """One train step's loss and gradients on the Qwen1.5-0.5B smoke
    variant in f32 on the card: the flash forward and backward kernels
    against the layers' chunked plain attention (autograd), loss within
    1e-5 relative and every leaf within 1e-4 of its max-abs."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import init_params, layers
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import leaves

    dev = no_tf32
    cfg = smoke_variant(get_config("qwen1.5-0.5b")).with_overrides(
        param_dtype="float32", compute_dtype="float32", remat="dots")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev)
    batch = SyntheticPipeline(cfg, batch=2, seq_len=100,
                              device=dev).batch_at(0)
    FK.reset_launches()
    lk, gk = _value_and_grad(params, cfg, batch)
    assert FK.flash_attention.launches == FK.flash_attention_bwd.launches \
        == cfg.n_layers
    saved = layers.attention_bshd
    layers.attention_bshd = lambda q, k, v, *, causal, window: \
        layers.flash_attention_chunked(q, k, v, causal=causal, window=window)
    try:
        lp, gp = _value_and_grad(params, cfg, batch)
    finally:
        layers.attention_bshd = saved
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    for a, b in zip(leaves(gk), leaves(gp)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


# ------------------------------------------------------ scan backwards
# each gradient of a backward kernel against its plain backward on the
# card, within 1e-4 of the gradient's max-abs (f32: both sum in f32 in
# other orders); 16-bit gradients are rounded to their type by both
# sides, so there one rounding step (2^-7 bf16, 2^-10 f16) of the
# max-abs on top
SCAN_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-4 + 2 ** -7,
                "float16": 1e-4 + 2 ** -10}


def _grad_close(got, want, what, tol=1e-4):
    for name, g, w in zip(what, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = w.float().abs().max().clamp_min(1e-30)
        ratio = ((g.float() - w.float()).abs().max() / scale).item()
        assert ratio <= tol, f"{name}: max |d| / max = {ratio:.3g} > {tol}"


def _wkv_bwd_case(dev, B, T, H, N, dtype, seed, s0=False, dS=False):
    """Model-layout inputs as [B,H,T,N] views, the kernel forward's
    (o, S, states), and seeded dO (and dS, s0)."""
    from repro_torch.kernels.wkv_scan import kernel as WK

    r, k, v, w_log, u = _wkv_inputs(dev, B, T, H, N, dtype, seed)
    x = [t.transpose(1, 2) for t in (r, k, v, w_log)]
    ub = u[None].expand(B, H, N)
    g = torch.Generator(device=dev).manual_seed(seed)
    state0 = torch.randn((B, H, N, N), generator=g, device=dev) \
        if s0 else None
    o, S, states = WK.wkv_scan(*x, ub, state0, return_states=True)
    do = torch.randn(o.shape, generator=g, device=dev)
    gS = torch.randn(S.shape, generator=g, device=dev) if dS else None
    return x, ub, state0, S, states, do, gS


WKV_GRADS = ("dr", "dk", "dv", "dw_log", "du", "ds0")


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("B,T,H,N", [(2, 1, 3, 32), (2, 37, 3, 64),
                                     (3, 200, 5, 32), (2, 130, 3, 64)])
def test_wkv_scan_bwd_equals_plain(no_tf32, dtype, B, T, H, N):
    """T = 1, ragged T, T over two and four 64-step segments, both head
    sizes, every input dtype, strided model-layout views; from a zero
    state with no dS, and from s0 with dS (and ds0)."""
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_bwd_ref

    dev = no_tf32
    for extra in (False, True):
        x, ub, s0, S, states, do, dS = _wkv_bwd_case(
            dev, B, T, H, N, dtype, T + N, s0=extra, dS=extra)
        WK.reset_launches()
        got = WK.wkv_scan_bwd(*x, ub, do, dS, s0, states, S=S,
                              need_ds0=extra)
        assert WK.wkv_scan_bwd.route_launches == {"reverse": 1}
        want = wkv_scan_bwd_ref(*x, ub, do, dS, s0, states, need_ds0=extra)
        _grad_close(got, want, WKV_GRADS, SCAN_BWD_TOL[dtype])


@pytest.mark.parametrize("N", [32, 64])
def test_wkv_scan_bwd_on_operands_off_16_bytes(no_tf32, N):
    """f32 r, k, v, w_log and dO one element into wider buffers (rows off
    16 bytes, read through their strides) equal the plain backward."""
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_bwd_ref

    dev = no_tf32
    B, T, H = 2, 130, 3
    g = torch.Generator(device=dev).manual_seed(N)
    wide = lambda: torch.randn((B, T, H, N + 1), generator=g, device=dev)
    x = [(0.5 * wide())[..., 1:].transpose(1, 2) for _ in range(2)]
    x.append(wide()[..., 1:].transpose(1, 2))
    x.append((-torch.exp(wide() - 2))[..., 1:].transpose(1, 2))
    u = (0.1 * torch.randn((H, N), generator=g, device=dev))[None].expand(
        B, H, N)
    _, _, states = WK.wkv_scan(*x, u, return_states=True)
    do = wide()[..., 1:].transpose(1, 2)
    got = WK.wkv_scan_bwd(*x, u, do, None, None, states)
    _grad_close(got, wkv_scan_bwd_ref(*x, u, do, None, None, states),
                WKV_GRADS)


def test_wkv_scan_bwd_at_the_train_shape_is_deterministic(no_tf32):
    """RWKV6-3B's train shape at batch 4 (B x H x 16 segments = 2,560
    blocks; T 1,024), f32: equal to the plain backward, and two launches
    give the same bits (no atomics)."""
    from repro_torch.kernels.cuda_build import Launch
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_bwd_ref

    x, ub, s0, S, states, do, dS = _wkv_bwd_case(no_tf32, 4, 1024, 40, 64,
                                                 "float32", 7, dS=True)
    got = WK.wkv_scan_bwd(*x, ub, do, dS, s0, states, S=S)
    assert WK.wkv_scan_bwd.last_route == Launch("reverse", (160, 16), 512,
                                                False)
    again = WK.wkv_scan_bwd(*x, ub, do, dS, s0, states, S=S)
    for a, b in zip(got[:5], again[:5]):
        assert torch.equal(a, b)
    _grad_close(got, wkv_scan_bwd_ref(*x, ub, do, dS, s0, states),
                WKV_GRADS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [16, 200])
def test_scan_forward_states_leave_o_and_s_bitwise(no_tf32, dtype, T):
    """The forwards with the chunk-boundary states on and off give the
    same o/y and final state, bit for bit; the states equal the plain
    version's."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_plain

    dev = no_tf32
    r, k, v, w_log, u = _wkv_inputs(dev, 2, T, 3, 64, dtype, T)
    x = [t.transpose(1, 2) for t in (r, k, v, w_log)]
    ub = u[None].expand(2, 3, 64)
    o, S = WK.wkv_scan(*x, ub)
    o2, S2, states = WK.wkv_scan(*x, ub, return_states=True)
    assert torch.equal(o, o2) and torch.equal(S, S2)
    torch.testing.assert_close(states, wkv_scan_plain(
        *x, ub, return_states=True)[2], rtol=WKV_TOL, atol=WKV_TOL)
    y_in = _ssm_inputs(dev, 2, T, 300, 16, dtype, T)
    y, h = SK.ssm_scan(*y_in)
    y2, h2, hs = SK.ssm_scan(*y_in, return_states=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    torch.testing.assert_close(hs, ssm_scan_ref(*y_in, return_states=True)[2],
                               rtol=SSM_TOL, atol=SSM_TOL)


def _ssm_bwd_case(dev, Bb, T, Di, N, u_dtype, seed, h0=False, dh=False):
    from repro_torch.kernels.ssm_scan import kernel as SK

    x = _ssm_inputs(dev, Bb, T, Di, N, u_dtype, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    state0 = torch.randn((Bb, Di, N), generator=g, device=dev) \
        if h0 else None
    y, h, states = SK.ssm_scan(*x, state0, return_states=True)
    dy = torch.randn(y.shape, generator=g, device=dev)
    gh = torch.randn(h.shape, generator=g, device=dev) if dh else None
    return x, state0, states, dy, gh


SSM_GRADS = ("du", "ddt", "dB", "dC", "dA", "dD", "dh0")


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bb,T,Di,N", [(2, 1, 300, 16), (2, 37, 1000, 8),
                                       (3, 200, 300, 16), (1, 64, 64, 16),
                                       (4, 130, 1100, 8)])
def test_ssm_scan_bwd_equals_plain(no_tf32, u_dtype, Bb, T, Di, N):
    """T = 1, ragged T and Di (not multiples of the 8-step chunk or of the
    block's 64 channels at N 16, 128 at N 8), batch rows over several
    blocks each, both state sizes, f32 and bf16 u (du in u's dtype; rows
    on 16 bytes or not: cp.async or element staging); from a zero state
    with no dh, and from h0 with dh (and dh0)."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    dev = no_tf32
    for extra in (False, True):
        x, h0, states, dy, dh = _ssm_bwd_case(dev, Bb, T, Di, N, u_dtype,
                                              T + Di, h0=extra, dh=extra)
        SK.reset_launches()
        got = SK.ssm_scan_bwd(*x, dy, dh, h0, states, need_dh0=extra)
        assert SK.ssm_scan_bwd.route_launches == {"reverse": 1}
        want = ssm_scan_bwd_ref(*x, dy, dh, h0, states, need_dh0=extra)
        assert got[0].dtype == x[0].dtype
        _grad_close(got, want, SSM_GRADS, SCAN_BWD_TOL[u_dtype])


def test_ssm_scan_bwd_at_the_train_shape_is_deterministic(no_tf32):
    """Jamba's train microbatch (Bb 1, T 1,024, Di 16,384, N 16, bf16 u):
    256 blocks of 256 threads, four lanes a channel, cp.async staging;
    equal to the plain backward, and two launches give the same bits (no
    atomics)."""
    from repro_torch.kernels.cuda_build import Launch
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    x, h0, states, dy, dh = _ssm_bwd_case(no_tf32, 1, 1024, 16384, 16,
                                          "bfloat16", 3)
    got = SK.ssm_scan_bwd(*x, dy, dh, h0, states)
    assert SK.ssm_scan_bwd.last_route == Launch("reverse", (256, 1), 256,
                                                True)
    again = SK.ssm_scan_bwd(*x, dy, dh, h0, states)
    for a, b in zip(got[:6], again[:6]):
        assert torch.equal(a, b)
    _grad_close(got, ssm_scan_bwd_ref(*x, dy, dh, h0, states), SSM_GRADS,
                SCAN_BWD_TOL["bfloat16"])


@contextlib.contextmanager
def _plain_scans():
    """The scan wrappers the ops call, swapped for the plain versions."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    sites = [(WK, "wkv_scan", WR.wkv_scan_plain),
             (WK, "wkv_scan_bwd", WR.wkv_scan_bwd_ref),
             (SK, "ssm_scan", SR.ssm_scan_ref),
             (SK, "ssm_scan_bwd", SR.ssm_scan_bwd_ref)]
    saved = [getattr(m, n) for m, n, _ in sites]
    for m, n, fn in sites:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for (m, n, _), fn in zip(sites, saved):
            setattr(m, n, fn)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_scan_smoke_train_step_kernel_path_equals_plain_path(no_tf32, arch,
                                                             remat):
    """One train step's loss and gradients on the smoke variant in f32
    on the card: the scan kernels forward and backward (through
    `WKVScan` / `SSMScan`) against the plain forwards and backwards,
    loss within 1e-5 relative and every leaf within 1e-4 of its
    max-abs; each step launches each scan's forward once a layer (twice
    under "full") and its backward once."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.models import init_params, layers
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import leaves

    dev = no_tf32
    cfg = smoke_variant(get_config(arch)).with_overrides(
        param_dtype="float32", compute_dtype="float32", remat=remat)
    if arch != "rwkv6-3b":      # Mamba and attention, no MoE routing to flip
        cfg = cfg.with_overrides(pattern=(cfg.pattern[0], cfg.pattern[4]),
                                 n_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    batch = SyntheticPipeline(cfg, batch=2, seq_len=80,
                              device=dev).batch_at(0)
    mod, fwd, bwd = (WK, WK.wkv_scan, WK.wkv_scan_bwd) if arch == "rwkv6-3b" \
        else (SK, SK.ssm_scan, SK.ssm_scan_bwd)
    mixer = "rwkv" if arch == "rwkv6-3b" else "mamba"
    n = sum(s.mixer == mixer for s in cfg.pattern) * cfg.n_periods
    mod.reset_launches()
    lk, gk = _value_and_grad(params, cfg, batch)
    assert fwd.route_launches["chunked"] == n * (2 if remat == "full" else 1)
    assert bwd.route_launches == {"reverse": n}
    saved_attn = layers.attention_bshd
    layers.attention_bshd = lambda q, k, v, *, causal, window: \
        layers.flash_attention_chunked(q, k, v, causal=causal, window=window)
    try:
        with _plain_scans():
            lp, gp = _value_and_grad(params, cfg, batch)
    finally:
        layers.attention_bshd = saved_attn
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0)
    for a, b in zip(leaves(gk), leaves(gp)):
        if a.is_floating_point():
            scale = b.abs().max().clamp_min(1e-30)
            assert ((a - b).abs().max() / scale).item() <= 1e-4
