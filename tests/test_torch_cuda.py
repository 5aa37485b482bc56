"""On-card checks of the port's CUDA kernels: each kernel == its plain
PyTorch version on the GPU (bitwise), the shared-memory and global-atomic
reduction paths both, plus the wrappers' input checks and a small driver
run on "cuda" against the same run on "cpu".

Marked `cuda`: they skip without a GPU (a CUDA kernel has no CPU mode).
On the GPU machine: PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

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
    """G = 2000 does not fit the chunked kernel's shared-memory tile, so
    it takes the global-atomic path."""
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
    """lp = 2048 exceeds the shared-memory tile: global-atomic path."""
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


def test_wrappers_reject_bad_inputs_and_count_launches(dev):
    from repro_torch.kernels.rss_scan_agg import kernel as K

    data, ts, mem, gid, _ = _inputs(dev, 64)
    K.reset_launches()
    K.rss_scan_agg(data, ts, mem, 0)
    assert K.rss_scan_agg.launches == 1
    with pytest.raises(TypeError):
        K.rss_scan_agg(data.long(), ts, mem, 0)
    with pytest.raises(ValueError):
        K.rss_scan_agg(data, ts, mem.cpu(), 0)
    with pytest.raises(ValueError):
        K.rss_scan_agg_grouped(data, ts, torch.cat([gid, gid], 1)[:, :1],
                               mem, 0, n_groups=5)      # strided gid
    with pytest.raises(OverflowError):
        K.rss_scan_agg(data, ts, mem, 2**31)
    assert K.rss_scan_agg.launches == 1


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
