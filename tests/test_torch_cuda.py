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
    assert RK.rss_gather.launches == VK.version_gather.launches == 0


def test_gather_wrappers_reject_bad_inputs_and_count_launches(dev):
    from repro_torch.kernels.rss_gather import kernel as RK
    from repro_torch.kernels.version_gather import kernel as VK

    data, ts, _ = _gather_inputs(dev, 64, 4, 16, "float32")
    mem = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    RK.reset_launches(), VK.reset_launches()
    RK.rss_gather(data, ts, mem, 0)
    VK.version_gather(data, ts, 100)
    assert RK.rss_gather.launches == VK.version_gather.launches == 1
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
    assert RK.rss_gather.launches == VK.version_gather.launches == 1
