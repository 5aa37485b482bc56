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
