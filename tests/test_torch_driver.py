"""Driver parity: the same seeded HTAP run through the reference (`repro`,
Pallas kernels in interpret mode) and the port (`repro_torch` on
device="cpu", plain PyTorch versions) gives equal `Metrics`, field for
field — commits, aborts by reason, OLAP outputs, dispatch modes, view
hits/fallbacks/demotions, cache counters.

Latency histograms are compared by sample count only (times differ).
The port's `olap_kernel_device_calls` is the reference's
`olap_kernel_pallas_calls` (series kernel_launch_device_calls <->
kernel_launch_pallas_calls): both count the reference's kernel call
sites.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import mvcc as ref_mvcc  # noqa: E402
from repro_torch import mvcc as port_mvcc  # noqa: E402
from repro_torch.tensorstore import PagedMirror  # noqa: E402

RENAMED = {"olap_kernel_pallas_calls": "olap_kernel_device_calls"}
COUNT_ONLY = ("serve_latency", "oltp_commit_latency")
GROUPED_COUNT_ONLY = ("serve_latency_by_plan", "serve_stage_latency")


def assert_metrics_equal(ref, port):
    a, b = dataclasses.asdict(ref), dataclasses.asdict(port)
    for old, new in RENAMED.items():
        a[new] = a.pop(old)
    assert set(a) == set(b)
    for k in a:
        va, vb = a[k], b[k]
        if k in COUNT_ONLY:
            va, vb = va.get("count"), vb.get("count")
        elif k in GROUPED_COUNT_ONLY:
            va = {x: y["count"] for x, y in va.items()}
            vb = {x: y["count"] for x, y in vb.items()}
        assert va == vb, (k, va, vb)


SINGLE = dict(olap_mode="ssi+rss", oltp_clients=4, olap_clients=3,
              rounds=150, seed=3, olap_scan=True, paged_olap=True,
              check_scans=True, batch_plans=True, materialize=True)


@pytest.mark.parametrize("certifier", ["conservative", "commit-order", "ssn"])
def test_single_node_metrics_equal(certifier):
    ref = ref_mvcc.run_single_node(certifier=certifier, **SINGLE)
    port = port_mvcc.run_single_node(certifier=certifier, device="cpu",
                                     **SINGLE)
    assert_metrics_equal(ref, port)
    # the run drove every fused path the port has a kernel for
    assert port.olap_kernel_device_calls > 0
    assert port.olap_mode_flat and port.olap_mode_chunked
    assert port.olap_view_hits and port.olap_view_demotions
    assert port.olap_aborts == 0


def test_single_node_grouped_mode_pinned(monkeypatch):
    """Every grouped dispatch forced through one strategy (the env
    override both packages read) still matches."""
    monkeypatch.setenv("REPRO_GROUPED_MODE", "flat")
    kw = dict(SINGLE, rounds=80, materialize=False)
    assert_metrics_equal(ref_mvcc.run_single_node(**kw),
                         port_mvcc.run_single_node(device="cpu", **kw))


def test_multi_node_metrics_equal():
    kw = dict(olap_mode="ssi+rss", oltp_clients=4, olap_clients=3,
              rounds=150, seed=5, olap_scan=True, paged_olap=True,
              check_scans=True, batch_plans=True, materialize=True,
              n_replicas=2, ship_skew=1)
    ref = ref_mvcc.run_multi_node(**kw)
    port = port_mvcc.run_multi_node(device="cpu", **kw)
    assert_metrics_equal(ref, port)
    assert sum(port.olap_served_by) and port.olap_kernel_device_calls


def test_sessions_metrics_equal():
    ref, ref_sessions = ref_mvcc.run_sessions(n_sessions=60, rounds=6,
                                              seed=2, check_scans=True)
    port, port_sessions = port_mvcc.run_sessions(
        n_sessions=60, rounds=6, seed=2, check_scans=True, device="cpu")
    assert_metrics_equal(ref, port)
    assert [s.name for s in ref_sessions] == [s.name for s in port_sessions]
    assert port.session_token_violations == 0


@pytest.mark.parametrize("certifier", ["conservative", "ssn"])
def test_write_skew_metrics_equal(certifier):
    ref, ref_engine = ref_mvcc.run_write_skew(certifier=certifier,
                                              rounds=400, seed=1)
    port, port_engine = port_mvcc.run_write_skew(certifier=certifier,
                                                 rounds=400, seed=1)
    assert_metrics_equal(ref, port)
    assert ref_engine.stats == port_engine.stats


def test_entry_points_raise_without_cuda():
    """The device defaults to "cuda"; without a GPU the entry points
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedMirror()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mvcc.run_single_node(olap_mode="ssi+rss", oltp_clients=1,
                                  olap_clients=1, rounds=1,
                                  paged_olap=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mvcc.run_multi_node(olap_mode="ssi+rss", oltp_clients=1,
                                 olap_clients=1, rounds=1, paged_olap=True)
    assert PagedMirror(device="cpu").device.type == "cpu"
