"""Paged-store parity: every function of the port's `tensorstore/paged.py`
against `repro.tensorstore.paged` on the same numpy-seeded inputs (stores
on "cpu"), plus `VersionedParamStore` through both packages.  Exact, on
bits: the store does no arithmetic.  Cases follow tests/test_tensorstore.py
and tests/test_replica.py::TestVersionedParamStore; the seeded publish /
read sequences replace the reference's hypothesis property with
parametrized seeds."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.tensorstore as jts  # noqa: E402
import repro_torch.tensorstore as tts  # noqa: E402
from repro.kernels.version_gather import ops as j_ops  # noqa: E402
from repro_torch.kernels.version_gather import ops as t_ops  # noqa: E402

j_read, t_read = j_ops.snapshot_read, t_ops.snapshot_read

CPU = "cpu"


def _np(a):
    """Bits of a JAX array or torch tensor as numpy (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_store(js, ts_):
    np.testing.assert_array_equal(_np(ts_["data"]), _np(js["data"]))
    np.testing.assert_array_equal(_np(ts_["ts"]), _np(js["ts"]))


def _stores(P, K, E, jdt=jnp.float32, tdt=torch.float32, initial=None):
    return (jts.init_store(P, K, E, jdt, initial=None if initial is None
                           else jnp.asarray(initial)),
            tts.init_store(P, K, E, tdt, initial=None if initial is None
                           else torch.from_numpy(initial), device=CPU))


def test_init_store_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.init_store(4, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.store_from_numpy({"data": np.zeros((1, 1, 1), np.float32),
                              "ts": np.zeros((1, 1), np.int32)})


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_init_store_with_initial(dt):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    init = np.random.default_rng(1).standard_normal((4, 8)).astype(
        np.float32)
    js, ts_ = _stores(4, 3, 8, jdt, tdt, initial=init)
    _same_store(js, ts_)
    np.testing.assert_array_equal(
        _np(tts.snapshot_read_ref(ts_, 0)),
        _np(jts.snapshot_read_ref(js, jnp.int32(0))))


def test_initial_visibility():
    init = np.arange(32.0, dtype=np.float32).reshape(4, 8)
    _, store = _stores(4, 3, 8, initial=init)
    np.testing.assert_array_equal(tts.snapshot_read_ref(store, 0).numpy(),
                                  init)


def test_publish_then_read_at_watermarks():
    js, store = _stores(2, 3, 4)
    for v, t in ((1.0, 10), (2.0, 20)):
        js = jts.publish_page(js, 0, jnp.full((4,), v), jnp.int32(t))
        assert tts.publish_page(store, 0, torch.full((4,), v), t) is store
    _same_store(js, store)
    for wm, want in ((5, 0.0), (15, 1.0), (25, 2.0)):
        assert float(tts.snapshot_read_ref(store, wm)[0][0]) == want
        assert float(t_read(store, wm)[0][0]) == want


@pytest.mark.parametrize("K", [2, 3, 8])
@pytest.mark.parametrize("gc_floor", [None, 0, 15, 35])
def test_publish_page_ties_and_gc_floor(K, gc_floor):
    """Fresh pages have K slots at ts 0 (a K-way tie): the victim and the
    protected slot must be the reference's slot for slot, for every
    publish of a sequence, with and without a gc_floor."""
    rng = np.random.default_rng(K * 100 + (gc_floor or 0))
    js, store = _stores(3, K, 5)
    kw = {} if gc_floor is None else {"gc_floor": gc_floor}
    t = 0
    for _ in range(3 * K + 4):
        t += int(rng.integers(1, 8))
        page = int(rng.integers(0, 3))
        payload = rng.standard_normal(5).astype(np.float32)
        js = jts.publish_page(js, page, jnp.asarray(payload), jnp.int32(t),
                              **kw)
        tts.publish_page(store, page, torch.from_numpy(payload), t, **kw)
        _same_store(js, store)


def test_publish_page_bf16_payload_rounds_like_jax():
    rng = np.random.default_rng(2)
    js, store = _stores(2, 2, 16, jnp.bfloat16, torch.bfloat16)
    for t in (3, 9, 12):
        payload = rng.standard_normal(16).astype(np.float32)
        js = jts.publish_page(js, 1, jnp.asarray(payload), jnp.int32(t))
        tts.publish_page(store, 1, torch.from_numpy(payload), t)
    _same_store(js, store)


@pytest.mark.parametrize("seed", range(12))
def test_publish_read_sequence_matches_versions_oracle(seed):
    """publish_page + snapshot reads == a python dict-of-versions oracle at
    the newest watermark, and == the reference's store and reads at every
    watermark."""
    rng = np.random.default_rng(seed)
    P, E = 4, 8
    slots, n_pub = int(rng.integers(2, 5)), int(rng.integers(1, 13))
    js, store = _stores(P, slots, E)
    oracle = {p: [(0, np.zeros(E, np.float32))] for p in range(P)}
    t = 0
    for _ in range(n_pub):
        t += int(rng.integers(1, 5))
        p = int(rng.integers(P))
        payload = rng.standard_normal(E).astype(np.float32)
        js = jts.publish_page(js, p, jnp.asarray(payload), jnp.int32(t))
        tts.publish_page(store, p, torch.from_numpy(payload), t)
        oracle[p].append((t, payload))
    _same_store(js, store)
    out = tts.snapshot_read_ref(store, t).numpy()
    for p in range(P):
        np.testing.assert_array_equal(out[p], max(oracle[p],
                                                  key=lambda kv: kv[0])[1])
    for wm in range(t + 1):
        np.testing.assert_array_equal(
            t_read(store, wm).numpy(), np.asarray(j_read(js, jnp.int32(wm))))
        np.testing.assert_array_equal(
            tts.visible_slots(store["ts"], wm).numpy(),
            np.asarray(jts.visible_slots(js["ts"], jnp.int32(wm))))


def test_member_set_read():
    """RSS-set visibility: a newer non-member version is skipped."""
    js, store = _stores(1, 3, 4)
    for v, t in ((1.0, 10), (2.0, 20)):
        js = jts.publish_page(js, 0, jnp.full((4,), v), jnp.int32(t))
        tts.publish_page(store, 0, torch.full((4,), v), t)
    members = torch.tensor([10], dtype=torch.int32)     # 20 not in RSS
    out = tts.snapshot_read_members(store, members)
    assert float(out[0][0]) == 1.0
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jts.snapshot_read_members(
            js, jnp.asarray([10], jnp.int32))))
    idx = tts.visible_slots_members(store["ts"], members)
    assert int(store["ts"][0, idx[0]]) == 10


@pytest.mark.parametrize("M", [0, 1, 6])
@pytest.mark.parametrize("floor", [0, 9, 30])
def test_visible_slots_members_matches_reference(M, floor):
    rng = np.random.default_rng(M * 7 + floor)
    ts = rng.integers(0, 40, (24, 4)).astype(np.int32)
    mem = np.sort(rng.choice(np.arange(floor + 1, floor + 40), M,
                             replace=False)).astype(np.int32)
    got = tts.visible_slots_members(torch.from_numpy(ts),
                                    torch.from_numpy(mem), floor)
    want = jts.visible_slots_members(jnp.asarray(ts), jnp.asarray(mem),
                                     floor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    data = rng.standard_normal((24, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tts.snapshot_read_members({"data": torch.from_numpy(data),
                                   "ts": torch.from_numpy(ts)}, mem,
                                  floor).numpy(),
        np.asarray(jts.snapshot_read_members(
            {"data": jnp.asarray(data), "ts": jnp.asarray(ts)},
            jnp.asarray(mem), floor)))


def test_kernel_and_ref_agree_on_store():
    rng = np.random.default_rng(0)
    store = {"data": torch.from_numpy(rng.standard_normal(
        (16, 4, 256)).astype(np.float32)),
             "ts": torch.from_numpy(rng.integers(0, 30, (16, 4)).astype(
                 np.int32))}
    for wm in (0, 10, 29):
        assert torch.equal(t_read(store, wm),
                           tts.snapshot_read_ref(store, wm))


@pytest.mark.parametrize("pages", [[2, 3, 4, 5], [5, 0, 7], [1],
                                   list(range(8)), [6, 6, 1, 3, 0, 2, 4, 5,
                                                    7, 2]],
                         ids=["dense", "arbitrary", "one", "dense8",
                              "arbitrary10"])
def test_gather_pages(pages):
    rng = np.random.default_rng(len(pages))
    data = rng.standard_normal((8, 3, 6)).astype(np.float32)
    ts = rng.integers(0, 20, (8, 3)).astype(np.int32)
    js = {"data": jnp.asarray(data), "ts": jnp.asarray(ts)}
    store = {"data": torch.from_numpy(data), "ts": torch.from_numpy(ts)}
    sub_j, sub_t = jts.gather_pages(js, pages), tts.gather_pages(store,
                                                                 pages)
    assert sub_t["data"].shape[0] % 8 == 0
    _same_store(sub_j, sub_t)
    np.testing.assert_array_equal(t_read(sub_t, 12).numpy(),
                                  np.asarray(j_read(sub_j, jnp.int32(12))))


@pytest.mark.parametrize("dt", ["bf16", "i32", "f32"])
def test_store_from_numpy(dt):
    """A JAX store carried across through numpy keeps every bit (bf16 via
    ml_dtypes arrays), and reads the same."""
    rng = np.random.default_rng(4)
    jdt = {"bf16": jnp.bfloat16, "i32": jnp.int32, "f32": jnp.float32}[dt]
    js = jts.init_store(6, 3, 10, jdt)
    for t in (4, 8, 15, 16):
        payload = (rng.standard_normal(10) * 1000).astype(np.float32)
        js = jts.publish_page(js, t % 6, jnp.asarray(payload), jnp.int32(t))
    store = tts.store_from_numpy({"data": np.asarray(js["data"]),
                                  "ts": np.asarray(js["ts"])}, device=CPU)
    _same_store(js, store)
    assert store["data"].dtype == {"bf16": torch.bfloat16,
                                   "i32": torch.int32,
                                   "f32": torch.float32}[dt]
    for wm in (0, 8, 16):
        np.testing.assert_array_equal(
            _np(t_read(store, wm)), _np(j_read(js, jnp.int32(wm))))


# ------------------------------------------------- VersionedParamStore
@pytest.mark.parametrize("pkg", [jts, tts], ids=["jax", "torch"])
def test_wait_free_publish_under_pin(pkg):
    store = pkg.VersionedParamStore(slots=2)
    store.publish({"w": 1}); store.refresh()
    pin, params = store.pin_snapshot()
    assert params == {"w": 1}
    for i in range(2, 6):
        store.publish({"w": i})
    _, params2 = store.pin_snapshot()
    assert params2 == {"w": 1}            # watermark not refreshed yet
    store.refresh()
    _, params3 = store.pin_snapshot()
    assert params3 == {"w": 5}
    assert store.slots[store._pins[pin]].params == {"w": 1}


@pytest.mark.parametrize("pkg", [jts, tts], ids=["jax", "torch"])
def test_freshness_lag_metric(pkg):
    store = pkg.VersionedParamStore(slots=2)
    store.publish({"w": 0}); store.refresh()
    for i in range(3):
        store.publish({"w": i})
    assert store.freshness_lag() > 0
    store.refresh()
    assert store.freshness_lag() == 0


@pytest.mark.parametrize("seed", range(4))
def test_versioned_param_store_trace_matches_reference(seed):
    """A seeded publish / refresh / pin / release trace, with rw-deps and
    explicit open transactions, gives the same pins, params, slot counts,
    visible LSNs and freshness lags in both packages."""
    import random

    def run(pkg):
        rng = random.Random(seed)
        store = pkg.VersionedParamStore(slots=rng.randint(1, 3))
        trace, pins, open_txns = [], [], []
        for step in range(40):
            op = rng.random()
            if op < 0.15:
                open_txns.append(store.begin_txn())
            elif op < 0.5:
                tid = open_txns.pop() if open_txns and rng.random() < .5 \
                    else None
                deps = tuple(rng.sample(range(1, step + 2), 1)) \
                    if rng.random() < 0.2 else ()
                trace.append(("pub", store.publish({"v": step}, txn_id=tid,
                                                   out_rw=deps)))
            elif op < 0.7:
                snap = store.refresh()
                trace.append(("snap", snap.floor_seq,
                              sorted(snap.txns or ())))
            elif op < 0.9:
                try:
                    pid, params = store.pin_snapshot()
                except RuntimeError:
                    trace.append(("nopin",))
                    continue
                pins.append(pid)
                trace.append(("pin", pid, params))
            elif pins:
                store.release(pins.pop(rng.randrange(len(pins))))
            trace.append((store.n_slots, store.visible_lsn(),
                          store.freshness_lag(),
                          [(s.txn_id, s.pins) for s in store.slots]))
        return trace

    assert run(tts) == run(jts)
