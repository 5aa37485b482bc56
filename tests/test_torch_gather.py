"""Gather-kernel parity: the port's version_gather / rss_gather (plain
PyTorch versions, which the CUDA wrappers return for CPU tensors) against
the JAX package's jnp refs and its Pallas kernels in interpret mode, on
the same numpy-seeded inputs.  A gather does no arithmetic, so every
comparison is exact, on bits, for every dtype.  Cases follow
tests/test_rss_gather.py and tests/test_kernels.py::TestVersionGather.

Pallas comparisons use finite data without -0.0: the Pallas kernels sum a
one-hot product over K, which turns a NaN/Inf in an unselected slot into
NaN and a selected -0.0 into +0.0; the refs and the port copy bits
(`test_bits_copied_where_pallas_one_hot_does_not`)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from repro.kernels.rss_gather import kernel as jk_rss  # noqa: E402
from repro.kernels.rss_gather import ref as jref_rss  # noqa: E402
from repro.kernels.version_gather import kernel as jk_vg  # noqa: E402
from repro.kernels.version_gather import ref as jref_vg  # noqa: E402
from repro_torch.kernels.cuda_build import launch_count  # noqa: E402
from repro_torch.kernels.rss_gather import kernel as tk_rss  # noqa: E402
from repro_torch.kernels.rss_gather import ops as tops_rss  # noqa: E402
from repro_torch.kernels.rss_gather import ref as tref_rss  # noqa: E402
from repro_torch.kernels.version_gather import kernel as tk_vg  # noqa: E402
from repro_torch.kernels.version_gather import ops as tops_vg  # noqa: E402
from repro_torch.kernels.version_gather import ref as tref_vg  # noqa: E402

pallas_rss, pallas_vg = jk_rss.rss_gather, jk_vg.version_gather
jax_rss_ref, jax_vg_ref = jref_rss.rss_gather_ref, jref_vg.version_gather_ref
jax_slots = jref_rss.rss_visible_slots_ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "i32": (jnp.int32, torch.int32)}


def _data(rng, shape, dt):
    """float32 numpy data (integers for i32), finite, no -0.0."""
    if dt == "i32":
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32)
    x = (rng.standard_normal(shape) * 10).astype(np.float32)
    return np.where(x == 0, np.float32(1.0), x)


def _both(x, dt):
    """The same numpy input in each framework, cast there (bf16: round to
    nearest even in both)."""
    jd, td = DTYPES[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _bits(a):
    """Bit pattern of a JAX array or torch tensor as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.element_size() == 2
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _i32(x):
    return jnp.asarray(x, jnp.int32), torch.from_numpy(
        np.ascontiguousarray(x, np.int32))


def _python_oracle(data, ts, members, floor=0):
    """Independent per-page scan: newest slot with ts <= floor or ts in
    members, ties toward the lowest slot; all-invisible pages -> slot 0."""
    P, K, _ = data.shape
    mset = set(int(m) for m in members)
    out = np.empty((P, data.shape[2]), data.dtype)
    for p in range(P):
        best, best_ts = 0, -1
        for k in range(K):
            t = int(ts[p, k])
            if (t <= floor or t in mset) and t > best_ts:
                best, best_ts = k, t
        out[p] = data[p, best]
    return out


SHAPES = [(8, 2, 128), (16, 4, 256), (32, 3, 128), (8, 8, 512)]


@pytest.mark.parametrize("P,K,E", SHAPES)
@pytest.mark.parametrize("M", [0, 1, 7, 150])
def test_rss_gather_matches_jax_ref_and_pallas(P, K, E, M):
    rng = np.random.default_rng(P * K + M)
    data = rng.standard_normal((P, K, E)).astype(np.float32)
    ts = rng.integers(0, 60, (P, K)).astype(np.int32)
    members = np.sort(rng.choice(np.arange(1, 60), size=min(M, 59),
                                 replace=False)).astype(np.int32)
    (jd, td), (jt, tt), (jm, tm) = (_both(data, "f32"), _i32(ts),
                                    _i32(members))
    port = tk_rss.rss_gather(td, tt, tm)
    np.testing.assert_array_equal(_bits(port),
                                  _bits(jax_rss_ref(jd, jt, jm)))
    np.testing.assert_array_equal(_bits(port),
                                  _bits(pallas_rss(jd, jt, jm)))
    np.testing.assert_array_equal(port.numpy(),
                                  _python_oracle(data, ts, members))
    np.testing.assert_array_equal(
        tref_rss.rss_visible_slots_ref(tt, tm).numpy(),
        np.asarray(jax_slots(jt, jm)))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("which", ["rss", "version"])
def test_gather_dtypes(dt, which):
    rng = np.random.default_rng(len(dt))
    data = _data(rng, (16, 4, 256), dt)
    ts = rng.integers(0, 30, (16, 4)).astype(np.int32)
    (jd, td), (jt, tt) = _both(data, dt), _i32(ts)
    if which == "rss":
        jm, tm = _i32(np.asarray([3, 11, 19, 27]))
        outs = (tk_rss.rss_gather(td, tt, tm, 5),
                jax_rss_ref(jd, jt, jm, 5), pallas_rss(jd, jt, jm, 5))
    else:
        outs = (tk_vg.version_gather(td, tt, 17), jax_vg_ref(jd, jt, 17),
                pallas_vg(jd, jt, 17))
    assert outs[0].dtype == DTYPES[dt][1]
    for other in outs[1:]:
        np.testing.assert_array_equal(_bits(outs[0]), _bits(other))


@pytest.mark.parametrize("P,K,E", [(8, 2, 256), (32, 4, 512), (16, 8, 128),
                                   (64, 3, 1024)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_version_gather_shapes_dtypes(P, K, E, dt):
    rng = np.random.default_rng(P * K)
    data = _data(rng, (P, K, E), dt)
    ts = rng.integers(0, 50, (P, K)).astype(np.int32)
    (jd, td), (jt, tt) = _both(data, dt), _i32(ts)
    for wm in (0, 13, 49):
        port = tk_vg.version_gather(td, tt, wm)
        np.testing.assert_array_equal(_bits(port),
                                      _bits(jax_vg_ref(jd, jt, wm)))
        np.testing.assert_array_equal(
            _bits(port), _bits(pallas_vg(jd, jt, wm, block_pages=min(8, P),
                                         block_elems=min(256, E))))


@pytest.mark.parametrize("seed", range(6))
def test_version_gather_matches_per_page_scan(seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((16, 4, 128)).astype(np.float32)
    ts = rng.integers(0, 50, (16, 4)).astype(np.int32)
    wm = int(rng.integers(0, 61))
    got = tops_vg.snapshot_read({"data": torch.from_numpy(data),
                                 "ts": torch.from_numpy(ts)}, wm)
    np.testing.assert_array_equal(got.numpy(),
                                  _python_oracle(data, ts, [], wm))


@pytest.mark.parametrize("P,K,E", SHAPES[:2])
@pytest.mark.parametrize("M", [0, 5])
@pytest.mark.parametrize("floor", [0, 13, 59])
def test_floor_compressed_membership(P, K, E, M, floor):
    rng = np.random.default_rng(P + M + floor)
    data = rng.standard_normal((P, K, E)).astype(np.float32)
    ts = rng.integers(0, 60, (P, K)).astype(np.int32)
    members = np.sort(rng.choice(np.arange(floor + 1, floor + 60), size=M,
                                 replace=False)).astype(np.int32)
    (jd, td), (jt, tt), (jm, tm) = (_both(data, "f32"), _i32(ts),
                                    _i32(members))
    port = tk_rss.rss_gather(td, tt, tm, floor)
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(pallas_rss(jd, jt, jm, floor)))
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(jax_rss_ref(jd, jt, jm, floor)))
    np.testing.assert_array_equal(port.numpy(),
                                  _python_oracle(data, ts, members, floor))


def test_floor_equivalence_to_explicit_members():
    """A floor equals enumerating every seq at or below it as a member."""
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.standard_normal((16, 4, 64)).astype(
        np.float32))
    ts = torch.from_numpy(rng.integers(0, 40, (16, 4)).astype(np.int32))
    above = torch.tensor([25, 31, 39], dtype=torch.int32)
    explicit = torch.tensor(sorted(set(range(1, 21)) | {25, 31, 39}),
                            dtype=torch.int32)
    assert torch.equal(tk_rss.rss_gather(data, ts, above, 20),
                       tk_rss.rss_gather(data, ts, explicit, 0))


def test_ops_on_cpu_tensors_return_plain_result_without_launch():
    rng = np.random.default_rng(11)
    store = {"data": torch.from_numpy(rng.standard_normal(
        (5, 3, 7)).astype(np.float32)),
             "ts": torch.from_numpy(rng.integers(0, 20, (5, 3)).astype(
                 np.int32))}
    tk_rss.reset_launches(), tk_vg.reset_launches()
    got = tops_rss.snapshot_read_members(store, [12, 3, 7], 2)  # unsorted
    want = tref_rss.rss_gather_ref(store["data"], store["ts"],
                                   torch.tensor([3, 7, 12],
                                                dtype=torch.int32), 2)
    assert torch.equal(got, want)
    assert torch.equal(tops_vg.snapshot_read(store, 9),
                       tref_vg.version_gather_ref(store["data"], store["ts"],
                                                  9))
    assert launch_count(tk_rss.rss_gather) == \
        launch_count(tk_vg.version_gather) == 0


def test_empty_member_array_is_never_indexed():
    ts = torch.tensor([[0, 4, 0], [7, 0, 2]], dtype=torch.int32)
    data = torch.arange(18, dtype=torch.float32).view(2, 3, 3)
    empty = torch.zeros((0,), dtype=torch.int32)
    got = tk_rss.rss_gather(data, ts, empty)
    assert torch.equal(got, data[[0, 1], [0, 1]])      # first ts == 0 slot
    assert torch.equal(tk_rss.rss_gather(data, ts, empty, 3),
                       data[[0, 1], [0, 2]])


def test_bits_copied_where_pallas_one_hot_does_not():
    """NaN/Inf in an unselected slot and a selected -0.0: the port and the
    JAX refs copy bits; the Pallas kernels' one-hot sum does not (a fault
    of the reference kernel that the port deliberately does not copy)."""
    data = np.ones((8, 3, 128), np.float32)
    data[:, 1] = np.nan                 # never selected below
    data[:, 2, :64] = np.inf            # never selected below
    data[:, 2, 64:] = np.nan
    data[:, 0, 0] = -0.0                # selected
    ts = np.zeros((8, 3), np.int32)
    ts[:, 1:] = 50                      # above every read horizon
    (jd, td), (jt, tt) = _both(data, "f32"), _i32(ts)
    members = _i32(np.asarray([7], np.int32))
    for port, ref, pallas in (
            (tk_vg.version_gather(td, tt, 10), jax_vg_ref(jd, jt, 10),
             pallas_vg(jd, jt, 10)),
            (tk_rss.rss_gather(td, tt, members[1]),
             jax_rss_ref(jd, jt, members[0]),
             pallas_rss(jd, jt, members[0]))):
        np.testing.assert_array_equal(_bits(port), _bits(ref))
        np.testing.assert_array_equal(_bits(port), data[:, 0].view(np.int32))
        assert np.isnan(np.asarray(pallas)).all()
    data[:, 1:] = 2.0                   # finite: only the -0.0 differs
    jd, td = _both(data, "f32")
    port, pallas = tk_vg.version_gather(td, tt, 10), pallas_vg(jd, jt, 10)
    assert np.signbit(port.numpy()[:, 0]).all()
    assert not np.signbit(np.asarray(pallas)[:, 0]).any()


def test_unaligned_and_edge_shapes_on_cpu():
    """Shapes the Pallas kernels reject (P % 8, E % 512, K > 32) go through
    the port's plain versions against the jnp refs."""
    rng = np.random.default_rng(5)
    for P, K, E in [(1, 1, 1), (3, 33, 3), (13, 5, 640), (7, 2, 1)]:
        data = _data(rng, (P, K, E), "bf16")
        ts = rng.integers(0, 40, (P, K)).astype(np.int32)
        members = np.sort(rng.choice(np.arange(21, 40), 6, replace=False))
        (jd, td), (jt, tt), (jm, tm) = (_both(data, "bf16"), _i32(ts),
                                        _i32(members))
        np.testing.assert_array_equal(
            _bits(tk_rss.rss_gather(td, tt, tm, 20)),
            _bits(jax_rss_ref(jd, jt, jm, 20)))
        np.testing.assert_array_equal(
            _bits(tk_vg.version_gather(td, tt, 25)),
            _bits(jax_vg_ref(jd, jt, 25)))
