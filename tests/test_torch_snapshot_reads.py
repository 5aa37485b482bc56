"""The snapshot-read slice as a whole, on "cpu": the same transactions run
through the JAX package and the port (engine -> WAL -> RSS -> paged
mirror -> exported store -> gather), and the page-granular reads of the
port equal, after decoding, the reference's gather kernels (Pallas,
interpret mode), both mirrors' batched scans and both engines' per-key
protected reads.  Also runs `examples/pt_paged_snapshot_reads.py`."""

import importlib.util
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import repro.core.replica as jrep  # noqa: E402
import repro.mvcc as jmvcc  # noqa: E402
import repro.tensorstore as jts  # noqa: E402
import repro_torch.core.replica as trep  # noqa: E402
import repro_torch.mvcc as tmvcc  # noqa: E402
import repro_torch.tensorstore as tts  # noqa: E402
from repro.kernels.rss_gather import ops as j_rss_ops  # noqa: E402
from repro.kernels.version_gather import ops as j_vg_ops  # noqa: E402
from repro_torch.kernels.rss_gather import ops as t_rss_ops  # noqa: E402
from repro_torch.kernels.version_gather import ops as t_vg_ops  # noqa: E402

j_members, t_members = (j_rss_ops.snapshot_read_members,
                        t_rss_ops.snapshot_read_members)
j_read, t_read = j_vg_ops.snapshot_read, t_vg_ops.snapshot_read

ROOT = Path(__file__).resolve().parents[1]


def _value(rng, key):
    if key.startswith("district"):
        return {"next_o_id": rng.randrange(40), "ytd": rng.randrange(99)}
    if key.startswith("order"):
        return {"items": [rng.randrange(9) for _ in range(rng.randrange(4))],
                "total": rng.randrange(500)}
    return rng.randrange(-50, 200)


def _example_txns(mvcc):
    """Part 2 of the example: t2 stays active, so t3 commits outside the
    RSS and its page must read the previous version."""
    eng = mvcc.Engine("ssi")
    t = eng.begin()
    for i in range(6):
        eng.write(t, f"stock:0:{i}", 100)
    eng.commit(t)
    t1 = eng.begin(); eng.write(t1, "stock:0:0", 61); eng.commit(t1)
    t2 = eng.begin(); eng.write(t2, "stock:0:1", 7)
    t3 = eng.begin(); eng.write(t3, "stock:0:2", 43); eng.commit(t3)
    return eng, [f"stock:0:{i}" for i in range(6)]


def _random_txns(mvcc, seed, n_keys=48, steps=160):
    """A seeded interleaving of writers over stock/district/order keys:
    writers begin, write, commit or abort in random order, and some are
    still in flight at the end."""
    rng = random.Random(seed)
    keys = ([f"stock:0:{i}" for i in range(n_keys)]
            + [f"district:0:{d}" for d in range(4)]
            + [f"order:0:{d}:{o}" for d in range(2) for o in range(4)])
    eng = mvcc.Engine("ssi")
    t = eng.begin()
    for k in keys:
        eng.write(t, k, _value(rng, k))
    eng.commit(t)
    live = []
    for _ in range(steps):
        op = rng.random()
        try:
            if op < 0.25 or not live:
                live.append(eng.begin())
            elif op < 0.75:
                t = rng.choice(live)
                if t.status == mvcc.Status.ACTIVE:
                    k = rng.choice(keys)
                    eng.write(t, k, _value(rng, k))
            else:
                t = live.pop(rng.randrange(len(live)))
                if t.status == mvcc.Status.ACTIVE:
                    if rng.random() < 0.9:
                        eng.commit(t)
                    else:
                        eng.abort(t)
        except mvcc.SerializationFailure:
            live = [x for x in live if x.status == mvcc.Status.ACTIVE]
    return eng, keys


def _read_side(pkg_rep, pkg_ts, eng, **mirror_kw):
    rss = pkg_rep.RSSManager()
    prot = pkg_rep.PRoTManager(rss)
    rss.catch_up(eng.wal)
    rss.construct()
    mirror = pkg_ts.PagedMirror(**mirror_kw)
    mirror.catch_up(eng.wal, gc_floor=prot.gc_floor_seq())
    _, snap = prot.acquire()
    return rss, mirror, snap


def _decode(mirror, out, keys):
    from repro_torch.tensorstore.mirror import decode_value

    return [decode_value(out[mirror.page_of[k]]) for k in keys]


def _check_slice(make, seed_args=()):
    """Run `make(mvcc, *seed_args)` in both packages; compare every read
    of the slice.  Returns (values, previous-version page count)."""
    j_eng, keys = make(jmvcc, *seed_args)
    t_eng, keys_t = make(tmvcc, *seed_args)
    assert keys == keys_t
    j_rss, j_mirror, j_snap = _read_side(jrep, jts, j_eng)
    t_rss, t_mirror, t_snap = _read_side(trep, tts, t_eng, device="cpu")
    assert t_snap.floor_seq == j_snap.floor_seq
    members = t_mirror.member_seqs_for(t_snap)
    assert list(members) == list(j_mirror.member_seqs_for(j_snap)) \
        == t_rss.member_seqs(t_snap)
    np.testing.assert_array_equal(t_mirror.ts[:t_mirror.n_pages],
                                  j_mirror.ts[:j_mirror.n_pages])

    # RSS membership read of the whole mirror
    store = t_mirror.torch_store()
    out = t_members(store, members, t_snap.floor_seq).numpy()
    ref = np.asarray(j_members(j_mirror.jnp_store(),
                               jnp.asarray(members, jnp.int32),
                               j_snap.floor_seq))
    np.testing.assert_array_equal(out, ref)
    port = _decode(t_mirror, out, keys)
    r = t_eng.begin(read_only=True, rss=t_snap)
    rj = j_eng.begin(read_only=True, rss=j_snap)
    assert port == t_mirror.scan_members(keys, t_snap) \
        == j_mirror.scan_members(keys, j_snap)
    assert port == [t_eng.read(r, k) for k in keys] \
        == [j_eng.read(rj, k) for k in keys]

    # SI-V reads at the floor and at the newest commit, and a sub-store
    for wm in (t_snap.floor_seq, t_mirror.watermark):
        out = t_read(store, wm).numpy()
        np.testing.assert_array_equal(
            out, np.asarray(j_read(j_mirror.jnp_store(), jnp.int32(wm))))
        assert _decode(t_mirror, out, keys) == t_mirror.scan_at(keys, wm)
    pages = [t_mirror.page_of[k] for k in keys[::3]]
    sub = tts.gather_pages(store, pages)
    got = t_members(sub, members, t_snap.floor_seq).numpy()
    assert [tts.decode_value(row) for row in got[:len(pages)]] == \
        port[::3]

    # pages whose visible slot is older than their newest committed one
    ts = store["ts"]
    vis = tts.visible_slots_members(ts, torch.tensor(members),
                                    t_snap.floor_seq)
    newest = ts.max(dim=1).values
    older = int((ts[torch.arange(ts.shape[0]), vis.long()] < newest).sum())
    return port, older


def test_mirror_part_of_example_through_both_packages():
    values, older = _check_slice(_example_txns)
    assert values == [61, 100, 100, 100, 100, 100]
    assert older == 1                   # stock:0:2 reads its previous version


@pytest.mark.parametrize("seed", range(6))
def test_random_interleavings_through_both_packages(seed):
    _, older = _check_slice(_random_txns, (seed,))
    assert older > 0                    # previous-version reads happened


def test_example_runs_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "pt_paged_snapshot_reads",
        ROOT / "examples" / "pt_paged_snapshot_reads.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main("cpu")
    out = capsys.readouterr().out
    assert "mirror scan == rss_gather kernel == engine per-key reads" in out
    assert "view hits=" in out
