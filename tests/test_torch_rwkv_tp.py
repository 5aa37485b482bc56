"""RWKV6 served tensor parallel over a mesh of ranks (`ServingEngine(
group=)`, `parallel.tensor.serve_specs`) on the CPU: every rank a
process of its own over gloo, rendezvous through a file under a
temporary directory.

The serving layout cuts RWKV6's vocabulary over "model" (`embed` by
rows, summed over "model" after the lookup; `lm_head` by columns, the
logits vocab-sharded) and keeps its time mix and channel mix whole on
every rank, so a rank runs the whole recurrence on its rows and sums
none of their outputs (a sum there would scale them by the model
degree).  The port's sharded prefill and teacher-forced decode are held
against the reference's unsharded jitted ones (the reference cannot run
sharded on this CPU; a GSPMD program equals its unsharded program), its
weights carried by `params_from_numpy`, the leaves it initialises to
constants drawn from a numpy seed: RWKV6's smoke config on meshes (data,
model) of (1, 2) and (2, 2) and on the pod mesh (pod, data, model) of
(2, 1, 2), f32 within 1e-5 and bf16 within 3e-2 of the reference's
max-abs, each rank's logits gathered over "model" for its rows, its
recurrent state whole-headed; the engine's greedy tokens against the
reference engine's (f32).  Then the layout's pieces and the plan of
RWKV6-3B on the production meshes.

Each mesh's ranks are spawned once (`ranks`, a module fixture, on
background threads while the tests compute the reference) and run
every job of that mesh (`torch_tp_ranks.run`)."""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import repro.configs as JC
import repro.models as JM
from repro.serve import ServingEngine as JEngine
from repro.tensorstore import VersionedParamStore as JStore

import repro_torch.models as TM
import torch_tp_ranks
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.parallel import check_tp, serve_specs, spawn
from repro_torch.parallel import group as PG
from repro_torch.parallel.tensor import cut_dims

RWKV = "rwkv6-3b"
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "2x1x2": (2, 1, 2)}
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
B, S, N = 4, 9, 3               # batch, prompt, decode steps
# RWKV6's leaves the reference initialises to constants, drawn instead
# (any other constant leaf c: c + 0.1 x a standard normal)
DRAWN = {"mix_base": lambda r, s: r.uniform(0, 1, s),
         "mix_k": lambda r, s: r.uniform(0, 1, s),
         "mix_r": lambda r, s: r.uniform(0, 1, s),
         "w_base": lambda r, s: r.uniform(-6, -1, s)}
# the meshes, two chains spawned side by side
CHAINS = [["2x2", "1x2"], ["2x1x2"]]


def _mesh(name):
    shape = MESHES[name]
    return Mesh(shape, ("data", "model") if len(shape) == 2
                else ("pod", "data", "model"))


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


@functools.lru_cache(maxsize=None)
def _jcfg(dtype):
    j = JC.smoke_variant(JC.get_config(RWKV))
    return j.with_overrides(param_dtype="float32", compute_dtype="float32") \
        if dtype == "float32" else j


def _draw(jp, seed):
    """The reference's params with its constant leaves drawn from numpy
    `seed` (DRAWN by name, else the constant plus noise)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        a = np.asarray(x, np.float32)
        if name in DRAWN:
            a = DRAWN[name](rng, x.shape)
        elif a.size > 1 and (a == a.flat[0]).all():
            a = a + 0.1 * rng.standard_normal(x.shape)
        else:
            return x
        return jnp.asarray(a.astype(np.float32), x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, jp)


# the reference's computations run one at a time (the fixture's threads
# make their inputs while the tests compute the reference)
_LOCK = threading.RLock()


def _serial(fn):
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        with _LOCK:
            return cached(*args)
    return call


@_serial
def _inputs(dtype):
    """(the reference's params, the port's tree carried from them,
    tokens [B, S + N]: the prompt, then the teacher tokens)."""
    j = _jcfg(dtype)
    jp = _draw(JM.init_params(jax.random.PRNGKey(4), j), seed=5)
    toks = np.random.default_rng(5).integers(0, j.vocab_size, (B, S + N))
    tree = TM.params_from_numpy(_port_cfg(j), jax.tree.map(np.asarray, jp),
                                "cpu")
    return jp, tree, toks


@_serial
def _reference(dtype):
    """The reference engine's jitted prefill + N teacher-forced decode
    logits (f32 numpy)."""
    jp, _, toks = _inputs(dtype)
    eng = JEngine(_jcfg(dtype), JStore(slots=2), max_seq=S + N)
    lg, cache = eng._prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    want = [np.asarray(lg, np.float32)]
    for k in range(N):
        lg, cache = eng._decode(jp, jnp.asarray(toks[:, S + k:S + k + 1]),
                                cache, jnp.int32(S + k))
        want.append(np.asarray(lg, np.float32))
    return want


@_serial
def _reference_engine():
    """The reference engine's greedy tokens and snapshot LSN (f32)."""
    jp, _, toks = _inputs("float32")
    store = JStore(slots=2)
    store.publish(jp)
    eng = JEngine(_jcfg("float32"), store, max_seq=S + N)
    eng.refresh()
    res = eng.generate({"tokens": jnp.asarray(toks[:, :S])}, N)
    return np.asarray(res.tokens), res.snapshot_lsn


def _jobs():
    """Every mesh's jobs, by key: ("logits", dtype) and "engine"."""
    jobs = {}
    for dtype in DTYPES:
        _, tree, toks = _inputs(dtype)
        jobs["logits", dtype] = ("logits", (
            _port_cfg(_jcfg(dtype)), tree,
            {"tokens": torch.from_numpy(toks[:, :S])},
            torch.from_numpy(toks[:, S:])))
    _, tree, toks = _inputs("float32")
    jobs["engine"] = ("engine", (_port_cfg(_jcfg("float32")), tree,
                                 {"tokens": torch.from_numpy(toks[:, :S])},
                                 N))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(mesh name) -> [each rank's {job key: result}].  Every mesh
    is spawned once, each chain on a thread of its own."""
    names = [n for chain in CHAINS for n in chain]
    dirs = {n: tmp_path_factory.mktemp(f"mesh{n}") for n in names}
    out, done = {}, {n: threading.Event() for n in names}

    def work(chain):
        for name in chain:
            mesh = _mesh(name)
            try:
                jobs = _jobs()
                got = spawn(torch_tp_ranks.run, mesh, backend="gloo",
                            devices=["cpu"] * mesh.size, tmpdir=dirs[name],
                            args=(list(jobs.values()),))
                out[name] = [dict(zip(jobs, r)) for r in got]
            except Exception as e:          # raised in the tests
                out[name] = e
            done[name].set()

    threads = [threading.Thread(target=work, args=(chain,), daemon=True)
               for chain in CHAINS]
    for t in threads:
        t.start()

    def get(name):
        done[name].wait()
        if isinstance(out[name], Exception):
            raise out[name]
        return out[name]
    yield get
    for t in threads:
        t.join()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_rwkv_prefill_and_decode_match_the_reference(
        ranks, mesh_name, dtype):
    """Every rank's prefill and decode logits, gathered over "model",
    for its rows (over "data", ("pod", "data") on the pod mesh) against
    the reference's; every rank's recurrent state whole-headed."""
    mesh = _mesh(mesh_name)
    want = _reference(dtype)
    j = _jcfg(dtype)
    data = mesh.size // mesh.shape["model"]
    rows = B // data
    H, Nh = j.d_model // j.rwkv_head_dim, j.rwkv_head_dim
    state = {"shift": (j.n_periods, rows, j.d_model),
             "wkv": (j.n_periods, rows, H, Nh, Nh),
             "cmix_shift": (j.n_periods, rows, j.d_model)}
    for rank, results in enumerate(ranks(mesh_name)):
        d, got, shapes, _ = results["logits", dtype]
        coords = PG.coords_of(mesh, rank)
        assert d == coords.get("pod", 0) * mesh.shape["data"] \
            + coords["data"]
        assert shapes == [state] * len(j.pattern)
        for step, (g, w) in enumerate(zip(got, want)):
            w = w[d * rows:(d + 1) * rows]
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= TOL[dtype], \
                f"rank {rank} step {step}: max |d| / max |want| {err:.3g}"


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rwkv_engine_over_the_mesh_matches_the_reference_engine(
        ranks, mesh_name):
    tokens, lsn = _reference_engine()
    for results in ranks(mesh_name):
        got, got_lsn = results["engine"]
        np.testing.assert_array_equal(got, tokens)
        assert got_lsn == lsn


def test_the_serving_layout_cuts_only_rwkvs_vocabulary():
    """`serve_specs` of RWKV6: `embed` by rows and `lm_head` by columns
    over "model"; every time-mix and channel-mix leaf whole (the rules'
    attention patterns would cut `wk`, `wv` and `wo`)."""
    cfg = smoke_variant(get_config(RWKV))
    specs = serve_specs(Mesh((2, 2), ("data", "model")), cfg,
                        TM.init_params(cfg, None, "meta"))
    assert specs["embed"] == ("model", None)
    assert specs["lm_head"] == (None, "model")
    for path, spec in specs.items():
        if path.startswith("blocks/"):
            assert all(e is None for e in spec), (path, spec)
    assert cut_dims(cfg) == ["vocab_size"]


@pytest.mark.parametrize("shape,axes", [
    ((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
    ((2, 1, 2), ("pod", "data", "model"))])
def test_rwkv_runs_on_a_mesh(shape, axes):
    """RWKV6-3B passes `check_tp` wherever the model degree divides its
    vocabulary (its 40 heads are never cut), the production meshes'
    16-way model axis too, and its cache keeps every head."""
    cfg = get_config(RWKV)
    check_tp(cfg, Mesh(shape, axes))
    for multi_pod in (False, True):
        check_tp(cfg, make_production_mesh(multi_pod=multi_pod))
    spec = TM.cache_spec(cfg.with_overrides(n_layers=1), 2, 16, model=16)
    assert spec["blocks"][0]["wkv"][0] == (1, 2, 40, 64, 64)
