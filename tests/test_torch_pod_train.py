"""Training and serving on the reference's pod mesh ("pod", "data",
"model"; `src/repro/launch/mesh.py`'s multi-pod mesh at smoke size) on
the CPU: every rank a process of its own over gloo, rendezvous through a
file under a temporary directory.

There the batch goes over ("pod", "data") alone (`train_dp_axes`) while
fsdp2d cuts every weight over ("data", "model"), so the ranks along
"model" compute the same rows and the pod replicas hold the same pieces.
A GSPMD program equals its unsharded program, and the reference cannot
run sharded on this CPU, so the port is held against the reference's
unsharded jitted programs on the same numpy-seeded inputs, with its
weights carried by `params_from_numpy` and cut by the ported rules, at
the tolerances of tests/test_torch_fsdp_train.py and
tests/test_torch_fsdp_serve.py:

- two train steps of Qwen1.5's smoke config (f32, fsdp2d) on meshes
  (pod, data, model) of (2, 2, 1), (2, 1, 2) and (2, 2, 2), RWKV6's
  (its `wkv_scan` backward) on (2, 1, 2), and Qwen1.5 hybrid sharded
  ("tp" with FSDP and with ZeRO-2 at model 1) on (2, 2, 1): loss and
  `grad_norm` of each step on every rank, every parameter and moment
  leaf gathered after the second, and each rank's pieces bitwise equal
  to its pod replica's after every step;
- a state saved on (2, 1, 2), by pod 0's ranks alone, restored onto
  (2, 2), and one saved on (2, 2) restored onto (2, 2, 2), bitwise once
  gathered;
- `Trainer(group=)` on (2, 1, 2) against the unsharded `Trainer`;
- Qwen1.5 served on (2, 1, 2) gathered under its training placement
  (`ServeView`, the rows over "pod") and resident tensor parallel
  (`ServingEngine(group=)`, "data" = ("pod", "data")): each rank's
  prefill and 3 teacher-forced decode logits against the reference's
  jitted prefill and decode (f32, 1e-5 of max-abs), the engines' greedy
  tokens against the reference engine's;
- `norm_weight` counting each piece once over the pod mesh.

Each mesh's ranks are spawned once (`ranks`, a module fixture, two
chains of meshes on background threads while the tests compute the
reference) and run every job of that mesh (`torch_fsdp_ranks.run`)."""

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
from repro.optim import AdamWConfig as JAdamWConfig
from repro.serve import ServingEngine as JEngine
from repro.tensorstore import VersionedParamStore as JStore
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step

import repro_torch.models as TM
import torch_fsdp_ranks
from repro_torch.data import SyntheticPipeline
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import params_specs
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import Layout, spawn
from repro_torch.parallel import group as PG
from repro_torch.train import Trainer, init_state
from repro_torch.tree import leaves_with_path, path_key

POD = ("pod", "data", "model")
F32 = dict(param_dtype="float32", compute_dtype="float32",
           moment_dtype="float32")
B, S, STEPS = 8, 16, 2
OPT = dict(lr=1e-3, eps=1e-4)
STEP_TOL = {"rwkv6-3b": 1e-4}
QWEN, RWKV = "qwen1.5-0.5b", "rwkv6-3b"
# case -> (arch, config overrides (placement only), mesh)
CASES = {
    "qwen 2x2x1": (QWEN, {}, (2, 2, 1)),
    "qwen 2x1x2": (QWEN, {}, (2, 1, 2)),
    "qwen 2x2x2": (QWEN, {}, (2, 2, 2)),
    "rwkv6 2x1x2": (RWKV, {}, (2, 1, 2)),
    "qwen fsdp 2x2x1": (QWEN, {"train_sharding": "tp", "fsdp": True},
                        (2, 2, 1)),
    "qwen zero2 2x2x1": (QWEN, {"train_sharding": "tp", "zero2": True},
                         (2, 2, 1)),
}
# serving: batch, prompt, teacher-forced decode steps; the serving mesh
SB, SS, SN = 4, 9, 3
SERVE_MESH = (2, 1, 2)
# the meshes, two chains spawned side by side, each in its order (a
# restore mesh after the mesh whose save it reads)
CHAINS = [[(2, 1, 2), (2, 2), (2, 2, 2)], [(2, 2, 1)]]


def _mesh(shape):
    return Mesh(shape, POD if len(shape) == 3 else ("data", "model"))


def _name(shape):
    return "x".join(map(str, shape))


def _port_cfg(jcfg, **overrides):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d).with_overrides(**overrides)


@functools.lru_cache(maxsize=None)
def _jcfg(arch):
    """The smoke config in f32; RWKV6 one layer, as
    tests/test_torch_fsdp_train.py cuts it."""
    j = JC.smoke_variant(JC.get_config(arch)).with_overrides(**F32)
    if arch == RWKV:
        j = j.with_overrides(n_layers=1)
    return j


# the reference's computations run one at a time: the fixture's threads
# make their inputs while the tests compute the references
_LOCK = threading.RLock()


def _serial(fn):
    """`fn` cached, its calls one at a time (`_LOCK`)."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        with _LOCK:
            return cached(*args)
    return call


@_serial
def _inputs(arch):
    """(the reference's params, the port's whole state, the STEPS global
    batches of the port's pipeline, bitwise the reference's)."""
    j = _jcfg(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), j)
    tcfg = _port_cfg(j)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    state = init_state(None, tcfg, AdamWConfig(**OPT), params=tp)
    pipe = SyntheticPipeline(tcfg, batch=B, seq_len=S, device="cpu")
    return jp, state, [pipe.batch_at(i) for i in range(STEPS)]


def _by_path(tree, prefix):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                              for p in path): np.asarray(x, np.float32)
            for path, x in flat}


@_serial
def _reference(arch):
    """The reference's STEPS jitted steps: each step's loss and
    grad_norm, and the final state's leaves by path (f32 numpy)."""
    jp, _, batches = _inputs(arch)
    j, jopt = _jcfg(arch), JAdamWConfig(**OPT)
    js = j_init_state(None, j, jopt, params=jp)
    step = jax.jit(j_make_train_step(j, jopt))
    metrics = []
    for batch in batches:
        js, m = step(js, {k: jnp.asarray(x.numpy()) for k, x in
                          batch.items()})
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])})
    return metrics, {**_by_path(js["params"], "params/"),
                     **_by_path(js["opt"], "opt/")}


def _draw(jp, seed):
    """The reference's params with each constant leaf (norms, biases)
    plus 0.1 x a standard normal from numpy `seed`, so a wrong piece of
    one shows."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        a = np.asarray(x, np.float32)
        if a.size > 1 and (a == a.flat[0]).all():
            return jnp.asarray((a + 0.1 * rng.standard_normal(a.shape))
                               .astype(np.float32), x.dtype)
        return x
    return jax.tree.map(leaf, jp)


@_serial
def _serve_inputs():
    """(the reference's serving params (f32), the port's tree carried
    from them, tokens [SB, SS + SN]: the prompt, then the teacher
    tokens)."""
    j = _jcfg(QWEN)
    jp = _draw(JM.init_params(jax.random.PRNGKey(4), j), seed=5)
    toks = np.random.default_rng(5).integers(0, j.vocab_size,
                                             (SB, SS + SN))
    tree = TM.params_from_numpy(_port_cfg(j), jax.tree.map(np.asarray, jp),
                                "cpu")
    return jp, tree, toks


@_serial
def _reference_serving():
    """The reference's jitted prefill + SN teacher-forced decode logits,
    and its engine's greedy tokens and snapshot LSN for the prompts."""
    jp, _, toks = _serve_inputs()
    j = _jcfg(QWEN)
    eng = JEngine(j, JStore(slots=2), max_seq=SS + SN)
    lg, cache = eng._prefill(jp, {"tokens": jnp.asarray(toks[:, :SS])})
    want = [np.asarray(lg, np.float32)]
    for k in range(SN):
        lg, cache = eng._decode(jp, jnp.asarray(toks[:, SS + k:SS + k + 1]),
                                cache, jnp.int32(SS + k))
        want.append(np.asarray(lg, np.float32))
    store = JStore(slots=2)
    store.publish(jp)
    eng = JEngine(j, store, max_seq=SS + SN)
    eng.refresh()
    res = eng.generate({"tokens": jnp.asarray(toks[:, :SS])}, SN)
    return want, np.asarray(res.tokens), res.snapshot_lsn


def _case(name):
    arch, over, _ = CASES[name]
    return arch, _port_cfg(_jcfg(arch), **over)


def _jobs(shape, tmp):
    """Every job of a mesh, by name."""
    jobs = {}
    opt = AdamWConfig(**OPT)
    for name, (_, _, mesh) in CASES.items():
        if mesh == shape:
            arch, tcfg = _case(name)
            _, state, batches = _inputs(arch)
            jobs[name] = ("steps", (tcfg, opt, state, batches))
    qwen = _port_cfg(_jcfg(QWEN))
    _, state, batches = _inputs(QWEN)
    saves = {(2, 1, 2): "pod", (2, 2): "2x2"}
    if shape in saves:
        jobs["save"] = ("saved", (qwen, opt, state, batches[0],
                                  str(tmp / saves[shape])))
    restores = {(2, 2): "pod", (2, 2, 2): "2x2"}
    if shape in restores:
        jobs["restore"] = ("restore", (qwen, opt,
                                       str(tmp / restores[shape])))
    if shape == SERVE_MESH:
        jobs["trainer"] = ("trainer", (qwen, opt, B, S,
                                       str(tmp / "trainer")))
        _, tree, toks = _serve_inputs()
        prompt = {"tokens": torch.from_numpy(toks[:, :SS])}
        teacher = torch.from_numpy(toks[:, SS:])
        specs = params_specs(_mesh(shape), qwen).specs
        jobs["serve logits"] = ("serve logits", (qwen, tree, specs, prompt,
                                                 teacher))
        jobs["serve engine"] = ("serve engine", (qwen, tree, specs, prompt,
                                                 SN))
        jobs["tp logits"] = ("tp logits", (qwen, tree, prompt, teacher))
        jobs["tp engine"] = ("tp engine", (qwen, tree, prompt, SN))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(mesh shape) -> {job: [each rank's result]}.  Every mesh is
    spawned once, each chain of meshes on a thread of its own (its jobs'
    inputs made there), while the tests compute the reference."""
    tmp = tmp_path_factory.mktemp("pod")
    meshes = [shape for chain in CHAINS for shape in chain]
    dirs = {shape: tmp_path_factory.mktemp(f"mesh{_name(shape)}")
            for shape in meshes}
    out, done = {}, {shape: threading.Event() for shape in meshes}

    def work(chain):
        for shape in chain:
            mesh = _mesh(shape)
            try:
                jobs = _jobs(shape, tmp)
                got = spawn(torch_fsdp_ranks.run, mesh, backend="gloo",
                            devices=["cpu"] * mesh.size, tmpdir=dirs[shape],
                            args=(list(jobs.values()),))
                out[shape] = {name: [r[i] for r in got]
                              for i, name in enumerate(jobs)}
            except Exception as e:          # raised in the tests
                out[shape] = e
            done[shape].set()

    threads = [threading.Thread(target=work, args=(chain,), daemon=True)
               for chain in CHAINS]
    for t in threads:
        t.start()

    def get(shape):
        done[shape].wait()
        if isinstance(out[shape], Exception):
            raise out[shape]
        return out[shape]
    yield get
    for t in threads:
        t.join()


def _np(x):
    return x.detach().float().numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_two_steps_on_a_pod_mesh_match_the_reference(ranks, case):
    """Each step's loss and grad_norm on every rank, every gathered
    parameter (rtol = atol = tol) and moment (tol of its max-abs) leaf
    after the second step, against the reference's unsharded steps; the
    pod replicas bitwise equal after every step."""
    arch, _, shape = CASES[case]
    metrics, want = _reference(arch)
    tol = STEP_TOL.get(arch, 1e-5)
    results = ranks(shape)[case]
    for r in results:
        assert r["replicas"] == [True] * STEPS
        for got, ref in zip(r["metrics"], metrics):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], ref[k], rtol=tol,
                                           err_msg=k)
    got = {path_key(p): x for p, x in leaves_with_path(results[0]["state"])}
    want = dict(want)
    assert int(got.pop("step")) == STEPS
    assert int(got.pop("opt/count")) == int(want.pop("opt/count")) == STEPS
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = _np(got[k])
        if k.startswith("params/"):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= tol * scale, k


def _bitwise(a, b):
    a, b = leaves_with_path(a), leaves_with_path(b)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path_key(p)


@pytest.mark.parametrize("saved,restored", [((2, 1, 2), (2, 2)),
                                            ((2, 2), (2, 2, 2))],
                         ids=["pod-to-2x2", "2x2-to-pod"])
def test_elastic_restore_between_a_pod_mesh_and_2x2(ranks, saved,
                                                    restored):
    """A state saved under one mesh restores onto the other, bitwise
    once gathered, both ways."""
    state, _ = ranks(saved)["save"][0]
    _bitwise(state, ranks(restored)["restore"][0])


def test_a_pod_mesh_saves_each_piece_once(ranks):
    """On (2, 1, 2) only pod 0's ranks gather for the save: pod 1 holds
    replicas of the same pieces."""
    calls = [n for _, n in ranks((2, 1, 2))["save"]]
    mesh = _mesh((2, 1, 2))
    for r, n in enumerate(calls):
        pod = PG.coords_of(mesh, r)["pod"]
        assert (n > 0) == (pod == 0), calls


def test_trainer_on_a_pod_mesh_matches_the_unsharded_trainer(ranks):
    """`Trainer(group=)` on (2, 1, 2): 3 steps through an injected
    failure restored from the sharded checkpoint, each rank publishing
    into its own store (a reader pinned at v1 reads v1 bitwise), against
    the unsharded `Trainer`'s 3 steps."""
    tcfg = _port_cfg(_jcfg(QWEN))
    ref = Trainer(tcfg, batch=B, seq_len=S, opt=AdamWConfig(**OPT), seed=0,
                  device="cpu")
    log = ref.run(3)
    out = ranks(SERVE_MESH)["trainer"]
    for r in out:
        np.testing.assert_allclose(r["losses"], [m["loss"] for m in log],
                                   rtol=1e-5)
        assert r["v1_bitwise"]
    assert len({r["lsns"] for r in out}) == 1
    for (p, a), (_, b) in zip(leaves_with_path(out[0]["params"]),
                              leaves_with_path(ref.state["params"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=path_key(p))


@pytest.mark.parametrize("how", ["serve", "tp"])
def test_serving_on_a_pod_mesh_matches_the_reference(ranks, how):
    """Qwen1.5 on (2, 1, 2), gathered under its training placement
    ("serve": rows over ("pod",), whole-headed caches, no all-reduce) or
    resident tensor parallel ("tp": rows over ("pod", "data"), the KV
    heads and vocabulary over "model"): each rank's logits for its rows
    within 1e-5 of the reference's max-abs."""
    want, _, _ = _reference_serving()
    j = _jcfg(QWEN)
    rows = SB // 2
    mesh = _mesh(SERVE_MESH)
    for rank, result in enumerate(ranks(SERVE_MESH)[f"{how} logits"]):
        r, got, shapes = result[:3]
        assert r == PG.coords_of(mesh, rank)["pod"]
        heads = j.n_kv_heads // (2 if how == "tp" else 1)
        assert all(e["k"] == (j.n_periods, rows, SS + SN, heads, j.head_dim)
                   for e in shapes)
        if how == "serve":
            assert result[4] == 0           # no all-reduce
        for step, (g, w) in enumerate(zip(got, want)):
            w = w[r * rows:(r + 1) * rows]
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= 1e-5, f"rank {rank} step {step}: {err:.3g}"


@pytest.mark.parametrize("how", ["serve", "tp"])
def test_engines_on_a_pod_mesh_match_the_reference_engine(ranks, how):
    """`ServingEngine(group=, specs=)` and `ServingEngine(group=)` on
    (2, 1, 2): every rank's greedy tokens and snapshot LSN are the
    reference engine's."""
    _, tokens, lsn = _reference_serving()
    for result in ranks(SERVE_MESH)[f"{how} engine"]:
        np.testing.assert_array_equal(result[0], tokens)
        assert result[1] == lsn


@pytest.mark.parametrize("shape", [(2, 1, 2), (2, 2, 2), (2, 2, 1)])
def test_norm_weight_counts_each_piece_once_on_a_pod_mesh(shape):
    """Summed over the ranks, `norm_weight` of a leaf is the number of its
    distinct pieces: the pieces of a leaf cut over ("data", "model")
    once in pod 0, a whole leaf once on the mesh."""
    mesh = _mesh(shape)
    cfg = _port_cfg(_jcfg(QWEN))
    layouts = [Layout(PG.MeshGroup(mesh, r, "gloo", torch.device("cpu"),
                                   PG.coords_of(mesh, r)), cfg,
                      AdamWConfig(**OPT)) for r in range(mesh.size)]
    for key in ("blocks/0/mixer/wq", "embed", "final_norm/w"):
        total = sum(lay.norm_weight(key) for lay in layouts)
        cut = layouts[0]._cut(layouts[0].spec(f"opt/m/{key}"))
        assert total == (1 if cut is None else layouts[0]._pieces(cut[1]))
        owners = [r for r, lay in enumerate(layouts) if lay.norm_weight(key)]
        assert all(PG.coords_of(mesh, r)["pod"] == 0 for r in owners)
