"""Sharded training over a mesh of ranks (`repro_torch.parallel.fsdp`,
`make_train_step(group=)`, `Trainer(group=)`, the checkpoint manager's
`group=` / `specs=`) on the CPU: every rank a process of its own over
gloo, rendezvous through a file under a temporary directory.

A GSPMD program equals its unsharded program, and the reference cannot
run sharded on this CPU, so the port's sharded step is held against the
reference's unsharded jitted step on the same global batch, with the
reference's weights carried by `params_from_numpy` and cut by the
ported rules (`param_shardings` / `opt_shardings` / `train_dp_axes`):
loss and `grad_norm` on every rank, and every parameter and moment leaf
gathered after one step, in f32 (moments too: `F32`) within
tests/test_torch_train.py's tolerances (1e-5; the scans' 1e-4 and 2e-4;
parameters rtol = atol, gradients and moments of each leaf's max-abs;
AdamW eps 1e-4 as there).  Cases: Qwen1.5's smoke config (fsdp2d) on
meshes (data, model) of (1, 2), (2, 2) under remat "dots" and (4, 1);
Mixtral (MoE, sliding window), Jamba (Mamba: the `ssm_scan` backward),
RWKV6 (the `wkv_scan` backward) and Qwen2-VL (M-RoPE positions cut at
dim 1, 2 microbatches) on (2, 2); Qwen1.5 under train_sharding "tp"
with FSDP and with ZeRO-2 on (2, 1); Whisper (plain data parallelism)
on (2, 1); on (2, 2) a batch whose ranks hold different counts of
masked labels (rank 0 none), a leaf `sanitize` leaves whole (d_ff 250
over 4 ranks) and int8 compression with its error-feedback pieces.
Then: the gathers a step (2 a period under remat, 1 without, and one of
the top-level leaves), `init_local_state` against the pieces of
`init_state`, `Trainer(group=)` against the unsharded `Trainer` through
an injected failure with a reader pinned at v1 on every rank, the twins
of tests/test_launch_small.py's two mesh tests (a step on (4, 2), a save
there restored onto (2, 4)), and the refusals.

Each mesh's ranks are spawned once (`ranks`, a module fixture) and run
every job of that mesh (`torch_fsdp_ranks.run`)."""

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
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step

import repro_torch.models as TM
import torch_fsdp_ranks
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import SyntheticPipeline
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import check_train, spawn
from repro_torch.parallel import group as PG
from repro_torch.parallel.fsdp import Layout
from repro_torch.train import Trainer, init_state
from repro_torch.tree import leaves_with_path, path_key

F32 = dict(param_dtype="float32", compute_dtype="float32",
           moment_dtype="float32")
B, S = 8, 16
OPT = dict(lr=1e-3, eps=1e-4)
STEP_TOL = {"rwkv6-3b": 1e-4, "jamba-1.5-large-398b": 2e-4}
# the scan families' pattern positions, one layer each: RWKV6's one
# layer kind, Jamba's Mamba layer (the MoE and attention layers are
# Mixtral's and Qwen's cases)
STEP_POSITIONS = {"rwkv6-3b": (0,), "jamba-1.5-large-398b": (0,)}
# int8 compression: an element whose quantized value lies within TIE of
# a rounding boundary (in units of the int8 step) may round either way
# under another f32 summation order; the case holds the rest at the f32
# tolerance and counts those (`_ties`).  The residual `ef` = g - deq
# keeps the gradient's summation noise at the gradient's scale, while
# its own max-abs is half an int8 step (1/254 of the gradient's): it is
# held within the tolerance of the gradient's max-abs
TIE = 1e-3
# the config fields that change the reference's numbers (the placement
# and remat fields change only the port's layout)
NUMERIC = ("microbatches", "d_ff")
# case -> (arch, config overrides, AdamW overrides, mesh, batch edit)
CASES = {
    "qwen 1x2": ("qwen1.5-0.5b", {}, {}, (1, 2), None),
    "qwen 2x2 dots": ("qwen1.5-0.5b", {"remat": "dots"}, {}, (2, 2), None),
    "qwen 4x1": ("qwen1.5-0.5b", {}, {}, (4, 1), None),
    "mixtral 2x2": ("mixtral-8x7b", {}, {}, (2, 2), None),
    "jamba 2x2": ("jamba-1.5-large-398b", {}, {}, (2, 2), None),
    "rwkv6 2x2": ("rwkv6-3b", {}, {}, (2, 2), None),
    "qwen2-vl 2x2 microbatches": ("qwen2-vl-72b", {"microbatches": 2}, {},
                                  (2, 2), None),
    "qwen tp fsdp 2x1": ("qwen1.5-0.5b", {"train_sharding": "tp",
                                          "fsdp": True}, {}, (2, 1), None),
    "qwen tp zero2 2x1": ("qwen1.5-0.5b", {"train_sharding": "tp",
                                           "zero2": True}, {}, (2, 1), None),
    "whisper 2x1": ("whisper-tiny", {}, {}, (2, 1), None),
    "qwen masked 2x2": ("qwen1.5-0.5b", {}, {}, (2, 2), "masked"),
    "qwen d_ff 250 2x2": ("qwen1.5-0.5b", {"d_ff": 250}, {}, (2, 2), None),
    "qwen compress 2x2": ("qwen1.5-0.5b", {}, {"compress": True}, (2, 2),
                          None),
}
TWIN = "qwen1.5-0.5b"


def _mesh(shape):
    return Mesh(shape, ("data", "model"))


def _name(shape):
    return "x".join(map(str, shape))


def _port_cfg(jcfg, **overrides):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d).with_overrides(**overrides)


@functools.lru_cache(maxsize=None)
def _jcfg(arch, numeric):
    j = JC.smoke_variant(JC.get_config(arch)).with_overrides(**F32)
    if arch in STEP_POSITIONS:
        pos = STEP_POSITIONS[arch]
        j = j.with_overrides(pattern=tuple(j.pattern[i] for i in pos),
                             n_layers=len(pos))
    return j.with_overrides(**dict(numeric))


def _batch(tcfg, edit):
    """The port pipeline's step-0 batch of B x S (the reference's,
    bitwise), edited: "masked" masks all of rows 0-1 (rank 0's on (2,
    2)), the tail of row 2 and the head of row 5."""
    batch = SyntheticPipeline(tcfg, batch=B, seq_len=S,
                              device="cpu").batch_at(0)
    if edit == "masked":
        labels = batch["labels"].clone()
        labels[:2] = -1
        labels[2, 5:] = -1
        labels[5, :3] = -1
        batch = dict(batch, labels=labels)
    return batch


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _inputs(arch, numeric, opt, edit):
    """(the reference's params, config and AdamW config, the port's
    whole state and the batch)."""
    j = _jcfg(arch, numeric)
    jopt = JAdamWConfig(**OPT, **dict(opt))
    jp = JM.init_params(jax.random.PRNGKey(0), j)
    tcfg = _port_cfg(j)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    state = init_state(None, tcfg, AdamWConfig(**OPT, **dict(opt)),
                       params=tp)
    return jp, j, jopt, state, _batch(tcfg, edit)


def _jax_batch(batch):
    return {k: jnp.asarray(x.numpy()) for k, x in batch.items()}


def _by_path(tree, prefix):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                              for p in path): np.asarray(x, np.float32)
            for path, x in flat}


@functools.lru_cache(maxsize=None)
def _reference(arch, numeric, opt, edit):
    """The reference's step: loss, grad_norm, and the new state's leaves
    by path (f32 numpy)."""
    jp, j, jopt, _, batch = _inputs(arch, numeric, opt, edit)
    js = j_init_state(None, j, jopt, params=jp)
    new, m = jax.jit(j_make_train_step(j, jopt))(js, _jax_batch(batch))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "leaves": {**_by_path(new["params"], "params/"),
                       **_by_path(new["opt"], "opt/")}}


@functools.lru_cache(maxsize=None)
def _ties(arch, numeric, opt, edit):
    """{parameter path: (the elements whose int8 quantization in the
    reference's first step lies within TIE of a rounding boundary, the
    gradient's max-abs)}."""
    jp, j, _, _, batch = _inputs(arch, numeric, opt, edit)
    _, g = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, j, b)))(
        jp, _jax_batch(batch))
    out = {}
    for key, x in _by_path(g, "").items():
        amax = max(float(np.abs(x).max()), 1e-12)
        t = np.abs(x) * 127.0 / amax
        out[key] = (np.abs(t - np.floor(t) - 0.5) < TIE, amax)
    return out


def _case(name):
    """(port config, AdamW config, reference key) of a case."""
    arch, over, opt, _, edit = CASES[name]
    numeric = tuple(sorted((k, v) for k, v in over.items()
                           if k in NUMERIC))
    tcfg = _port_cfg(_jcfg(arch, numeric), **over)
    key = (arch, numeric, tuple(sorted(opt.items())), edit)
    return tcfg, AdamWConfig(**OPT, **opt), key


@functools.lru_cache(maxsize=None)
def _twin():
    """tests/test_launch_small.py's cell: Qwen1.5 smoke with fsdp=True
    (bf16, the default AdamW), batch ones(8, 16): (port config, state,
    batch, the reference's state and jitted step)."""
    j = JC.smoke_variant(JC.get_config(TWIN)).with_overrides(fsdp=True)
    jopt = JAdamWConfig()
    js = j_init_state(jax.random.PRNGKey(0), j, jopt)
    tcfg = _port_cfg(j)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, js["params"]),
                              "cpu")
    state = init_state(None, tcfg, AdamWConfig(), params=tp)
    batch = {"tokens": torch.ones((8, 16), dtype=torch.int32),
             "labels": torch.ones((8, 16), dtype=torch.int32)}
    return tcfg, state, batch, js, jax.jit(j_make_train_step(j, jopt))


def _twin_loss():
    """The reference's unsharded loss on the twin's cell."""
    _, _, batch, js, step = _twin()
    return float(step(js, _jax_batch(batch))[1]["loss"])


def _jobs(shape, tmp):
    """Every job of a mesh, by case name."""
    jobs = {}
    for name, (_, _, _, mesh, _) in CASES.items():
        if mesh == shape:
            tcfg, opt, key = _case(name)
            state, batch = _inputs(*key)[3:]
            jobs[name] = ("step", (tcfg, opt, state, batch))
    if shape == (2, 2):
        tcfg, opt, _ = _case("qwen 1x2")
        jobs["init"] = ("init", (tcfg.with_overrides(d_ff=250), opt, 3))
        jobs["trainer"] = ("trainer", (tcfg, opt, B, S,
                                       str(tmp / "trainer")))
    if shape == (4, 2):
        tcfg, state, batch = _twin()[:3]
        jobs["twin step"] = ("step", (tcfg, AdamWConfig(), state, batch))
        jobs["twin save"] = ("save", (tcfg, AdamWConfig(), state, batch,
                                      str(tmp / "elastic")))
    if shape == (2, 4):
        jobs["twin restore"] = ("restore", (_twin()[0], AdamWConfig(),
                                            str(tmp / "elastic")))
    return jobs


# the meshes, two chains spawned side by side, each in its order (the
# restore mesh (2, 4) after the save mesh (4, 2))
CHAINS = [[(1, 2), (2, 2), (4, 1)], [(2, 1), (4, 2), (2, 4)]]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(mesh shape) -> {job: [each rank's result]}.  Every mesh is
    spawned once, each chain of meshes on a thread of its own (its jobs'
    inputs made there), while the tests compute the reference's
    steps."""
    tmp = tmp_path_factory.mktemp("fsdp")
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


def _close_leaf(key, got, want, tol, skip=None, scale=None):
    """Parameters rtol = atol = tol; moments within tol of their
    max-abs (or of `scale`); the elements of `skip` left out."""
    got = _np(got)
    if skip is not None:
        got, want = got[~skip], want[~skip]
    if key.startswith("params/"):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=key)
    else:
        scale = scale or max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, f"{key}: {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_reference(ranks, case):
    arch, _, _, shape, _ = CASES[case]
    _, _, key = _case(case)
    want = _reference(*key)
    tol = STEP_TOL.get(arch, 1e-5)
    ties = _ties(*key) if CASES[case][2].get("compress") else {}
    for k, (t, _) in ties.items():
        assert t.sum() <= 1e-2 * t.size, k
    results = ranks(shape)[case]
    for r in results:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][k], want[k], rtol=tol,
                                       err_msg=k)
    state = results[0]["state"]
    got = {path_key(p): x for p, x in leaves_with_path(state)
           if p[-1] != "expert_ids"}
    want = dict(want["leaves"])
    assert int(got.pop("step")) == 1 and int(got.pop("opt/count")) == 1
    assert int(want.pop("opt/count")) == 1
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        param = k.split("/", 2)[-1] if k.startswith("opt/") \
            else k.removeprefix("params/")
        skip, amax = ties.get(param, (None, None))
        _close_leaf(k, got[k], w, tol, skip,
                    amax if k.startswith("opt/ef/") else None)


def test_a_rank_without_unmasked_labels_still_weighs_the_global_mean(
        ranks):
    """On (2, 2) rank 0's rows are all masked and the others' counts
    differ: the loss is the global masked mean (a mean of the ranks'
    means would differ from it by far more than the tolerance)."""
    _, _, key = _case("qwen masked 2x2")
    batch, want = _inputs(*key)[4], _reference(*key)
    rows = batch["labels"].reshape(4, 2, S)
    counts = (rows >= 0).sum(dim=(1, 2)).tolist()
    assert counts[0] == 0 and len(set(counts)) > 2
    got = [r["metrics"]["loss"] for r in ranks((2, 2))["qwen masked 2x2"]]
    assert len(set(got)) == 1 and abs(got[0] - want["loss"]) <= \
        1e-5 * want["loss"]


def test_a_leaf_the_mesh_does_not_divide_stays_whole(ranks):
    """d_ff 250 over 4 ranks: `sanitize` replicates the MLP's weights,
    each rank holds them whole and their gradients are all-reduced."""
    tcfg, opt, _ = _case("qwen d_ff 250 2x2")
    layout = Layout(PG.MeshGroup(_mesh((2, 2)), 0, "gloo",
                                 torch.device("cpu"),
                                 {"data": 0, "model": 0}), tcfg, opt)
    assert layout.spec("params/blocks/0/mlp/w_up") == (None, None, None)
    assert layout.spec("params/blocks/0/mixer/wq") == (
        None, ("data", "model"), None)
    for r in ranks((2, 2))["qwen d_ff 250 2x2"]:
        if r["pieces"] is not None:
            assert tuple(r["pieces"]["blocks/0/mlp/w_up"].shape) == (
                tcfg.n_periods, tcfg.d_model, 250)


@pytest.mark.parametrize("case,per_period", [("qwen 2x2 dots", 2),
                                             ("qwen 1x2", 1)])
def test_gathers_a_step(ranks, case, per_period):
    """A period's leaves are gathered once in the forward and once more
    in the backward's recompute under remat; the top-level leaves once;
    a reduce-scatter for each gather of the forward."""
    tcfg, _, _ = _case(case)
    for r in ranks(CASES[case][3])[case]:
        assert r["gathers"] == per_period * tcfg.n_periods + 1
        assert r["reduce_scatters"] == tcfg.n_periods + 1


def test_init_local_state_equals_the_pieces_of_init_state(ranks):
    assert ranks((2, 2))["init"] == [[]] * 4


def test_trainer_over_the_mesh_matches_the_unsharded_trainer(ranks,
                                                             tmp_path):
    """`Trainer(group=)`: 3 steps, a failure injected before step 2 and
    restored from the sharded step-2 checkpoint, against the unsharded
    `Trainer`'s uninterrupted 3 steps; each rank's reader pinned at v1
    reads the rank's v1 pieces bitwise; every rank's store at the same
    commit LSNs."""
    tcfg, opt, _ = _case("qwen 1x2")
    ref = Trainer(tcfg, batch=B, seq_len=S, opt=opt, seed=0, device="cpu")
    log = ref.run(3)
    out = ranks((2, 2))["trainer"]
    for r in out:
        np.testing.assert_allclose(r["losses"], [m["loss"] for m in log],
                                   rtol=1e-5)
        assert r["v1_bitwise"]
    assert len({r["lsns"] for r in out}) == 1
    pinned, visible = out[0]["lsns"]
    assert visible > pinned > 0
    for (p, a), (_, b) in zip(leaves_with_path(out[0]["params"]),
                              leaves_with_path(ref.state["params"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=path_key(p))


def test_step_on_a_4x2_mesh_twin(ranks):
    """tests/test_launch_small.py:30-58 on the port: the step on (4, 2)
    gives the reference's unsharded loss (bf16: 3e-2, the repo's bf16
    bound) and a parameter lies in more than one piece."""
    loss = _twin_loss()
    out = ranks((4, 2))["twin step"]
    for r in out:
        assert abs(r["metrics"]["loss"] - loss) <= 3e-2 * abs(loss)
    first, last = out[0]["pieces"], out[-1]["pieces"]
    whole = dict((path_key(p), x) for p, x in
                 leaves_with_path(out[0]["state"]["params"]))
    cut = [k for k in first if first[k].numel() < whole[k].numel()]
    assert "blocks/0/mixer/wq" in cut
    assert all(first[k].numel() * 8 == whole[k].numel() for k in cut)
    assert any(not torch.equal(first[k], last[k]) for k in cut)


def test_elastic_restore_across_meshes_twin(ranks):
    """tests/test_launch_small.py:61-91 on the port: the state saved on
    (4, 2) restores onto (2, 4), bitwise once gathered."""
    saved = ranks((4, 2))["twin save"][0]
    restored = ranks((2, 4))["twin restore"][0]
    a, b = leaves_with_path(saved), leaves_with_path(restored)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path_key(p)


POD = ("pod", "data", "model")


@pytest.mark.parametrize("overrides,mesh,match", [
    ({"train_sharding": "tp", "fsdp": True}, Mesh((1, 2), ("data",
                                                           "model")),
     "Tensor-parallel training"),
    # "tp" at model 2 stays refused on the pod mesh too
    ({"train_sharding": "tp", "fsdp": True}, Mesh((2, 1, 2), POD),
     "Tensor-parallel training"),
])
def test_training_placements_the_port_does_not_run_are_refused(
        overrides, mesh, match):
    cfg = smoke_variant(get_config("qwen1.5-0.5b")).with_overrides(
        **overrides)
    with pytest.raises(ValueError, match=match):
        check_train(cfg, mesh)
    check_train(cfg, _mesh((1, 1)))             # one device: trains
    check_train(cfg.with_overrides(train_sharding="fsdp2d"),
                _mesh((2, 2)))


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1), (2, 1, 2)])
def test_training_on_a_pod_mesh_is_accepted(shape):
    """The reference's pod mesh trains: fsdp2d cuts a weight over
    ("data", "model") and the batch goes over ("pod", "data") alone (a
    layout of one axis of one rank keeps only the others); "tp" with
    FSDP at model 1 cuts over "data" (hybrid sharded)."""
    mesh = Mesh(shape, POD)
    cfg = smoke_variant(get_config("qwen1.5-0.5b"))
    check_train(cfg, mesh)
    group = PG.MeshGroup(mesh, 0, "gloo", torch.device("cpu"),
                         PG.coords_of(mesh, 0))
    layout = Layout(group, cfg, AdamWConfig())
    big = tuple(a for a in ("pod", "data") if mesh.shape[a] > 1)
    assert layout.batch_axes == big
    cut = tuple(a for a in ("data", "model") if mesh.shape[a] > 1)
    assert layout._cut(layout.spec("params/blocks/0/mixer/wq")) == \
        ((1, cut) if cut else None)
    hybrid = cfg.with_overrides(train_sharding="tp", fsdp=True)
    check_train(hybrid, Mesh(shape[:2] + (1,), POD))


def test_microbatches_the_batch_ranks_do_not_divide_are_refused():
    cfg = smoke_variant(get_config("qwen1.5-0.5b")).with_overrides(
        microbatches=2)
    layout = Layout(PG.MeshGroup(_mesh((2, 2)), 1, "gloo",
                                 torch.device("cpu"),
                                 {"data": 0, "model": 1}), cfg,
                    AdamWConfig())
    batch = {"tokens": torch.zeros((12, S), dtype=torch.int32)}
    with pytest.raises(ValueError, match="Every rank in every microbatch"):
        layout.rows(batch, 2)
    # 16 rows: each block of 8 cut 4 ways, rank 1 takes rows 2-3 of each
    rows = layout.rows({"tokens": torch.arange(16)[:, None]}, 2)["tokens"]
    assert rows[:, 0].tolist() == [2, 3, 10, 11]
