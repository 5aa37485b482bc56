"""Tensor-parallel serving over a mesh of ranks (`repro_torch.parallel`,
`models.sharding`, `ServingEngine(group=)`) on the CPU: every
rank a process of its own over gloo, rendezvous through a file under
`tmp_path`.

The port's sharded `prefill` and teacher-forced `decode_step` are held
against the reference's unsharded ones (a GSPMD program equals its
unsharded program by construction; the reference cannot run sharded on
this CPU), with the reference's weights carried by `params_from_numpy`
and cut by the ported rules: Qwen2-VL's and Qwen1.5's smoke configs
(M-RoPE, the vision stub and QKV biases in the first) on meshes
(data, model) of (1, 2), (2, 2) and (1, 4), at (1, 4) with 8 heads over
4 KV heads (the smoke configs' 2 and 4 KV heads do not both split four
ways).  Every rank's logits, gathered over "model", for its rows of the
batch: f32 within 1e-5 of the reference's max-abs, bf16 within 3e-2.
Then `ServingEngine` over each mesh against the reference engine's
greedy tokens (f32), equal on every rank; the rules' pieces and the
shard-aware init; one pin across the ranks and the refusal of a rank
without the pinned version or with a WAL that is not rank 0's; the
refusals of configs and of devices.

Each mesh's ranks are spawned once (`ranks`, a module fixture) and run
every job of that mesh (`torch_tp_ranks.run`)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC
import repro.models as JM
from repro.serve import ServingEngine as JEngine
from repro.tensorstore import VersionedParamStore as JStore

import repro_torch.models as TM
import torch_tp_ranks
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.shardings import param_shardings
from repro_torch.models import sharding as TS
from repro_torch.parallel import (check_tp, init_local_params, serve_specs,
                                  shard_params, spawn)
from repro_torch.parallel import group as PG
from repro_torch.parallel.tensor import greedy, local_slice
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.tensorstore import VersionedParamStore as TStore
from repro_torch.tree import leaves_with_path, path_key

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ["qwen2-vl-72b", "qwen1.5-0.5b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
B, S, N = 4, 9, 3               # batch, prompt, decode steps
ENGINE_ARCH = "qwen2-vl-72b"


def _mesh(name):
    return Mesh(MESHES[name], ("data", "model"))


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


@functools.lru_cache(maxsize=None)
def _jcfg(arch, dtype, model):
    j = JC.smoke_variant(JC.get_config(arch))
    if dtype == "float32":
        j = j.with_overrides(param_dtype="float32", compute_dtype="float32")
    if model == 4:
        j = j.with_overrides(n_heads=8, n_kv_heads=4)
    return j


def _inputs(j, seed=5):
    """Numpy inputs: tokens [B, S + N] (the prompt, then the teacher
    tokens) and, for M-RoPE, the vision stub [B, S//4, D] and positions
    [3, B, S + N] with the stub's rows on a grid of width 2."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, j.vocab_size, (B, S + N))}
    if j.mrope_sections:
        nv = S // 4
        out["vision_embeds"] = rng.standard_normal(
            (B, nv, j.d_model), dtype=np.float32) * 0.02
        pos = np.broadcast_to(np.arange(S + N), (3, B, S + N)).copy()
        i = np.arange(nv)
        pos[0, :, :nv], pos[1, :, :nv], pos[2, :, :nv] = 0, i // 2, i % 2
        out["mrope_positions"] = pos.astype(np.int32)
    return out


def _prompt(inp):
    """The prompt's inputs (the first S tokens and positions)."""
    out = dict(inp, tokens=inp["tokens"][:, :S])
    if "mrope_positions" in inp:
        out["mrope_positions"] = inp["mrope_positions"][:, :, :S]
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, model):
    """(the port's whole tree carried from the reference's, inputs, the
    reference's prefill + N teacher-forced decode logits)."""
    j = _jcfg(arch, dtype, model)
    jp = JM.init_params(jax.random.PRNGKey(4), j)
    if j.qkv_bias:       # the reference inits biases to zero: draw them
        mix = dict(jp["blocks"][0]["mixer"])
        for n, k in zip(("bq", "bk", "bv"),
                        jax.random.split(jax.random.PRNGKey(7), 3)):
            mix[n] = (0.1 * jax.random.normal(k, mix[n].shape)).astype(
                mix[n].dtype)
        jp = dict(jp, blocks=(dict(jp["blocks"][0], mixer=mix),))
    inp = _inputs(j)
    jb = {k: jnp.asarray(v) for k, v in _prompt(inp).items()}
    # jitted as the reference engine runs them (one compile a config)
    lg, cache = jax.jit(lambda p, b: JM.prefill(p, j, b, cache_len=S + N))(
        jp, jb)
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, j, t, c, n))
    want = [np.asarray(lg, np.float32)]
    for k in range(N):
        tok = jnp.asarray(inp["tokens"][:, S + k:S + k + 1])
        lg, cache = decode(jp, tok, cache, jnp.int32(S + k))
        want.append(np.asarray(lg, np.float32))
    tree = TM.params_from_numpy(_port_cfg(j), jax.tree.map(np.asarray, jp),
                                "cpu")
    return jp, tree, inp, want


@functools.lru_cache(maxsize=None)
def _reference_engine(model):
    """The reference engine's greedy tokens for the engine case, and the
    prompt batch (f32, ENGINE_ARCH)."""
    j = _jcfg(ENGINE_ARCH, "float32", model)
    jp, tree, inp, _ = _reference(ENGINE_ARCH, "float32", model)
    store = JStore(slots=2)
    store.publish(jp)
    eng = JEngine(j, store, max_seq=S + N)
    eng.refresh()
    batch = _prompt(inp)
    res = eng.generate({k: jnp.asarray(v) for k, v in batch.items()}, N)
    return np.asarray(res.tokens), res.snapshot_lsn, tree, batch


def _jobs(name):
    """Every job of a mesh: the logits of each arch and dtype, the
    engine, and on (1, 2) the pins."""
    model = MESHES[name][1]
    jobs = []
    for arch in ARCHS:
        for dtype in DTYPES:
            _, tree, inp, _ = _reference(arch, dtype, model)
            jobs.append(("logits", (
                _port_cfg(_jcfg(arch, dtype, model)), tree,
                _torch(_prompt(inp)),
                torch.from_numpy(inp["tokens"][:, S:]))))
    _, _, tree, batch = _reference_engine(model)
    cfg = _port_cfg(_jcfg(ENGINE_ARCH, "float32", model))
    jobs.append(("engine", (cfg, tree, _torch(batch), N)))
    if name == "1x2":
        jobs += [("pins", (cfg, tree, _torch(batch), fault))
                 for fault in (None, "lacking", "extra")]
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh name: every rank's job results}, each mesh spawned once."""
    cache = {}

    def get(name):
        if name not in cache:
            mesh = _mesh(name)
            cache[name] = spawn(
                torch_tp_ranks.run, mesh, backend="gloo",
                devices=["cpu"] * mesh.size,
                tmpdir=tmp_path_factory.mktemp(f"mesh{name}"),
                args=(_jobs(name),))
        return cache[name]
    return get


def _close(got, want, dtype, what):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL[dtype], f"{what}: max |d| / max |want| = {err:.3g}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_prefill_and_decode_match_the_reference(ranks, mesh_name,
                                                        arch, dtype):
    mesh = _mesh(mesh_name)
    model, data = mesh.shape["model"], mesh.shape["data"]
    _, _, _, want = _reference(arch, dtype, model)
    job = 2 * ARCHS.index(arch) + DTYPES.index(dtype)
    rows = B // data
    j = _jcfg(arch, dtype, model)
    for rank, results in enumerate(ranks(mesh_name)):
        d, got, kshape = results[job]
        assert d == PG.coords_of(mesh, rank)["data"]
        # the rank's cache: its rows, its KV heads
        assert kshape == (j.n_layers, rows, S + N, j.n_kv_heads // model,
                          j.head_dim)
        for step, (g, w) in enumerate(zip(got, want)):
            _close(g, w[d * rows:(d + 1) * rows], dtype,
                   f"rank {rank} step {step}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_engine_over_the_mesh_matches_the_reference_engine(ranks,
                                                           mesh_name):
    tokens, lsn, _, _ = _reference_engine(MESHES[mesh_name][1])
    for results in ranks(mesh_name):
        got, got_lsn = results[4]
        np.testing.assert_array_equal(got, tokens)
        assert got_lsn == lsn


def test_every_rank_pins_the_version_rank_0_chose(ranks):
    """Rank 1's own RSS sees only v1; it serves v2, which rank 0
    pinned, in prefill and every decode step, and releases its pin."""
    one, other = (results[5] for results in ranks("1x2"))
    assert one[0] == other[0] > other[2]      # rank 1's visible lsn: v1's
    assert one[1] == other[1] == ["v2"] * 3
    assert one[3] == other[3] == [0, 0]


def test_a_rank_without_the_pinned_version_refuses(ranks):
    for results in ranks("1x2"):
        msg = results[6]
        assert isinstance(msg, str), msg
        assert "ranks [1] hold no version" in msg and "lsn" in msg


def test_a_rank_whose_wal_is_not_rank_0s_refuses(ranks):
    """Rank 1 published one version more: its v1 sits at the commit LSN
    of rank 0's v2, and pinning by LSN alone would mix the two."""
    for results in ranks("1x2"):
        msg = results[7]
        assert isinstance(msg, str), msg
        assert "the WALs of ranks [1] end at lsn [6], rank 0's at 4" in msg


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_params_cuts_each_leaf_into_the_rules_pieces(mesh_name):
    """Every rank's leaf is its block of the whole leaf under the ported
    rules (`param_shardings` of the Megatron layout), and the pieces of
    the ranks along an axis put the whole leaf back together."""
    mesh = _mesh(mesh_name)
    cfg = smoke_variant(get_config("qwen1.5-0.5b"))
    g = torch.Generator().manual_seed(1)
    tree = TM.init_params(cfg, g, "cpu")
    specs = param_shardings(mesh, cfg.with_overrides(
        fsdp=False, zero2=False, train_sharding="tp"), tree)
    # the rules' specs, but the QKV biases cut as their products' columns
    assert specs["blocks/0/mixer/bq"] == (None, None)
    specs = {p: (s[:-1] + specs[p.replace("/b", "/w")][-1:]
                 if p.split("/")[-1] in ("bq", "bk", "bv") else s)
             for p, s in specs.items()}
    assert specs == serve_specs(mesh, cfg, tree)
    assert specs["embed"] == ("model", None)
    assert specs["blocks/0/mixer/wq"] == (None, None, "model")
    assert specs["blocks/0/mixer/bq"] == (None, "model")
    assert specs["blocks/0/mlp/w_down"] == (None, "model", None)
    pieces = [shard_params(cfg, tree, mesh, PG.coords_of(mesh, r))
              for r in range(mesh.size)]
    m = mesh.shape["model"]
    for path, whole in leaves_with_path(tree):
        spec = specs[path_key(path)]
        got = [dict(leaves_with_path(p))[path] for p in pieces]
        if "model" not in spec:
            assert all(torch.equal(x, whole) for x in got)
            continue
        dim = spec.index("model")
        # the model ranks of data row 0 are ranks 0..m-1
        assert torch.equal(torch.cat(got[:m], dim=dim), whole)
        assert all(x.shape[dim] == whole.shape[dim] // m for x in got)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_aware_init_equals_the_slice_of_the_unsharded_init(
        mesh_name):
    mesh = _mesh(mesh_name)
    cfg = smoke_variant(get_config("qwen2-vl-72b")).with_overrides(
        n_heads=8, n_kv_heads=4)
    whole = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for rank in range(mesh.size):
        coords = PG.coords_of(mesh, rank)
        got = init_local_params(cfg, torch.Generator().manual_seed(3), mesh,
                                coords, "cpu")
        want = shard_params(cfg, whole, mesh, coords)
        for (path, a), (_, b) in zip(leaves_with_path(got),
                                     leaves_with_path(want)):
            assert torch.equal(a, b), path_key(path)


@pytest.mark.parametrize("arch,overrides,mesh_shape,match", [
    ("qwen2-vl-72b", {}, (1, 4), "does not divide n_kv_heads 2"),
    ("granite-34b", None, (1, 2), "does not divide n_kv_heads 1"),
    ("qwen1.5-0.5b", {"d_ff": 250}, (1, 4), "does not divide d_ff 250"),
    ("jamba-1.5-large-398b", {}, (1, 2), "Sharded Mamba"),
    ("mixtral-8x7b", {}, (2, 1), "Sharded MoE"),
    ("rwkv6-3b", {}, (1, 2), "Sharded RWKV"),
    ("whisper-tiny", {}, (1, 2), "Sharded Whisper"),
])
def test_configs_the_mesh_does_not_run_are_refused(arch, overrides,
                                                   mesh_shape, match):
    cfg = get_config(arch)
    if overrides is not None:
        cfg = smoke_variant(cfg).with_overrides(**overrides)
    mesh = Mesh(mesh_shape, ("data", "model"))
    with pytest.raises(ValueError, match=match):
        check_tp(cfg, mesh)
    check_tp(cfg, Mesh((1, 1), ("data", "model")))      # one device: runs


def test_the_engine_refuses_a_group_on_another_device():
    cfg = smoke_variant(get_config("qwen1.5-0.5b"))
    store = TStore(slots=2)
    group = PG.MeshGroup(_mesh("1x2"), 1, "gloo", torch.device("cuda:0"))
    with pytest.raises(ValueError, match="rank 1 is on cuda:0, the engine "
                                         "on cpu"):
        TEngine(cfg, store, device="cpu", group=group)
    one = PG.MeshGroup(Mesh((1, 1), ("data", "model")), 0, "gloo",
                       torch.device("cpu"))
    assert TEngine(cfg, store, device="cpu", group=one).group is None


@pytest.mark.parametrize("backend,devices,match", [
    ("nccl", ["cuda:0", "cuda:0"], "ranks 0 and 1 share cuda:0"),
    ("nccl", ["cpu", "cpu"], "nccl runs on cards"),
    ("gloo", ["cuda", "cuda"], "name the card"),
    ("gloo", ["cpu"], "1 devices for a mesh of 2"),
    ("mpi", ["cpu", "cpu"], "use one of"),
])
def test_spawn_refuses_devices_before_starting_a_rank(tmp_path, backend,
                                                      devices, match):
    with pytest.raises(ValueError, match=match):
        spawn(torch_tp_ranks.run, _mesh("1x2"), backend=backend,
              devices=devices, tmpdir=tmp_path, args=([],))
    assert not list(tmp_path.iterdir())       # nothing started


def test_coords_follow_the_reference_device_order():
    """Row-major over the axes, "model" fastest (a jax mesh's order);
    the axis groups partition the ranks."""
    mesh = Mesh((2, 2), ("data", "model"))
    assert [PG.coords_of(mesh, r) for r in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert PG.axis_ranks(mesh, ("model",)) == [[0, 1], [2, 3]]
    assert PG.axis_ranks(mesh, ("data",)) == [[0, 2], [1, 3]]
    pod = Mesh((2, 2, 2), ("pod", "data", "model"))
    assert PG.axis_ranks(pod, ("pod", "data")) == [[0, 2, 4, 6],
                                                   [1, 3, 5, 7]]


def test_psum_and_the_hint_outside_an_executing_group():
    x = torch.ones(2, 3)
    assert TS.psum(x) is x and TS.model_index() == (0, 1)
    with TS.with_mesh(make_production_mesh()):
        with pytest.raises(ValueError, match="no process group"):
            TS.psum(x)
        with pytest.raises(ValueError, match="ROADMAP"):
            TS.hint(x, "data", None)
    group = PG.MeshGroup(_mesh("1x2"), 0, "gloo", torch.device("cpu"),
                         {"data": 0, "model": 0}, {"model": None})
    with TS.with_mesh(group):
        assert TS.hint(x, "data", None) is x
        assert TS.model_index() == (0, 2)
        with pytest.raises(ValueError, match="autograd"):
            TS.psum(x.clone().requires_grad_())


class _Gathered:
    """A stand-in group whose "model" gather returns the given pieces."""

    def __init__(self, pieces, rank, size):
        self.pieces, self.model_rank, self.model_size = pieces, rank, size

    def all_gather(self, x, axis, dim=0):
        return torch.cat(self.pieces(x), dim=dim)


def test_greedy_keeps_the_lowest_index_among_equal_maxima():
    """Over vocab-sharded logits: the global argmax, the first of equal
    maxima (as torch.argmax over the whole row), NaN-free rows."""
    rng = np.random.default_rng(0)
    whole = torch.from_numpy(rng.integers(0, 3, (64, 12)).astype(
        np.float32))
    want = whole.argmax(dim=-1)
    parts = whole.chunk(3, dim=-1)
    for rank in range(3):
        def pieces(mine, rank=rank):
            out = []
            for r, p in enumerate(parts):
                idx = p.argmax(-1)
                out.append(torch.stack([p.gather(-1, idx[:, None])[:, 0]
                                        .double(),
                                        (idx + r * 4).double()])[None])
            assert torch.equal(mine, out[rank])
            return out
        got = greedy(parts[rank], _Gathered(pieces, rank, 3))
        assert torch.equal(got, want)


def test_local_slice_cuts_over_several_axes_row_major():
    mesh = Mesh((2, 2), ("data", "model"))
    t = torch.arange(8)
    got = [local_slice(t, (("data", "model"),), mesh, PG.coords_of(mesh, r))
           for r in range(4)]
    assert [x.tolist() for x in got] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not cut"):
        local_slice(torch.arange(6), ("model", None), Mesh((1, 4),
                    ("data", "model")), {"data": 0, "model": 1})
