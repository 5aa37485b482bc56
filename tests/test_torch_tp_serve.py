"""Tensor-parallel serving over a mesh of ranks (`repro_torch.parallel`,
`models.sharding`, `ServingEngine(group=)`) on the CPU: every
rank a process of its own over gloo, rendezvous through a file under
`tmp_path`.

The port's sharded `prefill` and teacher-forced `decode_step` are held
against the reference's unsharded ones (a GSPMD program equals its
unsharded program by construction; the reference cannot run sharded on
this CPU), with the reference's weights carried by `params_from_numpy`
and cut by the ported rules: the smoke configs of Qwen2-VL, Qwen1.5
(M-RoPE, the vision stub and QKV biases in the first), Jamba-1.5-Large
(Mamba's d_inner and the experts' d_ff over "model") and Mixtral-8x7B
(the experts' d_ff, its sliding window) on meshes (data, model) of
(1, 2), (2, 2) and (1, 4), at (1, 4) with 8 heads over 4 KV heads (the
smoke configs' 2 and 4 KV heads do not both split four ways).  Every
rank's logits, gathered over "model", for its rows of the batch: f32
within 1e-5 of the reference's max-abs, bf16 within 3e-2; each rank's
cache holds its KV heads and its Mamba channels.  The MoE configs run
the reference unjitted with `unroll_layers=True`, so its routing can
be recorded and replayed into every rank (in f32 asserted equal to the
rank's own); Jamba's Mamba leaves that the reference initialises to
constants (dt_bias, conv_b, D, A_log) are drawn from a numpy seed, so a
wrong piece of them shows.  Jamba's smoke variant in bf16 lies further
from its f32 model than 3e-2 in both packages, sharded or not (its
128-wide bf16 layers; tests/test_torch_mamba_moe.py), so there each
rank is held as that file holds the unsharded port: within 3e-2 of the
f32 model's max-abs (the port in f32 on the same weights, widened, and
the same routing), or within 1.5x the reference's own distance from it.
Then `ServingEngine` over each mesh against the reference engine's
greedy tokens (f32; Qwen2-VL and Jamba), equal on every rank; the
rules' pieces (Mamba's paired `in_proj` cut and `conv_b` with `conv_w`)
and the shard-aware init, with an expert share too; one pin across the
ranks and the refusal of a rank without the pinned version or with a
WAL that is not rank 0's; the refusals of configs and of devices.

Each mesh's ranks are spawned once (`ranks`, a module fixture) and run
every job of that mesh (`torch_tp_ranks.run`)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import repro.configs as JC
import repro.models as JM
from repro.models import layers as JL
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
from repro_torch.parallel.tensor import (Paired, gather_piece, greedy,
                                        local_slice)
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.tensorstore import VersionedParamStore as TStore
from repro_torch.tree import leaves_with_path, path_key

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
JAMBA, MIXTRAL = "jamba-1.5-large-398b", "mixtral-8x7b"
ARCHS = ["qwen2-vl-72b", "qwen1.5-0.5b", JAMBA, MIXTRAL]
MOE = (JAMBA, MIXTRAL)
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
B, S, N = 4, 9, 3               # batch, prompt, decode steps
ENGINE_ARCHS = ("qwen2-vl-72b", JAMBA)
# Mamba leaves the reference initialises to constants, drawn instead
DRAWN = {"dt_bias": lambda r, s: 0.5 * r.standard_normal(s),
         "conv_b": lambda r, s: 0.1 * r.standard_normal(s),
         "D": lambda r, s: r.standard_normal(s),
         "A_log": lambda r, s: np.log(r.uniform(0.5, 16.0, s))}


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


def _draw(jp, seed):
    """The reference's params with the DRAWN leaves from numpy `seed`."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key if hasattr(path[-1], "key") else None
        if name in DRAWN:
            return jnp.asarray(DRAWN[name](rng, x.shape).astype(np.float32),
                               x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, jp)


def _recording(routes):
    """The reference's `moe_apply`, appending the experts each call
    chooses (its router's top-k, [B, S, K]) to `routes`."""
    apply = JL.moe_apply

    def rec(p, x, cfg, **kw):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], -1)
        routes.append(np.array(jax.lax.top_k(probs, cfg.top_k)[1]))
        return apply(p, x, cfg, **kw)
    return rec


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, model):
    """(the reference's params, the port's whole tree carried from them,
    inputs, the reference's prefill + N teacher-forced decode logits,
    the experts its MoE layers chose in call order, or None)."""
    j = _jcfg(arch, dtype, model)
    jp = JM.init_params(jax.random.PRNGKey(4), j)
    if j.qkv_bias:       # the reference inits biases to zero: draw them
        mix = dict(jp["blocks"][0]["mixer"])
        for n, k in zip(("bq", "bk", "bv"),
                        jax.random.split(jax.random.PRNGKey(7), 3)):
            mix[n] = (0.1 * jax.random.normal(k, mix[n].shape)).astype(
                mix[n].dtype)
        jp = dict(jp, blocks=(dict(jp["blocks"][0], mixer=mix),))
    jp = _draw(jp, seed=5)
    inp = _inputs(j)
    jb = {k: jnp.asarray(v) for k, v in _prompt(inp).items()}
    routes = None
    if arch in MOE:
        # unjitted, its layers unrolled: its MoE layers see concrete
        # inputs, so their routing is recorded
        routes, run = [], j.with_overrides(unroll_layers=True)
        saved, JL.moe_apply = JL.moe_apply, _recording(routes)
        prefill = lambda p, b: JM.prefill(p, run, b, cache_len=S + N)
        decode = lambda p, t, c, n: JM.decode_step(p, run, t, c, n)
    else:
        # jitted as the reference engine runs them (one compile a config)
        prefill = jax.jit(lambda p, b: JM.prefill(p, j, b, cache_len=S + N))
        decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, j, t, c, n))
    try:
        lg, cache = prefill(jp, jb)
        want = [np.asarray(lg, np.float32)]
        for k in range(N):
            tok = jnp.asarray(inp["tokens"][:, S + k:S + k + 1])
            lg, cache = decode(jp, tok, cache, jnp.int32(S + k))
            want.append(np.asarray(lg, np.float32))
    finally:
        if routes is not None:
            JL.moe_apply = saved
    tree = TM.params_from_numpy(_port_cfg(j), jax.tree.map(np.asarray, jp),
                                "cpu")
    return jp, tree, inp, want, routes


def _routes(routes):
    return None if routes is None else [torch.from_numpy(r).long()
                                        for r in routes]


@functools.lru_cache(maxsize=None)
def _exact(arch, model):
    """The f32 model of the bf16 reference's weights (the port unsharded
    in f32 on them, widened, with the reference's bf16 routing
    replayed): prefill + N teacher-forced decode logits."""
    _, tree, inp, _, routes = _reference(arch, "bfloat16", model)
    cfg = _port_cfg(_jcfg(arch, "float32", model))
    tree32 = TM.params_from_numpy(cfg, jax.tree.map(
        lambda x: np.asarray(x, np.float32),
        _reference(arch, "bfloat16", model)[0]), "cpu")
    toks = torch.from_numpy(inp["tokens"])
    with torch.no_grad(), torch_tp_ranks.replaying(_routes(routes),
                                                   None):
        lg, cache = TM.prefill(tree32, cfg, _torch(_prompt(inp)),
                               cache_len=S + N)
        out = [lg.numpy()]
        for k in range(N):
            lg, cache = TM.decode_step(tree32, cfg, toks[:, S + k:S + k + 1],
                                       cache, S + k)
            out.append(lg.numpy())
    return out


@functools.lru_cache(maxsize=None)
def _reference_engine(arch, model):
    """The reference engine's greedy tokens for the engine case of
    `arch`, and the prompt batch (f32)."""
    j = _jcfg(arch, "float32", model)
    jp, tree, inp, _, _ = _reference(arch, "float32", model)
    store = JStore(slots=2)
    store.publish(jp)
    eng = JEngine(j, store, max_seq=S + N)
    eng.refresh()
    batch = _prompt(inp)
    res = eng.generate({k: jnp.asarray(v) for k, v in batch.items()}, N)
    return np.asarray(res.tokens), res.snapshot_lsn, tree, batch


def _jobs(name):
    """Every job of a mesh, by key: the logits of each arch and dtype
    ("logits", arch, dtype), the engines ("engine", arch), and on (1, 2)
    the pins ("pins", fault)."""
    model = MESHES[name][1]
    jobs = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            _, tree, inp, _, routes = _reference(arch, dtype, model)
            jobs["logits", arch, dtype] = ("logits", (
                _port_cfg(_jcfg(arch, dtype, model)), tree,
                _torch(_prompt(inp)),
                torch.from_numpy(inp["tokens"][:, S:]), _routes(routes)))
    for arch in ENGINE_ARCHS:
        _, _, tree, batch = _reference_engine(arch, model)
        cfg = _port_cfg(_jcfg(arch, "float32", model))
        jobs["engine", arch] = ("engine", (cfg, tree, _torch(batch), N))
    if name == "1x2":
        _, _, tree, batch = _reference_engine(ENGINE_ARCHS[0], model)
        cfg = _port_cfg(_jcfg(ENGINE_ARCHS[0], "float32", model))
        for fault in (None, "lacking", "extra"):
            jobs["pins", fault] = ("pins", (cfg, tree, _torch(batch),
                                            fault))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh name: every rank's {job key: result}}, each mesh spawned
    once."""
    cache = {}

    def get(name):
        if name not in cache:
            mesh = _mesh(name)
            jobs = _jobs(name)
            out = spawn(
                torch_tp_ranks.run, mesh, backend="gloo",
                devices=["cpu"] * mesh.size,
                tmpdir=tmp_path_factory.mktemp(f"mesh{name}"),
                args=(list(jobs.values()),))
            cache[name] = [dict(zip(jobs, results)) for results in out]
        return cache[name]
    return get


def _close(got, want, dtype, what, exact=None):
    """max |got - want| within TOL[dtype] of max |want|; with `exact`
    (Jamba in bf16, see the module docstring): max |got - exact| within
    3e-2 of max |exact| or 1.5x the reference's own distance from it."""
    if exact is None:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL[dtype], \
            f"{what}: max |d| / max |want| = {err:.3g}"
        return
    scale = np.abs(exact).max()
    d_port = np.abs(got - exact).max() / scale
    d_ref = np.abs(want - exact).max() / scale
    assert np.isfinite(got).all() and d_port <= max(TOL[dtype],
                                                    1.5 * d_ref), \
        (f"{what}: sharded bf16 {d_port:.4g} of max-abs from the f32 "
         f"model, reference bf16 {d_ref:.4g}")


def _cache_shapes(j, rows, model):
    """Each pattern position's cache entries on a rank: its rows, its KV
    heads, its Mamba channels."""
    P, di = j.n_periods, j.mamba_d_inner // model
    out = []
    for spec in j.pattern:
        if spec.mixer == "attn":
            T = min(j.sliding_window, S + N) if j.sliding_window else S + N
            kv = (P, rows, T, j.n_kv_heads // model, j.head_dim)
            out.append({"k": kv, "v": kv})
        else:
            out.append({"ssm": (P, rows, di, j.mamba_d_state),
                        "conv": (P, rows, j.mamba_d_conv - 1, di)})
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_prefill_and_decode_match_the_reference(ranks, mesh_name,
                                                        arch, dtype):
    mesh = _mesh(mesh_name)
    model, data = mesh.shape["model"], mesh.shape["data"]
    _, _, _, want, routes = _reference(arch, dtype, model)
    exact = _exact(arch, model) if arch == JAMBA and dtype == "bfloat16" \
        else [None] * (N + 1)
    rows = B // data
    j = _jcfg(arch, dtype, model)
    for rank, results in enumerate(ranks(mesh_name)):
        d, got, shapes, flips = results["logits", arch, dtype]
        assert d == PG.coords_of(mesh, rank)["data"]
        assert shapes == _cache_shapes(j, rows, model)
        if routes is not None and dtype == "float32":
            assert flips == 0, f"rank {rank}: {flips} routing flips (f32)"
        sl = slice(d * rows, (d + 1) * rows)
        for step, (g, w, x) in enumerate(zip(got, want, exact)):
            _close(g, w[sl], dtype, f"rank {rank} step {step}",
                   None if x is None else x[sl])


def _engine_case(ranks, mesh_name, arch):
    tokens, lsn, _, _ = _reference_engine(arch, MESHES[mesh_name][1])
    for results in ranks(mesh_name):
        got, got_lsn = results["engine", arch]
        np.testing.assert_array_equal(got, tokens)
        assert got_lsn == lsn


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_engine_over_the_mesh_matches_the_reference_engine(ranks,
                                                           mesh_name):
    _engine_case(ranks, mesh_name, ENGINE_ARCHS[0])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_jamba_engine_over_the_mesh_matches_the_reference_engine(
        ranks, mesh_name):
    """Jamba's smoke variant (Mamba channels and experts' d_ff over
    "model"): every rank's greedy tokens are the reference engine's."""
    _engine_case(ranks, mesh_name, JAMBA)


def test_every_rank_pins_the_version_rank_0_chose(ranks):
    """Rank 1's own RSS sees only v1; it serves v2, which rank 0
    pinned, in prefill and every decode step, and releases its pin."""
    one, other = (results["pins", None] for results in ranks("1x2"))
    assert one[0] == other[0] > other[2]      # rank 1's visible lsn: v1's
    assert one[1] == other[1] == ["v2"] * 3
    assert one[3] == other[3] == [0, 0]


def test_a_rank_without_the_pinned_version_refuses(ranks):
    for results in ranks("1x2"):
        msg = results["pins", "lacking"]
        assert isinstance(msg, str), msg
        assert "ranks [1] hold no version" in msg and "lsn" in msg


def test_a_rank_whose_wal_is_not_rank_0s_refuses(ranks):
    """Rank 1 published one version more: its v1 sits at the commit LSN
    of rank 0's v2, and pinning by LSN alone would mix the two."""
    for results in ranks("1x2"):
        msg = results["pins", "extra"]
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


class _Pieces:
    """A stand-in group for `gather_piece` of one leaf: its all-gather
    over axes returns the ranks' pieces (`pieces`, by rank) of the ranks
    that differ from `rank` only on those axes, in piece order."""

    def __init__(self, mesh, pieces, rank):
        self.mesh, self.pieces, self.rank = mesh, pieces, rank

    def all_gather(self, x, axes, dim=0):
        assert torch.equal(x, self.pieces[self.rank])
        group = next(g for g in PG.axis_ranks(self.mesh, axes)
                     if self.rank in g)
        order = sorted(group, key=lambda r: PG.piece_index(
            PG.coords_of(self.mesh, r), axes, self.mesh))
        return torch.cat([self.pieces[r] for r in order], dim=dim)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_and_mamba_leaves_round_trip_through_their_pieces(mesh_name,
                                                              arch):
    """Every Jamba and Mixtral leaf cut by `shard_params` and put back by
    `gather_piece` on every rank is the whole leaf; the experts' d_ff and
    Mamba's channels are cut, the router and `expert_ids` whole; a
    rank's `in_proj` holds x's and z's columns of the same channels,
    its `conv_b` the channels of its `conv_w`."""
    mesh = _mesh(mesh_name)
    m = mesh.shape["model"]
    cfg = smoke_variant(get_config(arch)).with_overrides(
        n_heads=8, n_kv_heads=4)
    tree = TM.init_params(cfg, torch.Generator().manual_seed(2), "cpu",
                          experts=range(1, cfg.n_experts))
    specs = serve_specs(mesh, cfg, tree)
    pieces = [dict(leaves_with_path(shard_params(
        cfg, tree, mesh, PG.coords_of(mesh, r)))) for r in range(mesh.size)]
    cut = set()
    for path, whole in leaves_with_path(tree):
        key, spec = path_key(path), specs[path_key(path)]
        by_rank = [p[path] for p in pieces]
        for r in range(mesh.size):
            got = gather_piece(by_rank[r], spec, _Pieces(mesh, by_rank, r))
            assert torch.equal(got, whole), (key, r)
        if by_rank[0].shape != whole.shape:
            cut.add(key.split("/", 2)[-1])
    want = {"mlp/w_up", "mlp/w_down", "mlp/w_gate"}
    if arch == JAMBA:
        want |= {f"mixer/{n}" for n in ("in_proj", "conv_w", "conv_b",
                                        "x_proj", "dt_proj", "dt_bias",
                                        "A_log", "D", "out_proj")}
    else:
        want |= {f"mixer/{n}" for n in ("wq", "wk", "wv", "wo")}
    assert want <= cut and not cut & {"mlp/router", "mlp/expert_ids"}
    if arch != JAMBA:
        return
    di, dl = cfg.mamba_d_inner, cfg.mamba_d_inner // m
    blk = tree["blocks"][0]["mixer"]
    assert specs["blocks/0/mixer/in_proj"] == (None, None, Paired("model"))
    assert specs["blocks/0/mixer/conv_b"] == (None, "model")
    for r in range(mesh.size):
        k = PG.coords_of(mesh, r)["model"]
        mine = slice(k * dl, (k + 1) * dl)
        got = pieces[r]
        x_cols, z_cols = got[("blocks", 0, "mixer", "in_proj")].split(
            dl, dim=-1)
        assert torch.equal(x_cols, blk["in_proj"][..., mine])
        assert torch.equal(z_cols, blk["in_proj"][..., di:][..., mine])
        for name in ("conv_w", "conv_b"):
            assert torch.equal(got[("blocks", 0, "mixer", name)],
                               blk[name][..., mine])


def _init_case(mesh_name, arch, experts=None):
    mesh = _mesh(mesh_name)
    cfg = smoke_variant(get_config(arch)).with_overrides(
        n_heads=8, n_kv_heads=4)
    whole = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                           experts=experts)
    for rank in range(mesh.size):
        coords = PG.coords_of(mesh, rank)
        got = init_local_params(cfg, torch.Generator().manual_seed(3), mesh,
                                coords, "cpu", experts=experts)
        want = shard_params(cfg, whole, mesh, coords)
        for (path, a), (_, b) in zip(leaves_with_path(got),
                                     leaves_with_path(want)):
            assert torch.equal(a, b), path_key(path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_aware_init_equals_the_slice_of_the_unsharded_init(
        mesh_name):
    _init_case(mesh_name, "qwen2-vl-72b")


@pytest.mark.parametrize("arch,experts", [
    (JAMBA, None), (JAMBA, (0, 2)), (MIXTRAL, None), (MIXTRAL, (1, 2, 3))])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_aware_init_of_mamba_and_moe_equals_the_slice(mesh_name,
                                                            arch, experts):
    """Jamba's and Mixtral's pieces drawn on a rank, the whole model or an
    expert share (`experts=`), equal the slice of the unsharded draws."""
    _init_case(mesh_name, arch, experts)


@pytest.mark.parametrize("arch,overrides,mesh_shape,match", [
    ("qwen2-vl-72b", {}, (1, 4), "does not divide n_kv_heads 2"),
    ("granite-34b", None, (1, 2), "does not divide n_kv_heads 1"),
    ("qwen1.5-0.5b", {"d_ff": 250}, (1, 4), "does not divide d_ff 250"),
    # heads, d_ff and vocabulary split four ways, d_inner 130 does not
    (JAMBA, {"n_heads": 8, "n_kv_heads": 4, "d_model": 65}, (1, 4),
     "does not divide mamba_d_inner 130"),
    # the production mesh's 16-way model axis over Mixtral's 8 KV heads
    (MIXTRAL, None, (1, 16), "does not divide n_kv_heads 8"),
    # Whisper on the reference's pod mesh
    ("whisper-tiny", {}, (2, 1, 2), "Sharded Whisper"),
    ("whisper-tiny", {}, (1, 2), "Sharded Whisper"),
])
def test_configs_the_mesh_does_not_run_are_refused(arch, overrides,
                                                   mesh_shape, match):
    cfg = get_config(arch)
    if overrides is not None:
        cfg = smoke_variant(cfg).with_overrides(**overrides)
    mesh = Mesh(mesh_shape, ("data", "model") if len(mesh_shape) == 2
                else ("pod", "data", "model"))
    with pytest.raises(ValueError, match=match):
        check_tp(cfg, mesh)
    check_tp(cfg, Mesh((1, 1), ("data", "model")))      # one device: runs


@pytest.mark.parametrize("arch,mesh_shape", [
    (JAMBA, (1, 2)), (MIXTRAL, (2, 1)), (JAMBA, (2, 8)),
    ("mixtral-8x22b", (1, 8))])
def test_the_mamba_and_moe_families_run_on_a_mesh(arch, mesh_shape):
    """Jamba and the Mixtrals pass `check_tp` where the model degree
    divides their KV heads, d_ff, vocabulary and d_inner (up to 8, their
    KV heads: the production mesh's 16-way model axis would cut
    part-heads), and the cache a rank allocates holds its share of
    Mamba's channels."""
    cfg = get_config(arch)
    check_tp(cfg, Mesh(mesh_shape, ("data", "model")))
    m = mesh_shape[1]
    spec = TM.cache_spec(cfg.with_overrides(n_layers=cfg.period), 2, 16,
                         model=m)
    for entry, layer in zip(spec["blocks"], cfg.pattern):
        if layer.mixer == "mamba":
            assert entry["ssm"][0][2] == entry["conv"][0][3] \
                == cfg.mamba_d_inner // m


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
