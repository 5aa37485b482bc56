"""Serving a training placement over a mesh of ranks
(`repro_torch.parallel.fsdp.ServeView`, `ServingEngine(group=,
specs=)`, `launch.specs.serving_fallback`) on the CPU: every rank a
process of its own over gloo, rendezvous through a file under a
temporary directory.

The reference serves whatever sharding its parameters carry, GSPMD
regathering the training placement inside its jitted prefill and decode;
a GSPMD program equals its unsharded program, and the reference cannot
run sharded on this CPU, so the port's gathered serving is held against
the reference's unsharded serving (`repro.serve.ServingEngine`'s jitted
prefill and decode, and its `generate`) with the reference's weights
carried by `params_from_numpy` and cut by the placement the rules give
the trainer (`launch.specs.params_specs`, fsdp2d for four of the five
families, plain data parallelism for Whisper): the smoke configs of
Qwen1.5, Mixtral-8x22B, Jamba-1.5-Large and RWKV6 on meshes (data,
model) of (1, 2), (2, 2) and (1, 4), Whisper-tiny on (2, 1) and (4, 1).
Each rank's prefill and 3 teacher-forced decode logits for its rows of
the batch (cut over ("data", "model") under fsdp2d): f32 within 1e-5 of
the reference's max-abs, bf16 within 3e-2 (Jamba's bf16 as
tests/test_torch_tp_serve.py holds it: within 3e-2 of the f32 model or
1.5x the reference's own distance from it); the MoE configs' routing
is recorded in the reference's jitted calls (an ordered host callback)
and replayed into every rank (in f32 asserted equal to the rank's own);
every rank's cache whole-headed, no all-reduce made.  Leaves the
reference initialises to constants (norms, biases, Mamba's and RWKV's
constants) are drawn from a numpy seed, so a wrong piece of them shows.
Then the engine's greedy tokens, snapshot LSN and lag against the
reference engine's (f32), equal on every rank; the HTAP loop on (2, 2)
(`Trainer(group=)` publishing 3 steps, the engine over the trainer's
placement) against the reference's `launch.serve` flow at the same
seed; a version published under request 1's pin; the placements
`params_specs(serving=True)` falls back on, and the engine accepting
them; the refusals.

Each mesh's ranks are spawned once (`ranks`, a module fixture), on
background threads while the tests compute the reference, and run every
job of that mesh (`torch_fsdp_serve_ranks.run`)."""

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
from repro.models import layers as JL
from repro.optim import AdamWConfig as JAdamWConfig
from repro.serve import ServingEngine as JEngine
from repro.tensorstore import VersionedParamStore as JStore
from repro.train import Trainer as JTrainer

import repro_torch.models as TM
import torch_fsdp_serve_ranks
from repro_torch.configs import get_config, list_archs, smoke_variant
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import (SERVE_RESIDENT_LIMIT, params_specs,
                                      serving_fallback)
from repro_torch.models import sharding as TS
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import ServeView, serve_specs, shard_params, spawn
from repro_torch.parallel import group as PG
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.tensorstore import VersionedParamStore as TStore

JAMBA, MIXTRAL = "jamba-1.5-large-398b", "mixtral-8x22b"
QWEN, RWKV, WHISPER = "qwen1.5-0.5b", "rwkv6-3b", "whisper-tiny"
MESHES = {QWEN: [(1, 2), (2, 2), (1, 4)], MIXTRAL: [(1, 2), (2, 2), (1, 4)],
          JAMBA: [(1, 2), (2, 2), (1, 4)], RWKV: [(1, 2), (2, 2), (1, 4)],
          WHISPER: [(2, 1), (4, 1)]}
MOE = (JAMBA, MIXTRAL)
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
F32 = dict(param_dtype="float32", compute_dtype="float32")
B, S, N = 4, 9, 3               # batch, prompt, decode steps
# leaves the reference initialises to constants, drawn instead (any
# other constant leaf c: c + 0.1 x a standard normal)
DRAWN = {"dt_bias": lambda r, s: 0.5 * r.standard_normal(s),
         "A_log": lambda r, s: np.log(r.uniform(0.5, 16.0, s)),
         "mix_base": lambda r, s: r.uniform(0, 1, s),
         "mix_k": lambda r, s: r.uniform(0, 1, s),
         "mix_r": lambda r, s: r.uniform(0, 1, s),
         "w_base": lambda r, s: r.uniform(-6, -1, s)}
# the HTAP loop: the trainer's batch and sequence, its steps, the served
# prompts' length and decode steps (the reference launcher's defaults,
# the batch 4 so that the four batch ranks of (2, 2) divide it)
HTAP = dict(batch=4, seq_len=16, train_steps=3, prompt=16, n_steps=8)
HTAP_OPT = dict(lr=1e-3, eps=1e-4)
PUBLISH_AT = 2


# the reference's computations run one at a time: the MoE recording
# patches a module global, and the fixture's threads make their inputs
_LOCK = threading.RLock()


def _serial(fn):
    """`fn` cached, its calls one at a time (`_LOCK`)."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        with _LOCK:
            return cached(*args)
    return call


def _mesh(shape):
    return Mesh(shape, ("data", "model"))


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


@functools.lru_cache(maxsize=None)
def _jcfg(arch, dtype):
    j = JC.smoke_variant(JC.get_config(arch))
    return j.with_overrides(**F32) if dtype == "float32" else j


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


def _inputs(j, seed=5):
    """Numpy inputs: tokens [B, S + N] (the prompt, then the teacher
    tokens) and, for Whisper, its frames [B, encoder_len, D] in the
    parameter dtype."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, j.vocab_size, (B, S + N))}
    if j.is_encoder_decoder:
        frames = rng.standard_normal((B, j.encoder_len, j.d_model),
                                     dtype=np.float32)
        out["enc_embeds"] = np.asarray(jnp.asarray(frames, j.param_dtype))
    return out


def _prompt(inp):
    return dict(inp, tokens=inp["tokens"][:, :S])


def _torch(batch):
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


def _recording(routes):
    """The reference's `moe_apply`, appending the experts each call
    chooses (its router's top-k, [B, S, K]) to `routes` through an
    ordered host callback, so it records under `jax.jit` too."""
    apply = JL.moe_apply

    def rec(p, x, cfg, **kw):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], -1)
        jax.debug.callback(lambda idx: routes.append(np.array(idx)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return apply(p, x, cfg, **kw)
    return rec


@_serial
def _reference(arch, dtype):
    """(the reference's params, the port's whole tree carried from them,
    inputs, the reference's prefill + N teacher-forced decode logits,
    the experts its MoE layers chose in call order, or None)."""
    j = _jcfg(arch, dtype)
    jp = _draw(JM.init_params(jax.random.PRNGKey(4), j), seed=5)
    inp = _inputs(j)
    jb = {k: jnp.asarray(v) for k, v in _prompt(inp).items()}
    routes = [] if arch in MOE else None
    if routes is not None:
        # its MoE layers' routing recorded as the jitted calls run
        saved, JL.moe_apply = JL.moe_apply, _recording(routes)
    try:
        # the reference engine's own jitted prefill and decode
        eng = JEngine(j, JStore(slots=2), max_seq=S + N)
        lg, cache = eng._prefill(jp, jb)
        want = [np.asarray(lg, np.float32)]
        for k in range(N):
            tok = jnp.asarray(inp["tokens"][:, S + k:S + k + 1])
            lg, cache = eng._decode(jp, tok, cache, jnp.int32(S + k))
            want.append(np.asarray(lg, np.float32))
        jax.effects_barrier()
    finally:
        if routes is not None:
            JL.moe_apply = saved
    tree = TM.params_from_numpy(_port_cfg(j), jax.tree.map(np.asarray, jp),
                                "cpu")
    return jp, tree, inp, want, routes


@_serial
def _exact(arch):
    """The f32 model of the bf16 reference's weights (the port unsharded
    in f32 on them, widened, with the reference's bf16 routing
    replayed): prefill + N teacher-forced decode logits."""
    jp, _, inp, _, routes = _reference(arch, "bfloat16")
    cfg = _port_cfg(_jcfg(arch, "float32"))
    tree32 = TM.params_from_numpy(cfg, jax.tree.map(
        lambda x: np.asarray(x, np.float32), jp), "cpu")
    toks = torch.from_numpy(inp["tokens"])
    replay = None if routes is None else [torch.from_numpy(r).long()
                                          for r in routes]
    with torch.no_grad(), torch_fsdp_serve_ranks.replaying(replay, None):
        lg, cache = TM.prefill(tree32, cfg, _torch(_prompt(inp)),
                               cache_len=S + N)
        out = [lg.numpy()]
        for k in range(N):
            lg, cache = TM.decode_step(tree32, cfg, toks[:, S + k:S + k + 1],
                                       cache, S + k)
            out.append(lg.numpy())
    return out


@_serial
def _reference_engine(arch):
    """The reference engine's greedy tokens, snapshot LSN and lag for
    the prompt batch (f32)."""
    j = _jcfg(arch, "float32")
    jp, _, inp, _, _ = _reference(arch, "float32")
    store = JStore(slots=2)
    store.publish(jp)
    eng = JEngine(j, store, max_seq=S + N)
    eng.refresh()
    res = eng.generate({k: jnp.asarray(v) for k, v in _prompt(inp).items()},
                       N)
    return np.asarray(res.tokens), res.snapshot_lsn, res.freshness_lag


@_serial
def _reference_htap():
    """`repro.launch.serve`'s flow at seed 0 on Qwen1.5's smoke config in
    f32 (HTAP's sizes): the trainer's initial params (numpy) and the
    served (tokens, snapshot lsn, freshness lag)."""
    j = _jcfg(QWEN, "float32")
    store = JStore(slots=2)
    tr = JTrainer(j, batch=HTAP["batch"], seq_len=HTAP["seq_len"],
                  opt=JAdamWConfig(**HTAP_OPT), store=store)
    init = jax.tree.map(np.asarray, tr.state["params"])
    tr.run(HTAP["train_steps"])
    eng = JEngine(j, store, max_seq=HTAP["prompt"] + HTAP["n_steps"] + 8)
    eng.refresh()
    res = eng.generate({"tokens": jnp.ones((HTAP["batch"], HTAP["prompt"]),
                                           jnp.int32)}, HTAP["n_steps"])
    return init, (np.asarray(res.tokens), res.snapshot_lsn,
                  res.freshness_lag)


def _routes(routes):
    return None if routes is None else [torch.from_numpy(r).long()
                                        for r in routes]


def _specs(arch, shape, dtype="float32"):
    """The trainer's parameter placement of the smoke config on the
    mesh (the rules' `params_specs`, serving=False)."""
    return params_specs(_mesh(shape), _port_cfg(_jcfg(arch, dtype))).specs


def _jobs(shape):
    """Every job of a mesh, by key: ("logits", arch, dtype), ("engine",
    arch), and on (2, 2) "htap", "pins" and "mismatch"."""
    jobs = {}
    for arch, meshes in MESHES.items():
        if shape not in meshes:
            continue
        for dtype in DTYPES:
            _, tree, inp, _, routes = _reference(arch, dtype)
            jobs["logits", arch, dtype] = ("logits", (
                _port_cfg(_jcfg(arch, dtype)), tree,
                _specs(arch, shape, dtype), _torch(_prompt(inp)),
                torch.from_numpy(inp["tokens"][:, S:]), _routes(routes)))
        _, tree, inp, _, _ = _reference(arch, "float32")
        jobs["engine", arch] = ("engine", (
            _port_cfg(_jcfg(arch, "float32")), tree, _specs(arch, shape),
            _torch(_prompt(inp)), N))
    if shape == (2, 2):
        cfg = _port_cfg(_jcfg(QWEN, "float32"))
        init = TM.params_from_numpy(cfg, _reference_htap()[0], "cpu")
        jobs["htap"] = ("htap", (cfg, AdamWConfig(**HTAP_OPT), init,
                                 *HTAP.values()))
        _, tree, inp, _, _ = _reference(QWEN, "float32")
        batch = _torch(_prompt(inp))
        jobs["pins"] = ("pins", (cfg, tree, _specs(QWEN, shape), batch,
                                 PUBLISH_AT))
        jobs["mismatch"] = ("mismatch", (cfg, tree, _specs(QWEN, shape),
                                         batch))
    return jobs


# the meshes, two chains spawned side by side, each in its order
CHAINS = [[(2, 2), (1, 2)], [(1, 4), (2, 1), (4, 1)]]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(mesh shape) -> [each rank's {job key: result}].  Every mesh
    is spawned once, each chain of meshes on a thread of its own (its
    jobs' inputs made there), while the tests compute the reference."""
    meshes = [shape for chain in CHAINS for shape in chain]
    dirs = {shape: tmp_path_factory.mktemp(
        f"mesh{'x'.join(map(str, shape))}") for shape in meshes}
    out, done = {}, {shape: threading.Event() for shape in meshes}

    def work(chain):
        for shape in chain:
            mesh = _mesh(shape)
            try:
                jobs = _jobs(shape)
                got = spawn(torch_fsdp_serve_ranks.run, mesh,
                            backend="gloo", devices=["cpu"] * mesh.size,
                            tmpdir=dirs[shape], args=(list(jobs.values()),))
                out[shape] = [dict(zip(jobs, r)) for r in got]
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


def _close(got, want, dtype, what, exact=None):
    """max |got - want| within TOL[dtype] of max |want|; with `exact`
    (Jamba in bf16): max |got - exact| within 3e-2 of max |exact| or
    1.5x the reference's own distance from it."""
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
        (f"{what}: gathered bf16 {d_port:.4g} of max-abs from the f32 "
         f"model, reference bf16 {d_ref:.4g}")


def _whole_cache(j, rows):
    """Each pattern position's cache entries on a rank: its rows, every
    KV head and Mamba channel."""
    P, out = j.n_periods, []
    for spec in j.pattern:
        entry = {}
        if spec.mixer == "attn":
            T = min(j.sliding_window, S + N) if j.sliding_window else S + N
            entry["k"] = entry["v"] = (P, rows, T, j.n_kv_heads, j.head_dim)
        elif spec.mixer == "mamba":
            entry["ssm"] = (P, rows, j.mamba_d_inner, j.mamba_d_state)
            entry["conv"] = (P, rows, j.mamba_d_conv - 1, j.mamba_d_inner)
        else:
            entry["shift"] = (P, rows, j.d_model)
            entry["wkv"] = (P, rows, j.d_model // j.rwkv_head_dim,
                            j.rwkv_head_dim, j.rwkv_head_dim)
        if spec.mlp == "rwkv_cmix":
            entry["cmix_shift"] = (P, rows, j.d_model)
        if spec.cross_attn:
            entry["xk"] = entry["xv"] = (P, rows, j.encoder_len,
                                         j.n_kv_heads, j.head_dim)
        out.append(entry)
    return out


CASES = [(arch, shape) for arch, meshes in MESHES.items()
         for shape in meshes]


def _id(case):
    arch, shape = case
    return f"{arch}-{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_gathered_prefill_and_decode_match_the_reference(ranks, case,
                                                         dtype):
    """Every rank's logits for its rows of the batch (cut over the
    placement's batch axes in piece order) against the reference's
    unsharded prefill and decode; every cache whole-headed over the
    rank's rows; no all-reduce (`psum` is the identity under a view);
    one gather of the top-level leaves and one of each layer a call."""
    arch, shape = case
    _, _, _, want, routes = _reference(arch, dtype)
    exact = _exact(arch) if arch == JAMBA and dtype == "bfloat16" \
        else [None] * (N + 1)
    j = _jcfg(arch, dtype)
    rows = B // (shape[0] * shape[1])
    calls = (N + 1) * (1 + j.n_layers) + j.n_encoder_layers
    for rank, results in enumerate(ranks(shape)):
        r, got, shapes, flips, reduces, gathers = results[
            "logits", arch, dtype]
        assert r == rank            # batch axes cover the mesh, in order
        assert shapes == _whole_cache(j, rows)
        assert reduces == 0 and gathers == calls
        if routes is not None and dtype == "float32":
            assert flips == 0, f"rank {rank}: {flips} routing flips (f32)"
        sl = slice(r * rows, (r + 1) * rows)
        for step, (g, w, x) in enumerate(zip(got, want, exact)):
            _close(g, w[sl], dtype, f"rank {rank} step {step}",
                   None if x is None else x[sl])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_engine_over_a_training_placement_matches_the_reference_engine(
        ranks, case):
    """`ServingEngine(group=, specs=)`: every rank's greedy tokens,
    snapshot LSN and lag are the reference engine's (f32)."""
    arch, shape = case
    tokens, lsn, lag = _reference_engine(arch)
    for results in ranks(shape):
        got, got_lsn, got_lag, reduces = results["engine", arch]
        np.testing.assert_array_equal(got, tokens)
        assert (got_lsn, got_lag, reduces) == (lsn, lag, 0)


def test_htap_loop_serves_what_the_ranks_train(ranks):
    """On (2, 2): the ranks' `Trainer(group=)` publishes 3 steps into
    each rank's store, and `ServingEngine(group=, specs=<the trainer's
    placement>)` serves the newest version: tokens, snapshot LSN and lag
    equal on every rank and to the reference's `launch.serve` flow at
    the same seed and weights."""
    want = _reference_htap()[1]
    out = [results["htap"] for results in ranks((2, 2))]
    for tokens, lsn, lag in out:
        np.testing.assert_array_equal(tokens, want[0])
        assert (lsn, lag) == want[1:]
    assert want[0].shape == (HTAP["batch"], HTAP["n_steps"])


def test_a_version_published_under_the_pin_waits_for_the_next_request(
        ranks):
    """v2 published on every rank under request 1's pin after decode
    step PUBLISH_AT: request 1 reads v1 in every call on every rank,
    request 2 reads v2, at a later LSN equal on every rank; the tokens
    equal on every rank; no pin left."""
    out = [results["pins"] for results in ranks((2, 2))]
    first, second = zip(*(reqs for reqs, _ in out))
    assert len({lsn for lsn, _, _ in first}) == 1
    assert len({lsn for lsn, _, _ in second}) == 1
    assert second[0][0] > first[0][0]
    for (_, r1, t1), (_, r2, t2) in zip(first, second):
        assert r1 == ["v1"] * 5 and r2 == ["v2"] * 5
        np.testing.assert_array_equal(t1, first[0][2])
        np.testing.assert_array_equal(t2, second[0][2])
    assert all(p == [0, 0] for _, p in out)


def test_pieces_that_do_not_match_the_specs_are_refused(ranks):
    """A store holding the whole tree where the specs cut it: every
    rank's engine raises, naming a leaf, and releases its pin."""
    for msg, pins in (results["mismatch"] for results in ranks((2, 2))):
        assert msg is not None and "pinned leaf" in msg, msg
        assert "its piece under spec" in msg
        assert pins == [0, 0]


ALL_MESHES = [(1, 4), (2, 2), (16, 16)]
# (arch, mesh) where a model shard passes the resident limit
FALLBACK = {(MIXTRAL, (1, 4)), (MIXTRAL, (2, 2)), (JAMBA, (1, 4)),
            (JAMBA, (2, 2)), ("qwen2-vl-72b", (2, 2))}


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list_archs())
def test_serving_falls_back_to_the_training_placement_by_the_rule(arch,
                                                                  shape):
    """`serving_fallback` says "fallback" exactly where 2 * param_count /
    model passes SERVE_RESIDENT_LIMIT, where `params_specs(serving=True)`
    is then the training placement; the engine accepts that placement
    of the smoke config on the mesh."""
    mesh, cfg = _mesh(shape), get_config(arch)
    fell = serving_fallback(mesh, cfg)
    assert fell == (2 * cfg.param_count() / shape[1] > SERVE_RESIDENT_LIMIT)
    assert fell == ((arch, shape) in FALLBACK)
    if not fell:
        return
    assert params_specs(mesh, cfg, serving=True).specs == \
        params_specs(mesh, cfg).specs
    smoke = smoke_variant(cfg)
    group = PG.MeshGroup(mesh, 0, "gloo", torch.device("cpu"),
                         PG.coords_of(mesh, 0))
    eng = TEngine(smoke, TStore(slots=2), device="cpu", group=group,
                  specs=params_specs(mesh, smoke).specs)
    assert eng.view.batch_axes == tuple(a for a, n in mesh.shape.items()
                                        if n > 1)


def test_a_depth_cut_keeps_the_fallback_placement():
    """The placement of Mixtral-8x22B's 56 layers on (1, 4) is, leaf for
    leaf, the training placement of its one-layer cut: a depth cut of
    a fallback config is served under the full config's rule."""
    mesh, cfg = _mesh((1, 4)), get_config(MIXTRAL)
    assert serving_fallback(mesh, cfg)
    assert not serving_fallback(mesh, cfg.with_overrides(n_layers=1))
    assert params_specs(mesh, cfg, serving=True).specs == params_specs(
        mesh, cfg.with_overrides(n_layers=1)).specs


def _stub(shape, rank=0, mesh=None):
    mesh = mesh or _mesh(shape)
    return PG.MeshGroup(mesh, rank, "gloo", torch.device("cpu"),
                        PG.coords_of(mesh, rank))


@pytest.mark.parametrize("arch,mesh,match", [
    (WHISPER, Mesh((2, 1, 2), ("pod", "data", "model")),
     "Tensor-parallel training"),
    (WHISPER, Mesh((1, 2), ("data", "model")), "Tensor-parallel training"),
])
def test_placements_the_port_does_not_serve_gathered_are_refused(arch, mesh,
                                                                 match):
    cfg = smoke_variant(get_config(arch))
    specs = params_specs(mesh, cfg).specs
    with pytest.raises(ValueError, match=match):
        TEngine(cfg, TStore(slots=2), device="cpu",
                group=_stub(None, mesh=mesh), specs=specs)


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 1, 2), (2, 2, 2)])
def test_a_pod_mesh_placement_is_served_over_pod_and_data(shape):
    """The engine takes Qwen's training placement on the reference's pod
    mesh: the rows over ("pod", "data") (its axes of more than one
    rank), fsdp2d's cut over ("data", "model"); the ranks along "model"
    take the same rows."""
    mesh = Mesh(shape, ("pod", "data", "model"))
    cfg = smoke_variant(get_config(QWEN))
    specs = params_specs(mesh, cfg).specs
    views = [TEngine(cfg, TStore(slots=2), device="cpu",
                     group=_stub(None, r, mesh), specs=specs).view
             for r in range(mesh.size)]
    assert views[0].batch_axes == tuple(a for a in ("pod", "data")
                                        if mesh.shape[a] > 1)
    rows = [v.rows({"tokens": torch.arange(4)[:, None]})["tokens"][:, 0]
            .tolist() for v in views]
    m = shape[2]
    assert all(rows[r] == rows[r - r % m] for r in range(mesh.size))
    assert sorted(sum(rows[::m], [])) == [0, 1, 2, 3]


def test_a_batch_the_batch_ranks_do_not_divide_is_refused():
    """fsdp2d on (2, 2) cuts the batch over four ranks: two rows are
    refused before any pin; four rows give rank 1 its one row."""
    cfg = smoke_variant(get_config(QWEN))
    eng = TEngine(cfg, TStore(slots=2), device="cpu", group=_stub((2, 2), 1),
                  specs=params_specs(_mesh((2, 2)), cfg).specs)
    with pytest.raises(ValueError, match=r"over 4 batch ranks \('data', "
                                         r"'model'\)"):
        eng.generate({"tokens": torch.zeros((2, 5), dtype=torch.int32)}, 1)
    rows = eng.view.rows({"tokens": torch.arange(4)[:, None]})["tokens"]
    assert rows[:, 0].tolist() == [1]


def test_specs_that_are_not_a_stored_placement_are_refused():
    """The serving layout (Mamba's paired `in_proj` cut), a leaf cut on
    two dims, and a spec tree missing a leaf; then pieces of another
    shape."""
    cfg = smoke_variant(get_config(JAMBA))
    mesh = _mesh((1, 2))
    meta = TM.init_params(cfg, None, "meta")
    with pytest.raises(ValueError, match="not a placement"):
        ServeView(_stub((1, 2)), cfg, serve_specs(mesh, cfg, meta))
    qwen = smoke_variant(get_config(QWEN))
    specs = params_specs(_mesh((2, 2)), qwen).specs
    bad = dict(specs, **{"blocks/0/mixer/wq": (None, "data", "model")})
    with pytest.raises(ValueError, match="the port cuts one dim"):
        ServeView(_stub((2, 2)), qwen, bad)
    with pytest.raises(ValueError, match=r"\['params/embed'\] have no spec"):
        ServeView(_stub((2, 2)), qwen, {k: s for k, s in specs.items()
                                        if k != "embed"})
    view = ServeView(_stub((2, 2)), qwen, specs)
    tree = TM.init_params(qwen, torch.Generator().manual_seed(0), "cpu")
    view.check(shard_params(qwen, tree, view.mesh, view.group.coords,
                            specs=specs))
    with pytest.raises(ValueError, match="pinned leaf blocks/0/mixer/"):
        view.check(tree)


def test_psum_and_the_cache_under_a_serving_view():
    """Under `with_mesh(view)` no tensor parallelism runs: `psum` hands
    its input back, `model_index` is (0, 1), the cache is whole-headed,
    the gather is the view's and no training layout is active."""
    cfg = smoke_variant(get_config(QWEN))
    view = ServeView(_stub((1, 2), 1), cfg,
                     params_specs(_mesh((1, 2)), cfg).specs)
    x = torch.ones(2, 3)
    with TS.with_mesh(view):
        assert TS.psum(x) is x and TS.model_index() == (0, 1)
        assert TS.gatherer() == view.gather and TS.training() is None
        assert TS.placement() is view
        cache = TM.init_cache(cfg, 2, 8, "cpu",
                              model=TS.model_index()[1])
    assert cache["blocks"][0]["k"].shape[3] == cfg.n_kv_heads
