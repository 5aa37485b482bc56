"""The port's Mamba and MoE layers, and the models built from them
(Jamba's hybrid period, Mixtral's SWA + MoE), against the JAX package on
the CPU, with the reference's weights carried by `params_from_numpy`:

- `mamba_apply` (output and state), then `mamba_decode` step by step
  from that state, written in place;
- `moe_apply` at the configured capacity factor 1.25, where choices are
  dropped, and at 8.0, where none is; each test first asserts that the
  routing (the experts chosen, and which choices were kept) equals the
  reference's, so a routing flip reports as a flip, not as an output
  mismatch;
- the expert share: the layer holding experts [0, E/2) plus the layer
  holding [E/2, E) equals the reference's whole layer, and the first
  alone equals the reference's layer with the other experts' w_down
  zeroed;
- the whole models: `forward`, then `prefill` + `decode_step`, logits and
  caches.

The reference initialises Mamba's dt_bias, conv_b, D and A_log to
constants (0, 0, 1, log(1..N)), which would hide a fault in their use:
those leaves are drawn from a numpy seed and carried to both packages.
The reference runs with `unroll_layers=True` (its layer loop in Python,
the same arithmetic), so its MoE layers see concrete inputs and their
routing can be recorded.

Every JAX result is computed and waited for before the port runs, and
the port gets copies of the inputs.  Failure messages name the side.

Tolerances: f32 layers and models at rtol = atol = 2e-4 (the reference's
Mamba scan is associative, the port's plain one sequential with D·u
fused: the reference's tolerance for its scan kernel); bf16 within 3e-2
of the max-abs of what is compared (bf16 rounds at other places in the
two frameworks), as tests/test_torch_models.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import repro.configs as JC  # noqa: E402
import repro.models as JM  # noqa: E402
from repro.models import layers as JL  # noqa: E402

import repro_torch.models as TM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

JAMBA, MIXTRAL = "jamba-1.5-large-398b", "mixtral-8x7b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
# Mamba leaves the reference initialises to constants, drawn here instead
DRAWN = {"dt_bias": lambda r, s: 0.5 * r.standard_normal(s),
         "conv_b": lambda r, s: 0.1 * r.standard_normal(s),
         "D": lambda r, s: r.standard_normal(s),
         "A_log": lambda r, s: np.log(r.uniform(0.5, 16.0, s))}


def _t(x):
    """numpy / jax array -> CPU tensor holding a copy, bf16 bit for bit."""
    x = np.array(jax.block_until_ready(x) if isinstance(x, jax.Array)
                 else x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jax.block_until_ready(x), np.float32)


def _close(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max(),
                                   err_msg=what)


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


def _smoke(arch, dtype):
    cfg = JC.smoke_variant(JC.get_config(arch)).with_overrides(
        unroll_layers=True)
    return cfg.with_overrides(**F32) if dtype == "float32" else cfg


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


_MODELS: dict = {}


def _model(arch, dtype):
    """(reference cfg, port cfg, reference params, port params), once per
    (arch, dtype) for the module."""
    if (arch, dtype) not in _MODELS:
        j = _smoke(arch, dtype)
        jp = jax.block_until_ready(
            _draw(JM.init_params(jax.random.PRNGKey(4), j), seed=5))
        tp = TM.params_from_numpy(_port_cfg(j), jax.tree.map(np.array, jp),
                                  "cpu")
        _MODELS[arch, dtype] = (j, _port_cfg(j), jp, tp)
    return _MODELS[arch, dtype]


def _layer(arch, dtype, pos, part):
    """Period 0's params of pattern position `pos`, part "mixer" or
    "mlp": reference (jax) and port (torch)."""
    j, tcfg, jp, tp = _model(arch, dtype)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][pos][part])
    tl = {k: v[0] for k, v in tp["blocks"][pos][part].items()}
    return j, tcfg, jl, tl


def _x(shape, dtype, seed, shared=0.0):
    """Unit normals; with `shared` > 0, each token also carries that
    multiple of one common vector, so the tokens lean to the same experts
    (a skewed load, whose overflow the capacity drops)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + shared * rng.standard_normal(shape[-1])
    return jnp.asarray(x, jnp.dtype(dtype))


# ------------------------------------------------------------------ Mamba
def test_drawn_mamba_leaves_are_carried():
    _, _, jp, tp = _model(JAMBA, "bfloat16")
    mixer = tp["blocks"][0]["mixer"]
    for name in DRAWN:
        want = np.asarray(jp["blocks"][0]["mixer"][name])
        got = mixer[name]
        assert str(got.dtype).replace("torch.", "") == want.dtype.name, name
        np.testing.assert_array_equal(_f32(got), want.astype(np.float32),
                                      err_msg=name)
    assert {k for k, v in mixer.items() if v.dtype == torch.float32} == \
        {"dt_bias", "A_log", "D"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [9, 2])
def test_mamba_apply_then_decode(dtype, T):
    """The Mamba mixer over a sequence (y and state; T = 2 is shorter
    than the conv's 3-input tail), then three one-token steps from that
    state; the port writes the state in place."""
    j, tcfg, jl, tl = _layer(JAMBA, dtype, 0, "mixer")
    x = _x((2, T, j.d_model), dtype, 6 + T)
    y_j, st_j = JL.mamba_apply(jl, x, j)
    y_j, st_j = jax.block_until_ready((y_j, st_j))
    y_t, st_t = TL.mamba_apply(tl, _t(x), tcfg)
    _close(y_t, y_j, dtype, "port mamba_apply y against the reference's")
    _close(st_t["ssm"], st_j["ssm"], dtype, "port ssm state")
    _close(st_t["conv"], st_j["conv"], dtype, "port conv state")
    assert st_t["ssm"].dtype == torch.float32
    assert st_t["conv"].dtype == y_t.dtype == _t(x).dtype
    state = {"ssm": st_t["ssm"].clone(), "conv": st_t["conv"].clone()}
    bufs = dict(state)
    for step in range(3):
        xt = _x((2, 1, j.d_model), dtype, 20 + step)
        y_j, st_j = jax.block_until_ready(JL.mamba_decode(jl, xt, j, st_j))
        y_t, st = TL.mamba_decode(tl, _t(xt), tcfg, state)
        assert st is state and all(state[k] is bufs[k] for k in bufs)
        _close(y_t, y_j, dtype, f"port mamba_decode y, step {step}")
        _close(state["ssm"], st_j["ssm"], dtype,
               f"port ssm state, step {step}")
        _close(state["conv"], st_j["conv"], dtype,
               f"port conv state, step {step}")


def test_mamba_prefill_state_is_written_in_place():
    j, tcfg, _, tl = _layer(JAMBA, "float32", 0, "mixer")
    x = _t(_x((2, 7, j.d_model), "float32", 3))
    y, st = TL.mamba_apply(tl, x, tcfg)
    state = {"ssm": torch.full_like(st["ssm"], 5.0),
             "conv": torch.full_like(st["conv"], 5.0)}
    bufs = dict(state)
    y2, st2 = TL.mamba_apply(tl, x, tcfg, state=state)
    assert st2 is state and all(state[k] is bufs[k] for k in bufs)
    for k in ("ssm", "conv"):
        torch.testing.assert_close(state[k], st[k], rtol=0, atol=0)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)


# -------------------------------------------------------------------- MoE
def _ref_routing(jl, x, j, cf):
    """The reference's routing of x, as its `moe_apply` computes it:
    (gate_idx [B,S,K], kept [B,S,K] bool), numpy."""
    B, S, _ = x.shape
    E, K, cf = j.n_experts, j.top_k, cf or j.moe_capacity_factor
    C = min(max(int(cf * S * K / E), 4), S)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jl["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32).reshape(B, S * K, E)
    pos = ((jnp.cumsum(onehot, axis=1) - onehot) * onehot).sum(-1)
    return np.array(idx), np.array(pos.reshape(B, S, K) < C)


def _assert_same_routing(tl, jl, x, j, tcfg, cf):
    """The port's routing equals the reference's; returns the number of
    choices dropped."""
    idx_j, kept_j = _ref_routing(jl, x, j, cf)
    _, idx_t, slot_t = TL.moe_route(tl, _t(x), tcfg, capacity_factor=cf)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j,
                                  err_msg="routing flipped: port vs "
                                  "reference expert ids")
    np.testing.assert_array_equal(slot_t.numpy() >= 0, kept_j,
                                  err_msg="port vs reference kept choices")
    return int((~kept_j).sum())


def _share(tl, lo, hi):
    """The port's layer holding experts [lo, hi) of `tl`'s."""
    return {k: (v[lo:hi] if k in ("w_up", "w_gate", "w_down", "expert_ids")
                else v) for k, v in tl.items()}


@pytest.mark.parametrize("arch", [JAMBA, MIXTRAL])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_apply_matches_the_reference(arch, dtype, cf):
    """At 1.25 some choices overflow their expert's queue and are
    dropped (asserted), at 8.0 none is."""
    j, tcfg, jl, tl = _layer(arch, dtype, 1 if arch == JAMBA else 0, "mlp")
    x = _x((2, 40, j.d_model), dtype, 7, shared=1.0)
    dropped = _assert_same_routing(tl, jl, x, j, tcfg, cf)
    assert (dropped > 0) == (cf == 1.25), dropped
    want = jax.block_until_ready(JL.moe_apply(jl, x, j, capacity_factor=cf))
    got = TL.moe_apply(tl, _t(x), tcfg, capacity_factor=cf)
    assert got.dtype == _t(x).dtype and got.shape == x.shape
    _close(got, want, dtype, "port moe_apply against the reference's")


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_expert_shares_sum_to_the_whole_layer(cf):
    """f32: experts [0, E/2) plus [E/2, E) = the reference's layer; the
    capacity and the softmax keep E (a share that took E from its
    weights would halve the softmax's width and change C)."""
    j, tcfg, jl, tl = _layer(JAMBA, "float32", 3, "mlp")
    x = _x((2, 40, j.d_model), "float32", 8, shared=1.0)
    _assert_same_routing(tl, jl, x, j, tcfg, cf)
    want = jax.block_until_ready(JL.moe_apply(jl, x, j, capacity_factor=cf))
    E = j.n_experts
    lo, hi = _share(tl, 0, E // 2), _share(tl, E // 2, E)
    assert lo["w_up"].shape[0] == E // 2
    got = sum(TL.moe_apply(p, _t(x), tcfg, capacity_factor=cf)
              for p in (lo, hi))
    _close(got, want, "float32", "port shares' sum against the reference")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_share_equals_the_reference_with_the_rest_zeroed(dtype):
    j, tcfg, jl, tl = _layer(JAMBA, dtype, 5, "mlp")
    E = j.n_experts
    x = _x((2, 40, j.d_model), dtype, 9, shared=1.0)
    _assert_same_routing(tl, jl, x, j, tcfg, 0.0)
    zeroed = dict(jl, w_down=jl["w_down"].at[E // 2:].set(0))
    want = jax.block_until_ready(JL.moe_apply(zeroed, x, j))
    got = TL.moe_apply(_share(tl, 0, E // 2), _t(x), tcfg)
    _close(got, want, dtype, "port share [0, E/2) against the reference "
           "with the other experts' w_down zeroed")


def test_params_from_numpy_takes_an_expert_share():
    j, tcfg, jp, _ = _model(JAMBA, "bfloat16")
    share = TM.params_from_numpy(tcfg, jax.tree.map(np.array, jp), "cpu",
                                 experts=[1, 3])
    mlp, ref = share["blocks"][1]["mlp"], jp["blocks"][1]["mlp"]
    assert mlp["expert_ids"].tolist() == [[1, 3]] * j.n_periods
    for k in ("w_up", "w_gate", "w_down"):
        np.testing.assert_array_equal(
            mlp[k].view(torch.int16).numpy(),
            np.asarray(ref[k])[:, [1, 3]].view(np.int16), err_msg=k)
    np.testing.assert_array_equal(mlp["router"].numpy(),
                                  np.asarray(ref["router"]))
    meta = TM.init_params(tcfg, None, "meta", experts=[1, 3])
    assert meta["blocks"][1]["mlp"]["w_down"].shape == \
        (j.n_periods, 2, j.d_ff, j.d_model)
    with pytest.raises(ValueError, match="ascending"):
        TM.init_params(tcfg, None, "meta", experts=[3, 1])


# ------------------------------------------------------------ whole models
def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()
                if k != "expert_ids"}
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", [JAMBA, MIXTRAL])
def test_param_tree_and_cache_spec_match_the_reference(arch):
    """Full size: the tree (less `expert_ids`) and the cache layout
    equal the reference's `eval_shape` tree and `cache_spec`."""
    j = JC.get_config(arch)
    want = jax.eval_shape(lambda k: JM.init_params(k, j),
                          jax.random.PRNGKey(0))
    got = TM.init_params(_port_cfg(j), None, "meta")
    assert _shapes(got) == _shapes(want)
    ids = [b["mlp"]["expert_ids"] for b in got["blocks"]
           if "expert_ids" in b["mlp"]]
    assert ids and all(t.shape == (j.n_periods, j.n_experts) for t in ids)
    name = lambda dt: str(dt).replace("torch.", "") \
        if isinstance(dt, torch.dtype) else np.dtype(dt).name
    norm = lambda spec: tuple(
        {k: (tuple(shape), name(dt)) for k, (shape, dt) in e.items()}
        for e in spec["blocks"])
    assert norm(TM.cache_spec(_port_cfg(j), 8, 1088)) == \
        norm(JM.cache_spec(j, 8, 1088))


class _Routes:
    """The experts the reference's MoE layers choose, recorded in call
    order from its `moe_apply`'s concrete inputs, and replayed in that
    order into the port's `moe_route`: the port keeps its own gate
    values (its router's softmax at the replayed experts, renormalised)
    and assigns the slots itself.  `flips` counts the choices where the
    port's own routing differed from the reference's."""

    def __init__(self, monkeypatch):
        self.ref, self.n, self.replayed, self.flips = [], 0, 0, 0
        j_apply, t_route = JL.moe_apply, TL.moe_route

        def j_rec(p, x, cfg, **kw):
            probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], -1)
            self.ref.append(np.array(jax.lax.top_k(probs, cfg.top_k)[1]))
            return j_apply(p, x, cfg, **kw)

        def t_replay(p, x, cfg, *, capacity_factor=0.0):
            _, own, _ = t_route(p, x, cfg, capacity_factor=capacity_factor)
            idx = torch.from_numpy(self.ref[self.n]).long()
            self.n += 1
            self.replayed += 1
            self.flips += int((own != idx).sum())
            vals = torch.softmax(x.float() @ p["router"], -1).gather(-1, idx)
            vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
            C = TL.moe_capacity(cfg, x.shape[1], capacity_factor)
            return vals, idx, TL.moe_slots(idx, cfg.n_experts, C)

        monkeypatch.setattr(JL, "moe_apply", j_rec)
        monkeypatch.setattr(TL, "moe_route", t_replay)

    def check(self, what, dtype, passes=1):
        """Every recorded call was replayed `passes` times; in f32 no
        choice flipped (in bf16 the two frameworks' roundings may flip a
        near tie, and a flip moves the rest of the model by a whole
        expert: the replay keeps the comparison on the arithmetic)."""
        assert self.replayed == passes * len(self.ref) > 0, \
            f"{what}: MoE calls"
        if dtype == "float32":
            assert self.flips == 0, (f"{what}: the port's routing flipped "
                                     f"{self.flips} choices (f32)")
        self.ref.clear()
        self.n = self.replayed = 0

    def rewind(self):
        """Replay the recorded calls once more (the f32 run below)."""
        self.n = 0


def _tree32(tree):
    if isinstance(tree, dict):
        return {k: _tree32(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree32(v) for v in tree)
    return tree.float() if tree.dtype == torch.bfloat16 else tree


def _close_model(got, want, exact, dtype, what):
    """f32: `_close`.  bf16: the port's distance from `exact` (the port
    in f32 on the same weights, widened, and the same routing) within
    3e-2 of max |exact|, or, where the model's own bf16 rounding takes
    the reference further than that, within 1.5x the reference's own
    distance from `exact`.  Jamba's smoke variant stacks 16 bf16 layers:
    there both packages' bf16 logits lie ~5e-2 of max-abs from the f32
    model (and from each other)."""
    if exact is None:
        return _close(got, want, dtype, what)
    got, want, exact = _f32(got), _f32(want), _f32(exact)
    scale = np.abs(exact).max()
    d_port = np.abs(got - exact).max() / scale
    d_ref = np.abs(want - exact).max() / scale
    assert np.isfinite(got).all() and d_port <= max(3e-2, 1.5 * d_ref), \
        (f"{what}: port bf16 {d_port:.4g} of max-abs from the f32 model, "
         f"reference bf16 {d_ref:.4g}")


# (batch, tokens, prompt, cache length) of the whole-model tests
_LENGTHS = {JAMBA: (2, 12, 9, 12), MIXTRAL: (2, 68, 64, 64)}


@pytest.mark.parametrize("arch", [JAMBA, MIXTRAL])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_the_reference(arch, dtype,
                                                    monkeypatch):
    """Logits of `forward`, then `prefill` and `decode_step`s, and the
    caches after them, with the reference's expert choices replayed into
    the port (in f32 asserted equal to the port's own).  Mixtral runs
    past its smoke window (64): a 64-token prompt into a cache of the
    window, then decode steps that overwrite its oldest slots."""
    j, tcfg, jp, tp = _model(arch, dtype)
    bf16 = dtype == "bfloat16"
    t32, p32 = (_port_cfg(j.with_overrides(**F32)), _tree32(tp)) if bf16 \
        else (None, None)
    routes = _Routes(monkeypatch)
    passes = 2 if bf16 else 1

    def exact(fn, empty=None):
        """`fn(params, cfg)` on the f32 model with the same routing (bf16
        only; `empty` otherwise)."""
        if not bf16:
            return empty
        routes.rewind()
        return fn(p32, t32)

    B, S, P, T = _LENGTHS[arch]
    toks = np.random.default_rng(8).integers(0, j.vocab_size, (B, S))
    want = jax.block_until_ready(JM.forward(jp, j, {"tokens":
                                                    jnp.asarray(toks)}))
    batch = {"tokens": torch.tensor(toks)}
    got = TM.forward(tp, tcfg, batch)
    ex = exact(lambda p, c: TM.forward(p, c, batch))
    routes.check("forward", dtype, passes)
    _close_model(got, want, ex, dtype, "port forward logits")
    lp_j, cache_j = jax.block_until_ready(JM.prefill(
        jp, j, {"tokens": jnp.asarray(toks[:, :P])}, cache_len=T))
    prompt = {"tokens": torch.tensor(toks[:, :P])}
    lp_t, cache_t = TM.prefill(tp, tcfg, prompt, cache_len=T)
    lp_x, cache_x = exact(lambda p, c: TM.prefill(p, c, prompt,
                                                  cache_len=T), (None, None))
    routes.check("prefill", dtype, passes)
    _close_model(lp_t, lp_j, lp_x, dtype, "port prefill logits")
    for n in range(P, S):
        tok = toks[:, n:n + 1]
        ld_j, cache_j = jax.block_until_ready(JM.decode_step(
            jp, j, jnp.asarray(tok), cache_j, jnp.int32(n)))
        ld_t, cache_t = TM.decode_step(tp, tcfg, torch.tensor(tok),
                                       cache_t, n)
        ld_x, cache_x = exact(lambda p, c: TM.decode_step(
            p, c, torch.tensor(tok), cache_x, n), (None, None))
        routes.check(f"decode step {n}", dtype, passes)
        _close_model(ld_t, ld_j, ld_x, dtype, f"port decode logits at {n}")
    for pos, (entry_t, entry_j) in enumerate(zip(cache_t["blocks"],
                                                 cache_j["blocks"])):
        for name in entry_t:
            got, want = entry_t[name], entry_j[name]
            assert str(got.dtype).replace("torch.", "") == \
                str(want.dtype), (pos, name)
            _close_model(got, want, cache_x["blocks"][pos][name] if bf16
                         else None, dtype, f"port cache {name} at {pos}")


@pytest.mark.parametrize("arch", [JAMBA, MIXTRAL])
def test_port_prefill_decode_matches_port_forward(arch):
    """Teacher forcing in f32 at the smoke variants' drop-free capacity
    (8.0): the caches carry the prompt, so decode logits at position t
    equal the forward's at t (for Mixtral past its window too)."""
    _, tcfg, _, tp = _model(arch, "float32")
    B, S, P, T = _LENGTHS[arch]
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (B, S)))
    full = TM.forward(tp, tcfg, {"tokens": toks})
    logits, cache = TM.prefill(tp, tcfg, {"tokens": toks[:, :P]},
                               cache_len=T)
    torch.testing.assert_close(logits, full[:, P - 1], rtol=1e-4, atol=1e-4)
    for n in range(P, S):
        logits, cache = TM.decode_step(tp, tcfg, toks[:, n:n + 1], cache, n)
        torch.testing.assert_close(logits, full[:, n], rtol=1e-4, atol=1e-4)
