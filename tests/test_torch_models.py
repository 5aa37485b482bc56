"""The port's model stack (`repro_torch.configs`, `repro_torch.models`)
against the JAX package: configs field for field, the parameter tree's
keys and shapes, `params_from_numpy`, the layers, and forward / prefill /
decode logits on Qwen1.5-0.5B's smoke variant with the reference's
weights carried across.  All on the CPU (the port's plain paths).

Tolerances: layers in f32 at 1e-5 (one op's summation order); whole-model
logits in f32 at rtol = atol = 1e-4 (summation order over 2 layers); in
bf16 at 3e-2 of the logits' max-abs (bf16 rounds at other places in the
two frameworks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC
import repro.models as JM
from repro.models import layers as JL

import repro_torch.configs as TC
import repro_torch.models as TM
from repro_torch.models import layers as TL

QWEN = "qwen1.5-0.5b"
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _t(x):
    """numpy / jax array -> CPU tensor, bf16 bit for bit."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _smoke(dtype="float32"):
    cfg = JC.smoke_variant(JC.get_config(QWEN))
    return cfg.with_overrides(**F32) if dtype == "float32" else cfg


def _port_cfg(jcfg):
    """The port's config with the same fields (LayerSpecs rebuilt)."""
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


def _params(jcfg, seed=0):
    """Reference params (jax) and the same values in the port's tree."""
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    np_tree = jax.tree.map(np.asarray, jp)
    return jp, TM.params_from_numpy(_port_cfg(jcfg), np_tree, "cpu")


# ------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", JC.list_archs())
def test_configs_equal_the_reference(arch):
    assert TC.list_archs() == JC.list_archs()
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(TC.smoke_variant(t)) == \
        dataclasses.asdict(JC.smoke_variant(j))
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.period, t.n_periods, t.q_per_kv, t.is_subquadratic) == \
        (j.period, j.n_periods, j.q_per_kv, j.is_subquadratic)


def test_cells_and_shapes_equal_the_reference():
    assert list(TC.iter_cells()) == list(JC.iter_cells())
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_unported_layers_are_refused(arch):
    cfg = TC.smoke_variant(TC.get_config(arch))
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        TM.init_params(cfg, None, "meta")


# -------------------------------------------------------------- param tree
def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("smoke", [False, True])
def test_param_tree_matches_eval_shape(smoke):
    j = JC.get_config(QWEN)
    j = JC.smoke_variant(j) if smoke else j
    want = jax.eval_shape(lambda k: JM.init_params(k, j),
                          jax.random.PRNGKey(0))
    got = TM.init_params(_port_cfg(j), None, "meta")
    assert _shapes(got) == _shapes(want)
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    assert n == j.param_count()


@pytest.mark.parametrize("smoke", [False, True])
def test_rwkv_param_tree_and_cache_spec_match_the_reference(smoke):
    """RWKV6's tree (bf16 matrices beside the f32 decay, bonus, ddlerp
    bases, groupnorm affine and channel-mix lerps) and its cache layout
    (bf16 shifts, f32 state) equal the reference's `eval_shape` tree and
    `cache_spec`."""
    j = JC.get_config("rwkv6-3b")
    j = JC.smoke_variant(j) if smoke else j
    want = jax.eval_shape(lambda k: JM.init_params(k, j),
                          jax.random.PRNGKey(0))
    got = TM.init_params(_port_cfg(j), None, "meta")
    assert _shapes(got) == _shapes(want)
    f32 = {k for k, v in got["blocks"][0]["mixer"].items()
           if v.dtype == torch.float32}
    assert f32 == {"w_base", "u", "mix_base", "ln_w", "ln_b"}
    for batch, seq in ((2, 12), (8, 1088)):
        want = JM.cache_spec(j, batch, seq)
        got = TM.cache_spec(_port_cfg(j), batch, seq)
        name = lambda dt: str(dt).replace("torch.", "") \
            if isinstance(dt, torch.dtype) else np.dtype(dt).name
        norm = lambda spec: tuple(
            {k: (tuple(shape), name(dt)) for k, (shape, dt) in e.items()}
            for e in spec["blocks"])
        assert norm(got) == norm(want)


def test_init_params_draws_from_the_generator():
    cfg = _port_cfg(_smoke())
    a = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a["blocks"][0]["mlp"]["w_up"],
                       b["blocks"][0]["mlp"]["w_up"])
    w = a["blocks"][0]["mixer"]["wq"]
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.01
    assert torch.equal(a["blocks"][0]["mixer"]["bq"],
                       torch.zeros_like(a["blocks"][0]["mixer"]["bq"]))


def test_params_from_numpy_round_trips_and_checks():
    j = _smoke("bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(1), j)
    np_tree = jax.tree.map(np.asarray, jp)
    port = TM.params_from_numpy(_port_cfg(j), np_tree, "cpu")
    for (path, ref), got in zip(
            jax.tree_util.tree_leaves_with_path(np_tree),
            jax.tree.leaves(jax.tree.map(lambda x: x, port))):
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))
    bad = jax.tree.map(lambda x: x, np_tree)
    del bad["blocks"][0]["mixer"]["bq"]
    with pytest.raises(ValueError, match="keys"):
        TM.params_from_numpy(_port_cfg(j), bad, "cpu")
    bad = jax.tree.map(lambda x: x, np_tree)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        TM.params_from_numpy(_port_cfg(j), bad, "cpu")
    bad = jax.tree.map(lambda x: x.astype(np.float32), np_tree)
    with pytest.raises(ValueError, match="float32"):
        TM.params_from_numpy(_port_cfg(j), bad, "cpu")


# ------------------------------------------------------------------- layers
def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(_f32(TL.rmsnorm(_t(x), _t(w))),
                               np.asarray(JL.rmsnorm(x, w)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(TL.layernorm(_t(x), _t(w), _t(b))),
                               np.asarray(JL.layernorm(x, w, b)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("pos_rank", [1, 2])
def test_apply_rope(fraction, pos_rank):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.arange(7) + 5 if pos_rank == 1 else \
        rng.integers(0, 1000, (2, 7))
    want = np.asarray(JL.apply_rope(x, jnp.asarray(pos), 10_000.0, fraction))
    got = TL.apply_rope(_t(x), torch.as_tensor(pos), 10_000.0, fraction)
    np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_apply(act):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
         (("w_up", (d, f)), ("w_down", (f, d)), ("w_gate", (d, f)))}
    if act not in ("swiglu", "geglu"):
        del p["w_gate"]
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = np.asarray(JL.mlp_apply(p, x, act))
    got = TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), act)
    np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5)


def _layer(jcfg, jp):
    """Layer 0's attention params: reference (jax) and port (torch)."""
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mixer"])
    tattn = {k: _t(v) for k, v in jattn.items()}
    return jattn, tattn


@pytest.mark.parametrize("cache_len", [12, 16])
def test_attention_prefill_and_decode(cache_len):
    """Prefill's output and installed cache, then two decode steps (the
    score path of `attention_decode`) with their cache writes; the
    reference's caches are returned arrays, the port's are written in
    place."""
    j = _smoke()
    jp, _ = _params(j)
    jattn, tattn = _layer(j, jp)
    tcfg = _port_cfg(j)
    rng = np.random.default_rng(3)
    B, S = 2, 12
    x = rng.standard_normal((B, S, j.d_model)).astype(np.float32)
    pos = np.arange(S)
    y_j, (kc_j, vc_j) = JL.attention_prefill(jattn, x, j, positions=pos,
                                             cache_len=cache_len)
    kc = torch.zeros((B, cache_len, j.n_kv_heads, j.head_dim))
    vc = torch.zeros_like(kc)
    y_t = TL.attention_prefill(tattn, _t(x), tcfg,
                               positions=torch.as_tensor(pos),
                               kv_cache=(kc, vc))
    np.testing.assert_allclose(_f32(y_t), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_f32(kc), np.asarray(kc_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_f32(vc), np.asarray(vc_j), rtol=1e-5,
                               atol=1e-5)
    n = S
    for step in range(2):
        xt = rng.standard_normal((B, 1, j.d_model)).astype(np.float32)
        y_j, (kc_j, vc_j) = JL.attention_decode(
            jattn, xt, j, (kc_j, vc_j), pos=jnp.int32(n),
            cache_len=jnp.int32(n))
        y_t = TL.attention_decode(tattn, _t(xt), tcfg, (kc, vc), pos=n,
                                  cache_len=n)
        np.testing.assert_allclose(_f32(y_t), np.asarray(y_j), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(_f32(kc), np.asarray(kc_j), rtol=1e-5,
                                   atol=1e-5)
        n += 1


# -------------------------------------------------------------- whole model
def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _close(got, want, dtype):
    got, want = _f32(got), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        tol = 3e-2 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_the_reference(dtype):
    j = _smoke(dtype)
    tcfg = _port_cfg(j)
    jp, tp = _params(j, seed=4)
    B, S, P = 2, 12, 9
    toks = _tokens(j, B, S, seed=5)
    full_j = JM.forward(jp, j, {"tokens": jnp.asarray(toks)})
    full_t = TM.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    _close(full_t, full_j, dtype)
    lp_j, cache_j = JM.prefill(jp, j, {"tokens": jnp.asarray(toks[:, :P])},
                               cache_len=S)
    lp_t, cache_t = TM.prefill(tp, tcfg, {"tokens": torch.as_tensor(
        toks[:, :P])}, cache_len=S)
    _close(lp_t, lp_j, dtype)
    for n in range(P, S):
        tok = toks[:, n:n + 1]
        ld_j, cache_j = JM.decode_step(jp, j, jnp.asarray(tok), cache_j,
                                       jnp.int32(n))
        ld_t, cache_t = TM.decode_step(tp, tcfg, torch.as_tensor(tok),
                                       cache_t, n)
        _close(ld_t, ld_j, dtype)
    kv_j = np.asarray(cache_j["blocks"][0]["k"], np.float32)
    _close(cache_t["blocks"][0]["k"], kv_j, dtype)


def test_port_prefill_decode_matches_port_forward():
    """Teacher forcing, as tests/test_models_smoke.py's
    test_prefill_decode_matches_forward: decode logits at position t
    equal the forward's at t (f32)."""
    j = _smoke()
    tcfg = _port_cfg(j)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    B, S = 2, 12
    toks = torch.as_tensor(_tokens(j, B, S, seed=6))
    full = TM.forward(tp, tcfg, {"tokens": toks})
    logits, cache = TM.prefill(tp, tcfg, {"tokens": toks[:, :S - 3]},
                               cache_len=S)
    torch.testing.assert_close(logits, full[:, S - 4], rtol=1e-4, atol=1e-4)
    for n in range(S - 3, S):
        logits, cache = TM.decode_step(tp, tcfg, toks[:, n:n + 1], cache, n)
        torch.testing.assert_close(logits, full[:, n], rtol=1e-4, atol=1e-4)
