"""The port's RWKV6 (`repro_torch.models` on RWKV6-3B's smoke variant)
against the JAX package on the CPU: the time-mix pieces (`_rwkv_ddlerp`,
`rwkv_apply`, `rwkv_decode`) and the channel-mix, then `forward`, and
`prefill` followed by `decode_step`, logits and states, with the
reference's weights carried by `params_from_numpy`; and
`ServingEngine(device="cpu")` serving RWKV from a pinned snapshot while
a writer publishes.

The reference initialises `u`, `mix_base`, `mix_k`, `mix_r` and `ln_b`
to zero (and `w_base`, `ln_w` to constants), which would hide a fault in
the bonus term, the ddlerp bases, the channel-mix lerp or the groupnorm
affine: those leaves are drawn from a numpy seed and carried to both
packages.

Tolerances: f32 at rtol = atol = 1e-4 (the reference's WKV is an
associative scan, the port's plain path a sequential one: the kernel
tests' tolerance); bf16 logits and states within 3e-2 of their max-abs
(bf16 rounds at other places in the two frameworks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
import repro.models as JM  # noqa: E402
from repro.models import layers as JL  # noqa: E402

import repro_torch.models as TM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from repro_torch.tensorstore import VersionedParamStore  # noqa: E402

RWKV = "rwkv6-3b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
# leaves the reference initialises to constants, drawn here instead
DRAWN = {"u": lambda r, s: 0.5 * r.standard_normal(s),
         "mix_base": lambda r, s: r.uniform(0, 1, s),
         "mix_k": lambda r, s: r.uniform(0, 1, s),
         "mix_r": lambda r, s: r.uniform(0, 1, s),
         "ln_b": lambda r, s: 0.1 * r.standard_normal(s),
         "ln_w": lambda r, s: 1 + 0.2 * r.standard_normal(s),
         "w_base": lambda r, s: r.uniform(-6, -1, s)}


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


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


def _smoke(dtype):
    cfg = JC.smoke_variant(JC.get_config(RWKV))
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


def _model(dtype):
    """(reference cfg, port cfg, reference params, port params), once per
    dtype for the module."""
    if dtype not in _MODELS:
        j = _smoke(dtype)
        jp = _draw(JM.init_params(jax.random.PRNGKey(4), j), seed=5)
        tp = TM.params_from_numpy(_port_cfg(j), jax.tree.map(np.asarray, jp),
                                  "cpu")
        _MODELS[dtype] = (j, _port_cfg(j), jp, tp)
    return _MODELS[dtype]


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())


def _layer0(dtype, part):
    j, tcfg, jp, tp = _model(dtype)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][0][part])
    tl = {k: v[0] for k, v in tp["blocks"][0][part].items()}
    return j, tcfg, jl, tl


# ------------------------------------------------------------------ layers
def test_drawn_leaves_are_carried_and_nonzero():
    j, _, jp, tp = _model("bfloat16")
    mixer, mlp = tp["blocks"][0]["mixer"], tp["blocks"][0]["mlp"]
    for name, t in (("u", mixer["u"]), ("mix_base", mixer["mix_base"]),
                    ("ln_b", mixer["ln_b"]), ("mix_k", mlp["mix_k"]),
                    ("mix_r", mlp["mix_r"])):
        assert t.dtype == torch.float32 and t.abs().min() > 0, name
        src = jp["blocks"][0]["mlp" if name.startswith("mix_") and
                              name != "mix_base" else "mixer"][name]
        np.testing.assert_array_equal(t.numpy(), np.asarray(src))
    assert mixer["wr"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddlerp_and_channel_mix(dtype):
    j, _, jl, tl = _layer0(dtype, "mixer")
    _, _, jm, tm = _layer0(dtype, "mlp")
    rng = np.random.default_rng(6)
    x, xp = (rng.standard_normal((2, 7, j.d_model)).astype(np.float32)
             for _ in range(2))
    jx, jxp = (jnp.asarray(a, jnp.dtype(dtype)) for a in (x, xp))
    tx, txp = (_t(np.asarray(a)) for a in (jx, jxp))
    for got, want in zip(TL._rwkv_ddlerp(tl, tx, txp),
                         JL._rwkv_ddlerp(jl, jx, jxp)):
        # the f32 bases promote the stream, in both packages
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        _close(got, want, "float32")
    got = TL.rwkv_cmix_apply(tm, tx, txp)
    want = JL.rwkv_cmix_apply(jm, jx, jxp)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_apply_then_decode(dtype):
    """The time-mix over a sequence (y and state), then two one-token
    steps from that state; the port writes the state in place."""
    j, tcfg, jl, tl = _layer0(dtype, "mixer")
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 9, j.d_model)), jnp.dtype(dtype))
    y_j, st_j = JL.rwkv_apply(jl, x, j)
    y_t, st_t = TL.rwkv_apply(tl, _t(np.asarray(x)), tcfg)
    _close(y_t, y_j, dtype)
    _close(st_t["shift"], st_j["shift"], dtype)
    _close(st_t["wkv"], st_j["wkv"], dtype)
    state = {"shift": st_t["shift"].clone(), "wkv": st_t["wkv"].clone()}
    wkv_buf = state["wkv"]
    for step in range(2):
        xt = jnp.asarray(rng.standard_normal((2, 1, j.d_model)),
                         jnp.dtype(dtype))
        y_j, st_j = JL.rwkv_decode(jl, xt, j, st_j)
        y_t, st_t = TL.rwkv_decode(tl, _t(np.asarray(xt)), tcfg, state)
        assert st_t is state and state["wkv"] is wkv_buf
        _close(y_t, y_j, dtype)
        _close(state["shift"], st_j["shift"], dtype)
        _close(state["wkv"], st_j["wkv"], dtype)


# -------------------------------------------------------------- whole model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_the_reference(dtype):
    j, tcfg, jp, tp = _model(dtype)
    B, S, P = 2, 12, 9
    toks = np.random.default_rng(8).integers(0, j.vocab_size, (B, S))
    _close(TM.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)}),
           JM.forward(jp, j, {"tokens": jnp.asarray(toks)}), dtype)
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
    for name in ("shift", "wkv", "cmix_shift"):
        got, want = cache_t["blocks"][0][name], cache_j["blocks"][0][name]
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
        _close(got, want, dtype)


def test_port_prefill_decode_matches_port_forward():
    """Teacher forcing in f32: the recurrent state carries the prompt, so
    decode logits at position t equal the forward's at t."""
    _, tcfg, _, tp = _model("float32")
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 12)))
    full = TM.forward(tp, tcfg, {"tokens": toks})
    logits, cache = TM.prefill(tp, tcfg, {"tokens": toks[:, :8]},
                               cache_len=12)
    torch.testing.assert_close(logits, full[:, 7], rtol=1e-4, atol=1e-4)
    for n in range(8, 12):
        logits, cache = TM.decode_step(tp, tcfg, toks[:, n:n + 1], cache, n)
        torch.testing.assert_close(logits, full[:, n], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ serving
def test_engine_serves_rwkv_from_a_pinned_snapshot_while_a_writer_publishes():
    """Request 1 pins v1; the writer publishes v2 between its steps (and
    the replica replays it); every token of request 1 is the greedy
    choice of the port's model on v1, and request 2 pins v2."""
    _, tcfg, _, v1 = _model("float32")
    v2 = dict(v1, embed=v1["embed"] + 0.05 * torch.from_numpy(
        np.random.default_rng(10).standard_normal(
            tuple(v1["embed"].shape)).astype(np.float32)))
    store = VersionedParamStore(slots=2)
    eng = ServingEngine(tcfg, store, max_seq=24, device="cpu")
    store.publish(v1)
    eng.refresh()
    prompt = torch.as_tensor(np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (2, 10)))
    refresh, published = eng.refresh, []

    def writer_then_refresh():
        if not published:                 # the trainer commits mid-request
            published.append(store.publish(v2))
        return refresh()

    eng.refresh = writer_then_refresh
    r1 = eng.generate({"tokens": prompt}, 6, refresh_between_steps=True)
    eng.refresh = refresh
    assert published and store.visible_lsn() > r1.snapshot_lsn
    logits, cache = TM.prefill(v1, tcfg, {"tokens": prompt}, cache_len=16)
    for k in range(6):
        want = logits.argmax(dim=-1)
        assert torch.equal(r1.tokens[:, k], want), k
        logits, cache = TM.decode_step(v1, tcfg, want[:, None], cache,
                                       10 + k)
    r2 = eng.generate({"tokens": prompt}, 6)
    assert r2.snapshot_lsn > r1.snapshot_lsn and r2.freshness_lag == 0
    assert store.stats["gc_blocked"] == 0 and not store._pins
