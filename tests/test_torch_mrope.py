"""M-RoPE (`layers.apply_mrope`) and the attention layers that use it or
cross-attention, against the JAX package's `repro.models.layers`, on the
CPU: `apply_mrope` at Qwen2-VL's smoke sections (4, 6, 6) with hd 32 and
its published sections (16, 24, 24) with hd 128, theta 1e6, with three
distinct position streams, within 1e-6 in f32, and its gradient against
`jax.vjp` of the reference's at 1e-6; with the three streams
equal it is `apply_rope` bit for bit.  Then `attention` /
`attention_prefill` / `attention_decode` under M-RoPE, and
cross-attention (`attention(kv_x=)`, `cross_attention_prefill` and
`attention_decode(cross=True)`), at 1e-5 in f32 (one op's summation
order, as tests/test_torch_models.py's layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import repro.configs as JC
import repro.models as JM
from repro.models import layers as JL

import repro_torch.models as TM
from repro_torch.models import layers as TL

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _t(x):
    return torch.from_numpy(np.array(x))


def _positions3(rng, B, S):
    """Three distinct streams: a vision grid then text indices on t, and
    independent draws on h and w."""
    t = np.broadcast_to(np.arange(S), (B, S))
    h = rng.integers(0, 64, (B, S))
    w = rng.integers(0, 1100, (B, S))
    return np.stack([t, h, w]).astype(np.int32)


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 32),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_the_reference(sections, hd):
    rng = np.random.default_rng(hd)
    B, S, H = 2, 24, 3
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    pos3 = _positions3(rng, B, S)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections, 1e6)
    got = TL.apply_mrope(_t(x), _t(pos3), sections, 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 32),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_gradient_matches_the_reference(sections, hd):
    """Under autograd (training Qwen2-VL): the gradient of apply_mrope's
    output against a seeded cotangent equals `jax.vjp` of the
    reference's within 1e-6 (the rotation's transpose)."""
    rng = np.random.default_rng(hd + 1)
    B, S, H = 2, 24, 3
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    ct = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    pos3 = _positions3(rng, B, S)
    _, vjp = jax.vjp(lambda a: JL.apply_mrope(a, jnp.asarray(pos3), sections,
                                              1e6), jnp.asarray(x))
    want = vjp(jnp.asarray(ct))[0]
    xt = _t(x).requires_grad_()
    out = TL.apply_mrope(xt, _t(pos3), sections, 1e6)
    got, = torch.autograd.grad(out, xt, _t(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 32),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_with_equal_streams_is_rope(sections, hd):
    rng = np.random.default_rng(7)
    B, S, H = 2, 17, 2
    x = _t(rng.standard_normal((B, S, H, hd), dtype=np.float32))
    pos = torch.from_numpy(rng.integers(0, 2000, (B, S)))
    got = TL.apply_mrope(x, pos[None].expand(3, B, S), sections, 1e6)
    assert torch.equal(got, TL.apply_rope(x, pos, 1e6))
    with pytest.raises(ValueError, match="sum"):
        TL.apply_mrope(x, pos[None].expand(3, B, S), (1, 2, 3), 1e6)


def _cfg(arch):
    j = JC.smoke_variant(JC.get_config(arch)).with_overrides(**F32)
    d = dataclasses.asdict(j)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return j, TM.ModelConfig(**d)


def _attn_params(j, t, key, cross=False):
    jp = JL.attn_init(jax.random.PRNGKey(key), j, jnp.float32, cross=cross)
    if "bq" in jp:                  # the reference inits biases to zero
        ks = jax.random.split(jax.random.PRNGKey(key + 1), 3)
        jp = {**jp, **{n: 0.1 * jax.random.normal(k, jp[n].shape)
                       for n, k in zip(("bq", "bk", "bv"), ks)}}
    return jp, {k: _t(v) for k, v in jp.items()}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_mrope_attention_layers_match_the_reference():
    j, t = _cfg("qwen2-vl-72b")
    jp, tp = _attn_params(j, t, 3)
    rng = np.random.default_rng(3)
    B, S, T = 2, 10, 16
    x = rng.standard_normal((B, S, j.d_model), dtype=np.float32)
    pos3 = _positions3(rng, B, S)
    pos = jnp.arange(S)
    _close(TL.attention(tp, _t(x), t, positions=torch.arange(S),
                        mrope_positions=_t(pos3)),
           JL.attention(jp, jnp.asarray(x), j, positions=pos,
                        mrope_positions=jnp.asarray(pos3)))
    kc = torch.zeros((B, T, j.n_kv_heads, j.head_dim))
    vc = torch.zeros_like(kc)
    y = TL.attention_prefill(tp, _t(x), t, positions=torch.arange(S),
                             kv_cache=(kc, vc), mrope_positions=_t(pos3))
    yj, (kj, vj) = JL.attention_prefill(jp, jnp.asarray(x), j,
                                        positions=pos, cache_len=T,
                                        mrope_positions=jnp.asarray(pos3))
    _close(y, yj)
    _close(kc, kj)
    _close(vc, vj)
    x1 = rng.standard_normal((B, 1, j.d_model), dtype=np.float32)
    y = TL.attention_decode(tp, _t(x1), t, (kc, vc), pos=S, cache_len=S)
    yj, (kj, vj) = JL.attention_decode(jp, jnp.asarray(x1), j, (kj, vj),
                                       pos=jnp.int32(S),
                                       cache_len=jnp.int32(S))
    _close(y, yj)
    _close(kc, kj)
    _close(vc, vj)


def test_cross_attention_layers_match_the_reference():
    j, t = _cfg("whisper-tiny")
    jp, tp = _attn_params(j, t, 5, cross=True)
    assert "bq" not in tp
    rng = np.random.default_rng(5)
    B, S, T = 2, 6, j.encoder_len - 3      # a short encoder output
    x = rng.standard_normal((B, S, j.d_model), dtype=np.float32)
    enc = rng.standard_normal((B, T, j.d_model), dtype=np.float32)
    want = JL.attention(jp, jnp.asarray(x), j, positions=jnp.arange(S),
                        causal=False, kv_x=jnp.asarray(enc), rope=False)
    _close(TL.attention(tp, _t(x), t, positions=torch.arange(S),
                        causal=False, kv_x=_t(enc), rope=False), want)
    xk = torch.zeros((B, T, j.n_kv_heads, j.head_dim))
    xv = torch.zeros_like(xk)
    _close(TL.cross_attention_prefill(tp, _t(x), t, _t(enc), (xk, xv)),
           want)
    _, kj, vj = JL._qkv(jp, jnp.asarray(x), j, jnp.asarray(enc))
    _close(xk, kj)
    _close(xv, vj)
    x1 = rng.standard_normal((B, 1, j.d_model), dtype=np.float32)
    before = xk.clone(), xv.clone()
    for valid in (1, T - 5, T):
        y = TL.attention_decode(tp, _t(x1), t, (xk, xv), pos=S,
                                cache_len=valid, cross=True)
        yj, _ = JL.attention_decode(jp, jnp.asarray(x1), j, (kj, vj),
                                    pos=jnp.int32(S),
                                    cache_len=jnp.int32(valid), cross=True)
        _close(y, yj)
    assert torch.equal(xk, before[0]) and torch.equal(xv, before[1])
