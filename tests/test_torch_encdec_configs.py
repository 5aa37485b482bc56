"""Whole-model parity of the two configs with a frontend stub: the smoke
variants of whisper-tiny (an encoder over stub frame embeddings, a
decoder with cross-attention, LayerNorm, GELU) and qwen2-vl-72b (M-RoPE
at sections (4, 6, 6), vision-embedding stub, QKV bias, GQA), with the
reference's weights carried by `params_from_numpy`: forward, prefill
(logits and every cache entry slot for slot: k, v, and Whisper's
cross-attention xk, xv) and 3 decode steps against the JAX package, on
the CPU, at the tolerances of tests/test_torch_dense_configs.py (f32
rtol = atol = 1e-4; bf16 3e-2 of the compared tensor's max-abs).  Plus
`ServingEngine.generate` against the reference engine on Whisper.

Inputs are made with numpy from a seed.  Whisper's frames are rounded to
the parameter dtype before either package sees them, as the reference's
serve launcher hands them: the port's encoder takes frames in that dtype
only and refuses others (the reference would promote f32 frames against
bf16 weights to an f32 encoder).  Qwen2-VL's prompt starts
with a vision stub of S//4 rows on a grid (t = 0, h = i // w, w = i % w)
and its text tokens take their index on all three position streams, as
do the decode steps (the reference's decode rotates at (pos, pos, pos)),
so the forward over the whole sequence sees the positions prefill and
decode saw."""

import dataclasses

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
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.tensorstore import VersionedParamStore as TStore

F32 = dict(param_dtype="float32", compute_dtype="float32")
B, S, P = 2, 12, 9              # batch, whole sequence, prompt
ARCHS = ["whisper-tiny", "qwen2-vl-72b"]


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())


def _cfg(arch, dtype):
    j = JC.smoke_variant(JC.get_config(arch))
    return j.with_overrides(**F32) if dtype == "float32" else j


def mrope_grid(B: int, S: int, n_vision: int, width: int) -> np.ndarray:
    """[3, B, S] positions: the first `n_vision` rows on a grid of `width`
    columns (t = 0, h = i // width, w = i % width), every later row its
    index on all three streams."""
    pos = np.broadcast_to(np.arange(S), (3, B, S)).copy()
    i = np.arange(n_vision)
    pos[0, :, :n_vision] = 0
    pos[1, :, :n_vision] = i // width
    pos[2, :, :n_vision] = i % width
    return pos


def _inputs(j, seed=5):
    """Numpy inputs over the whole sequence: tokens [B, S] and the
    config's stub inputs."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, j.vocab_size, (B, S))}
    if j.is_encoder_decoder:
        frames = rng.standard_normal((B, j.encoder_len, j.d_model),
                                     dtype=np.float32) * 0.02
        out["enc_embeds"] = np.array(
            jnp.asarray(frames).astype(jnp.dtype(j.param_dtype)))
    if j.mrope_sections:
        out["vision_embeds"] = rng.standard_normal(
            (B, P // 4, j.d_model), dtype=np.float32) * 0.02
        out["mrope_positions"] = mrope_grid(B, S, P // 4, 2)
    return out


def _batches(inp, upto):
    """(jax batch, port batch) of the first `upto` tokens."""
    cut = dict(inp, tokens=inp["tokens"][:, :upto])
    if "mrope_positions" in inp:
        cut["mrope_positions"] = inp["mrope_positions"][:, :, :upto]
    jb = {k: jnp.asarray(v) for k, v in cut.items()}
    tb = {k: TM.convert._torch_from_numpy(np.asarray(v))
          for k, v in cut.items()}
    return jb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_the_reference(arch, dtype):
    j = _cfg(arch, dtype)
    tcfg = _port_cfg(j)
    jp = JM.init_params(jax.random.PRNGKey(4), j)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    inp = _inputs(j)
    jb, tb = _batches(inp, S)
    _close(TM.forward(tp, tcfg, tb), JM.forward(jp, j, jb), dtype)
    jb, tb = _batches(inp, P)
    lp_j, cache_j = JM.prefill(jp, j, jb, cache_len=S)
    lp_t, cache_t = TM.prefill(tp, tcfg, tb, cache_len=S)
    _close(lp_t, lp_j, dtype)
    keys = ("k", "v", "xk", "xv") if j.is_encoder_decoder else ("k", "v")
    assert set(cache_t["blocks"][0]) == set(keys)
    for key in keys:
        _close(cache_t["blocks"][0][key], cache_j["blocks"][0][key], dtype)
    for n in range(P, S):
        tok = inp["tokens"][:, n:n + 1]
        ld_j, cache_j = JM.decode_step(jp, j, jnp.asarray(tok), cache_j,
                                       jnp.int32(n))
        ld_t, cache_t = TM.decode_step(tp, tcfg, torch.as_tensor(tok),
                                       cache_t, n)
        _close(ld_t, ld_j, dtype)
    for key in keys:
        _close(cache_t["blocks"][0][key], cache_j["blocks"][0][key], dtype)


def test_frames_outside_the_parameter_dtype_are_refused():
    """The encoder takes frames in the parameter dtype: f32 frames
    against bf16 weights (which the reference would run in f32) and bf16
    frames against f32 weights are refused, not cast."""
    for dtype, frames in (("bfloat16", torch.float32),
                          ("float32", torch.bfloat16)):
        j = _cfg("whisper-tiny", dtype)
        tcfg = _port_cfg(j)
        tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.zeros((1, 2), dtype=torch.long),
                 "enc_embeds": torch.zeros((1, j.encoder_len, j.d_model),
                                           dtype=frames)}
        with pytest.raises(TypeError, match="parameter dtype"):
            TM.forward(tp, tcfg, batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_embeds_longer_than_the_prompt_are_refused(dtype):
    """S_v > S: the reference pads only a shorter stub and then fails to
    add [B, S_v, D] to [B, S, D]; the port refuses it with a ValueError
    that names both shapes (it cropped the stub's tail before).  S_v = S
    and S_v < S still run in both."""
    j = _cfg("qwen2-vl-72b", dtype)
    tcfg = _port_cfg(j)
    jp = JM.init_params(jax.random.PRNGKey(2), j)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, j.vocab_size, (B, 4))
    for s_v in (6, 4, 2):
        ve = rng.standard_normal((B, s_v, j.d_model), dtype=np.float32)
        jb = {"tokens": jnp.asarray(tokens), "vision_embeds": jnp.asarray(ve)}
        tb = {"tokens": torch.from_numpy(tokens),
              "vision_embeds": torch.from_numpy(ve)}
        if s_v > tokens.shape[1]:
            with pytest.raises((TypeError, ValueError)):
                JM.embed_inputs(jp, j, jb)
            with pytest.raises(ValueError, match=r"\(2, 6, 128\).*"
                               r"\(2, 4, 128\)"):
                TM.embed_inputs(tp, tcfg, tb)
        else:
            _close(TM.embed_inputs(tp, tcfg, tb),
                   JM.embed_inputs(jp, j, jb), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_cache_spec_match_the_reference(arch):
    """The tree (Whisper's enc_blocks, enc_final_norm, norm_x and the
    bias-free cross projections) matches the reference's `eval_shape`
    leaf for leaf, and the cache layout its `cache_spec`."""
    j = JC.smoke_variant(JC.get_config(arch))
    want = jax.eval_shape(lambda k: JM.init_params(k, j),
                          jax.random.PRNGKey(0))
    got = TM.init_params(_port_cfg(j), None, "meta")
    flat = lambda t: {jax.tree_util.keystr(p): (tuple(x.shape),
                                                str(x.dtype))
                      for p, x in jax.tree_util.tree_leaves_with_path(t)}
    tflat = {k: (s, d.replace("torch.", "")) for k, (s, d) in flat(
        jax.tree.map(lambda t: jax.ShapeDtypeStruct(
            t.shape, str(t.dtype).replace("torch.", "")), got)).items()}
    assert tflat == flat(want)
    name = lambda dt: str(dt).replace("torch.", "") \
        if isinstance(dt, torch.dtype) else np.dtype(dt).name
    norm = lambda spec: tuple(
        {k: (tuple(shape), name(dt)) for k, (shape, dt) in e.items()}
        for e in spec["blocks"])
    assert norm(TM.cache_spec(_port_cfg(j), 2, 12)) == \
        norm(JM.cache_spec(j, 2, 12))


def _margin(cfg, tp, batch, tokens):
    """Smallest top-1 minus top-2 logit over the greedy choices that made
    `tokens` (teacher-forced through the port's plain path)."""
    S_ = batch["tokens"].shape[1]
    logits, cache = TM.prefill(tp, cfg, batch,
                               cache_len=S_ + tokens.shape[1])
    gaps = []
    for k in range(tokens.shape[1]):
        top = logits.topk(2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).min().item())
        logits, cache = TM.decode_step(tp, cfg, tokens[:, k:k + 1], cache,
                                       S_ + k)
    return min(gaps)


def test_whisper_engine_matches_the_reference_engine():
    """Greedy generation through both engines from one published
    version: the same tokens (every choice's top-2 margin is above the
    f32 tolerance), the same snapshot LSN and lag."""
    j = _cfg("whisper-tiny", "float32")
    tcfg = _port_cfg(j)
    jp = JM.init_params(jax.random.PRNGKey(0), j)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    js, ts = JStore(slots=2), TStore(slots=2)
    js.publish(jp)
    ts.publish(tp)
    je = JEngine(j, js, max_seq=16)
    te = TEngine(tcfg, ts, max_seq=16, device="cpu")
    je.refresh()
    te.refresh()
    inp = _inputs(j, seed=6)
    jb, _ = _batches(inp, 4)
    numpy_batch = {"tokens": inp["tokens"][:, :4],
                   "enc_embeds": inp["enc_embeds"]}
    rj, rt = je.generate(jb, 8), te.generate(numpy_batch, 8)
    assert (rt.snapshot_lsn, rt.freshness_lag) == \
        (rj.snapshot_lsn, rj.freshness_lag)
    _, tb = _batches(inp, 4)
    assert _margin(tcfg, tp, tb, rt.tokens) > 1e-4
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_the_stub_leaves(arch):
    """`params_from_numpy` carries the new leaves bit for bit and refuses
    a tree without them."""
    j = JC.smoke_variant(JC.get_config(arch))
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1), j))
    tp = TM.params_from_numpy(_port_cfg(j), jp, "cpu")
    if j.is_encoder_decoder:
        got = tp["enc_blocks"]["mixer"]["wq"].float().numpy()
        np.testing.assert_array_equal(
            got, jp["enc_blocks"]["mixer"]["wq"].astype(np.float32))
        np.testing.assert_array_equal(
            tp["blocks"][0]["cross"]["wk"].float().numpy(),
            jp["blocks"][0]["cross"]["wk"].astype(np.float32))
        bad = {k: v for k, v in jp.items() if k != "enc_blocks"}
    else:
        np.testing.assert_array_equal(
            tp["blocks"][0]["mixer"]["bq"].float().numpy(),
            jp["blocks"][0]["mixer"]["bq"].astype(np.float32))
        bad = dict(jp, embed=jp["embed"][:, :-1])
    with pytest.raises(ValueError):
        TM.params_from_numpy(_port_cfg(j), bad, "cpu")
