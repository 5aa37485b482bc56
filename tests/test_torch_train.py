"""The port's training path (`repro_torch.optim`, `data`, `checkpoint`,
`train`, `models.loss_fn`) against the JAX package on the CPU, and the
reference's own training-infra cases (`tests/test_train_infra.py`)
ported.

- AdamW: `update` against `repro.optim.adamw.update` on the same
  gradients, f32 and bf16 leaves, compression on and off: f32 within
  1e-6 relative (elementwise arithmetic; XLA and PyTorch may round a
  power or a quotient differently in the last bit), bf16 leaves within
  one bf16 step (2^-7 relative) of the reference, since such a bit can
  round the result the other way.
- Data: the pipeline's batches bitwise equal to the reference's.
- The train step on the smoke variants of the dense and MoE configs in
  f32, with the reference's weights carried by `params_from_numpy`: the
  gradients of the loss within 1e-5 of each leaf's max-abs, and loss,
  `grad_norm` and the updated params within rtol = atol = 1e-5 after 1
  and 3 steps.  These steps use AdamW with eps = 1e-4: at the default
  1e-8 Adam's first steps map an element whose gradient lies within the
  two frameworks' f32 summation noise (~1e-7 of the leaf's scale) to
  +-lr, so one element in tens of thousands comes out up to 2 lr apart
  (3.1e-5 at lr 1e-3, measured on codeqwen1.5-7b's embedding); the
  optimizer itself is held at the default eps above.  Mixtral's routing
  is asserted equal to the reference's first.
  Whisper-tiny (encoder, cross-attention) and Qwen2-VL-72B (M-RoPE,
  the vision stub) are among them; Whisper also in bf16, where the port's
  step takes the pipeline's f32 frames and rounds them to bf16 at its
  entry and the reference's step gets the same frames rounded (its own
  trainer would run the encoder in f32 by promotion): loss, grad_norm
  and every gradient leaf within 3e-2 of its max-abs (the bf16
  tolerance of tests/test_torch_models.py).
- Equivalences of the port: 2 microbatches == 1, and remat none, dots and
  full give equal gradients.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import repro.configs as JC
import repro.models as JM
from repro.checkpoint import manager as j_ckpt
from repro.data import SyntheticPipeline as JPipeline
from repro.models import layers as JL
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as j_adamw
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step

import repro_torch.models as TM
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import SyntheticPipeline
from repro_torch.models import layers as TL
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.serve import ServingEngine
from repro_torch.tensorstore import VersionedParamStore
from repro_torch.train import (StragglerMonitor, Trainer, init_state,
                               make_train_step)
from repro_torch.train.step import _value_and_grad, frames_in_param_dtype
from repro_torch.tree import leaves, leaves_with_path

CFG = smoke_variant(get_config("qwen1.5-0.5b"))
F32 = dict(param_dtype="float32", compute_dtype="float32")
STEP_ARCHS = ["qwen1.5-0.5b", "granite-34b", "nemotron-4-15b",
              "codeqwen1.5-7b", "mixtral-8x7b", "rwkv6-3b",
              "jamba-1.5-large-398b", "whisper-tiny", "qwen2-vl-72b"]
# the step parity's tolerance where it is not 1e-5: the scans' recorded
# deviation from the reference (ROADMAP), whose associative chunked
# scans (`_wkv_chunked`, `_mamba_scan_chunked`) sum in another order than
# the port's sequential ones: 1e-4 for the WKV, 2e-4 for the selective scan
STEP_TOL = {"rwkv6-3b": 1e-4, "jamba-1.5-large-398b": 2e-4}
# the pattern positions, one layer each, of the scan families' step
# parity: RWKV6's one layer kind, and three positions of Jamba's period
# of 8 that hold every kind of layer it has (Mamba with a dense and with
# a MoE MLP, attention with a dense MLP), at a fraction of the JAX
# compile time of their two-period smoke variants
STEP_POSITIONS = {"rwkv6-3b": (0,), "jamba-1.5-large-398b": (0, 1, 4)}


def _t(x):
    """numpy / jax array -> CPU tensor, bf16 bit for bit."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(x):
    """tensor / jax array -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


def _float_leaves(tree):
    """The port tree's leaves that the reference's tree has too (all but
    a MoE layer's `expert_ids`), in the reference's order."""
    return [x for p, x in leaves_with_path(tree) if p[-1] != "expert_ids"]


# --------------------------------------------------------------------- AdamW
def _adamw_trees(seed=0):
    rng = np.random.default_rng(seed)
    p = {"a": rng.standard_normal((37, 5), dtype=np.float32),
         "b": {"c": rng.standard_normal(64, dtype=np.float32)}}
    gs = [{"a": rng.standard_normal((37, 5), dtype=np.float32) * 1e-2,
           "b": {"c": rng.standard_normal(64, dtype=np.float32) * 1e-2}}
          for _ in range(3)]
    return p, gs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_the_reference(dtype, compress):
    p_np, gs = _adamw_trees()
    jcfg = JAdamWConfig(lr=1e-2, compress=compress)
    tcfg = AdamWConfig(lr=1e-2, compress=compress)
    jp = jax.tree.map(lambda x: jnp.asarray(x, dtype), p_np)
    tp = jax.tree.map(lambda x: _t(np.asarray(jnp.asarray(x, dtype))), p_np)
    js, ts = j_adamw.init(jp, jcfg), adamw.init(tp, tcfg)
    assert sorted(ts) == sorted(js)
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for g in gs:
        jg = jax.tree.map(lambda x: jnp.asarray(x, dtype), g)
        tg = jax.tree.map(lambda x: _t(np.asarray(x)), jg)
        before = [x.clone() for x in leaves(tp)]
        jp, js, jm = j_adamw.update(jg, js, jp, jcfg)
        tp_new, ts, tm = adamw.update(tg, ts, tp, tcfg)
        # nothing is written in place: the old version stays as it was
        assert all(torch.equal(a, b) for a, b in zip(before, leaves(tp)))
        tp = tp_new
        np.testing.assert_allclose(_np(tm["grad_norm"]), _np(jm["grad_norm"]),
                                   rtol=1e-6)
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == _t(np.asarray(b)).dtype
            np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=1e-7)
        for key in ("m", "v") + (("ef",) if compress else ()):
            for a, b in zip(leaves(ts[key]), jax.tree.leaves(js[key])):
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-9)
        assert int(ts["count"]) == int(js["count"])


def test_error_feedback_is_unbiased_over_steps():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        512).astype(np.float32)) * 1e-3
    ef, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        sent, ef = adamw._compress_int8(g, ef)
        total += sent
    np.testing.assert_allclose(total / 50, g, atol=2e-5)


def test_int8_compression_matches_the_reference():
    """Half-way values round to even in both (`torch.round`,
    `jnp.round`)."""
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.2], np.float32)
    ef = np.zeros_like(g)
    jd, je = j_adamw._compress_int8(jnp.asarray(g), jnp.asarray(ef))
    td, te = adamw._compress_int8(torch.from_numpy(g), torch.from_numpy(ef))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-vl-72b",
                                  "whisper-tiny"])
def test_pipeline_batches_equal_the_reference(arch):
    jcfg = JC.smoke_variant(JC.get_config(arch))
    tcfg = smoke_variant(get_config(arch))
    jp = JPipeline(jcfg, batch=3, seq_len=20, seed=7)
    tp = SyntheticPipeline(tcfg, batch=3, seq_len=20, seed=7, device="cpu")
    for step in (0, 5):
        jb, tb = jp.batch_at(step), tp.batch_at(step)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            want = np.asarray(jb[k])
            got = tb[k].numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_pipeline_is_deterministic_and_resumable():
    p1 = SyntheticPipeline(CFG, batch=2, seq_len=16, seed=5, device="cpu")
    b0, b1 = p1.next_batch(), p1.next_batch()
    p2 = SyntheticPipeline(CFG, batch=2, seq_len=16, seed=5, device="cpu")
    p2.restore_state({"step": 1, "seed": 5})
    assert torch.equal(b1["tokens"], p2.next_batch()["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])


# ---------------------------------------------------------- train step parity
def _routing_equal(jcfg, tcfg, jp, tp, batch_np):
    """The port's MoE routing of the batch equals the reference's, layer
    by layer (the reference run eagerly with its layers unrolled, so its
    `moe_apply` sees concrete inputs)."""
    ref, got = [], []
    j_apply, t_route = JL.moe_apply, TL.moe_route

    def j_rec(p, x, cfg, **kw):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], -1)
        ref.append(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]))
        return j_apply(p, x, cfg, **kw)

    def t_rec(p, x, cfg, **kw):
        out = t_route(p, x, cfg, **kw)
        got.append(out[1].numpy())
        return out

    JL.moe_apply, TL.moe_route = j_rec, t_rec
    try:
        JM.forward(jp, jcfg.with_overrides(unroll_layers=True),
                   {"tokens": jnp.asarray(batch_np)})
        with torch.no_grad():
            TM.forward(tp, tcfg, {"tokens": torch.from_numpy(batch_np.copy())})
    finally:
        JL.moe_apply, TL.moe_route = j_apply, t_route
    assert len(got) == len(ref) > 0
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"MoE call {i}: "
                                      "routing flipped")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_the_reference(arch):
    jcfg = JC.smoke_variant(JC.get_config(arch)).with_overrides(**F32)
    if arch in STEP_POSITIONS:
        pos = STEP_POSITIONS[arch]
        jcfg = jcfg.with_overrides(pattern=tuple(jcfg.pattern[i] for i in pos),
                                   n_layers=len(pos))
    tcfg = _port_cfg(jcfg)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    jpipe = JPipeline(jcfg, batch=4, seq_len=16)
    tpipe = SyntheticPipeline(tcfg, batch=4, seq_len=16, device="cpu")
    if jcfg.n_experts:
        _routing_equal(jcfg, tcfg, jp, tp, np.asarray(
            jpipe.batch_at(0)["tokens"]))
    # the gradients of the loss
    jb, tb = jpipe.batch_at(0), tpipe.batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b)))(jp, jb)
    tl, tg = _value_and_grad(tp, tcfg, tb)
    tol = STEP_TOL.get(arch, 1e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol)
    for (path, a), b in zip(
            [(p, x) for p, x in leaves_with_path(tg) if p[-1] != "expert_ids"],
            jax.tree.leaves(jg)):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a.numpy() - b).max() <= tol * scale, path
    # 3 steps of the whole train step
    jopt, topt = JAdamWConfig(lr=1e-3, eps=1e-4), AdamWConfig(lr=1e-3,
                                                              eps=1e-4)
    js = j_init_state(None, jcfg, jopt, params=jp)
    ts = init_state(None, tcfg, topt, params=tp)
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    tstep = make_train_step(tcfg, topt)
    for i in range(3):
        js, jm = jstep(js, jpipe.batch_at(i))
        ts, tm = tstep(ts, tpipe.batch_at(i))
        if i in (0, 2):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=tol, err_msg=k)
            for a, b in zip(_float_leaves(ts["params"]),
                            jax.tree.leaves(js["params"])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=tol, atol=tol)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_whisper_bf16_step_on_rounded_frames_matches_the_reference():
    jcfg = JC.smoke_variant(JC.get_config("whisper-tiny"))
    tcfg = _port_cfg(jcfg)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    tb = SyntheticPipeline(tcfg, batch=4, seq_len=16,
                           device="cpu").batch_at(0)
    jb = dict(JPipeline(jcfg, batch=4, seq_len=16).batch_at(0))
    assert tb["enc_embeds"].dtype == torch.float32
    jb["enc_embeds"] = jb["enc_embeds"].astype(jnp.bfloat16)
    rounded = frames_in_param_dtype(tcfg, tb)
    assert rounded["enc_embeds"].dtype == torch.bfloat16
    assert torch.equal(rounded["enc_embeds"], _t(np.asarray(jb["enc_embeds"])))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b)))(jp, jb)
    tl, tg = _value_and_grad(tp, tcfg, rounded)
    np.testing.assert_allclose(float(tl), float(jl), rtol=3e-2)
    for (path, a), b in zip(leaves_with_path(tg), jax.tree.leaves(jg)):
        assert a.dtype == torch.bfloat16, path
        b = np.asarray(b, np.float32)
        assert np.abs(a.float().numpy() - b).max() <= \
            3e-2 * np.abs(b).max(), path
    # the whole step: the port's on the f32 frames it rounds itself
    jopt, topt = JAdamWConfig(lr=1e-3, eps=1e-4), AdamWConfig(lr=1e-3,
                                                              eps=1e-4)
    _, jm = jax.jit(j_make_train_step(jcfg, jopt))(
        j_init_state(None, jcfg, jopt, params=jp), jb)
    _, tm = make_train_step(tcfg, topt)(
        init_state(None, tcfg, topt, params=tp), tb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=3e-2,
                                   err_msg=k)


def _f32_state(cfg, opt, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_state(gen, cfg, opt, device="cpu")


def test_two_microbatches_equal_one():
    """The same global batch in 2 microbatches: gradients summed in f32
    and halved, the loss the mean of the two."""
    cfg1 = CFG.with_overrides(microbatches=1, **F32)
    cfg2 = CFG.with_overrides(microbatches=2, **F32)
    opt = AdamWConfig(lr=1e-3, eps=1e-4)
    s = _f32_state(cfg1, opt)
    batch = SyntheticPipeline(cfg1, batch=4, seq_len=16,
                              device="cpu").batch_at(0)
    o1, m1 = make_train_step(cfg1, opt)(s, batch)
    o2, m2 = make_train_step(cfg2, opt)(s, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5)
    for a, b in zip(leaves(o1["params"]), leaves(o2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-3b",
                                  "jamba-1.5-large-398b"])
def test_remat_settings_give_equal_gradients(arch):
    """none, dots and full give the same loss and gradients, bit for bit:
    the scans' forward ops are kept under "dots" and launched again under
    "full", on the same inputs."""
    cfg = smoke_variant(get_config(arch)).with_overrides(**F32)
    params = _f32_state(cfg, AdamWConfig())["params"]
    batch = SyntheticPipeline(cfg, batch=2, seq_len=16,
                              device="cpu").batch_at(0)
    out = {r: _value_and_grad(params, cfg.with_overrides(remat=r), batch)
           for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert torch.equal(out[r][0], out["none"][0])
        for a, b in zip(leaves(out[r][1]), leaves(out["none"][1])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_bf16(tmp_path):
    state = {"a": torch.ones((4, 4), dtype=torch.bfloat16) * 1.5,
             "b": {"c": torch.arange(5, dtype=torch.int32)}}
    ckpt.save(state, 7, str(tmp_path))
    out = ckpt.restore(str(tmp_path), state, device="cpu")
    assert out["a"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["a"].float().numpy(), 1.5)
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.arange(5))


def test_checkpoint_atomic_latest_and_gc(tmp_path):
    s = {"x": torch.zeros((2,))}
    for step in (1, 2, 3, 4, 5):
        ckpt.save(s, step, str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]


def test_save_async_writes_a_host_copy(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32)}
    ckpt.save_async(state, 3, str(tmp_path)).join()
    out = ckpt.restore(str(tmp_path), state, device="cpu")
    assert torch.equal(out["w"], state["w"])


def _j_state_bf16():
    jcfg = JC.smoke_variant(JC.get_config("qwen1.5-0.5b"))
    return jcfg, j_init_state(jax.random.PRNGKey(1), jcfg, JAdamWConfig())


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, js = _j_state_bf16()
    j_ckpt.save(js, 4, str(tmp_path))
    template = init_state(None, _port_cfg(jcfg), AdamWConfig(), params=(
        TM.init_params(_port_cfg(jcfg), None, "meta")))
    out = ckpt.restore(str(tmp_path), template, device="cpu")
    for (path, a), b in zip(leaves_with_path(out), jax.tree.leaves(js)):
        want = _t(np.asarray(b))
        assert a.dtype == want.dtype and torch.equal(a, want), path


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg, js = _j_state_bf16()
    ts = jax.tree.map(lambda x: _t(np.asarray(x)), js)
    ckpt.save(ts, 4, str(tmp_path))
    template = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js)
    out = j_ckpt.restore(str(tmp_path), template)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))


# ------------------------------------------------------------------- trainer
def test_crash_restore_resumes_identically(tmp_path):
    """A run that crashes and restores lands on the same weights as an
    uninterrupted run."""
    t1 = Trainer(CFG, batch=2, seq_len=16, ckpt_dir=str(tmp_path / "a"),
                 ckpt_every=2, device="cpu")
    t1.run(6)
    t2 = Trainer(CFG, batch=2, seq_len=16, ckpt_dir=str(tmp_path / "b"),
                 ckpt_every=2, device="cpu")
    t2.run(6, inject_failure_at=4)        # crash at 4, resume from 4
    assert int(t2.state["step"]) == 6
    for a, b in zip(leaves(t1.state["params"]), leaves(t2.state["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor(alpha=0.5, factor=2.0)
    for _ in range(5):
        assert not m.observe(0, 1.0)
    assert m.observe(5, 10.0)
    assert m.flagged


def test_trainer_publishes_server_reads_waitfree():
    store = VersionedParamStore(slots=2)
    tr = Trainer(CFG, batch=2, seq_len=16, store=store, device="cpu")
    tr.run(3)
    eng = ServingEngine(CFG, store, max_seq=32, device="cpu")
    eng.refresh()
    res = eng.generate({"tokens": torch.ones((1, 4), dtype=torch.int32)}, 3)
    assert res.tokens.shape == (1, 3)
    assert res.freshness_lag == 0
    # reader pinned while trainer advances: wait-free for both sides
    pin, _ = store.pin_snapshot()
    tr.run(2)
    assert store.stats["publishes"] >= 6
    store.release(pin)


def test_a_reader_pinned_at_v1_sees_v1_after_three_steps():
    store = VersionedParamStore(slots=2)
    tr = Trainer(CFG, batch=2, seq_len=16, store=store, device="cpu")
    v1 = [x.clone() for x in leaves(tr.state["params"])]
    pin, tree = store.pin_snapshot()
    tr.run(3)
    store.refresh()
    assert store.visible_lsn() > 0 and store.n_slots >= 2
    assert all(torch.equal(a, b) for a, b in zip(leaves(tree), v1))
    assert not all(torch.equal(a, b) for a, b in
                   zip(leaves(tr.state["params"]), v1))
    store.release(pin)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_trainer_trains_the_scan_mixers(arch):
    """Two steps of RWKV6's and Jamba's smoke variants through `Trainer`
    on the CPU (the plain scans and their plain backwards): finite losses,
    every float leaf moved (f32 weights: a bf16 weight near 1 does not
    move by lr), and each step published."""
    cfg = smoke_variant(get_config(arch)).with_overrides(**F32)
    store = VersionedParamStore(slots=2)
    tr = Trainer(cfg, batch=2, seq_len=16, store=store, device="cpu")
    before = [x.clone() for x in leaves(tr.state["params"])]
    log = tr.run(2)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert store.stats["publishes"] == 3
    for (path, a), b in zip(leaves_with_path(tr.state["params"]), before):
        if a.is_floating_point():
            assert not torch.equal(a, b), path
