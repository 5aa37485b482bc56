"""The port's `ServingEngine` against the JAX package's, on the tiny f32
model of `examples/htap_train_serve.py`: both engines get the same
parameters published into their own `VersionedParamStore`s, with the
same publish / refresh / pin sequence, and must report the same
`snapshot_lsn` and `freshness_lag` and generate the same tokens (where
every greedy choice has a top-2 margin well above the f32 difference of
the two frameworks' logits).  Plus: a publish between the steps of a
pinned generation leaves it unchanged, and the device rule."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
from htap_train_serve import model_tiny  # noqa: E402

import repro.models as JM  # noqa: E402
from repro.serve import ServingEngine as JEngine  # noqa: E402
from repro.tensorstore import VersionedParamStore as JStore  # noqa: E402

import repro_torch.models as TM  # noqa: E402
from repro_torch.serve import ServingEngine as TEngine  # noqa: E402
from repro_torch.tensorstore import VersionedParamStore as TStore  # noqa

# the f32 logits tolerance of tests/test_torch_models.py (the two
# frameworks' logits differ by a few 1e-6 here)
MARGIN = 1e-4


def _port_cfg(jcfg):
    import dataclasses
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(TM.LayerSpec(**s) for s in d["pattern"])
    return TM.ModelConfig(**d)


def _versions(jcfg, n=2):
    """n parameter versions (jax trees) and their port twins: v1 random,
    later ones with a slice of embedding rows and lm_head columns
    perturbed (the example's embedding tuner)."""
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    out = []
    for i in range(n):
        if i:
            rows = slice(0, jcfg.vocab_size // 4)
            noise = jax.random.normal(jax.random.PRNGKey(10 + i),
                                      (jcfg.vocab_size // 4, jcfg.d_model))
            jp = dict(jp, embed=jp["embed"].at[rows].add(0.05 * noise),
                      lm_head=jp["lm_head"].at[:, rows].add(0.05 * noise.T))
        tp = TM.params_from_numpy(_port_cfg(jcfg),
                                  jax.tree.map(np.asarray, jp), "cpu")
        out.append((jp, tp))
    return out


def _margin(cfg, tp, prompt, tokens):
    """Smallest top-1 minus top-2 logit over the greedy choices that made
    `tokens` (teacher-forced through the port's plain path)."""
    S = prompt.shape[1]
    logits, cache = TM.prefill(tp, cfg, {"tokens": prompt},
                               cache_len=S + tokens.shape[1])
    gaps = []
    for k in range(tokens.shape[1]):
        top = logits.topk(2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).min().item())
        logits, cache = TM.decode_step(tp, cfg, tokens[:, k:k + 1], cache,
                                       S + k)
    return min(gaps)


def test_engine_matches_the_reference_engine():
    jcfg = model_tiny()
    (j1, t1), (j2, t2) = _versions(jcfg)
    js, ts = JStore(slots=2), TStore(slots=2)
    je = JEngine(jcfg, js, max_seq=48)
    te = TEngine(_port_cfg(jcfg), ts, max_seq=48, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16))
    jbatch = {"tokens": jnp.asarray(prompt, jnp.int32)}
    tbatch = {"tokens": torch.as_tensor(prompt)}

    def both(n_steps, **kw):
        rj, rt = je.generate(jbatch, n_steps, **kw), \
            te.generate(tbatch, n_steps, **kw)
        assert (rt.snapshot_lsn, rt.freshness_lag) == \
            (rj.snapshot_lsn, rj.freshness_lag)
        return rj, rt

    js.publish(j1)
    ts.publish(t1)
    je.refresh()
    te.refresh()
    r1j, r1t = both(8)
    # v2 published but not yet replayed: the same v1 pin, a lag
    js.publish(j2)
    ts.publish(t2)
    r2j, r2t = both(8)
    assert r2t.snapshot_lsn == r1t.snapshot_lsn and r2t.freshness_lag > 0
    je.refresh()
    te.refresh()
    r3j, r3t = both(8, refresh_between_steps=True)
    assert r3t.snapshot_lsn > r1t.snapshot_lsn and r3t.freshness_lag == 0
    for (rj, rt), tp in (((r1j, r1t), t1), ((r2j, r2t), t1),
                         ((r3j, r3t), t2)):
        assert _margin(te.cfg, tp, tbatch["tokens"], rt.tokens) > MARGIN
        np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    assert not np.array_equal(np.asarray(r3j.tokens), np.asarray(r1j.tokens))
    assert ts.stats["pins"] == js.stats["pins"] == 3


def test_publish_between_steps_leaves_the_pinned_generation_unchanged():
    jcfg = model_tiny()
    (_, t1), (_, t2) = _versions(jcfg)
    store = TStore(slots=2)
    eng = TEngine(_port_cfg(jcfg), store, max_seq=40, device="cpu")
    store.publish(t1)
    eng.refresh()
    prompt = {"tokens": torch.as_tensor(
        np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16)))}
    alone = eng.generate(prompt, 12)

    refresh, published = eng.refresh, []

    def writer_then_refresh():
        if not published:                 # the trainer commits mid-request
            published.append(store.publish(t2))
        return refresh()

    eng.refresh = writer_then_refresh
    during = eng.generate(prompt, 12, refresh_between_steps=True)
    eng.refresh = refresh
    assert published and torch.equal(during.tokens, alone.tokens)
    assert during.snapshot_lsn == alone.snapshot_lsn
    assert store.visible_lsn() > during.snapshot_lsn   # v2 now visible
    after = eng.generate(prompt, 12)
    assert after.snapshot_lsn > during.snapshot_lsn
    assert store.stats["gc_blocked"] == 0 and not store._pins


def test_device_rule(monkeypatch):
    jcfg = model_tiny()
    cfg = _port_cfg(jcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(cfg, TStore(slots=2))
    store = TStore(slots=2)
    eng = TEngine(cfg, store, max_seq=24, device="cpu")
    store.publish(TM.init_params(cfg, None, "meta"))
    eng.refresh()
    tokens = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="meta"):
        eng.generate(tokens, 4)
    assert not store._pins                # released on the way out
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(tokens, 17)
