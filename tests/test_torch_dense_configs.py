"""Whole-model parity of the dense configs the port admits beside
Qwen1.5-0.5B (whose case is tests/test_torch_models.py's): the smoke
variants of granite-34b (MQA with one KV head, GELU, LayerNorm),
nemotron-4-15b (squared ReLU, 50% rotary, LayerNorm) and codeqwen1.5-7b
(QKV bias, theta 1e6), with the reference's weights carried by
`params_from_numpy`: forward, prefill and 3 decode steps against the JAX
package, on the CPU, at the Qwen test's tolerances (f32 rtol = atol =
1e-4; bf16 3e-2 of the logits' max-abs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

import repro.configs as JC
import repro.models as JM

import repro_torch.models as TM

F32 = dict(param_dtype="float32", compute_dtype="float32")


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-34b", "nemotron-4-15b",
                                  "codeqwen1.5-7b"])
def test_forward_prefill_decode_match_the_reference(arch, dtype):
    j = JC.smoke_variant(JC.get_config(arch))
    j = j.with_overrides(**F32) if dtype == "float32" else j
    tcfg = _port_cfg(j)
    jp = JM.init_params(jax.random.PRNGKey(4), j)
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    B, S, P = 2, 12, 9
    toks = np.random.default_rng(5).integers(0, j.vocab_size, (B, S))
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
    for key in ("k", "v"):
        _close(cache_t["blocks"][0][key], cache_j["blocks"][0][key], dtype)
