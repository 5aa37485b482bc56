"""The flash-attention backward of the port against the JAX package, on
the CPU: `attention_bwd_ref` (the plain backward the CUDA kernel
`fa_flash_bwd` is held against on the card) and `FlashAttention`'s CPU
backward, against `jax.vjp` of the reference's oracle `attention_ref`
(`src/repro/kernels/flash_attention/ref.py`) and of its XLA twin
`flash_attention_xla` (`src/repro/models/layers.py`), whose autodiff is
where the reference's training gradients come from.  The per-row
log-sum-exp the forward returns equals a masked logsumexp.  Also the
dispatch: `attention_bshd` goes through `FlashAttention` only when
autograd needs a gradient, remat "dots" keeps the flash forward's output
while "full" runs it again, and the kernels without a backward refuse a
gradient on the card.

Tolerance: f32 at 2e-5 of each gradient's max-abs (the same sums taken
in another order).  Inputs come from numpy with a fixed seed."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from repro.kernels.flash_attention.ref import attention_ref as j_attention
from repro.models.layers import flash_attention_xla

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

TOL = 2e-5


def _inputs(B, S, T, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, hd), dtype=np.float32)
    k = rng.standard_normal((B, K, T, hd), dtype=np.float32)
    v = rng.standard_normal((B, K, T, hd), dtype=np.float32)
    do = rng.standard_normal((B, H, S, hd), dtype=np.float32)
    return q, k, v, do


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= TOL * scale, \
        f"{what}: max |d| {err:.3g} > {TOL} x {scale:.3g}"


def _jax_grads(fn, q, k, v, do):
    """(o, [dq, dk, dv]) of `fn` at (q, k, v) for the cotangent do."""
    def run(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)
    o, g = jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, do)))
    return np.asarray(o), [np.asarray(x) for x in g]


# (B, S, T, H, K, hd, causal, window): every mask at G 1, G 4 and MQA
# (K 1) at hd 64 over a ragged 37 (not a multiple of a 64-row tile); hd
# 32 and 128; S = T = 70 (a tile and a ragged one); S != T
CASES = [(1, 37, 37, H, K, 64, causal, window)
         for causal in (True, False) for window in (0, 16)
         for H, K in ((4, 4), (8, 2), (4, 1))] + [
    (2, 37, 37, 8, 2, 32, True, 16), (1, 37, 37, 4, 1, 128, False, 0),
    (1, 70, 70, 4, 2, 64, True, 0), (1, 20, 50, 4, 2, 64, False, 16)]


def _id(c):
    B, S, T, H, K, hd, causal, window = c
    return (f"B{B}-S{S}-T{T}-H{H}-K{K}-hd{hd}-"
            f"{'causal' if causal else 'full'}-w{window}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_backward_matches_jax_grad_of_the_reference(case):
    B, S, T, H, K, hd, causal, window = case
    q, k, v, do = _inputs(B, S, T, H, K, hd)
    o_j, (dq_j, dk_j, dv_j) = _jax_grads(
        lambda q, k, v: j_attention(q, k, v, causal=causal, window=window),
        q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = attention_ref(tq, tk, tv, causal=causal, window=window,
                           return_lse=True)
    _close(o, o_j, "o")
    for name, got, want in zip(
            "qkv", attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                                     window=window), (dq_j, dk_j, dv_j)):
        _close(got, want, f"attention_bwd_ref d{name}")
    # the autograd Function's CPU backward, in the model's layout
    leaves = [x.transpose(1, 2).contiguous().requires_grad_()
              for x in (tq, tk, tv)]
    out = FO.attention_bshd(*leaves, causal=causal, window=window)
    grads = torch.autograd.grad(out, leaves, tdo.transpose(1, 2))
    for name, got, want in zip("qkv", grads, (dq_j, dk_j, dv_j)):
        _close(got.transpose(1, 2), want, f"FlashAttention d{name}")
    # and jax.grad of the XLA twin the reference's layers train through
    bshd = lambda x: np.swapaxes(x, 1, 2)
    _, (dq_x, dk_x, dv_x) = _jax_grads(
        lambda q, k, v: flash_attention_xla(q, k, v, causal=causal,
                                            window=window),
        bshd(q), bshd(k), bshd(v), bshd(do))
    for name, got, want in zip("qkv", grads, (dq_x, dk_x, dv_x)):
        _close(got, want, f"vs flash_attention_xla d{name}")


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 16), (False, 16)])
def test_lse_is_a_masked_logsumexp(causal, window):
    B, S, T, H, K, hd = 1, 37, 37, 8, 2, 64
    q, k, _, _ = _inputs(B, S, T, H, K, hd, seed=1)
    G = H // K
    s = jnp.einsum("bkgsh,bkth->bkgst",
                   jnp.asarray(q).reshape(B, K, G, S, hd) / math.sqrt(hd),
                   jnp.asarray(k))
    i, j = jnp.arange(S)[:, None], jnp.arange(T)[None, :]
    mask = jnp.ones((S, T), bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= i - j < window
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    _, lse = FK.flash_attention(tq, tk, tk, causal=causal, window=window,
                                return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    _close(lse, np.asarray(want).reshape(B, H, S), "lse")


def test_a_row_that_sees_no_key_has_no_gradient():
    """Causal with a window and S > T: rows past T + window - 1 see no
    key; their lse is -inf and every gradient they feed is 0, not NaN."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(1, 40, 10, 2, 1, 32, seed=2))
    o, lse = attention_ref(q, k, v, causal=True, window=4,
                           return_lse=True)
    assert torch.isinf(lse[..., 13:]).all()
    assert torch.isfinite(lse[..., :13]).all()
    o = torch.nan_to_num(o)          # softmax of no key: the forward's 0
    dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                   window=4)
    assert torch.isfinite(dq).all() and (dq[..., 13:, :] == 0).all()
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_attention_bshd_saves_nothing_without_grad(monkeypatch):
    """With no input requiring grad (serving) the kernel wrapper runs
    without lse and no Function is applied; with one, `FlashAttention`."""
    calls = []
    monkeypatch.setattr(FO.FlashAttention, "apply",
                        lambda *a: calls.append(a) or attention_ref(
                            *a[:3], causal=a[3], window=a[4]))
    q, k, v, _ = (torch.from_numpy(x).transpose(1, 2) for x in
                  _inputs(1, 8, 8, 2, 2, 32))
    FO.attention_bshd(q, k, v)
    with torch.no_grad():
        FO.attention_bshd(q.requires_grad_(), k, v)
    assert calls == []
    FO.attention_bshd(q, k, v)
    assert len(calls) == 1


@pytest.mark.parametrize("remat,launches", [("none", 1), ("dots", 1),
                                            ("full", 2)])
def test_remat_runs_the_flash_forward_as_the_setting_implies(
        monkeypatch, remat, launches):
    """`models.transformer._remat` around an attention call: "dots" keeps
    the forward op's output (one forward a step), "full" runs it again
    in the backward; the gradients agree."""
    from types import SimpleNamespace

    from repro_torch.models.transformer import _remat

    calls = []
    real = FO.flash_attention
    monkeypatch.setattr(FO, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2) for x in
                   _inputs(1, 16, 16, 2, 1, 32, seed=3))
    w = torch.eye(32, requires_grad=True)

    def layer(x):
        return FO.attention_bshd(x @ w, k, v, causal=True) @ w

    y = _remat(layer, SimpleNamespace(remat=remat))(q)
    (g,) = torch.autograd.grad(y, [w], do)
    assert len(calls) == launches
    y0 = layer(q)
    (g0,) = torch.autograd.grad(y0, [w], do)
    torch.testing.assert_close(g, g0, rtol=0, atol=0)


def test_kernels_without_a_backward_refuse_a_gradient():
    """`decode_attention` has no backward kernel: on a CUDA tensor, under
    grad with an input that requires it, it raises
    (`cuda_build.no_backward`); CPU tensors take the plain version, which
    autograd differentiates."""
    from repro_torch.kernels.cuda_build import no_backward

    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        no_backward("decode_attention", x, None)
    no_backward("decode_attention", x.detach(), None)
    with torch.no_grad():
        no_backward("decode_attention", x, None)
