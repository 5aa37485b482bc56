"""The port's plain attention versions against the JAX package: the
flash kernel's plain version (`kernels.flash_attention`, on CPU tensors)
and the layers' chunked online softmax against the reference's
`attention_ref`, `flash_attention_xla` and the Pallas `flash_attention`
in interpret mode; the decode kernel's plain version against
`decode_attention_ref` and the Pallas `decode_attention`.  Inputs are
made with numpy from a seed and handed to both packages.

Tolerances are those of tests/test_kernels.py: f32 2e-5 (summation
order), bf16 3e-2 (one rounding of the output to bf16 on each side).
The layer-level decode (`attention_decode`'s score path) is held against
the reference in tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.kernel import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.layers import flash_attention_xla

from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention.ops import decode_gqa
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ops import attention_bshd
from repro_torch.models import layers as L

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# the tests/test_kernels.py grid (B, H, K, S, hd), plus G = 2 at hd 32
SHAPES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 6, 6, 192, 32),
          (2, 4, 1, 128, 128), (1, 4, 2, 128, 32)]
MASKS = [(True, 0), (True, 64), (False, 0)]


def _np(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x


def _t(x):
    """numpy (ml_dtypes bf16 too) -> CPU tensor, bit for bit."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _qkv(B, H, K, S, T, hd, seed, dtype="float32"):
    """q [B,H,S,hd], k/v [B,K,T,hd] as numpy (the kernel layout)."""
    return (_np((B, H, S, hd), seed, dtype), _np((B, K, T, hd), seed + 1, dtype),
            _np((B, K, T, hd), seed + 2, dtype))


def _assert_parity(what, got, want, port_again, jax_again, tol):
    """assert_allclose(got, want, **tol).  On a mismatch, before failing,
    compute both sides once more from fresh copies of the inputs and put
    into the message how far each moved from its first result: a side
    that moves is not deterministic, and names itself.  A mismatch fails
    whatever the second results are."""
    try:
        np.testing.assert_allclose(got, want, **tol, err_msg=what)
    except AssertionError as err:
        port = np.abs(_f32(port_again()) - got).max()
        ref = np.abs(np.asarray(jax_again(), np.float32) - want).max()
        raise AssertionError(
            f"{err}\n{what}: computed once more from fresh copies of the "
            f"inputs, the port's result moved by max |d| {port:.3g}, the "
            f"JAX side's by {ref:.3g}") from None


@pytest.mark.parametrize("B,H,K,S,hd", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_flash_matches_jax_refs(B, H, K, S, hd, causal, window):
    """Kernel layout and model layout, both plain paths, f32; each of the
    port's functions asserted on its own, by name."""
    q, k, v = _qkv(B, H, K, S, S, hd, seed=B * S + hd)
    ref = lambda: np.asarray(attention_ref(q.copy(), k.copy(), v.copy(),
                                           causal=causal, window=window))
    kern = lambda: FK.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                      window=window)
    _assert_parity("kernels.flash_attention against attention_ref",
                   _f32(kern()), ref(), kern, ref, TOL["float32"])
    bshd = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    # several chunks without a window; with one, a single chunk (as the
    # layers' default of 1024 gives here): the reference's chunked path
    # returns NaN once a window leaves a whole chunk unseen (see below)
    chunk = S if window else 64
    xla = lambda: np.asarray(flash_attention_xla(
        bshd(q), bshd(k), bshd(v), causal=causal, window=window,
        chunk=chunk))
    want = xla()
    fns = {"ops.attention_bshd": lambda a, b, c: attention_bshd(
               a, b, c, causal=causal, window=window),
           f"layers.flash_attention_chunked(chunk={chunk})":
               lambda a, b, c: L.flash_attention_chunked(
                   a, b, c, causal=causal, window=window, chunk=chunk),
           "layers.flash_attention_chunked(chunk=48)":
               lambda a, b, c: L.flash_attention_chunked(
                   a, b, c, causal=causal, window=window, chunk=48),
           "layers.flash_attention(chunk=64)":
               lambda a, b, c: L.flash_attention(
                   a, b, c, causal=causal, window=window, chunk=64)}
    for name, fn in fns.items():
        port = lambda: fn(_t(bshd(q)), _t(bshd(k)), _t(bshd(v)))
        _assert_parity(f"{name} against flash_attention_xla", _f32(port()),
                       want, port, xla, TOL["float32"])


@pytest.mark.parametrize("B,H,K,S,hd,causal,window", [
    (1, 4, 4, 128, 64, True, 0), (2, 8, 2, 256, 64, True, 64),
    (1, 6, 6, 192, 32, False, 0), (2, 4, 1, 128, 128, True, 64),
    (1, 4, 2, 128, 32, False, 0)])
def test_plain_flash_matches_pallas_interpret(B, H, K, S, hd, causal,
                                              window):
    q, k, v = _qkv(B, H, K, S, S, hd, seed=S + hd)
    pal = np.asarray(pallas_flash(q, k, v, causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True))
    got = FK.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    np.testing.assert_allclose(_f32(got), pal, **TOL["float32"])


@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_flash_bf16_matches_jax(causal, window):
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=7, dtype="bfloat16")
    pal = pallas_flash(q, k, v, causal=causal, window=window, block_q=64,
                       block_k=64, interpret=True)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    got = FK.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    assert got.dtype == torch.bfloat16
    for want in (pal, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL["bfloat16"])


@pytest.mark.parametrize("S,T,causal,window", [
    (100, 100, True, 0), (100, 100, True, 64), (1000, 1000, True, 0),
    (50, 77, False, 0), (77, 50, False, 64), (60, 100, True, 0)])
def test_ragged_flash_matches_xla_twin(S, T, causal, window):
    """Ragged S and T (the Pallas kernel asserts divisibility, so only the
    XLA twin), the plain chunked path with a ragged last chunk."""
    B, H, K, hd = 2, 4, 2, 32
    q = _np((B, S, H, hd), S)
    k, v = _np((B, T, K, hd), T + 1), _np((B, T, K, hd), T + 2)
    want = np.asarray(flash_attention_xla(q, k, v, causal=causal,
                                          window=window,
                                          chunk=T if window else 48))
    for got in (attention_bshd(_t(q), _t(k), _t(v), causal=causal,
                               window=window),
                L.flash_attention_chunked(_t(q), _t(k), _t(v), causal=causal,
                                          window=window, chunk=48)):
        np.testing.assert_allclose(_f32(got), want, **TOL["float32"])


def test_chunked_softmax_has_no_nan_where_the_reference_does():
    """Reference fault (ROADMAP §3): with a window narrower than the
    distance to an earlier chunk, `flash_attention_xla` computes
    exp(-inf - -inf) for rows that see no key of that chunk and returns
    NaN.  The port's chunked path skips such chunks and equals the full
    softmax of `attention_ref`."""
    q, k = _np((1, 8, 2, 32), 0), _np((1, 8, 2, 32), 1)
    xla = np.asarray(flash_attention_xla(q, k, k, causal=True, window=2,
                                         chunk=4))
    assert np.isnan(xla[0, 5:]).all() and not np.isnan(xla[0, :5]).any()
    got = L.flash_attention_chunked(_t(q), _t(k), _t(k), causal=True,
                                    window=2, chunk=4)
    t = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    want = np.asarray(attention_ref(t(q), t(k), t(k), causal=True,
                                    window=2)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(got), want, **TOL["float32"])


@pytest.mark.parametrize("B,H,K,T,hd", [(2, 8, 2, 512, 64),
                                        (1, 4, 4, 256, 128),
                                        (4, 4, 1, 1024, 64),
                                        (2, 8, 4, 256, 32)])
def test_plain_decode_matches_jax(B, H, K, T, hd):
    q = _np((B, H, hd), T)
    k, v = _np((B, K, T, hd), T + 1), _np((B, K, T, hd), T + 2)
    for vl in (1, T // 2, T):
        want = np.asarray(decode_attention_ref(q, k, v, vl))
        pal = np.asarray(pallas_decode(q, k, v, vl, block_t=128,
                                       interpret=True))
        got = DK.decode_attention(_t(q), _t(k), _t(v), vl)
        for w in (want, pal):
            np.testing.assert_allclose(_f32(got), w, **TOL["float32"])
        # the op over a [B,T,K,hd] cache passed as a transposed view
        cache_k = _t(np.ascontiguousarray(k.transpose(0, 2, 1, 3)))
        cache_v = _t(np.ascontiguousarray(v.transpose(0, 2, 1, 3)))
        got = decode_gqa(_t(q), cache_k.transpose(1, 2),
                         cache_v.transpose(1, 2), vl)
        np.testing.assert_allclose(_f32(got), want, **TOL["float32"])


def test_plain_decode_bf16_matches_jax():
    q = _np((2, 8, 64), 3, "bfloat16")
    k, v = _np((2, 2, 512, 64), 4, "bfloat16"), _np((2, 2, 512, 64), 5,
                                                      "bfloat16")
    for vl in (1, 256, 512):
        got = DK.decode_attention(_t(q), _t(k), _t(v), vl)
        assert got.dtype == torch.bfloat16
        for want in (decode_attention_ref(q, k, v, vl),
                     pallas_decode(q, k, v, vl, block_t=128, interpret=True)):
            np.testing.assert_allclose(_f32(got), _f32(want),
                                       **TOL["bfloat16"])


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers take the plain versions: no launch is
    counted; the counts reset to 0."""
    FK.reset_launches()
    DK.reset_launches()
    q, k, v = (_t(x) for x in _qkv(1, 2, 2, 8, 8, 32, seed=0))
    FK.flash_attention(q, k, v)
    DK.decode_attention(q[:, :, 0], k, v, 8)
    assert FK.flash_attention.launches == 0
    assert DK.decode_attention.launches == 0
