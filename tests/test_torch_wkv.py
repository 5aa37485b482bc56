"""The port's WKV6 scan (`repro_torch.kernels.wkv_scan`) against the JAX
package on the CPU: the plain version `wkv_scan_ref` against the Pallas
kernel `wkv_scan` (interpret mode) and the reference's `wkv_scan_ref`,
the initial state `s0` against `_wkv_chunked(h0=...)`, and the
model-layout op `wkv` on strided inputs against the reference's
`ops.wkv`, ragged T included.  CPU tensors take the plain version; the
CUDA kernel is held against it on the card (tests/test_torch_cuda.py).

Tolerance: rtol = atol = 1e-4, the reference's own for its kernel against
its oracle (tests/test_kernels.py): the two sum in other orders (the
reference's `_wkv_chunked` is an associative scan)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from repro.kernels.wkv_scan import ops as JO  # noqa: E402
from repro.kernels.wkv_scan.kernel import wkv_scan as j_wkv_scan  # noqa
from repro.kernels.wkv_scan.ref import wkv_scan_ref as j_wkv_ref  # noqa
from repro.models.layers import _wkv_chunked  # noqa: E402

from repro_torch.kernels.cuda_build import launch_count  # noqa: E402
from repro_torch.kernels.wkv_scan import kernel as WK  # noqa: E402
from repro_torch.kernels.wkv_scan.ops import wkv  # noqa: E402
from repro_torch.kernels.wkv_scan.ref import wkv_scan_ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(shape, seed, n_u):
    """r, k, v, w_log of `shape` and u of `n_u`, numpy f32, at the
    reference test's scales (decays exp(-exp(z - 2)))."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal(shape).astype(np.float32) * 0.5
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32)
    w_log = -np.exp(rng.standard_normal(shape) - 2).astype(np.float32)
    u = rng.standard_normal(n_u).astype(np.float32) * 0.1
    return r, k, v, w_log, u


def _t(*xs):
    """CPU tensors holding copies (no memory shared with JAX's inputs)."""
    return [torch.tensor(np.asarray(x)) for x in xs]


def _np(*xs):
    """JAX results as numpy arrays (waits until they are computed)."""
    return [np.array(x) for x in xs]


def _assert_parity(what, got, want, port_again, jax_again):
    """assert_allclose(got, want, **TOL).  On a mismatch, before failing,
    compute both sides once more from fresh copies of the inputs and put
    into the message how far each moved from its first result, so that
    a side that is not deterministic names itself.  A mismatch fails
    whatever the second results are."""
    try:
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)
    except AssertionError as err:
        port = np.abs(np.asarray(port_again()) - got).max()
        ref = np.abs(np.asarray(jax_again()) - want).max()
        raise AssertionError(
            f"{err}\n{what}: computed once more from fresh copies of the "
            f"inputs, the port's result moved by max |d| {port:.3g}, the "
            f"JAX side's by {ref:.3g}") from None


@pytest.mark.parametrize("BH,T,N,chunk", [(2, 128, 64, 32), (4, 256, 64, 128),
                                          (1, 64, 32, 64)])
def test_ref_matches_pallas_kernel_and_reference_oracle(BH, T, N, chunk):
    x = _inputs((BH, T, N), T + N, (BH, N))
    jax_sides = {
        "oracle": lambda: _np(*j_wkv_ref(*(jnp.asarray(a.copy())
                                           for a in x))),
        "Pallas": lambda: _np(*j_wkv_scan(*(jnp.asarray(a.copy())
                                            for a in x), chunk=chunk,
                                          interpret=True))}
    port = lambda: [t.numpy() for t in wkv_scan_ref(*_t(*x))]
    o, S = wkv_scan_ref(*_t(*x))
    assert o.dtype == S.dtype == torch.float32
    for name, jax_side in jax_sides.items():
        want_o, want_S = jax_side()
        _assert_parity(f"wkv_scan_ref o against the {name}", o.numpy(),
                       want_o, lambda: port()[0], lambda: jax_side()[0])
        _assert_parity(f"wkv_scan_ref S against the {name}", S.numpy(),
                       want_S, lambda: port()[1], lambda: jax_side()[1])


@pytest.mark.parametrize("T,split", [(48, 20), (33, 1)])
def test_s0_continues_the_scan_as_h0_does(T, split):
    """A scan from s0 = the state after `split` steps equals the rest of
    one scan, and `_wkv_chunked(h0=s0)` on the same inputs."""
    B, H, N = 2, 3, 32
    r, k, v, w_log, u = _inputs((B, T, H, N), T, (H, N))
    o_all, S_all = _np(*_wkv_chunked(r, k, v, w_log, u, chunk=16))
    rest = [x[:, split:] for x in (r, k, v, w_log)]
    _, S_mid = wkv(*_t(*[x[:, :split] for x in (r, k, v, w_log)], u))
    o_j, S_j = _np(*_wkv_chunked(*rest, u, chunk=16,
                                 h0=jnp.asarray(S_mid.numpy().copy())))
    o, S = wkv(*_t(*rest, u), S_mid)
    np.testing.assert_allclose(o.numpy(), o_j, **TOL)
    np.testing.assert_allclose(S.numpy(), S_j, **TOL)
    np.testing.assert_allclose(o.numpy(), o_all[:, split:], **TOL)
    np.testing.assert_allclose(S.numpy(), S_all, **TOL)


@pytest.mark.parametrize("T", [1, 37, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layout_op_on_strided_inputs(T, dtype):
    """`wkv` on [B,T,H,N] views that are not contiguous (slices of a
    wider head axis, a transposed buffer) against the reference's
    `ops.wkv` (kernel in interpret mode where T divides its chunk, the
    oracle otherwise) on the same values; ragged T = 37 included."""
    B, H, N = 2, 3, 32
    r, k, v, w_log, u = _inputs((B, T, H, N), 7 * T, (H, N))
    tdt = getattr(torch, dtype)
    wide = [torch.zeros((B, T, H + 2, N), dtype=tdt) for _ in range(3)]
    for buf, x in zip(wide, (r, k, v)):
        buf[:, :, 1:H + 1] = torch.from_numpy(x).to(tdt)
    rt, kt, vt = (buf[:, :, 1:H + 1] for buf in wide)
    wt = torch.from_numpy(np.ascontiguousarray(
        w_log.transpose(0, 2, 1, 3))).to(tdt).transpose(1, 2)
    assert not any(x.is_contiguous() for x in (rt, kt, vt))
    o, S = wkv(rt, kt, vt, wt, torch.from_numpy(u))
    assert o.shape == (B, T, H, N) and S.shape == (B, H, N, N)
    assert o.dtype == S.dtype == torch.float32
    jx = [jnp.asarray(x.float().numpy().copy()).astype(jnp.dtype(dtype))
          for x in (rt, kt, vt, wt)]
    o_j, S_j = _np(*JO.wkv(*jx, jnp.asarray(u),
                           use_kernel=T % 32 == 0 or T == 1, interpret=True))
    np.testing.assert_allclose(o.numpy(), o_j, **TOL)
    np.testing.assert_allclose(S.numpy(), S_j, **TOL)


def test_state_out_is_written_in_place_and_may_be_s0():
    """`state_out` receives the final state (the decode step passes the
    layer's state as both s0 and state_out); CPU tensors launch nothing."""
    B, T, H, N = 2, 5, 2, 32
    r, k, v, w_log, u = _t(*_inputs((B, T, H, N), 3, (H, N)))
    _, S1 = wkv(r[:, :2], k[:, :2], v[:, :2], w_log[:, :2], u)
    want_o, want_S = wkv(r[:, 2:], k[:, 2:], v[:, 2:], w_log[:, 2:], u, S1)
    state = S1.clone()
    WK.reset_launches()
    o, S = wkv(r[:, 2:], k[:, 2:], v[:, 2:], w_log[:, 2:], u, state,
               state_out=state)
    assert S is state and launch_count(WK.wkv_scan) == 0
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(state, want_S, rtol=0, atol=0)
    fresh = torch.full((B, H, N, N), 7.0)
    _, S = wkv(r, k, v, w_log, u, state_out=fresh)
    assert S is fresh
    torch.testing.assert_close(fresh, wkv(r, k, v, w_log, u)[1], rtol=0,
                               atol=0)


def test_wrapper_refuses_other_devices():
    x = torch.zeros((1, 1, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        WK.wkv_scan(x, x, x, x, torch.zeros((1, 1, 32), device="meta"))
