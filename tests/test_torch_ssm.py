"""The port's Mamba selective scan (`repro_torch.kernels.ssm_scan`) against
the JAX package on the CPU: the plain version `ssm_scan_ref` against the
reference's sequential oracle and its Pallas kernel `ssm_scan`
(interpret mode) at the reference test's shapes and at ragged T; the op
`selective_scan` against the model's `_mamba_scan_chunked` + D·u (the
associative scan the reference's Mamba layer computes); the initial
state `h0`, and `state_out` that may alias it; B and C read as slices
of a wider buffer; bf16 u.  CPU tensors take the plain version; the CUDA
kernel is held against it on the card (tests/test_torch_cuda.py).

Every JAX result is computed and waited for (`np.array`) before the
port runs, and the port gets copies of the inputs, never views of
arrays JAX may hold.  Failure messages name the side compared.

Tolerance: rtol = atol = 2e-4, the reference's own for its kernel against
its oracle (tests/test_kernels.py): the sums run in other orders (the
model's scan is associative, the kernel fuses D·u into y)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from repro.kernels.ssm_scan.kernel import ssm_scan as j_ssm_scan  # noqa
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_ref  # noqa
from repro.models.layers import _mamba_scan_chunked  # noqa: E402

from repro_torch.kernels.cuda_build import launch_count  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(Bb, T, Di, N, seed):
    """u, dt, B, C, A, D as numpy f32 at the reference test's scales
    (u, B, C, D unit normals, dt = softplus(z - 1), A = -exp(z))."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = z(Bb, T, Di)
    dt = np.logaddexp(z(Bb, T, Di) - 1, 0).astype(np.float32)
    B, C = z(Bb, T, N), z(Bb, T, N)
    A = -np.exp(z(Di, N))
    return u, dt, B, C, A, z(Di)


def _t(*xs):
    """CPU tensors holding copies (no memory shared with JAX's inputs)."""
    return [torch.tensor(np.array(x)) for x in xs]


def _np(*xs):
    """JAX results as numpy arrays (waits until they are computed)."""
    return [np.array(jax.block_until_ready(x)) for x in xs]


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=what)


@pytest.mark.parametrize("Bb,T,Di,N,chunk", [(2, 64, 128, 8, 32),
                                             (1, 128, 256, 16, 128),
                                             (2, 37, 64, 16, 37),
                                             (1, 1, 40, 8, 1)])
def test_ref_matches_pallas_kernel_and_reference_oracle(Bb, T, Di, N, chunk):
    """The reference test's two shapes, then ragged T = 37 (one chunk of
    37 steps for the Pallas kernel, which asserts T % chunk == 0) and a
    single step."""
    x = _inputs(Bb, T, Di, N, T + Di)
    jx = [jnp.asarray(a) for a in x]
    kernel = _np(*j_ssm_scan(*jx, chunk=chunk, block_di=min(64, Di),
                             interpret=True))
    oracle = _np(*j_ssm_ref(*jx))
    y, h = ssm_scan_ref(*_t(*x))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (Bb, T, Di) and h.shape == (Bb, Di, N)
    for name, (want_y, want_h) in (("oracle", oracle), ("Pallas", kernel)):
        _close(y, want_y, f"port y against the reference's {name}")
        _close(h, want_h, f"port h against the reference's {name}")


@pytest.mark.parametrize("T,chunk", [(64, 32), (50, 16)])
def test_op_matches_the_models_chunked_scan_plus_du(T, chunk):
    """`selective_scan` (D·u fused) against what the reference's Mamba
    layer computes: `_mamba_scan_chunked`, then + u·D."""
    Bb, Di, N = 2, 64, 8
    u, dt, B, C, A, D = _inputs(Bb, T, Di, N, 11 + T)
    y_j, h_j = _np(*_mamba_scan_chunked(*(jnp.asarray(a) for a in
                                          (u, dt, B, C, A)), chunk))
    y_j = y_j + u * D
    y, h = selective_scan(*_t(u, dt, B, C, A, D))
    _close(y, y_j, "port op y against _mamba_scan_chunked + D·u")
    _close(h, h_j, "port op h against _mamba_scan_chunked")


@pytest.mark.parametrize("T,split", [(48, 20), (33, 1), (9, 8)])
def test_h0_continues_a_split_scan_as_the_one_shot_scan(T, split):
    """A scan from h0 = the state after `split` steps gives the rest of
    the one-shot scan (the reference's oracle over all T steps)."""
    Bb, Di, N = 2, 48, 16
    x = _inputs(Bb, T, Di, N, 3 * T)
    y_all, h_all = _np(*j_ssm_ref(*(jnp.asarray(a) for a in x)))
    u, dt, B, C, A, D = _t(*x)
    _, h_mid = selective_scan(u[:, :split], dt[:, :split], B[:, :split],
                              C[:, :split], A, D)
    y, h = selective_scan(u[:, split:], dt[:, split:], B[:, split:],
                          C[:, split:], A, D, h_mid)
    _close(y, y_all[:, split:], "port y from h0 against the one-shot oracle")
    _close(h, h_all, "port h from h0 against the one-shot oracle")


def test_state_out_is_written_in_place_and_may_be_h0():
    """`state_out` receives the final state (a decode step passes the
    layer's state as both h0 and state_out); CPU tensors launch
    nothing."""
    u, dt, B, C, A, D = _t(*_inputs(2, 6, 24, 8, 5))
    _, h1 = selective_scan(u[:, :2], dt[:, :2], B[:, :2], C[:, :2], A, D)
    want_y, want_h = selective_scan(u[:, 2:], dt[:, 2:], B[:, 2:],
                                    C[:, 2:], A, D, h1)
    state = h1.clone()
    SK.reset_launches()
    y, h = selective_scan(u[:, 2:], dt[:, 2:], B[:, 2:], C[:, 2:], A, D,
                          state, state_out=state)
    assert h is state and launch_count(SK.ssm_scan) == 0
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(state, want_h, rtol=0, atol=0)
    fresh = torch.full((2, 24, 8), 7.0)
    _, h = selective_scan(u, dt, B, C, A, D, state_out=fresh)
    assert h is fresh
    torch.testing.assert_close(fresh, selective_scan(u, dt, B, C, A, D)[1],
                               rtol=0, atol=0)


def test_strided_b_c_and_bf16_u():
    """B and C as slices of one wider buffer (the model's x_proj output)
    give what contiguous copies give, and bf16 u what its exact f32
    widening gives."""
    u, dt, B, C, A, D = _t(*_inputs(2, 17, 32, 16, 9))
    wide = torch.cat([torch.zeros((2, 17, 5)), B, C], dim=-1)
    Bs, Cs = wide[..., 5:21], wide[..., 21:]
    assert not Bs.is_contiguous()
    got = selective_scan(u, dt, Bs, Cs, A, D)
    want = selective_scan(u, dt, B, C, A, D)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    ub = u.bfloat16()
    got = selective_scan(ub, dt, B, C, A, D)
    want = selective_scan(ub.float(), dt, B, C, A, D)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    x = torch.zeros((1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        SK.ssm_scan(x, x, x[..., :8], x[..., :8],
                    torch.zeros((16, 8), device="meta"),
                    torch.zeros((16,), device="meta"))
