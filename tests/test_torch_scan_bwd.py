"""The scans' gradients on the CPU against the JAX package's autodiff.

- WKV6: `wkv_scan_bwd_ref` (the plain backward of the port's
  `wkv_scan_bwd` kernel) and `WKVScan`'s CPU backward (`ops.wkv` under
  autograd) against `jax.vjp` of the reference model's associative scan
  `_wkv_chunked(..., h0=)` and of the sequential oracle
  `repro.kernels.wkv_scan.ref.wkv_scan_ref`, with cotangents on o and on
  the final state: T not a multiple of the reference's chunk, T = 1,
  T over the forward's 64-step state segments, N 32 and 64, s0 given or
  not, and r, k, v, w_log as strided slices of the model's buffers.
- Selective scan: `ssm_scan_bwd_ref` and `SSMScan`'s CPU backward
  (`ops.selective_scan` under autograd) against `jax.vjp` of
  `_mamba_scan_chunked` + D·u (the reference's Mamba layer) and of the
  oracle `repro.kernels.ssm_scan.ref.ssm_scan_ref`; h0, which neither
  takes, against the oracle's step written out with an initial state;
  ragged T, T = 1, N 8 and 16, B and C as slices of one x_proj buffer,
  bf16 u.

Inputs are numpy, seeded; JAX gets the arrays, the port copies.

Tolerances, each gradient within this share of its max-abs: 1e-4 for
WKV6 and 2e-4 for the selective scan, the reference's own for each
kernel against its oracle (tests/test_kernels.py): the port's sequential
scans and the reference's associative ones sum in other orders.  A bf16
u's gradient is rounded to bf16 by the port, so there 2^-8 (half a bf16
step) is added.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_ref  # noqa
from repro.kernels.wkv_scan.ref import wkv_scan_ref as j_wkv_ref  # noqa
from repro.models.layers import _mamba_scan_chunked, _wkv_chunked  # noqa

from repro_torch.kernels.ssm_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref  # noqa
from repro_torch.kernels.wkv_scan.ops import wkv  # noqa: E402
from repro_torch.kernels.wkv_scan.ref import wkv_scan_bwd_ref  # noqa

WKV_TOL, SSM_TOL = 1e-4, 2e-4


def _t(x):
    return torch.tensor(np.array(x, dtype=np.float32))


def _close(got, want, tol, what):
    for name, g, w in zip(what, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        ratio = float(np.abs(g - w).max()) / scale
        assert ratio <= tol, f"{name}: max |d| / max = {ratio:.3g} > {tol}"


# ------------------------------------------------------------------- WKV6
def _wkv_np(B, T, H, N, seed):
    """r, k, v, w_log [B,T,H,N], u [H,N], s0 [B,H,N,N], cotangents do
    [B,T,H,N] and dS [B,H,N,N], numpy f32 at the reference test's scales
    (decays exp(-exp(z - 2)))."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(r=0.5 * z(B, T, H, N), k=0.5 * z(B, T, H, N),
                v=z(B, T, H, N), w=-np.exp(z(B, T, H, N) - 2),
                u=0.1 * z(H, N), s0=z(B, H, N, N), do=z(B, T, H, N),
                dS=z(B, H, N, N))


def _wkv_jax(x, chunk, s0, dS):
    """jax.vjp of `_wkv_chunked` (model layout) -> (dr, dk, dv, dw, du,
    ds0 or None)."""
    def f(r, k, v, w, u, h0):
        return _wkv_chunked(r, k, v, w, u, chunk=chunk, h0=h0)
    h0 = jnp.asarray(x["s0"]) if s0 else jnp.zeros_like(x["s0"])
    args = [jnp.asarray(x[n]) for n in "rkvwu"] + [h0]
    _, vjp = jax.vjp(f, *args)
    ct_S = jnp.asarray(x["dS"]) if dS else jnp.zeros_like(h0)
    g = [np.array(a) for a in vjp((jnp.asarray(x["do"]), ct_S))]
    return g[:5] + [g[5] if s0 else None]


def _wkv_port_ref(x, s0, dS):
    """`wkv_scan_bwd_ref` at the kernel's contract ([B,H,T,N] views of
    the model's tensors)."""
    B, T, H, N = x["r"].shape
    tr = lambda n: _t(x[n]).transpose(1, 2)
    out = wkv_scan_bwd_ref(
        tr("r"), tr("k"), tr("v"), tr("w"), _t(x["u"])[None].expand(B, H, N),
        tr("do"), _t(x["dS"]) if dS else None, _t(x["s0"]) if s0 else None,
        need_ds0=s0)
    return [g.transpose(1, 2) for g in out[:4]] + list(out[4:])


def _wkv_port_autograd(x, s0, dS):
    """`WKVScan`'s CPU backward through `ops.wkv`, r, k, v, w_log passed
    as strided slices of wider buffers (the model's layout)."""
    B, T, H, N = x["r"].shape
    leaves = []
    for n in "rkvw":
        wide = torch.zeros((B, T, H, 2 * N))
        wide[..., N:] = _t(x[n])
        leaves.append(wide.requires_grad_())
    u = _t(x["u"]).requires_grad_()
    state = _t(x["s0"]).requires_grad_() if s0 else None
    o, S = wkv(*(a[..., N:] for a in leaves), u, state)
    loss = (o * _t(x["do"])).sum()
    if dS:
        loss = loss + (S * _t(x["dS"])).sum()
    got = torch.autograd.grad(loss, leaves + [u] + ([state] if s0 else []))
    assert all(float(g[..., :N].abs().max()) == 0 for g in got[:4])
    return [g[..., N:] for g in got[:4]] + [got[4]] + \
        [got[5] if s0 else None]


WKV_GRADS = ("dr", "dk", "dv", "dw_log", "du", "ds0")
WKV_CASES = [(2, 37, 3, 32, 16, False, False), (2, 37, 3, 32, 16, True, True),
             (2, 1, 2, 32, 16, True, True), (1, 70, 2, 64, 32, False, True),
             (1, 130, 2, 64, 32, True, False)]


@pytest.mark.parametrize("B,T,H,N,chunk,s0,dS", WKV_CASES)
def test_wkv_bwd_matches_jax_vjp_of_the_model_scan(B, T, H, N, chunk, s0,
                                                   dS):
    x = _wkv_np(B, T, H, N, seed=T + N)
    want = _wkv_jax(x, chunk, s0, dS)
    _close(_wkv_port_ref(x, s0, dS), want, WKV_TOL, WKV_GRADS)
    _close(_wkv_port_autograd(x, s0, dS), want, WKV_TOL, WKV_GRADS)


@pytest.mark.parametrize("T,N", [(1, 32), (45, 64)])
def test_wkv_bwd_matches_jax_vjp_of_the_oracle(T, N):
    """The sequential oracle ([BH,T,N], u per (b, h), no initial state):
    the port's du summed over b equals the oracle's per-row du summed."""
    B, H = 2, 3
    x = _wkv_np(B, T, H, N, seed=5 + T)
    flat = lambda n: jnp.asarray(x[n]).transpose(0, 2, 1, 3).reshape(
        B * H, T, N)
    u_bh = jnp.broadcast_to(jnp.asarray(x["u"]), (B, H, N)).reshape(B * H, N)
    _, vjp = jax.vjp(j_wkv_ref, flat("r"), flat("k"), flat("v"), flat("w"),
                     u_bh)
    g = vjp((flat("do"), jnp.asarray(x["dS"]).reshape(B * H, N, N)))
    back = lambda a: np.array(a).reshape(B, H, T, N).transpose(0, 2, 1, 3)
    want = [back(a) for a in g[:4]] + \
        [np.array(g[4]).reshape(B, H, N).sum(0), None]
    _close(_wkv_port_ref(x, False, True), want, WKV_TOL, WKV_GRADS)
    _close(_wkv_port_autograd(x, False, True), want, WKV_TOL, WKV_GRADS)


# ---------------------------------------------------------- selective scan
def _ssm_np(Bb, T, Di, N, seed):
    """u, dt, B, C, A, D, h0 and cotangents dy, dh, numpy f32 at the
    reference test's scales (dt = softplus(z - 1), A = -exp(z))."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=z(Bb, T, Di), dt=np.logaddexp(z(Bb, T, Di) - 1, 0)
                .astype(np.float32), B=z(Bb, T, N), C=z(Bb, T, N),
                A=-np.exp(z(Di, N)), D=z(Di), h0=z(Bb, Di, N),
                dy=z(Bb, T, Di), dh=z(Bb, Di, N))


def _j_ssm_h0(u, dt, B, C, A, D, h0):
    """The oracle's step with an initial state: (y, h_last)."""
    def per_seq(u1, dt1, B1, C1, h1):
        def step(h, xs):
            ut, dtt, Bt, Ct = xs
            h = jnp.exp(dtt[:, None] * A) * h + (dtt * ut)[:, None] * Bt
            return h, (h * Ct).sum(-1) + D * ut
        h, y = jax.lax.scan(step, h1, (u1, dt1, B1, C1))
        return y, h
    return jax.vmap(per_seq)(u, dt, B, C, h0)


def _ssm_jax(x, chunk, h0, dh, u_dtype):
    """jax.vjp of `_mamba_scan_chunked` + D·u (no h0), or of the oracle
    step with h0 -> (du, ddt, dB, dC, dA, dD, dh0 or None)."""
    u = jnp.asarray(x["u"]).astype(u_dtype).astype(jnp.float32)
    args = [u] + [jnp.asarray(x[n]) for n in ("dt", "B", "C", "A", "D")]
    if h0:
        args.append(jnp.asarray(x["h0"]))
        f = _j_ssm_h0
    else:
        def f(u, dt, B, C, A, D):
            y, h = _mamba_scan_chunked(u, dt, B, C, A, chunk)
            return y + u * D, h
    _, vjp = jax.vjp(f, *args)
    ct_h = jnp.asarray(x["dh"]) if dh else jnp.zeros_like(
        jnp.asarray(x["dh"]))
    g = [np.array(a) for a in vjp((jnp.asarray(x["dy"]), ct_h))]
    return g[:6] + [g[6] if h0 else None]


def _ssm_port_ref(x, h0, dh, u_dtype):
    u = _t(x["u"]).to(getattr(torch, u_dtype))
    return ssm_scan_bwd_ref(
        u, *(_t(x[n]) for n in ("dt", "B", "C", "A", "D", "dy")),
        _t(x["dh"]) if dh else None, _t(x["h0"]) if h0 else None,
        need_dh0=h0)


def _ssm_port_autograd(x, h0, dh, u_dtype):
    """`SSMScan`'s CPU backward through `ops.selective_scan`, B and C as
    slices of one [Bb,T,8+2N] buffer (the model's x_proj output)."""
    Bb, T, N = x["B"].shape
    u = _t(x["u"]).to(getattr(torch, u_dtype)).requires_grad_()
    dt, A, D = (_t(x[n]).requires_grad_() for n in ("dt", "A", "D"))
    proj = torch.cat([torch.zeros((Bb, T, 8)), _t(x["B"]), _t(x["C"])], -1)
    proj.requires_grad_()
    state = _t(x["h0"]).requires_grad_() if h0 else None
    y, h = selective_scan(u, dt, proj[..., 8:8 + N], proj[..., 8 + N:], A,
                          D, state)
    loss = (y * _t(x["dy"])).sum()
    if dh:
        loss = loss + (h * _t(x["dh"])).sum()
    got = torch.autograd.grad(loss, [u, dt, proj, A, D] +
                              ([state] if h0 else []))
    assert got[0].dtype == u.dtype
    gp = got[2]
    return [got[0], got[1], gp[..., 8:8 + N], gp[..., 8 + N:], got[3],
            got[4], got[5] if h0 else None]


SSM_GRADS = ("du", "ddt", "dB", "dC", "dA", "dD", "dh0")
SSM_CASES = [(2, 37, 20, 16, 8, False, False), (2, 37, 20, 16, 8, False, True),
             (2, 1, 12, 8, 8, True, True), (1, 29, 16, 8, 16, True, False)]


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bb,T,Di,N,chunk,h0,dh", SSM_CASES)
def test_ssm_bwd_matches_jax_vjp_of_the_model_scan(Bb, T, Di, N, chunk, h0,
                                                   dh, u_dtype):
    x = _ssm_np(Bb, T, Di, N, seed=T + Di)
    want = _ssm_jax(x, chunk, h0, dh, jnp.dtype(u_dtype))
    tol = SSM_TOL + (2 ** -8 if u_dtype == "bfloat16" else 0)
    for got in (_ssm_port_ref(x, h0, dh, u_dtype),
                _ssm_port_autograd(x, h0, dh, u_dtype)):
        _close(got[:1], want[:1], tol, SSM_GRADS)
        _close(got[1:], want[1:], SSM_TOL, SSM_GRADS[1:])


@pytest.mark.parametrize("T", [1, 21])
def test_ssm_bwd_matches_jax_vjp_of_the_oracle(T):
    x = _ssm_np(2, T, 24, 16, seed=40 + T)
    args = [jnp.asarray(x[n]) for n in ("u", "dt", "B", "C", "A", "D")]
    _, vjp = jax.vjp(j_ssm_ref, *args)
    want = [np.array(a) for a in vjp((jnp.asarray(x["dy"]),
                                      jnp.asarray(x["dh"])))] + [None]
    _close(_ssm_port_ref(x, False, True, "float32"), want, SSM_TOL,
           SSM_GRADS)
    _close(_ssm_port_autograd(x, False, True, "float32"), want, SSM_TOL,
           SSM_GRADS)
