"""The selective scan's backward in the kernel's order of work, on the CPU.

`ssm_backward` (csrc/ssm.cu) gives each (b, d) channel N / 4 lanes of four
states each (two lanes at N = 8); a block is 256 lanes, 1,024 / N
channels of one batch row.  For each 8-step chunk, from the last to the
first, every lane recomputes its four states forward from the chunk's
saved state (keeping the states h_t in registers), then walks the chunk
backward with the adjoint G, taking the decays a_t again:

- ddt and du: each lane's sum over its four states, joined over the
  channel's lanes by xor shuffles (1, then 2);
- dA, dh0 and the carry a_t G_t: per lane, nothing joined;
- dB and dC: each lane's 2 x 4 terms of a step wait in shared memory;
  after the chunk, the block sums them over its channels in four running
  sums (channels ch = r mod 4, in order), added pairwise, into per-block
  partials that a second kernel sums over the blocks in order; dA and dD
  over the batch rows the same way.

Rows past T and channels past Di stage as zeros, which makes such a step
the identity (a_t = 1, nothing added).  The kernel runs only on the card;
here a plain PyTorch model of that schedule —

- in f64 against the plain backward `ssm_scan_bwd_ref` on f64 inputs,
  each gradient within 1e-12 of its max-abs: T 1, 37 and 200, Di ragged
  against the block, N 8 and 16, from a zero state with no dh and from
  h0 with dh (and dh0);
- in f32 against `jax.vjp` of the reference model's scan
  `_mamba_scan_chunked` + D·u at tests/test_torch_scan_bwd.py's SSM
  tolerance (2e-4 of each gradient's max-abs, and 2^-8 more for a bf16
  u's gradient);

and `plan_bwd`'s launch at Jamba's train microbatch and at ragged Di.  A
wrong lane map, padding, carry or summation order fails here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from repro.models.layers import _mamba_scan_chunked  # noqa: E402

from repro_torch.kernels.cuda_build import Launch  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (STATE_EVERY,  # noqa: E402
                                              ssm_scan_bwd_ref,
                                              ssm_scan_ref)

GRADS = ("du", "ddt", "dB", "dC", "dA", "dD", "dh0")
THREADS = 256
SSM_TOL = 2e-4          # tests/test_torch_scan_bwd.py's


def _block_sum(x):
    """The kernel's sum over a block's channels (axis 0): four running
    sums over the channels ch = r mod 4 in order, added pairwise."""
    s = [torch.zeros_like(x[0]) for _ in range(4)]
    for j in range(x.shape[0]):
        s[j % 4] = s[j % 4] + x[j]
    return (s[0] + s[1]) + (s[2] + s[3])


def ssm_bwd_lanes(u, dt, B, C, A, D, dy, dh, states, need_dh0=False):
    """`kernel.ssm_scan_bwd` in the kernel's order, in dt's dtype: u/dt/dy
    [Bb,T,Di], B/C [Bb,T,N], A [Di,N], D [Di], dh [Bb,Di,N] or None,
    states [Bb,ceil(T/8),Di,N] -> (du in u's dtype, ddt, dB, dC, dA, dD,
    dh0 or None)."""
    Bb, T, Di = u.shape
    N = B.shape[2]
    L = N // 4                                    # lanes a channel
    ch = THREADS // L                             # channels a block
    blocks = -(-Di // ch)
    Dp, K = blocks * ch, -(-T // STATE_EVERY)
    Tp = K * STATE_EVERY
    ct = dt.dtype
    log2e = torch.tensor(math.log2(math.e), dtype=ct)

    def pad(x, t_axis=None, d_axis=None):
        """Zeros past T and past Di, as the ring stages them."""
        x = x.to(ct)
        if t_axis is not None and Tp > T:
            shape = list(x.shape)
            shape[t_axis] = Tp - T
            x = torch.cat([x, torch.zeros(shape, dtype=ct)], t_axis)
        if d_axis is not None and Dp > Di:
            shape = list(x.shape)
            shape[d_axis] = Dp - Di
            x = torch.cat([x, torch.zeros(shape, dtype=ct)], d_axis)
        return x

    uf, dtf, dyf = (pad(x, 1, 2) for x in (u, dt, dy))
    Bq = pad(B, 1).reshape(Bb, Tp, L, 4)
    Cq = pad(C, 1).reshape(Bb, Tp, L, 4)
    Aq = pad(A, None, 0).reshape(Dp, L, 4)
    a2 = Aq * log2e
    Df = pad(D, None, 0)
    X = pad(states, None, 2).reshape(Bb, K, Dp, L, 4)
    carry = torch.zeros((Bb, Dp, L, 4), dtype=ct) if dh is None \
        else pad(dh, None, 1).reshape(Bb, Dp, L, 4)
    dA = torch.zeros((Bb, Dp, L, 4), dtype=ct)
    dD = torch.zeros((Bb, Dp), dtype=ct)
    ddt = torch.empty((Bb, Tp, Dp), dtype=ct)
    du = torch.empty((Bb, Tp, Dp), dtype=ct)
    part = torch.empty((Bb, blocks, Tp, 2 * N), dtype=ct)
    for k in reversed(range(K)):
        steps = range(k * STATE_EVERY, (k + 1) * STATE_EVERY)
        h, dec = [X[:, k]], []
        for t in steps:                           # the chunk forward
            dec.append(torch.exp2(dtf[:, t, :, None, None] * a2))
            h.append(dec[-1] * h[-1] + (dtf[:, t] * uf[:, t])[..., None, None]
                     * Bq[:, t, None])
        for c in reversed(range(STATE_EVERY)):    # and back
            t = steps[c]
            uc, dtc, dyc = (x[:, t, :, None, None] for x in (uf, dtf, dyf))
            bq, cq = Bq[:, t, None], Cq[:, t, None]
            ahp = dec[c] * h[c]
            g = dyc * cq + carry
            terms = torch.cat([g * (dtc * uc), h[c + 1] * dyc], -1)
            lane_ddt, lane_gb = 0, 0
            for e in range(4):                    # a lane's four states
                lane_ddt = lane_ddt + g[..., e] * (Aq[..., e] * ahp[..., e]
                                                   + uc[..., 0] * bq[..., e])
                lane_gb = lane_gb + g[..., e] * bq[..., e]
            join = lambda s: (s[..., 0] + s[..., 1]) if L == 2 else \
                (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
            ddt[:, t] = join(lane_ddt)
            du[:, t] = dtf[:, t] * join(lane_gb) + Df * dyf[:, t]
            dA = dA + g * dtc * ahp
            carry = dec[c] * g
            dD = dD + uf[:, t] * dyf[:, t]
            # dB/dC: [channels of a block, Bb, blocks, L lanes, 8 terms]
            w = terms.reshape(Bb, blocks, ch, L, 8).movedim(2, 0)
            blk = _block_sum(w)
            # [Bb, blocks, L, 8] -> columns: dB at 4q + j, dC at N + 4q + j
            part[:, :, t] = torch.cat([blk[..., :4].reshape(Bb, blocks, N),
                                       blk[..., 4:].reshape(Bb, blocks, N)],
                                      -1)
    dBC = torch.zeros((Bb, Tp, 2 * N), dtype=ct)
    for p in range(blocks):                       # sum_leading_kernel
        dBC = dBC + part[:, p]
    dA_sum = torch.zeros((Dp, L, 4), dtype=ct)
    dD_sum = torch.zeros(Dp, dtype=ct)
    for b in range(Bb):
        dA_sum, dD_sum = dA_sum + dA[b], dD_sum + dD[b]
    dh0 = carry.reshape(Bb, Dp, N)[:, :Di] if need_dh0 else None
    return (du[:, :T, :Di].to(u.dtype), ddt[:, :T, :Di], dBC[:, :T, :N],
            dBC[:, :T, N:], dA_sum.reshape(Dp, N)[:Di], dD_sum[:Di], dh0)


def _inputs(Bb, T, Di, N, seed, dtype=np.float64):
    """u, dt, B, C, A, D, h0, dy, dh at the reference test's scales
    (dt = softplus(z - 1), A = -exp(z)), numpy seeded."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(dtype)
    return dict(u=z(Bb, T, Di), dt=np.logaddexp(z(Bb, T, Di) - 1, 0)
                .astype(dtype), B=z(Bb, T, N), C=z(Bb, T, N),
                A=-np.exp(z(Di, N)), D=z(Di), h0=z(Bb, Di, N),
                dy=z(Bb, T, Di), dh=z(Bb, Di, N))


def _run(x, h0, dh, fn, dtype, u_dtype=None):
    t = lambda n: torch.tensor(np.ascontiguousarray(x[n]), dtype=dtype)
    u = t("u") if u_dtype is None else t("u").to(u_dtype)
    args = [u] + [t(n) for n in ("dt", "B", "C", "A", "D")]
    state0 = t("h0") if h0 else None
    states = ssm_scan_ref(*args, state0, return_states=True)[2].to(dtype)
    return fn(*args, t("dy"), t("dh") if dh else None, state0, states,
              need_dh0=h0)


def _lanes(u, dt, B, C, A, D, dy, dh, h0, states, need_dh0):
    return ssm_bwd_lanes(u, dt, B, C, A, D, dy, dh, states, need_dh0)


def _close(got, want, tol, tol_du=None):
    for name, a, b in zip(GRADS, got, want):
        if b is None:
            assert a is None, name
            continue
        a = np.asarray(a.detach().double() if isinstance(a, torch.Tensor)
                       else a, np.float64)
        b = np.asarray(b.detach().double() if isinstance(b, torch.Tensor)
                       else b, np.float64)
        assert a.shape == b.shape, name
        t = tol_du if name == "du" and tol_du is not None else tol
        err = float(np.abs(a - b).max())
        assert err <= t * max(float(np.abs(b).max()), 1e-300), \
            f"{name}: max |d| {err:.3g}"


@pytest.mark.parametrize("T", [1, 37, 200])
@pytest.mark.parametrize("Di,N", [(100, 16), (200, 8)])
@pytest.mark.parametrize("extra", [False, True])
def test_lane_model_equals_the_plain_backward(T, Di, N, extra):
    """f64, two batch rows, Di over two blocks with the second ragged (64
    channels a block at N 16, 128 at N 8): from a zero state with no dh,
    and from h0 with dh (and dh0)."""
    x = _inputs(2, T, Di, N, seed=T + Di + N)
    got = _run(x, extra, extra, _lanes, torch.float64)
    want = _run(x, extra, extra, ssm_scan_bwd_ref, torch.float64)
    _close(got, want, 1e-12)


def _jax_grads(x, chunk, u_dtype):
    """jax.vjp of `_mamba_scan_chunked` + D·u (no h0) with cotangents on y
    and on the final state."""
    u = jnp.asarray(x["u"]).astype(u_dtype).astype(jnp.float32)
    args = [u] + [jnp.asarray(x[n]) for n in ("dt", "B", "C", "A", "D")]

    def f(u, dt, B, C, A, D):
        y, h = _mamba_scan_chunked(u, dt, B, C, A, chunk)
        return y + u * D, h
    _, vjp = jax.vjp(f, *args)
    g = vjp((jnp.asarray(x["dy"]), jnp.asarray(x["dh"])))
    return [np.array(a) for a in g] + [None]


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,Di,N,chunk", [(37, 70, 16, 8), (29, 130, 8, 16)])
def test_lane_model_matches_jax_vjp_of_the_model_scan(u_dtype, T, Di, N,
                                                      chunk):
    """f32 (u f32 or bf16), ragged T and Di, dh given: the model against
    autodiff of the reference's Mamba scan."""
    x = _inputs(2, T, Di, N, seed=5 + T, dtype=np.float32)
    want = _jax_grads(x, chunk, jnp.dtype(u_dtype))
    got = _run(x, False, True, _lanes, torch.float32,
               getattr(torch, u_dtype))
    assert got[0].dtype == getattr(torch, u_dtype)
    _close(got, want, SSM_TOL,
           SSM_TOL + (2 ** -8 if u_dtype == "bfloat16" else 0))


@pytest.mark.parametrize("Bb,Di,N,vector,grid", [
    (1, 16384, 16, True, (256, 1)),     # Jamba's train microbatch
    (3, 300, 16, True, (5, 3)),         # ragged: 4 full blocks + 44
    (2, 1000, 8, False, (8, 2)),        # 128 channels a block at N 8
    (1, 64, 16, True, (1, 1)),
])
def test_plan_bwd_gives_four_lanes_a_channel(Bb, Di, N, vector, grid):
    """Blocks of 256 threads, 1,024 / N channels each, over Di and the
    batch rows; `vector` as given."""
    assert SK.plan_bwd(Bb, Di, N, vector) == Launch("reverse", grid, 256,
                                                    vector)
