"""The WKV backward's segment-parallel decomposition, on the CPU.

`wkv_backward` (csrc/wkv.cu) runs over the forward's 64-step segments in
parallel, its dw_log a running sum through the cumulative log decay
(dw_log_t = sum_{m >= t} (a_{m+1} - k_m * (G_m v_m)), a_t = r_t * (S_{t-1}
dO_t)), in four launches: (1) the state pass: dr, a, the jump into the
next segment (delta), the segment's state from zero M, its decay product
W, and in closed forward forms the adjoint from zero it leaves at its
start L (sum_t diag(P_t) r_t dO_t^T, P_t the decays from the segment's
start) and its running sum from zero (sum a_{m+1} - sum_t r_t * (M_{t-1}
dO_t)), and its du; (2) the carry per (b, h): the adjoint entering each
segment, G_in(c - 1) = diag(W(c)) G_in(c) + L(c) from dS, and the
running sum entering each segment's last step (a segment adds its own
sum plus rowsum(G_in * (delta - M))); (3) the gradient pass from the
true G_in and sum; (4) du over b and the segments.  The kernel runs
only on the card; here a plain PyTorch model of it in the kernel's order
of work —

- held in f64 against the plain backward `wkv_scan_bwd_ref` on f64
  inputs (each gradient within 1e-12 of its max-abs): T below 64, at 64
  and ragged over segments (45, 64, 130), N 32 and 64, with and without
  s0 and dS, at the reference test's decays, at RWKV6-3B's initial
  decays (w ~ 0.9975) and at decays whose products underflow to 0 (the
  carry multiplies by W = 0; nothing divides by a decay);
- held in f32 against `jax.vjp` of the reference model's scan
  `_wkv_chunked(..., h0=)` at tests/test_torch_scan_bwd.py's WKV
  tolerance (1e-4 of each gradient's max-abs);
- in f32 at RWKV6-3B's decays with dO orthogonal to o (the group norm
  after the scan): its distance from the f64 plain backward beside the
  f32 plain backward's own (PERF.md's precision study);

and `plan_bwd`'s launch.  A wrong carry, jump or segment order fails
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.layers import _wkv_chunked  # noqa: E402

from repro_torch.kernels.cuda_build import Launch  # noqa: E402
from repro_torch.kernels.wkv_scan import kernel as WK  # noqa: E402
from repro_torch.kernels.wkv_scan.ref import (STATE_EVERY,  # noqa: E402
                                              wkv_scan_bwd_ref,
                                              wkv_scan_plain)

GRADS = ("dr", "dk", "dv", "dw_log", "du", "ds0")


def wkv_bwd_segments(r, k, v, w_log, u, do, dS, states, S=None,
                     need_ds0=False):
    """`kernel.wkv_scan_bwd` in the kernel's order, in r's dtype:
    r/k/v/w_log/do [B,H,T,N], u [B,H,N], dS [B,H,N,N] or None (then S,
    the forward's final state, is not read), states [B,H,ceil(T/64),N,N]
    -> (dr, dk, dv, dw_log [B,H,T,N], du [H,N], ds0 or None)."""
    B, H, T, N = r.shape
    dt = r.dtype
    C = -(-T // STATE_EVERY)
    flat = lambda x: x.reshape(B * H, *x.shape[2:]).to(dt)
    rf, kf, vf, wl, dof, uf, X = (flat(x) for x in
                                  (r, k, v, w_log, do, u, states))
    w = torch.exp(wl)
    vdo = (vf * dof).sum(-1, keepdim=True)
    bonus = (rf * uf[:, None] * kf).sum(-1, keepdim=True)
    outer = lambda x, y: x[:, :, None] * y[:, None, :]
    rowsum = lambda x, y: (x * y).sum(-1)
    span = lambda c: range(c * STATE_EVERY, min(T, (c + 1) * STATE_EVERY))
    grads = [torch.empty(B * H, T, N, dtype=dt) for _ in range(4)]
    dr, dk, dv, dw = grads
    a = torch.zeros(B * H, T + 1, N, dtype=dt)      # a_T = 0 here
    zero = torch.zeros(B * H, N, N, dtype=dt)

    # (1) the state pass, with the segment's share from a zero adjoint
    delta, e, W = [zero] * (C + 1), [None] * C, [None] * C
    L, loc, du_part = [None] * C, [None] * C, [None] * C
    for c in range(C):
        Sc, M, Lc = X[:, c].clone(), zero.clone(), zero.clone()
        P = torch.ones(B * H, N, dtype=dt)
        lc = torch.zeros(B * H, N, dtype=dt)
        du = torch.zeros(B * H, N, dtype=dt)
        for t in span(c):
            sd = rowsum(Sc, dof[:, t, None, :])
            md = rowsum(M, dof[:, t, None, :])
            dr[:, t] = sd + uf * kf[:, t] * vdo[:, t]
            a[:, t] = rf[:, t] * sd
            lc = lc + (a[:, t] if t > span(c)[0] else 0) - rf[:, t] * md
            du = du + rf[:, t] * kf[:, t] * vdo[:, t]
            Lc = Lc + outer(P * rf[:, t], dof[:, t])
            kv = outer(kf[:, t], vf[:, t])
            Sc = w[:, t, :, None] * Sc + kv
            M = w[:, t, :, None] * M + kv
            P = P * w[:, t]
        if c + 1 < C:
            delta[c + 1] = Sc - X[:, c + 1]
            t1 = span(c)[-1] + 1          # a_{t1}, from the next saved state
            lc = lc + rf[:, t1] * rowsum(X[:, c + 1], dof[:, t1, None, :])
        elif dS is not None:            # the jump into the final state
            delta[C] = Sc - flat(S)
        e[c], W[c], L[c], loc[c], du_part[c] = delta[c + 1] - M, P, Lc, lc, du

    # (2) the carry, from the last segment
    G = zero.clone() if dS is None else flat(dS)
    acc = torch.zeros(B * H, N, dtype=dt) if dS is None else \
        rowsum(flat(S), G)
    gin, dwin = [None] * C, [None] * C
    for c in reversed(range(C)):
        gin[c], dwin[c] = G, acc
        acc = acc + loc[c] + rowsum(G, e[c])
        G = W[c][:, :, None] * G + L[c]

    # (3) the gradient pass, each segment from its true adjoint and sum
    ds0 = None
    for c in range(C):
        G, acc = gin[c].clone(), dwin[c].clone()
        for t in reversed(span(c)):
            if t == span(c)[-1]:
                acc = acc + rowsum(delta[c + 1], G)
            gv = rowsum(G, vf[:, t, None, :])
            dk[:, t] = gv + uf * rf[:, t] * vdo[:, t]
            dv[:, t] = (G * kf[:, t, :, None]).sum(1) + \
                dof[:, t] * bonus[:, t]
            acc = acc + a[:, t + 1] - kf[:, t] * gv
            dw[:, t] = acc
            G = w[:, t, :, None] * G + outer(rf[:, t], dof[:, t])
        if c == 0:
            ds0 = G

    # (4) du over b, then the segments
    parts = torch.stack(du_part, 1).reshape(B, H, C, N)
    du = torch.zeros(H, N, dtype=dt)
    for b in range(B):
        for c in range(C):
            du = du + parts[b, :, c]
    out = [g.reshape(B, H, T, N).to(r.dtype) for g in grads]
    return (*out, du.to(u.dtype),
            ds0.reshape(B, H, N, N) if need_ds0 else None)


def _inputs(B, T, H, N, decay, seed, dtype=np.float64):
    """r, k, v, w_log [B,H,T,N], u [B,H,N] (a batch view of [H,N]), s0,
    do, dS, numpy seeded.  decay: "reference" (w_log = -exp(z - 2), the
    reference test's), "rwkv6" (-exp(z - 6): RWKV6-3B's initial decays,
    w ~ 0.9975, unit r/k/v), "underflow" (w_log <= -30: a segment's
    decay product is 0)."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(dtype)
    s = 0.5 if decay == "reference" else 1.0
    r, k, v = s * z(B, H, T, N), s * z(B, H, T, N), z(B, H, T, N)
    zw = z(B, H, T, N)
    w_log = {"reference": -np.exp(zw - 2), "rwkv6": -np.exp(zw - 6),
             "underflow": -30 - 10 * np.abs(zw)}[decay]
    u = np.broadcast_to((0.1 if decay == "reference" else 0.5) * z(H, N),
                        (B, H, N))
    return dict(r=r, k=k, v=v, w=w_log, u=u, s0=z(B, H, N, N),
                do=z(B, H, T, N), dS=z(B, H, N, N))


def _run(x, s0, dS, fn, dtype):
    t = lambda n: torch.tensor(np.ascontiguousarray(x[n]), dtype=dtype)
    r, k, v, w, u = (t(n) for n in "rkvwu")
    state0 = t("s0") if s0 else None
    _, S, states = wkv_scan_plain(r, k, v, w, u, state0, return_states=True)
    return fn(r, k, v, w, u, t("do"), t("dS") if dS else None, state0,
              states, S=S, need_ds0=s0)


def _segments(r, k, v, w, u, do, dS, s0, states, S, need_ds0):
    return wkv_bwd_segments(r, k, v, w, u, do, dS, states, S, need_ds0)


def _close(got, want, tol, dw_scale=None):
    """Each gradient within `tol` of its max-abs; dw_log, with
    `dw_scale`, within `tol` of the max-abs of dr and dk instead: where the
    decays vanish, dw_log = w rowsum(S * G) vanishes with them, but the
    running sum still adds terms of dr's and dk's size (a_{m+1}, k_m *
    (G_m v_m)), so its rounding is at their scale."""
    for name, a, b in zip(GRADS, got, want):
        if b is None:
            assert a is None, name
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = float(np.abs(a - b).max())
        scale = float(np.abs(b).max())
        if name == "dw_log" and dw_scale is not None:
            scale = max(float(np.abs(np.asarray(x, np.float64)).max())
                        for x in want[:2])
        assert err <= tol * max(scale, 1e-300), f"{name}: max |d| {err:.3g}"


@pytest.mark.parametrize("decay", ["reference", "rwkv6", "underflow"])
@pytest.mark.parametrize("T,N", [(45, 32), (64, 64), (130, 64),
                                 (130, 32)])
@pytest.mark.parametrize("extra", [False, True])
def test_segment_model_equals_the_plain_backward(decay, T, N, extra):
    """f64: from a zero state with no dS, and from s0 with dS (and
    ds0).  With vanishing decays dw_log is held at the scale of the
    running sum's terms (see `_close`)."""
    x = _inputs(2, T, 2, N, decay, seed=T + N)
    got = _run(x, extra, extra, _segments, torch.float64)
    want = _run(x, extra, extra, wkv_scan_bwd_ref, torch.float64)
    _close(got, want, 1e-12, dw_scale=decay == "underflow" or None)


def test_segment_model_matches_jax_vjp_of_the_model_scan():
    """f32, ragged T over three segments, s0 and dS, against autodiff of
    the reference model's chunked scan (the model layout [B,T,H,N])."""
    B, T, H, N, chunk = 1, 130, 2, 64, 32
    x = _inputs(B, T, H, N, "reference", seed=3, dtype=np.float32)
    bt = lambda n: jnp.asarray(x[n]).transpose(0, 2, 1, 3)

    def f(r, k, v, w, u, h0):
        return _wkv_chunked(r, k, v, w, u, chunk=chunk, h0=h0)
    _, vjp = jax.vjp(f, bt("r"), bt("k"), bt("v"), bt("w"),
                     jnp.asarray(x["u"][0]), jnp.asarray(x["s0"]))
    g = vjp((bt("do"), jnp.asarray(x["dS"])))
    back = lambda a: np.asarray(a).transpose(0, 2, 1, 3)
    want = [back(a) for a in g[:4]] + [np.asarray(g[4]), np.asarray(g[5])]
    got = _run(x, True, True, _segments, torch.float32)
    _close([a.numpy() for a in got], want, 1e-4)


def test_segment_order_rounds_as_the_plain_f32_backward():
    """RWKV6-3B's decays, dO orthogonal to 1 and to o - mean(o) per step
    (the group norm after the scan), T 256: run in f32, the segment
    order is as far from the f64 plain backward as the f32 plain
    backward is (within 3x), every gradient.  (The kernel runs it in
    f64: on the real model f32 misses the per-launch check, PERF.md.)"""
    B, T, H, N = 1, 256, 2, 64
    x = _inputs(B, T, H, N, "rwkv6", seed=11)
    t64 = lambda n: torch.tensor(np.ascontiguousarray(x[n]))
    o, _ = wkv_scan_plain(*(t64(n) for n in "rkvwu"))
    o = o.numpy()
    g = x["do"] - x["do"].mean(-1, keepdims=True)
    oc = o - o.mean(-1, keepdims=True)
    x["do"] = g - (g * oc).sum(-1, keepdims=True) / \
        (oc * oc).sum(-1, keepdims=True) * oc
    exact = _run(x, False, False, wkv_scan_bwd_ref, torch.float64)
    plain = _run(x, False, False, wkv_scan_bwd_ref, torch.float32)
    model = _run(x, False, False, _segments, torch.float32)
    for name, m, p, e in zip(GRADS[:5], model, plain, exact):
        scale = float(e.abs().max())
        em = float((m.double() - e).abs().max()) / scale
        ep = float((p.double() - e).abs().max()) / scale
        assert em <= 3 * ep + 1e-7, f"{name}: {em:.3g} against {ep:.3g}"


@pytest.mark.parametrize("B,H,N,T,segs", [(4, 40, 64, 1024, 16),
                                          (2, 3, 32, 45, 1),
                                          (1, 2, 64, 64, 1),
                                          (2, 2, 64, 130, 3)])
def test_plan_bwd_runs_a_block_per_segment(B, H, N, T, segs):
    """RWKV6-3B's train shape (B 4: 2,560 blocks, 16 segments) and edge
    lengths: B x H x ceil(T / 64) blocks of N^2 / 8 threads."""
    assert WK.plan_bwd(B, H, N, T) == Launch("reverse", (B * H, segs),
                                             N * N // 8, False)
