"""The scan kernels' decompositions, on the CPU: each wrapper's choice of
route (`pick_route`) and launch shape (`plan`), and a plain PyTorch
model of each CUDA kernel's arithmetic in the kernel's order of
operations —

- WKV's chunked route: each column's rows split over 8 lane groups (lane
  g holds rows 32 m + 4 g + e), o summed per group and joined by the
  kernel's shuffle tree, the bonus scalar reduced over a warp's 32 lanes;
- WKV's step route: o over row groups (rows i0 + m N / 4), joined by the
  shuffles within a warp, then summed over warps;
- SSM's chunked route: the per-channel scan with y in two partial sums;
- SSM's step route: the state split over lanes of four (two at N = 8),
  y joined by the shuffle tree —

held against the port's `wkv_scan_ref` / `ssm_scan_ref` and against the
reference's Pallas kernels in interpret mode.  Tolerances are those of
tests/test_torch_wkv.py (1e-4) and tests/test_torch_ssm.py (2e-4): the
reference's own for its kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from repro.kernels.ssm_scan.kernel import ssm_scan as j_ssm_scan  # noqa
from repro.kernels.wkv_scan.kernel import wkv_scan as j_wkv_scan  # noqa
from repro.models.layers import _wkv_chunked  # noqa: E402

from repro_torch.kernels.cuda_build import Launch, on_16b  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.kernels.wkv_scan import kernel as WK  # noqa: E402
from repro_torch.kernels.wkv_scan.ref import wkv_scan_ref  # noqa: E402

WKV_TOL = dict(rtol=1e-4, atol=1e-4)
SSM_TOL = dict(rtol=2e-4, atol=2e-4)
LOG2E = 1.4426950408889634


def _tree(parts):
    """Sum pairwise as xor shuffles with rising offsets join lanes:
    ((p0 + p1) + (p2 + p3)) + ... ."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _fma(a, b, c):
    """f32 a * b + c rounded once, as the card's fused multiply-add."""
    return (a.double() * b.double() + c.double()).float()


# ------------------------------------------------------------ route choice
def test_wkv_plan_at_the_serve_shapes():
    """RWKV6-3B (B 8, H 40, N 64): prefill one block of 128 threads a
    head (16 column groups of 4 columns, 8 lanes each), decode one block
    of 512 a head (two float4s of the state a thread); N = 32 halves
    both.  The step route serves T = 1 unless the chunked one is forced."""
    assert WK.pick_route(1024) == "chunked"
    assert WK.pick_route(1) == "step"
    assert WK.pick_route(1, "chunked") == "chunked"
    assert WK.plan(8, 40, 64, "chunked", True) == Launch(
        "chunked", (320,), 128, True)
    assert WK.plan(8, 40, 64, "step", True) == Launch("step", (320,), 512,
                                                      True)
    assert WK.plan(8, 40, 64, "chunked", False) == Launch(
        "chunked", (320,), 128, False)
    assert WK.plan(3, 5, 32, "chunked", True) == Launch("chunked", (15,), 64,
                                                        True)
    assert WK.plan(3, 5, 32, "step", True) == Launch("step", (15,), 128,
                                                     True)


def test_ssm_plan_at_the_serve_shapes():
    """Jamba (Bb 8, Di 16,384, N 16): prefill 64 x 8 blocks of 256
    channels (3 or 4 on each of 132 SMs), decode 2,048 blocks of 256 lanes
    (4 a channel); N = 8 takes 2 lanes a channel; a ragged Di rounds up.
    The step route serves T = 1 unless the chunked one is forced."""
    assert SK.pick_route(1024) == "chunked"
    assert SK.pick_route(1) == "step"
    assert SK.pick_route(1, "chunked") == "chunked"
    assert SK.plan(8, 16384, 16, "chunked", True) == Launch(
        "chunked", (64, 8), 256, True)
    assert SK.plan(8, 16384, 16, "step", True) == Launch("step", (2048,),
                                                         256, True)
    assert SK.plan(2, 1000, 8, "chunked", False) == Launch(
        "chunked", (4, 2), 256, False)
    assert SK.plan(2, 1001, 8, "step", True) == Launch("step", (16,), 256,
                                                       True)


@pytest.mark.parametrize("kernel", [WK, SK])
@pytest.mark.parametrize("T,route", [(2, "step"), (1, "nope")])
def test_a_route_the_call_cannot_take_raises(kernel, T, route):
    """The step route takes one token only; an unknown route raises."""
    with pytest.raises(ValueError, match="route"):
        kernel.pick_route(T, route)


@pytest.mark.parametrize("dtype,offset,row,want", [
    ("float32", 0, 64, True), ("float32", 1, 64, False),
    ("float32", 4, 64, True), ("float32", 0, 69, False),
    ("bfloat16", 8, 64, True), ("bfloat16", 4, 64, False),
    ("bfloat16", 0, 68, False)])
def test_operands_on_16_bytes_choose_the_vector_staging(dtype, offset, row,
                                                        want):
    """`on_16b`: a start on 16 bytes and strides of 16 bytes (the
    model's [B, T, H, N] views, Jamba's x_proj slices at d_model 8,192)
    stage by cp.async; a start off 16 bytes, or a row stride that is
    not a multiple of 16 bytes, by element loads."""
    buf = torch.zeros(4 * 3 * row + 16, dtype=getattr(torch, dtype))
    assert buf.data_ptr() % 16 == 0
    x = buf[offset:offset + 4 * 3 * row].view(4, 3, row)[..., :32]
    assert on_16b(x, (0, 1)) is want


# ------------------------------------------------------------------ WKV
def _bonus(rt, kt, uf):
    """The step's scalar sum_i r_i u_i k_i as both WKV kernels reduce it:
    lane l sums rows l, l + 32 in order, then a butterfly over 32 lanes
    (offsets 16 .. 1); lane 0's value."""
    N = rt.shape[-1]
    lanes = [torch.zeros(rt.shape[:-1]) for _ in range(32)]
    for lane in range(32):
        for i in range(lane, N, 32):
            lanes[lane] = _fma(rt[..., i] * uf[..., i], kt[..., i],
                               lanes[lane])
    for off in (16, 8, 4, 2, 1):
        lanes = [lanes[x] + lanes[x ^ off] for x in range(32)]
    return lanes[0]


def wkv_chunked_model(r, k, v, w_log, u, s0=None):
    """`wkv_kernel_chunked`'s arithmetic on [B, H, T, N] (u [B, H, N]): per
    step, lane group g's share of o over its rows in order, joined by the
    shuffle tree, plus v times the bonus scalar (`_bonus`); then the
    state."""
    B, H, T, N = r.shape
    rows = N // 8
    lane_rows = [[32 * (q // 4) + 4 * g + q % 4 for q in range(rows)]
                 for g in range(8)]
    uf = u.float()
    S = torch.zeros((B, H, N, N)) if s0 is None else s0.float().clone()
    o = torch.empty((B, H, T, N))
    for t in range(T):
        rt, kt, vt = (x[:, :, t].float() for x in (r, k, v))
        wt = torch.exp(w_log[:, :, t].float())
        bonus = _bonus(rt, kt, uf)
        groups = []
        for g in range(8):
            acc = torch.zeros((B, H, N))
            for i in lane_rows[g]:
                acc = _fma(rt[..., i, None], S[:, :, i], acc)
            groups.append(acc)
        o[:, :, t] = _fma(vt, bonus[..., None], _tree(groups))
        S = _fma(wt[..., None], S, kt[..., None] * vt[:, :, None, :])
    return o, S


def wkv_step_model(r, k, v, w_log, u, s0):
    """`wkv_kernel_step`'s arithmetic for one token ([B, H, 1, N]), with
    M = `STEP_FLOAT4S` float4s of the state a thread: thread (i0, jq) sums
    rows i0 + m N / M in order, the lanes of a warp that share jq are
    joined by the shuffle tree (32 / (N / 4) row groups a warp), the
    warps summed in order, plus v times the bonus scalar (`_bonus`)."""
    B, H, _, N = r.shape
    M = WK.STEP_FLOAT4S
    rt, kt, vt = (x[:, :, 0].float() for x in (r, k, v))
    wt = torch.exp(w_log[:, :, 0].float())
    uf, S = u.float(), s0.float()
    groups = []
    for i0 in range(N // M):
        acc = torch.zeros((B, H, N))
        for m in range(M):
            i = i0 + m * (N // M)
            acc = _fma(rt[..., i, None], S[:, :, i], acc)
        groups.append(acc)
    per_warp = 32 // (N // 4)
    total = torch.zeros((B, H, N))
    for w in range(0, N // M, per_warp):
        total = total + _tree(groups[w:w + per_warp])
    o = _fma(vt, _bonus(rt, kt, uf)[..., None], total)
    S = _fma(wt[..., None], S, kt[..., None] * vt[:, :, None, :])
    return o[:, :, None], S


def _wkv_inputs(B, H, T, N, seed):
    """r, k, v, w_log [B, H, T, N] and u [B, H, N], numpy f32, at the
    reference test's scales (decays exp(-exp(z - 2)))."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (0.5 * z(B, H, T, N), 0.5 * z(B, H, T, N), z(B, H, T, N),
            -np.exp(z(B, H, T, N) - 2).astype(np.float32),
            0.1 * z(B, H, N))


def _flat(*xs):
    return [jnp.asarray(x.reshape(-1, *x.shape[2:]).copy()) for x in xs]


@pytest.mark.parametrize("B,H,T,N,seed", [(2, 3, 37, 64, 0),
                                          (1, 2, 64, 32, 1),
                                          (2, 2, 16, 64, 2)])
def test_wkv_chunked_model_matches_the_refs(B, H, T, N, seed):
    """The chunked model against `wkv_scan_ref` and, at T a multiple of
    its chunk, the Pallas `wkv_scan` in interpret mode."""
    x = _wkv_inputs(B, H, T, N, seed)
    o, S = wkv_chunked_model(*(torch.from_numpy(a.copy()) for a in x))
    want_o, want_S = wkv_scan_ref(*(torch.from_numpy(
        a.reshape(-1, *a.shape[2:]).copy()) for a in x))
    np.testing.assert_allclose(o.reshape(-1, T, N).numpy(),
                               want_o.numpy(), **WKV_TOL)
    np.testing.assert_allclose(S.reshape(-1, N, N).numpy(),
                               want_S.numpy(), **WKV_TOL)
    chunk = 16 if T % 16 == 0 else T
    pal_o, pal_S = (np.array(a) for a in j_wkv_scan(*_flat(*x), chunk=chunk,
                                                    interpret=True))
    np.testing.assert_allclose(o.reshape(-1, T, N).numpy(), pal_o,
                               **WKV_TOL, err_msg="o against the Pallas")
    np.testing.assert_allclose(S.reshape(-1, N, N).numpy(), pal_S,
                               **WKV_TOL, err_msg="S against the Pallas")


@pytest.mark.parametrize("N,seed", [(64, 3), (32, 4)])
def test_wkv_step_model_matches_the_refs(N, seed):
    """One token from a state: the step model against `wkv_scan_ref(s0=)`
    and the reference's `_wkv_chunked(h0=)`; from zeros, against the
    Pallas `wkv_scan` at T = 1."""
    B, H = 2, 3
    x = _wkv_inputs(B, H, 1, N, seed)
    s0 = np.random.default_rng(seed + 10).standard_normal(
        (B, H, N, N)).astype(np.float32)
    tx = [torch.from_numpy(a.copy()) for a in x]
    o, S = wkv_step_model(*tx, torch.from_numpy(s0.copy()))
    want_o, want_S = wkv_scan_ref(*(t.reshape(-1, *t.shape[2:]) for t in tx),
                                  torch.from_numpy(s0.reshape(-1, N, N)))
    np.testing.assert_allclose(o.reshape(-1, 1, N).numpy(), want_o.numpy(),
                               **WKV_TOL)
    np.testing.assert_allclose(S.reshape(-1, N, N).numpy(), want_S.numpy(),
                               **WKV_TOL)
    bthn = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in x[:4]]
    shared = [torch.from_numpy(a.copy()) for a in x[:4]] + [
        torch.from_numpy(np.broadcast_to(x[4][:1], x[4].shape).copy())]
    o_s, S_s = wkv_step_model(*shared, torch.from_numpy(s0.copy()))
    j_o, j_S = (np.array(a) for a in _wkv_chunked(
        *bthn, x[4][0], chunk=1, h0=jnp.asarray(s0)))
    np.testing.assert_allclose(o_s.numpy(), j_o.transpose(0, 2, 1, 3),
                               **WKV_TOL, err_msg="o against _wkv_chunked")
    np.testing.assert_allclose(S_s.numpy(), j_S, **WKV_TOL,
                               err_msg="S against _wkv_chunked")
    o0, S0 = wkv_step_model(*tx, torch.zeros((B, H, N, N)))
    pal_o, pal_S = (np.array(a) for a in j_wkv_scan(*_flat(*x), chunk=1,
                                                    interpret=True))
    np.testing.assert_allclose(o0.reshape(-1, 1, N).numpy(), pal_o,
                               **WKV_TOL)
    np.testing.assert_allclose(S0.reshape(-1, N, N).numpy(), pal_S,
                               **WKV_TOL)


# ------------------------------------------------------------------ SSM
def ssm_chunked_model(u, dt, B, C, A, D, h0=None):
    """`ssm_kernel_chunked`'s arithmetic: per channel, state n's decay
    exp2(dt · A log2 e), h = decay · h + (dt u) B, y in two partial sums
    (even and odd n), y = (y0 + y1) + D u."""
    Bb, T, Di = u.shape
    N = A.shape[1]
    a2 = A.float() * LOG2E
    h = torch.zeros((Bb, Di, N)) if h0 is None else h0.float().clone()
    y = torch.empty((Bb, T, Di))
    for t in range(T):
        uc, dtc = u[:, t].float(), dt[:, t].float()
        du = dtc * uc
        y0, y1 = torch.zeros((Bb, Di)), torch.zeros((Bb, Di))
        for n in range(N):
            decay = torch.exp2(dtc * a2[:, n])
            h[..., n] = _fma(decay, h[..., n], du * B[:, t, None, n])
            if n % 2 == 0:
                y0 = _fma(h[..., n], C[:, t, None, n], y0)
            else:
                y1 = _fma(h[..., n], C[:, t, None, n], y1)
        y[:, t] = _fma(D.float(), uc, y0 + y1)
    return y, h


def ssm_step_model(u, dt, B, C, A, D, h0):
    """`ssm_kernel_step`'s arithmetic for one token: lane q holds states
    4q .. 4q + 3 of a channel, its share of y as fma(h0, C0, h1 C1) +
    fma(h2, C2, h3 C3), the lanes joined by the shuffle tree, then D u."""
    uc, dtc = u[:, 0].float(), dt[:, 0].float()
    du = dtc * uc
    N = A.shape[1]
    decay = torch.exp2(dtc[..., None] * (A.float() * LOG2E))
    h = _fma(decay, h0.float(), du[..., None] * B[:, 0, None, :])
    c = C[:, 0, None, :]
    lanes = [_fma(h[..., 4 * q], c[..., 4 * q],
                  h[..., 4 * q + 1] * c[..., 4 * q + 1])
             + _fma(h[..., 4 * q + 2], c[..., 4 * q + 2],
                    h[..., 4 * q + 3] * c[..., 4 * q + 3])
             for q in range(N // 4)]
    return _fma(D.float(), uc, _tree(lanes))[:, None], h


def _ssm_inputs(Bb, T, Di, N, seed):
    """u, dt, B, C, A, D numpy f32 at the reference test's scales (dt =
    softplus(z - 1), A = -exp(z))."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (z(Bb, T, Di), np.logaddexp(z(Bb, T, Di) - 1, 0).astype(
        np.float32), z(Bb, T, N), z(Bb, T, N), -np.exp(z(Di, N)), z(Di))


@pytest.mark.parametrize("Bb,T,Di,N,seed", [(2, 64, 128, 8, 0),
                                            (1, 48, 256, 16, 1),
                                            (2, 37, 100, 16, 2)])
def test_ssm_chunked_model_matches_the_refs(Bb, T, Di, N, seed):
    """The chunked model against
    `ssm_scan_ref` and the Pallas `ssm_scan` in interpret mode (one chunk
    of T steps)."""
    x = _ssm_inputs(Bb, T, Di, N, seed)
    y, h = ssm_chunked_model(*(torch.from_numpy(a.copy()) for a in x))
    want_y, want_h = ssm_scan_ref(*(torch.from_numpy(a.copy()) for a in x))
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **SSM_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **SSM_TOL)
    blk = 64 if Di % 64 == 0 else Di
    pal_y, pal_h = (np.array(jax.block_until_ready(a)) for a in j_ssm_scan(
        *(jnp.asarray(a.copy()) for a in x), chunk=T, block_di=blk,
        interpret=True))
    np.testing.assert_allclose(y.numpy(), pal_y, **SSM_TOL,
                               err_msg="y against the Pallas")
    np.testing.assert_allclose(h.numpy(), pal_h, **SSM_TOL,
                               err_msg="h against the Pallas")


@pytest.mark.parametrize("N,seed", [(16, 3), (8, 4)])
def test_ssm_step_model_matches_the_refs(N, seed):
    """The lane-split step from a state against `ssm_scan_ref(h0=)`; from
    zeros against the Pallas `ssm_scan` at T = 1."""
    Bb, Di = 2, 96
    x = _ssm_inputs(Bb, 1, Di, N, seed)
    h0 = np.random.default_rng(seed + 10).standard_normal(
        (Bb, Di, N)).astype(np.float32)
    tx = [torch.from_numpy(a.copy()) for a in x]
    y, h = ssm_step_model(*tx, torch.from_numpy(h0.copy()))
    want_y, want_h = ssm_scan_ref(*tx, torch.from_numpy(h0.copy()))
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **SSM_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **SSM_TOL)
    y0, h0_ = ssm_step_model(*tx, torch.zeros((Bb, Di, N)))
    pal_y, pal_h = (np.array(jax.block_until_ready(a)) for a in j_ssm_scan(
        *(jnp.asarray(a.copy()) for a in x), chunk=1, block_di=32,
        interpret=True))
    np.testing.assert_allclose(y0.numpy(), pal_y, **SSM_TOL)
    np.testing.assert_allclose(h0_.numpy(), pal_h, **SSM_TOL)
