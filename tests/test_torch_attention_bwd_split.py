"""The flash backward's head split, on the CPU.

`fa_flash_bwd` cuts the G query heads of each KV head into `hsplit`
contiguous ranges, one dK/dV block each, and sums the ranges' f32
partials in range order in a second pass (`kernel.plan_bwd` decides the
launch; the kernel runs only on the card).  Here:

- `plan_bwd` at Qwen1.5-0.5B's train shape, Jamba's, granite-34b's MQA
  (48 heads on one KV head) and the GQA + window shape of chip_smoke's
  BWD_CASES: every query head lies in exactly one range, the dK/dV grid
  reaches two blocks an SM wherever G allows, and the grids are the ones
  the C entry checks;
- a plain PyTorch model of the split backward in the kernel's order
  (per range: heads, then query tiles of the plan's rows, accumulated in
  f32; the ranges' partials summed in order, dK scaled once) against
  `attention_bwd_ref` in f32, each gradient within 4e-6 of its max-abs
  (the two sum in other orders: at these shapes the model in f64 differs
  from the f32 plain version by up to 3.3e-6; a head left out of its
  range or counted twice moves a gradient by ~0.1 of its max-abs), and,
  at one case, against `jax.vjp` of the reference's `attention_ref`
  (2e-5, tests/test_torch_attention_bwd.py's tolerance).

Inputs are numpy, seeded.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ref import attention_ref as j_attention

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

# (B, H, KH, S, T, hd, causal, window): Qwen1.5-0.5B's train shape,
# Jamba's (64 heads on 8), MQA (granite-34b's 48 heads on 1), GQA +
# window (chip_smoke.BWD_CASES)
PLAN_SHAPES = [(8, 16, 16, 1024, 1024, 64, True, 0),
               (8, 64, 8, 1024, 1024, 128, True, 0),
               (2, 48, 1, 1024, 1024, 128, True, 0),
               (2, 32, 8, 2048, 2048, 128, True, 256)]


@pytest.mark.parametrize("B,H,KH,S,T,hd,causal,window", PLAN_SHAPES)
def test_plan_bwd_covers_every_head_once_and_fills_the_card(
        B, H, KH, S, T, hd, causal, window):
    plan = FK.plan_bwd(B, H, KH, S, T, hd, causal=causal, window=window)
    G = H // KH
    assert plan.route == "wgmma" and plan.block == FK.BWD_THREADS
    assert 1 <= plan.hsplit <= G
    ranges = FK.head_ranges(G, plan.hsplit)
    heads = [h for lo, hi in ranges for h in range(lo, hi)]
    assert heads == list(range(G)) and all(hi > lo for lo, hi in ranges)
    base = -(-T // 64) * KH * B
    assert plan.grid[1] == base * plan.hsplit
    if base * G >= 2 * FK.SMS:
        assert plan.grid[1] >= 2 * FK.SMS
    sums = -(-2 * B * T * KH * hd // 4 // FK.BWD_THREADS) \
        if plan.hsplit > 1 else 0
    assert plan.grid == (-(-B * H * S // 8), base * plan.hsplit,
                         -(-S // 64) * H * B + sums)
    assert FK.plan_bwd(B, H, KH, S, T, hd, f32=True).hsplit == 1


def test_plan_bwd_splits_only_where_the_grid_is_short():
    """Qwen (G 1) cannot split; MQA splits its 48 heads; a GQA grid that
    already fills the card keeps its heads together."""
    assert FK.plan_bwd(*PLAN_SHAPES[0][:6]).hsplit == 1
    assert FK.plan_bwd(*PLAN_SHAPES[1][:6]).hsplit == 1
    assert FK.plan_bwd(*PLAN_SHAPES[2][:6]).hsplit > 8
    assert FK.plan_bwd(*PLAN_SHAPES[3][:6], window=256).hsplit == 1


def _inputs(B, S, T, H, KH, hd, seed):
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return z(B, H, S, hd), z(B, KH, T, hd), z(B, KH, T, hd), z(B, H, S, hd)


def split_bwd(q, k, v, o, lse, do, *, causal, window, hsplit):
    """(dq, dk, dv) in the kernel's order: for each range of query heads
    an f32 dK/dV partial accumulated head by head and query tile by
    query tile (BQ rows, `kernel.BWD_TILE` or half at hd 128), then the
    partials summed in range order and dK scaled once."""
    B, H, S, hd = q.shape
    KH, T = k.shape[1], k.shape[2]
    G, scale = H // KH, 1.0 / math.sqrt(hd)
    BQ = 32 if hd == 128 else 64
    i, j = torch.arange(S)[:, None], torch.arange(T)[None, :]
    ok = (j <= i) if causal else torch.ones(S, T, dtype=torch.bool)
    if window > 0:
        ok = ok & (i - j < window)
    s = torch.einsum("bhsd,bhtd->bhst", q,
                     k.repeat_interleave(G, 1)) * scale
    fin = lse.masked_fill(lse == float("-inf"), 0.0)[..., None]
    p = torch.where(ok, torch.exp(s - fin), torch.zeros(()))
    delta = (do * o).sum(-1, keepdim=True)
    dp = torch.einsum("bhsd,bhtd->bhst", do, v.repeat_interleave(G, 1))
    ds = p * (dp - delta)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, k.repeat_interleave(G, 1))
    parts = []
    for lo, hi in FK.head_ranges(G, hsplit):
        pk = torch.zeros(B, KH, T, hd)
        pv = torch.zeros(B, KH, T, hd)
        for g in range(lo, hi):
            heads = torch.arange(KH) * G + g
            for q0 in range(0, S, BQ):
                rows = slice(q0, min(S, q0 + BQ))
                pv += torch.einsum("bkst,bksd->bktd", p[:, heads, rows],
                                   do[:, heads, rows])
                pk += torch.einsum("bkst,bksd->bktd", ds[:, heads, rows],
                                   q[:, heads, rows])
        parts.append((pk, pv))
    dk, dv = parts[0]
    for pk, pv in parts[1:]:
        dk, dv = dk + pk, dv + pv
    return dq * scale, dk * scale, dv


SPLIT_TOL = 4e-6
# (B, S, T, H, KH, hd, causal, window, hsplit)
SPLIT_CASES = [(2, 130, 130, 8, 1, 32, True, 0, 3),
               (1, 96, 96, 8, 2, 64, True, 40, 4),
               (1, 70, 201, 6, 2, 128, False, 0, 2),
               (2, 64, 64, 4, 4, 64, True, 0, 1),
               (1, 100, 100, 12, 1, 64, False, 30, 12)]


@pytest.mark.parametrize("B,S,T,H,KH,hd,causal,window,hsplit", SPLIT_CASES)
def test_split_model_equals_the_plain_backward(B, S, T, H, KH, hd, causal,
                                               window, hsplit):
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(B, S, T, H, KH, hd, seed=S + hd + hsplit))
    o, lse = attention_ref(q, k, v, causal=causal, window=window,
                           return_lse=True)
    got = split_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                    hsplit=hsplit)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                             window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a - b).abs().max())
        assert err <= SPLIT_TOL * float(b.abs().max()), (name, err)


def test_split_model_matches_jax_vjp_of_the_reference():
    """MQA with the heads in 3 ranges, causal, ragged S = T = 130."""
    B, S, T, H, KH, hd = 1, 130, 130, 6, 1, 64
    qn, kn, vn, don = _inputs(B, S, T, H, KH, hd, seed=7)
    q, k, v, do = (torch.from_numpy(x) for x in (qn, kn, vn, don))
    o, lse = attention_ref(q, k, v, causal=True, return_lse=True)
    got = split_bwd(q, k, v, o, lse, do, causal=True, window=0, hsplit=3)

    def f(q, k, v):
        return j_attention(q, k, v, causal=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (qn, kn, vn)))
    want = vjp(jnp.asarray(don))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b, np.float32)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 2e-5 * float(np.abs(b).max()), name
