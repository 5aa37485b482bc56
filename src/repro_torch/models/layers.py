"""Layer math of the dense attention path and of RWKV6: norms, RoPE,
attention (whole-sequence and one-token decode), the dense MLPs, and
RWKV6's time-mix (ddlerp token shift, WKV recurrence, per-head
groupnorm) and channel-mix.  Pure functions over parameter dicts of
tensors, ported from `repro.models.layers` with the same names and the
same arithmetic.

Attention: where the reference computes XLA twins of its Pallas kernels
(`flash_attention_xla`, the inline einsum softmax of `attention_decode`),
the port launches the Hopper kernels for CUDA tensors
(`kernels.flash_attention`, `kernels.decode_attention`, which implement
the same contract) and takes the plain PyTorch versions for CPU tensors:
the chunked online softmax of `flash_attention_chunked`, and
`decode_attention_ref`.

RWKV6: where the reference computes its XLA twin `_wkv_chunked` (an
associative scan) or the one-step einsums of `rwkv_decode`, the port
calls `kernels.wkv_scan.ops.wkv`: the Hopper kernel for CUDA tensors (the
whole prompt in prefill; one step from the layer's state, updated in
place, in decode), the sequential `wkv_scan_ref` for CPU tensors.  The
reference's `f32 @ bf16` products (the f32 ddlerp streams against bf16
weights) are computed in f32 as JAX computes them (`_mm32`).

MoE, Mamba and M-RoPE are not ported yet (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.cuda_build import on_cuda
from ..kernels.decode_attention.ops import decode_gqa
from ..kernels.flash_attention.ops import attention_bshd
from ..kernels.wkv_scan.ops import wkv

Params = dict


def eff_chunk(cfg, default: int, T: int) -> int:
    """Scan chunk size: cfg.scan_chunk == -1 means a single chunk."""
    sc = getattr(cfg, "scan_chunk", 0)
    if sc == -1:
        return T
    return sc if sc > 0 else default


def _normal(shape, scale: float, dtype, generator, device) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 from `generator`, cast to `dtype` (the
    reference's `(normal(key, shape) * s).astype(dtype)`)."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) \
        -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def norm_apply(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


def norm_init(d: int, kind: str, dtype, device=None) -> Params:
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


# ----------------------------------------------------------------------- RoPE
def rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions [...]; returns cos/sin [..., rot_dim/2] (fp32)."""
    half = rot_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) \
        -> torch.Tensor:
    """x [..., rot_dim] (split halves, not interleaved); cos/sin
    [..., rot_dim/2] broadcastable."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S] (or [S]).  Partial rotary
    supported (nemotron rope_fraction)."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = rope_cos_sin(positions, rot, theta)       # [B,S,rot/2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]    # broadcast heads
    if rot == hd:
        return _rotate(x, cos, sin)
    xr, xp = x[..., :rot], x[..., rot:]
    return torch.cat([_rotate(xr, cos, sin), xp], dim=-1)


# ----------------------------------------------------------------- attention
def attn_init(cfg, dtype, generator, device, *, cross: bool = False) \
        -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    n = lambda shape: _normal(shape, s, dtype, generator, device)
    p = {"wq": n((d, nh * hd)), "wk": n((d, nkv * hd)),
         "wv": n((d, nkv * hd)), "wo": n((nh * hd, d))}
    if cfg.qkv_bias and not cross:
        z = lambda n_: torch.zeros((n_,), dtype=dtype, device=device)
        p["bq"], p["bk"], p["bv"] = z(nh * hd), z(nkv * hd), z(nkv * hd)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg,
         kv_x: Optional[torch.Tensor] = None):
    B, S, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    xkv = x if kv_x is None else kv_x
    T = xkv.shape[1]
    q = x @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, nh, hd), k.reshape(B, T, nkv, hd),
            v.reshape(B, T, nkv, hd))


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            window: int = 0, chunk: int = 1024) \
        -> torch.Tensor:
    """Online-softmax attention, scanning KV in chunks: the plain
    counterpart of `repro.models.layers.flash_attention_xla` (without
    its `q_offset` / `kv_len` arguments, which no layer passes).

    q [B,S,H,hd]; k/v [B,T,K,hd] with H = K*G (GQA); query i and key j at
    positions i and j; `window` > 0 adds sliding-window masking.
    Returns [B,S,H,hd] in q's dtype."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    chunk = min(chunk, T)
    qf = q.reshape(B, S, K, G, hd).float() * (1.0 / math.sqrt(hd))
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, S, K, G), float("-inf"), device=q.device)
    l = torch.zeros((B, S, K, G), device=q.device)
    acc = torch.zeros((B, S, K, G, hd), device=q.device)
    for j0 in range(0, T, chunk):
        kj = k[:, j0:j0 + chunk].float()
        vj = v[:, j0:j0 + chunk].float()
        kv_pos = torch.arange(j0, j0 + kj.shape[1], device=q.device)
        s = torch.einsum("bskgh,btkh->bskgt", qf, kj)
        mask = torch.ones((S, kj.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window > 0:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a row with no visible key yet (m_new = -inf) takes nothing from
        # this chunk; the reference computes exp(-inf - -inf) = NaN there
        # (ROADMAP §3)
        m_safe = m_new.masked_fill(m_new == float("-inf"), 0.0)
        p = torch.exp(s - m_safe[..., None])
        scale = torch.exp(m - m_safe)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] \
            + torch.einsum("bskgt,btkh->bskgh", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, chunk: int = 1024) \
        -> torch.Tensor:
    """The layers' whole-sequence attention (q [B,S,H,hd]; k/v
    [B,T,K,hd]): the Hopper kernel for CUDA tensors (`attention_bshd`;
    `chunk` is the plain path's only), the chunked online softmax for CPU
    tensors."""
    if on_cuda(q):
        return attention_bshd(q, k, v, causal=causal, window=window)
    return flash_attention_chunked(q, k, v, causal=causal, window=window,
                                   chunk=chunk)


def _check_rope(cfg) -> None:
    if cfg.mrope_sections:
        raise NotImplementedError(
            "M-RoPE is not ported yet (ROADMAP queue 1 item 7)")


def attention(p: Params, x: torch.Tensor, cfg, *, positions,
              causal: bool = True, kv_x: Optional[torch.Tensor] = None,
              rope: bool = True) -> torch.Tensor:
    """Full-sequence (train / prefill) attention."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, kv_x)
    chunk = eff_chunk(cfg, 1024, k.shape[1] if kv_x is not None else S)
    if rope and kv_x is None:
        _check_rope(cfg)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                        chunk=chunk)
    return o.reshape(B, S, -1) @ p["wo"]


def attention_prefill(p: Params, x: torch.Tensor, cfg, *, positions,
                      kv_cache: tuple[torch.Tensor, torch.Tensor]) \
        -> torch.Tensor:
    """Prefill: full attention over the prompt, and its K/V written IN
    PLACE into `kv_cache` ([B, T_cache, K, hd] each, allocated once at the
    serving length).  Slot for slot the cache then equals the reference's
    returned one: the prompt's K/V at slots [0, S) when T_cache >= S (the
    reference pads the rest with zeros, which the port's fresh cache
    holds), the last T_cache positions at slots [0, T_cache) for a
    sliding-window rolling buffer.  Returns y."""
    B, S, _ = x.shape
    _check_rope(cfg)
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                        chunk=eff_chunk(cfg, 1024, S))
    y = o.reshape(B, S, -1) @ p["wo"]
    kc, vc = kv_cache
    n = min(S, kc.shape[1])
    kc[:, :n] = k[:, S - n:]
    vc[:, :n] = v[:, S - n:]
    return y


def attention_decode(p: Params, x: torch.Tensor, cfg,
                     kv_cache: tuple[torch.Tensor, torch.Tensor], *,
                     pos: int, cache_len: int) -> torch.Tensor:
    """One-token decode.  x [B,1,D]; kv_cache ([B,T,K,hd], [B,T,K,hd]).

    `pos` is the absolute position of the new token (for RoPE),
    `cache_len` the number of valid cache entries (plain ints).  The new
    K/V is written IN PLACE at slot `cache_len % T` (rolling buffer —
    exact for SWA, and for full attention T is sized to hold the max
    sequence); attention then runs over the first min(cache_len + 1, T)
    slots.  Returns y.  (Cross-attention decode is not ported yet.)"""
    B = x.shape[0]
    kc, vc = kv_cache
    T = kc.shape[1]
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    _check_rope(cfg)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    posb = torch.full((B, 1), pos, device=x.device)
    q = apply_rope(q.reshape(B, 1, nh, hd), posb, cfg.rope_theta,
                   cfg.rope_fraction)
    k = apply_rope(k.reshape(B, 1, nkv, hd), posb, cfg.rope_theta,
                   cfg.rope_fraction)
    slot = cache_len % T
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v.reshape(B, nkv, hd).to(vc.dtype)
    valid = min(cache_len + 1, T)
    o = decode_gqa(q.reshape(B, nh, hd), kc.transpose(1, 2),
                   vc.transpose(1, 2), valid)
    return o.reshape(B, 1, nh * hd).to(x.dtype) @ p["wo"]


# ------------------------------------------------------------------------ MLP
def mlp_init(d: int, f: int, act: str, dtype, generator, device) -> Params:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w_up": _normal((d, f), s_in, dtype, generator, device),
         "w_down": _normal((f, d), s_out, dtype, generator, device)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = _normal((d, f), s_in, dtype, generator, device)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    elif act == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    elif act == "relu2":                    # nemotron squared-ReLU
        h = torch.relu(up).square()
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]


# ---------------------------------------------------------------------- RWKV6
def _mm32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in f32: what JAX computes for the reference's f32 x bf16
    products (torch refuses mixed dtypes)."""
    return x.float() @ w.float()


def rwkv_init(cfg, dtype, generator, device) -> Params:
    d = cfg.d_model
    lw, lx = 64, 32
    s = 1.0 / math.sqrt(d)
    n = lambda shape, scale: _normal(shape, scale, dtype, generator, device)
    f32 = dict(dtype=torch.float32, device=device)
    p = {name: n((d, d), s) for name in ("wr", "wk", "wv", "wg", "wo")}
    p["w_lora_a"] = n((d, lw), s)
    p["w_lora_b"] = n((lw, d), 0.1)
    p["w_base"] = torch.full((d,), -6.0, **f32)          # decay base
    p["u"] = torch.zeros((d,), **f32)                    # time_first bonus
    p["mix_base"] = torch.zeros((6, d), **f32)           # ddlerp bases
    p["mix_lora_a"] = n((d, lx * 5), s)
    p["mix_lora_b"] = n((5, lx, d), 0.1)
    p["ln_w"] = torch.ones((d,), **f32)                  # post-wkv groupnorm
    p["ln_b"] = torch.zeros((d,), **f32)
    return p


def _rwkv_ddlerp(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift (RWKV6 ddlerp): returns the 5 mixed
    streams (r,k,v,w,g), f32 as in the reference (the f32 bases promote
    the stream).  x/x_prev [B,T,D]."""
    dx = x_prev - x
    base = x + dx * p["mix_base"][0]
    lora = torch.tanh(_mm32(base, p["mix_lora_a"]))     # [B,T,5*lx]
    lora = lora.reshape(*lora.shape[:-1], 5, -1)        # [B,T,5,lx]
    mixed = []
    for i in range(5):
        adj = _mm32(lora[..., i, :], p["mix_lora_b"][i])
        mixed.append(x + dx * (p["mix_base"][i + 1] + adj))
    return mixed  # [xr, xk, xv, xw, xg]


def _rwkv_streams(p: Params, x: torch.Tensor, x_prev: torch.Tensor, cfg):
    """r, k, v, w_log [B,T,H,N] and the gate g [B,T,D], all f32."""
    B, T, D = x.shape
    N = cfg.rwkv_head_dim
    H = D // N
    xr, xk, xv, xw, xg = _rwkv_ddlerp(p, x, x_prev)
    rr = _mm32(xr, p["wr"]).reshape(B, T, H, N)
    kk = _mm32(xk, p["wk"]).reshape(B, T, H, N)
    vv = _mm32(xv, p["wv"]).reshape(B, T, H, N)
    g = F.silu(_mm32(xg, p["wg"]))
    w_log = -torch.exp(
        p["w_base"] + _mm32(torch.tanh(_mm32(xw, p["w_lora_a"])),
                            p["w_lora_b"])).reshape(B, T, H, N)
    return rr, kk, vv, w_log, g


def _rwkv_out(p: Params, o: torch.Tensor, x: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """Per-head groupnorm of o [B,T,H,N] (population variance), the f32
    affine, then the gated output projection."""
    B, T, D = x.shape
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = (o - mu) * torch.rsqrt(var + 1e-5)
    o = o.reshape(B, T, D) * p["ln_w"] + p["ln_b"]
    return _mm32(o.to(x.dtype) * g, p["wo"])


def rwkv_apply(p: Params, x: torch.Tensor, cfg,
               state: Optional[Params] = None):
    """RWKV6 time-mix over a sequence from a zero shift and a zero state.
    x [B,T,D] -> (y [B,T,D] f32, {"shift": [B,D], "wkv": [B,H,N,N]}).
    With `state` (a layer's cache entries), the final state is written
    into it in place and returned."""
    T = x.shape[1]
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :T]
    rr, kk, vv, w_log, g = _rwkv_streams(p, x, x_prev, cfg)
    u = p["u"].reshape(rr.shape[2], rr.shape[3])
    o, S = wkv(rr, kk, vv, w_log, u,
               state_out=None if state is None else state["wkv"])
    y = _rwkv_out(p, o, x, g)
    if state is None:
        return y, {"shift": x[:, -1], "wkv": S}
    state["shift"].copy_(x[:, -1])
    return y, state


def rwkv_decode(p: Params, x: torch.Tensor, cfg, state: Params):
    """One-token RWKV6 step.  x [B,1,D]; state {'shift':[B,D],
    'wkv':[B,H,N,N]} (the layer's cache entries), read and then updated
    IN PLACE: the kernel takes the state as `s0` and writes it back.
    Returns (y [B,1,D] f32, state)."""
    rr, kk, vv, w_log, g = _rwkv_streams(p, x, state["shift"][:, None],
                                         cfg)
    u = p["u"].reshape(rr.shape[2], rr.shape[3])
    o, _ = wkv(rr, kk, vv, w_log, u, state["wkv"], state_out=state["wkv"])
    y = _rwkv_out(p, o, x, g)
    state["shift"].copy_(x[:, 0])
    return y, state


def rwkv_cmix_init(cfg, dtype, generator, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    f32 = dict(dtype=torch.float32, device=device)
    return {"wk": _normal((d, f), s, dtype, generator, device),
            "wv": _normal((f, d), 1.0 / math.sqrt(f), dtype, generator,
                          device),
            "wr": _normal((d, d), s, dtype, generator, device),
            "mix_k": torch.zeros((d,), **f32),
            "mix_r": torch.zeros((d,), **f32)}


def rwkv_cmix_apply(p: Params, x: torch.Tensor, x_prev: torch.Tensor) \
        -> torch.Tensor:
    """RWKV channel-mix.  x [B,T,D]; x_prev = token-shifted x."""
    dx = x_prev - x
    xk = x + dx * p["mix_k"]
    xr = x + dx * p["mix_r"]
    k = torch.relu(_mm32(xk, p["wk"])).square()
    return torch.sigmoid(_mm32(xr, p["wr"])) * _mm32(k, p["wv"])
