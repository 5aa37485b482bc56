"""Layer math of the dense attention path, RWKV6, Mamba and MoE: norms,
RoPE and M-RoPE, attention (whole-sequence, cross-attention and
one-token decode over a self or a cross cache), the dense MLPs,
the MoE MLP, the Mamba mixer (causal conv, selective scan), and RWKV6's
time-mix (ddlerp token shift, WKV recurrence, per-head groupnorm) and
channel-mix.  Pure functions over parameter dicts of
tensors, ported from `repro.models.layers` with the same names and the
same arithmetic.

Attention: where the reference computes XLA twins of its Pallas kernels
(`flash_attention_xla`, the inline einsum softmax of `attention_decode`),
the port launches the Hopper kernels for CUDA tensors
(`kernels.flash_attention`, `kernels.decode_attention`, which implement
the same contract) and takes the plain PyTorch versions for CPU tensors:
the chunked online softmax of `flash_attention_chunked`, and
`decode_attention_ref`.  In training, the CUDA path's gradient is
`FlashAttention`'s hand-written backward kernel (`attention_bshd` applies
it when an input requires grad); on the CPU autograd differentiates the
chunked softmax, the counterpart of the reference's `jax.grad` through
`flash_attention_xla`.  The decode kernel has no backward and refuses a
gradient on the card.

RWKV6: where the reference computes its XLA twin `_wkv_chunked` (an
associative scan) or the one-step einsums of `rwkv_decode`, the port
calls `kernels.wkv_scan.ops.wkv`: the Hopper kernel for CUDA tensors (the
whole prompt in prefill; one step from the layer's state, updated in
place, in decode), the sequential `wkv_scan_ref` for CPU tensors.  The
reference's `f32 @ bf16` products (the f32 ddlerp streams against bf16
weights) are computed in f32 as JAX computes them (`_mm32`; autograd
carries the gradient back through the widening to the bf16 weight).  In
training, `wkv` applies `WKVScan`: the kernel's hand-written backward on
the card, `wkv_scan_bwd_ref` on the CPU (the counterpart of the
reference's `jax.grad` through `_wkv_chunked`).  Training passes no
cache, so nothing is written in place under autograd.

Mamba: where the reference computes its XLA twin `_mamba_scan_chunked`
(an associative scan) and then adds D·u, or the one-step einsums of
`mamba_decode`, the port calls `kernels.ssm_scan.ops.selective_scan`,
which adds D·u itself: the Hopper kernel for CUDA tensors (the whole
prompt in prefill; one step from the layer's state, updated in place, in
decode), the sequential `ssm_scan_ref` for CPU tensors.  In training,
`selective_scan` applies `SSMScan` (the kernel's backward on the card,
`ssm_scan_bwd_ref` on the CPU); the causal conv is plain tensor code,
which autograd differentiates.

MoE: the reference's GShard-style top-k dispatch with per-sequence
capacity, its routing factored out (`moe_route`: router, softmax, top-k,
renormalised gates and each choice's slot in its expert's queue).  A
layer may hold a share of the experts (`expert_ids`, the global ids of
the experts whose weights it holds): it computes only their part of the
combine, while the softmax and the capacity keep the router's width
`cfg.n_experts`.  Dispatch and combine are index gathers over the
capacity slots; the expert products are `torch.bmm` (the reference's
XLA einsums).

M-RoPE (Qwen2-VL): `apply_mrope` rotates with three position streams
(temporal, height, width), each owning a section of the frequency pairs;
the angles are computed in f32 in the reference's order.  Cross-attention
(Whisper's decoder) takes its K/V from the encoder's output, unrotated,
and attends without a mask; in decode it reads the immutable cross cache
that prefill filled.

Tensor parallel: an attention layer may hold a rank's columns of
`wq`/`wk`/`wv` and rows of `wo` (`parallel.tensor`); the layers read
their head counts from those widths (the QKV biases come cut to the
same columns) and return the rank's partial output, which the model
stack sums over "model".  A MoE layer may hold a rank's columns of
each expert's `w_up`/`w_gate` and rows of its `w_down` (its d_ff); the
router is whole, so every rank routes alike, and the layer returns the
rank's partial output.  A Mamba mixer may hold a rank's channels of
`d_inner` (`in_proj`'s x and z columns of them, `conv_w`, `conv_b`,
`dt_proj`, `dt_bias`, `A_log`, `D`, the rows of `x_proj` and
`out_proj`): the conv, the scan and the gate run on those channels,
`x_proj`'s product over them is a partial sum, which the mixer sums
over "model" in f32 and rounds once to the compute dtype (the one
all-reduce inside a layer; GSPMD's in the reference), and the mixer
returns the rank's partial output.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.cuda_build import on_cuda
from ..kernels.decode_attention.ops import decode_gqa
from ..kernels.flash_attention.ops import attention_bshd
from ..kernels.ssm_scan.ops import selective_scan
from ..kernels.wkv_scan.ops import wkv
from .sharding import psum

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
    return x.mul_(scale).to(dtype)


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


@functools.lru_cache(maxsize=16)
def _stream_of_pair(sections: tuple[int, ...], device) -> torch.Tensor:
    """The position stream of each frequency pair (`repeat_interleave`
    of the stream ids over `sections`), made once per device: built
    from host values, it would make the device wait for the host at
    every call."""
    ids = torch.repeat_interleave(torch.arange(len(sections)),
                                  torch.tensor(sections))
    return ids.to(device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: tuple[int, ...], theta: float) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x [B,S,H,hd]; positions3 [3,B,S] gives
    the (temporal, height, width) position streams; `sections` partitions
    the hd/2 frequency pairs among the three streams (pair i takes the
    stream of the section it falls in)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not sum to {half}")
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half))
    sec_id = _stream_of_pair(tuple(sections), x.device)     # [half]
    pos_sel = positions3.float().index_select(0, sec_id)   # [half,B,S]
    ang = pos_sel.movedim(0, -1) * inv                      # [B,S,half]
    return _rotate(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


def _rope_qk(q: torch.Tensor, k: torch.Tensor, cfg, positions,
             mrope_positions) -> tuple[torch.Tensor, torch.Tensor]:
    """q and k rotated: M-RoPE where the config has sections and the
    batch gives `mrope_positions` [3,B,S], else RoPE at `positions`."""
    if cfg.mrope_sections and mrope_positions is not None:
        return (apply_mrope(q, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta),
                apply_mrope(k, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction),
            apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction))


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


def _heads(p: Params, cfg) -> tuple[int, int]:
    """(query heads, KV heads) of an attention layer's weights: the
    config's, or a rank's share of them when `wq` / `wk` hold its
    columns (tensor parallel over heads)."""
    hd = cfg.head_dim
    return p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd


def _qkv(p: Params, x: torch.Tensor, cfg,
         kv_x: Optional[torch.Tensor] = None):
    B, S, _ = x.shape
    hd = cfg.head_dim
    nh, nkv = _heads(p, cfg)
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
    [B,T,K,hd]): the Hopper kernel for CUDA tensors (`attention_bshd`,
    with its backward kernel under autograd; `chunk` is the plain path's
    only), the chunked online softmax for CPU tensors."""
    if on_cuda(q):
        return attention_bshd(q, k, v, causal=causal, window=window)
    return flash_attention_chunked(q, k, v, causal=causal, window=window,
                                   chunk=chunk)


def attention(p: Params, x: torch.Tensor, cfg, *, positions,
              causal: bool = True, mrope_positions=None,
              kv_x: Optional[torch.Tensor] = None,
              rope: bool = True) -> torch.Tensor:
    """Full-sequence (train / prefill) attention; with `kv_x` [B,T,D]
    cross-attention over it (K/V from kv_x, no rotation)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, kv_x)
    chunk = eff_chunk(cfg, 1024, k.shape[1] if kv_x is not None else S)
    if rope and kv_x is None:
        q, k = _rope_qk(q, k, cfg, positions, mrope_positions)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                        chunk=chunk)
    return o.reshape(B, S, -1) @ p["wo"]


def cross_attention_prefill(p: Params, x: torch.Tensor, cfg,
                            enc_out: torch.Tensor,
                            kv_cache: tuple[torch.Tensor, torch.Tensor]) \
        -> torch.Tensor:
    """Prefill's cross-attention: the K/V of `enc_out` [B,T,D] written IN
    PLACE into `kv_cache` (the immutable cross cache, [B,T,K,hd] each),
    then attention of x [B,S,D] over that cache, without a mask.  The
    reference computes the same K/V twice (once inside `attention`, once
    for the cache); the values are equal.  Returns y."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    nh, nkv = _heads(p, cfg)
    T = enc_out.shape[1]
    xk, xv = kv_cache
    xk.copy_((enc_out @ p["wk"]).reshape(B, T, nkv, hd))
    xv.copy_((enc_out @ p["wv"]).reshape(B, T, nkv, hd))
    q = (x @ p["wq"]).reshape(B, S, nh, hd)
    o = flash_attention(q, xk, xv, causal=False, window=cfg.sliding_window,
                        chunk=eff_chunk(cfg, 1024, T))
    return o.reshape(B, S, -1) @ p["wo"]


def attention_prefill(p: Params, x: torch.Tensor, cfg, *, positions,
                      kv_cache: tuple[torch.Tensor, torch.Tensor],
                      mrope_positions=None) -> torch.Tensor:
    """Prefill: full attention over the prompt, and its K/V written IN
    PLACE into `kv_cache` ([B, T_cache, K, hd] each, allocated once at the
    serving length).  Slot for slot the cache then equals the reference's
    returned one: the prompt's K/V at slots [0, S) when T_cache >= S (the
    reference pads the rest with zeros, which the port's fresh cache
    holds), the last T_cache positions at slots [0, T_cache) for a
    sliding-window rolling buffer.  Returns y."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_qk(q, k, cfg, positions, mrope_positions)
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
                     pos: int, cache_len: int,
                     cross: bool = False) -> torch.Tensor:
    """One-token decode.  x [B,1,D]; kv_cache ([B,T,K,hd], [B,T,K,hd]).

    `pos` is the absolute position of the new token (for RoPE, or M-RoPE
    with `pos` on all three streams), `cache_len` the number of valid
    cache entries (plain ints).  For self-attention the new K/V is
    written IN PLACE at slot `cache_len % T` (rolling buffer — exact for
    SWA, and for full attention T is sized to hold the max sequence);
    attention then runs over the first min(cache_len + 1, T) slots.
    Cross-attention (`cross=True`) reads the immutable cross cache over
    its first `cache_len` slots and writes and rotates nothing.
    Returns y."""
    B = x.shape[0]
    kc, vc = kv_cache
    T = kc.shape[1]
    hd = cfg.head_dim
    nh, nkv = _heads(p, cfg)
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, 1, nh, hd)
    if cross:
        valid = cache_len
    else:
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(B, 1, nkv, hd)
        posb = torch.full((B, 1), pos, device=x.device)
        pos3 = posb[None].expand(3, B, 1) if cfg.mrope_sections else None
        q, k = _rope_qk(q, k, cfg, posb, pos3)
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


# ------------------------------------------------------------------------ MoE
def moe_init(cfg, dtype, generator, device, experts=None,
             keep=None) -> Params:
    """The MoE MLP: the router over all `cfg.n_experts` experts (f32) and
    the weights of the experts this layer holds, `experts` (global ids,
    ascending; None: all), recorded in the int32 leaf `expert_ids`.  Each
    expert's matrices are drawn one expert at a time, so a full-width
    layer never holds its f32 draws at once.  `keep(name, leaf)`: what to
    keep of each leaf (a rank's piece), applied as it is drawn, to each
    expert's matrix as a leaf of one expert ([1, D, F]), so the whole
    layer is never held."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    held = list(range(E)) if experts is None else [int(e) for e in experts]
    if not held or held != sorted(set(held)) or held[0] < 0 \
            or held[-1] >= E:
        raise ValueError(f"experts {held} must be ascending ids in "
                         f"[0, {E})")
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    keep = keep or (lambda name, t: t)

    def per_expert(name, shape, scale):
        w = None
        for i in range(len(held)):
            x = keep(name, _normal(shape, scale, dtype, generator,
                                   device)[None])[0]
            if w is None:
                w = x.new_empty((len(held), *x.shape))
            w[i] = x
        return w

    p = {"router": keep("router", _normal((d, E), s_in, torch.float32,
                                          generator, device)),
         "w_up": per_expert("w_up", (d, f), s_in),
         "w_down": per_expert("w_down", (f, d), s_out)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["w_gate"] = per_expert("w_gate", (d, f), s_in)
    p["expert_ids"] = keep("expert_ids", torch.tensor(
        held, dtype=torch.int32, device=device))
    return p


def moe_capacity(cfg, S: int, capacity_factor: float = 0.0) -> int:
    """Slots per expert and sequence of S tokens, as the reference sizes
    them: C = min(max(int(cf * S * K / E), 4), S), with E the router's
    width (never the number of experts a layer holds)."""
    cf = capacity_factor or cfg.moe_capacity_factor
    return min(max(int(cf * S * cfg.top_k / cfg.n_experts), 4), S)


def moe_slots(gate_idx: torch.Tensor, n_experts: int, capacity: int) \
        -> torch.Tensor:
    """Each choice's position in its expert's queue: gate_idx [B,S,K] ->
    slot [B,S,K], counted per sequence in (s, k) order; -1 where the
    queue already holds `capacity` choices (the choice is dropped)."""
    B, S, K = gate_idx.shape
    onehot = F.one_hot(gate_idx.reshape(B, S * K), n_experts)  # [B,SK,E]
    pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).view(B, S, K)
    return torch.where(pos < capacity, pos, -1)


def moe_route(p: Params, x: torch.Tensor, cfg, *,
              capacity_factor: float = 0.0):
    """The routing of x [B,S,D]: the router in f32, softmax over all
    `cfg.n_experts`, top-k (descending), the k gate values renormalised
    to sum 1, and each choice's slot (`moe_slots` at `moe_capacity`).
    Returns (gate_vals [B,S,K] f32, gate_idx [B,S,K] int64, slot
    [B,S,K] int64, -1 for a dropped choice)."""
    logits = x.float() @ p["router"]                        # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    C = moe_capacity(cfg, x.shape[1], capacity_factor)
    return gate_vals, gate_idx, moe_slots(gate_idx, cfg.n_experts, C)


def moe_apply(p: Params, x: torch.Tensor, cfg, *,
              capacity_factor: float = 0.0) -> torch.Tensor:
    """GShard-style top-k MoE with per-sequence expert capacity, as the
    reference's `moe_apply`; x [B,S,D] -> [B,S,D].  Each held expert's
    C slots per sequence are filled by an index gather of x (empty slots
    read a zero row), its SwiGLU/GeGLU/... MLP runs on all of its slots
    at once (`torch.bmm` over the held experts), and each token sums its
    kept choices' outputs weighted by the gate values rounded to x's
    dtype (the reference's combine), in f32, rounded once.  Choices of
    experts this layer does not hold add nothing."""
    B, S, D = x.shape
    dev = x.device
    gate_vals, gate_idx, slot = moe_route(p, x, cfg,
                                          capacity_factor=capacity_factor)
    C = moe_capacity(cfg, S, capacity_factor)
    held = p["expert_ids"].long()
    Eh = held.numel()
    local = torch.full((cfg.n_experts,), -1, dtype=torch.long, device=dev)
    local[held] = torch.arange(Eh, device=dev)
    le = local[gate_idx]                                    # -1: not held
    use = (slot >= 0) & (le >= 0)
    # slot rows in (held expert, b, c) order: the products' [Eh, B*C]
    n_rows = Eh * B * C
    b = torch.arange(B, device=dev).view(B, 1, 1)
    row = torch.where(use, (le * B + b) * C + slot, n_rows)   # [B,S,K]
    token = torch.full((n_rows + 1,), B * S, dtype=torch.long, device=dev)
    token.scatter_(0, row.reshape(-1), (b * S + torch.arange(
        S, device=dev).view(1, S, 1)).expand(B, S, cfg.top_k).reshape(-1))
    xs = torch.cat([x.reshape(B * S, D), x.new_zeros((1, D))])
    xe = xs[token[:n_rows]].view(Eh, B * C, D)
    up = torch.bmm(xe, p["w_up"])
    if "w_gate" in p:                   # in place: one [Eh, B*C, F] less
        h = torch.bmm(xe, p["w_gate"])
        # not under autograd: remat "dots" keeps the bmm output, which
        # must stay as it was
        h = (F.silu(h, inplace=not torch.is_grad_enabled())
             if cfg.mlp_act == "swiglu"
             else F.gelu(h, approximate="tanh")).mul_(up)
    else:
        h = torch.relu(up).square() if cfg.mlp_act == "relu2" \
            else F.gelu(up, approximate="tanh")
    del up
    ye = torch.bmm(h, p["w_down"]).view(n_rows, D)
    ye = torch.cat([ye, ye.new_zeros((1, D))])
    w = torch.where(use, gate_vals, 0.0).to(x.dtype)       # the combine
    out = (ye[row].float() * w.float()[..., None]).sum(2)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- Mamba
def mamba_init(cfg, dtype, generator, device) -> Params:
    d, di = cfg.d_model, cfg.mamba_d_inner
    ds, dc, dtr = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.mamba_dt_rank
    s, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di)
    n = lambda shape, scale: _normal(shape, scale, dtype, generator, device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": n((d, 2 * di), s),
        "conv_w": n((dc, di), 0.1),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": n((di, dtr + 2 * ds), si),
        "dt_proj": n((dtr, di), 1.0 / math.sqrt(dtr)),
        "dt_bias": torch.zeros((di,), **f32),
        "A_log": torch.log(torch.arange(1, ds + 1, **f32)).expand(
            di, ds).contiguous(),
        "D": torch.ones((di,), **f32),
        "out_proj": n((di, d), si),
    }


def _mamba_streams(p: Params, xc: torch.Tensor, cfg):
    """From the conv output xc [..., Di]: SiLU(xc), and the scan's f32
    dt (softplus of dt_r @ dt_proj widened, + dt_bias), B and C (slices
    of the x_proj output, read through their strides) and A = -exp(A_log),
    as the reference computes them.  On a rank's channels (fewer than
    `d_inner`) the x_proj product is a partial sum: the ranks' f32
    partials are summed over "model" and rounded once to xc's dtype, as
    the reference rounds the whole product."""
    ds, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank
    xc = F.silu(xc)
    if xc.shape[-1] < cfg.mamba_d_inner:
        proj = psum(xc.float() @ p["x_proj"].float()).to(xc.dtype).float()
    else:
        proj = (xc @ p["x_proj"]).float()
    dt_r, B_, C_ = proj.split([dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"])
    return xc, dt, B_, C_, -torch.exp(p["A_log"])


def mamba_apply(p: Params, x: torch.Tensor, cfg,
                state: Optional[Params] = None):
    """Mamba block over a sequence from a zero state.  x [B,T,D] -> (y
    [B,T,D], {"ssm": [B,Di,N] f32, "conv": [B,d_conv-1,Di]}: the final
    state and the last d_conv-1 conv inputs).  With `state` (a layer's
    cache entries), both are written into it in place and returned."""
    T = x.shape[1]
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)            # [B,T,Di] each
    # depthwise causal conv: the reference's sum of rounded products, in
    # its order (x's dtype throughout)
    dc = p["conv_w"].shape[0]
    xp = F.pad(xin, (0, 0, dc - 1, 0))
    xc = xp[:, :T] * p["conv_w"][0]
    for i in range(1, dc):
        xc = xc + xp[:, i:i + T] * p["conv_w"][i]
    xc, dt, B_, C_, A = _mamba_streams(p, xc + p["conv_b"], cfg)
    y, h = selective_scan(xc, dt, B_, C_, A, p["D"],
                          state_out=None if state is None else state["ssm"])
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    conv = xp[:, T:T + dc - 1]
    if state is None:
        return y, {"ssm": h, "conv": conv.clone()}
    state["conv"].copy_(conv)
    return y, state


def mamba_decode(p: Params, x: torch.Tensor, cfg, state: Params):
    """One-token Mamba step.  x [B,1,D]; state {'ssm': [B,Di,N] f32,
    'conv': [B,d_conv-1,Di]} (the layer's cache entries), read and then
    updated IN PLACE: the scan runs one step through `selective_scan`
    with the state as both h0 and output.  Returns (y [B,1,D], state)."""
    xin, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)      # [B,Di] each
    conv = torch.cat([state["conv"], xin[:, None]], dim=1)  # [B,k,Di]
    # the reference's einsum over the k taps: an f32 sum, rounded once
    xc = (conv.float() * p["conv_w"].float()).sum(1).to(x.dtype)
    xc, dt, B_, C_, A = _mamba_streams(p, xc + p["conv_b"], cfg)
    y, _ = selective_scan(xc[:, None], dt[:, None], B_[:, None],
                          C_[:, None], A, p["D"], state["ssm"],
                          state_out=state["ssm"])
    y = (y[:, 0].to(x.dtype) * F.silu(z)) @ p["out_proj"]
    state["conv"].copy_(conv[:, 1:])
    return y[:, None], state


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
