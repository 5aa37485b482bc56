"""Plain PyTorch version of flash attention: the full-materialization
oracle `repro.kernels.flash_attention.ref.attention_ref`, in PyTorch."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,H,S,hd]; k/v [B,K,T,hd] (H = K·G) -> [B,H,S,hd].  fp32 math,
    output in q's dtype.  Query i and key j are at positions i and j."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, S, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgsh,bkth->bkgst", qf, k.float())
    q_pos = torch.arange(S, device=q.device)[:, None]
    kv_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bkth->bkgsh", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)
