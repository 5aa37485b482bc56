"""Plain PyTorch version of decode attention: the oracle
`repro.kernels.decode_attention.ref.decode_attention_ref`, in PyTorch."""

from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len) -> torch.Tensor:
    """q [B,H,hd]; k/v [B,K,T,hd]; -> [B,H,hd] over the first valid_len
    cache slots.  fp32 math, output in q's dtype."""
    B, H, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgh,bkth->bkgt", qf, k.float())
    mask = torch.arange(T, device=q.device) < valid_len
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bkth->bkgh", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)
