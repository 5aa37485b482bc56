"""Plain PyTorch versions of flash attention: the full-materialization
oracle `repro.kernels.flash_attention.ref.attention_ref`, in PyTorch,
with the per-row log-sum-exp the backward reads, and the backward
written out as formulas (the reference has none: its gradients come from
autodiff of the XLA twin)."""

from __future__ import annotations

import math

import torch


def _mask(S: int, T: int, causal: bool, window: int, device) \
        -> torch.Tensor:
    """[S, T] bool, True where query i sees key j (positions i and j)."""
    q_pos = torch.arange(S, device=device)[:, None]
    kv_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int):
    """Scaled f32 scores [B, K, G, S, T], -inf where the mask hides."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    qf = q.reshape(B, K, H // K, S, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgsh,bkth->bkgst", qf, k.float())
    return s.masked_fill(~_mask(S, T, causal, window, q.device),
                         float("-inf"))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  return_lse: bool = False):
    """q [B,H,S,hd]; k/v [B,K,T,hd] (H = K·G) -> [B,H,S,hd].  fp32 math,
    output in q's dtype.  Query i and key j are at positions i and j.
    With `return_lse` also each row's log-sum-exp of its scaled scores,
    f32 [B,H,S] (-inf for a row that sees no key)."""
    B, H, S, hd = q.shape
    s = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bkth->bkgsh", p, v.float())
    o = o.reshape(B, H, S, hd).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, S)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: int = 0):
    """The gradients of `attention_ref`'s output o (row log-sum-exp lse,
    f32 [B,H,S]) for its gradient do [B,H,S,hd], in f32 and written out:
    δ = rowsum(dO∘O), P = exp(S·scale − lse), dV = Pᵀ dO, dP = dO Vᵀ,
    dS = P∘(dP − δ), dQ = dS K·scale, dK = dSᵀ Q·scale, dK and dV summed
    over the G query heads of each KV head.  Masked scores are -inf
    before the exp (P = 0 there; a row that sees no key has lse = -inf
    and P = 0).  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    s = _scores(q, k, causal, window)
    lse = lse.reshape(B, K, G, S, 1)
    p = torch.exp(s - lse.masked_fill(lse == float("-inf"), 0.0))
    of = o.reshape(B, K, G, S, hd).float()
    dof = do.reshape(B, K, G, S, hd).float()
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bkgst,bkgsh->bkth", p, dof)
    dp = torch.einsum("bkgsh,bkth->bkgst", dof, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,bkth->bkgsh", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bkgsh->bkth", ds,
                      q.reshape(B, K, G, S, hd).float()) * scale
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
