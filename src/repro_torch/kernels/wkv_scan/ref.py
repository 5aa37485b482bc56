"""Plain PyTorch version of the WKV6 recurrence: the sequential oracle
`repro.kernels.wkv_scan.ref.wkv_scan_ref`, in PyTorch, with an optional
initial state; and `wkv_scan_plain`, the same at the CUDA wrapper's
contract."""

from __future__ import annotations

from typing import Optional

import torch


def wkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w_log: torch.Tensor, u: torch.Tensor,
                 s0: Optional[torch.Tensor] = None):
    """r/k/v/w_log [BH,T,N]; u [BH,N]; s0 [BH,N,N] or None (zeros) ->
    (o [BH,T,N] f32, S [BH,N,N] f32).  Per step, in f32:

        o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
        S_t = diag(exp(w_log_t)) S_{t-1} + k_t v_t^T

    `s0` is the reference's `_wkv_chunked(h0=...)`; it is read, never
    written."""
    BH, T, N = r.shape
    rf, kf, vf = (x.float() for x in (r, k, v))
    wf = torch.exp(w_log.float())
    uf = u.float()[:, :, None]
    S = torch.zeros((BH, N, N), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float().clone()
    o = torch.empty((BH, T, N), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, None] * vf[:, t, None, :]          # [BH,N,N]
        o[:, t] = torch.einsum("bkn,bk->bn", S + uf * kv, rf[:, t])
        S = wf[:, t, :, None] * S + kv
    return o, S


def wkv_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w_log: torch.Tensor, u: torch.Tensor,
                   s0: Optional[torch.Tensor] = None, *,
                   state_out: Optional[torch.Tensor] = None):
    """`kernel.wkv_scan`'s contract on `wkv_scan_ref`, on the tensors' own
    device: r/k/v/w_log [B,H,T,N], u [B,H,N], s0 [B,H,N,N] or None ->
    (o [B,H,T,N] f32, S [B,H,N,N] f32), S copied into `state_out` when
    given (which may be s0)."""
    B, H, T, N = r.shape
    flat = lambda x: x.reshape(B * H, *x.shape[2:])
    o, S = wkv_scan_ref(flat(r), flat(k), flat(v), flat(w_log), flat(u),
                        None if s0 is None else flat(s0))
    S = S.reshape(B, H, N, N)
    if state_out is not None:
        S = state_out.copy_(S)
    return o.reshape(B, H, T, N), S
