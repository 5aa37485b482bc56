"""Plain PyTorch version of the WKV6 recurrence: the sequential oracle
`repro.kernels.wkv_scan.ref.wkv_scan_ref`, in PyTorch, with an optional
initial state; `wkv_scan_plain`, the same at the CUDA wrapper's
contract; and `wkv_scan_bwd_ref`, its gradient as an explicit reverse
scan (the plain version of `kernel.wkv_scan_bwd`)."""

from __future__ import annotations

from typing import Optional

import torch

# the forward saves the state before every STATE_EVERY-th step (the
# chunk boundaries the backward recomputes from)
STATE_EVERY = 64


def wkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w_log: torch.Tensor, u: torch.Tensor,
                 s0: Optional[torch.Tensor] = None, *,
                 return_states: bool = False):
    """r/k/v/w_log [BH,T,N]; u [BH,N]; s0 [BH,N,N] or None (zeros) ->
    (o [BH,T,N] f32, S [BH,N,N] f32).  Per step, in f32:

        o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
        S_t = diag(exp(w_log_t)) S_{t-1} + k_t v_t^T

    `s0` is the reference's `_wkv_chunked(h0=...)`; it is read, never
    written.  With `return_states`, also the state before every
    STATE_EVERY-th step, f32 [BH, ceil(T / STATE_EVERY), N, N] (the
    first is s0, or zeros)."""
    BH, T, N = r.shape
    rf, kf, vf = (x.float() for x in (r, k, v))
    wf = torch.exp(w_log.float())
    uf = u.float()[:, :, None]
    S = torch.zeros((BH, N, N), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float().clone()
    o = torch.empty((BH, T, N), dtype=torch.float32, device=r.device)
    states = torch.empty((BH, -(-T // STATE_EVERY), N, N),
                         dtype=torch.float32, device=r.device)
    for t in range(T):
        if t % STATE_EVERY == 0:
            states[:, t // STATE_EVERY] = S
        kv = kf[:, t, :, None] * vf[:, t, None, :]          # [BH,N,N]
        o[:, t] = torch.einsum("bkn,bk->bn", S + uf * kv, rf[:, t])
        S = wf[:, t, :, None] * S + kv
    return (o, S, states) if return_states else (o, S)


def wkv_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w_log: torch.Tensor, u: torch.Tensor,
                   s0: Optional[torch.Tensor] = None, *,
                   state_out: Optional[torch.Tensor] = None,
                   return_states: bool = False):
    """`kernel.wkv_scan`'s contract on `wkv_scan_ref`, on the tensors' own
    device: r/k/v/w_log [B,H,T,N], u [B,H,N], s0 [B,H,N,N] or None ->
    (o [B,H,T,N] f32, S [B,H,N,N] f32), S copied into `state_out` when
    given (which may be s0); with `return_states` also the chunk-boundary
    states [B,H,ceil(T / STATE_EVERY),N,N]."""
    B, H, T, N = r.shape
    flat = lambda x: x.reshape(B * H, *x.shape[2:])
    o, S, states = wkv_scan_ref(flat(r), flat(k), flat(v), flat(w_log),
                                flat(u), None if s0 is None else flat(s0),
                                return_states=True)
    S = S.reshape(B, H, N, N)
    if state_out is not None:
        S = state_out.copy_(S)
    o = o.reshape(B, H, T, N)
    if return_states:
        return o, S, states.reshape(B, H, -1, N, N)
    return o, S


def wkv_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w_log: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                     dS: Optional[torch.Tensor] = None,
                     s0: Optional[torch.Tensor] = None,
                     states: Optional[torch.Tensor] = None, *,
                     S: Optional[torch.Tensor] = None,
                     need_ds0: bool = False):
    """The gradients of `wkv_scan_plain`'s (o, S) for their gradients do
    [B,H,T,N] and dS [B,H,N,N] (None: zero), as an explicit reverse scan
    in f32 (f64 for f64 inputs; not autograd through the forward, which
    would keep a state a step).  With Ḡ_t the adjoint of S_t (Ḡ_{T-1} = dS):

        Ḡ_{t-1} = diag(w_t) Ḡ_t + r_t do_t^T,         ds0 = Ḡ_{-1}
        dr_t = (S_{t-1} + diag(u) k_t v_t^T) do_t
        dk_t = (Ḡ_t + diag(u) r_t do_t^T) v_t
        dv_t = (Ḡ_t + diag(u) r_t do_t^T)^T k_t
        dw_log_t = w_t * rowsum(S_{t-1} * Ḡ_t)
        du = sum over b, t of r_t * k_t * (v_t . do_t)

    S_{t-1} is recomputed forward inside each chunk of STATE_EVERY steps
    from `states` (the forward's chunk-boundary states; computed here
    when None), never by dividing by the decay.  Returns (dr, dk, dv,
    dw_log) [B,H,T,N] in r's dtype, du [H,N] (summed over the batch: the
    model shares u) in u's dtype, and ds0 [B,H,N,N] f32 when `need_ds0`
    (else None).  `S`, the forward's final state, is taken for the
    kernel's signature and not read."""
    B, H, T, N = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    flat = lambda x: x.reshape(B * H, *x.shape[2:]).to(ct)
    rf, kf, vf, wl, dof = (flat(x) for x in (r, k, v, w_log, do))
    uf = flat(u)
    w = torch.exp(wl)
    if states is None:
        states = wkv_scan_plain(r, k, v, w_log, u, s0,
                                return_states=True)[2]
    states = flat(states)
    G = torch.zeros((B * H, N, N), dtype=ct, device=r.device) \
        if dS is None else flat(dS).clone()
    grads = [torch.empty((B * H, T, N), dtype=ct, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((B * H, N), dtype=ct, device=r.device)
    for c in reversed(range(states.shape[1])):
        t0, t1 = c * STATE_EVERY, min((c + 1) * STATE_EVERY, T)
        prev = [states[:, c]]                       # S_{t-1}, t0 .. t1-1
        for t in range(t0, t1 - 1):
            prev.append(w[:, t, :, None] * prev[-1]
                        + kf[:, t, :, None] * vf[:, t, None, :])
        for t in reversed(range(t0, t1)):
            Sp = prev[t - t0]
            vdo = (vf[:, t] * dof[:, t]).sum(-1, keepdim=True)     # [BH,1]
            bonus = (uf * rf[:, t] * kf[:, t]).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bij,bj->bi", Sp, dof[:, t]) \
                + uf * kf[:, t] * vdo
            dk[:, t] = torch.einsum("bij,bj->bi", G, vf[:, t]) \
                + uf * rf[:, t] * vdo
            dv[:, t] = torch.einsum("bij,bi->bj", G, kf[:, t]) \
                + dof[:, t] * bonus
            dw[:, t] = w[:, t] * (Sp * G).sum(-1)
            du += rf[:, t] * kf[:, t] * vdo
            G = w[:, t, :, None] * G + rf[:, t, :, None] * dof[:, t, None, :]
    out = [g.reshape(B, H, T, N).to(r.dtype) for g in grads]
    du = du.reshape(B, H, N).sum(0).to(u.dtype)
    return (*out, du, G.reshape(B, H, N, N) if need_ds0 else None)
