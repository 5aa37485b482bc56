"""Plain PyTorch version of the Mamba selective scan: the sequential
oracle `repro.kernels.ssm_scan.ref.ssm_scan_ref`, in PyTorch, with an
optional initial state and an optional output buffer for the final
state."""

from __future__ import annotations

from typing import Optional

import torch


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, *,
                 state_out: Optional[torch.Tensor] = None):
    """u/dt [Bb,T,Di]; B/C [Bb,T,N]; A [Di,N]; D [Di]; h0 [Bb,Di,N] or None
    (zeros) -> (y [Bb,T,Di] f32, h [Bb,Di,N] f32).  Per step, in f32:

        h_t = exp(dt_t A) * h_{t-1} + (dt_t u_t) B_t
        y_t = h_t C_t + D u_t

    `h0` is the state a decode step continues from (the reference's
    `mamba_decode` state["ssm"]).  The final state is copied into
    `state_out` when given, which may be `h0`: h0 is read first."""
    uf, dtf = u.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    Af, Df = A.float(), D.float()
    Bb, T, Di = u.shape
    h = torch.zeros((Bb, Di, Af.shape[1]), dtype=torch.float32,
                    device=u.device) if h0 is None else h0.float().clone()
    y = torch.empty((Bb, T, Di), dtype=torch.float32, device=u.device)
    for t in range(T):
        dtt, ut = dtf[:, t], uf[:, t]                      # [Bb,Di]
        h = torch.exp(dtt[:, :, None] * Af) * h \
            + (dtt * ut)[:, :, None] * Bf[:, t, None, :]
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1) + Df * ut
    if state_out is not None:
        h = state_out.copy_(h)
    return y, h
