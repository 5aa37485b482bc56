"""Plain PyTorch version of the Mamba selective scan: the sequential
oracle `repro.kernels.ssm_scan.ref.ssm_scan_ref`, in PyTorch, with an
optional initial state and an optional output buffer for the final
state; and `ssm_scan_bwd_ref`, its gradient as an explicit reverse scan
(the plain version of `kernel.ssm_scan_bwd`)."""

from __future__ import annotations

from typing import Optional

import torch

# the forward saves the state before every STATE_EVERY-th step (the
# chunk boundaries the backward recomputes from)
STATE_EVERY = 8


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, *,
                 state_out: Optional[torch.Tensor] = None,
                 return_states: bool = False):
    """u/dt [Bb,T,Di]; B/C [Bb,T,N]; A [Di,N]; D [Di]; h0 [Bb,Di,N] or None
    (zeros) -> (y [Bb,T,Di] f32, h [Bb,Di,N] f32).  Per step, in f32:

        h_t = exp(dt_t A) * h_{t-1} + (dt_t u_t) B_t
        y_t = h_t C_t + D u_t

    `h0` is the state a decode step continues from (the reference's
    `mamba_decode` state["ssm"]).  The final state is copied into
    `state_out` when given, which may be `h0`: h0 is read first.  With
    `return_states`, also the state before every STATE_EVERY-th step,
    f32 [Bb, ceil(T / STATE_EVERY), Di, N] (the first is h0, or zeros)."""
    uf, dtf = u.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    Af, Df = A.float(), D.float()
    Bb, T, Di = u.shape
    h = torch.zeros((Bb, Di, Af.shape[1]), dtype=torch.float32,
                    device=u.device) if h0 is None else h0.float().clone()
    y = torch.empty((Bb, T, Di), dtype=torch.float32, device=u.device)
    states = torch.empty((Bb, -(-T // STATE_EVERY), Di, Af.shape[1]),
                         dtype=torch.float32, device=u.device)
    for t in range(T):
        if t % STATE_EVERY == 0:
            states[:, t // STATE_EVERY] = h
        dtt, ut = dtf[:, t], uf[:, t]                      # [Bb,Di]
        h = torch.exp(dtt[:, :, None] * Af) * h \
            + (dtt * ut)[:, :, None] * Bf[:, t, None, :]
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1) + Df * ut
    if state_out is not None:
        h = state_out.copy_(h)
    return (y, h, states) if return_states else (y, h)


def ssm_scan_bwd_ref(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                     dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
                     h0: Optional[torch.Tensor] = None,
                     states: Optional[torch.Tensor] = None, *,
                     need_dh0: bool = False):
    """The gradients of `ssm_scan_ref`'s (y, h) for their gradients dy
    [Bb,T,Di] and dh [Bb,Di,N] (None: zero), as an explicit reverse scan
    in f32 (f64 when dt is f64).  With a_t = exp(dt_t A) and Ḡ_t the
    adjoint of h_t (Ḡ_{T-1} = dy_{T-1} C_{T-1} + dh):

        Ḡ_t = dy_t C_t + a_{t+1} * Ḡ_{t+1},          dh0 = a_0 * Ḡ_0
        dC_t = sum_d h_t dy_t,    dB_t = sum_d Ḡ_t dt_t u_t
        ddt_t = sum_n Ḡ_t (A a_t h_{t-1} + u_t B_t)
        du_t = dt_t sum_n Ḡ_t B_t + D dy_t
        dA = sum_{b,t} Ḡ_t dt_t a_t h_{t-1},  dD = sum_{b,t} u_t dy_t

    h_{t-1} is recomputed forward inside each chunk of STATE_EVERY steps
    from `states` (the forward's chunk-boundary states; computed here
    when None), never by dividing by the decay.  Returns (du in u's
    dtype, ddt, dB, dC, dA, dD, and dh0 [Bb,Di,N] when `need_dh0` (else
    None), in the compute dtype)."""
    Bb, T, Di = u.shape
    ct = torch.float64 if dt.dtype == torch.float64 else torch.float32
    uf, dtf, dyf = u.to(ct), dt.to(ct), dy.to(ct)
    Bf, Cf, Af, Df = B.to(ct), C.to(ct), A.to(ct), D.to(ct)
    if states is None:
        states = ssm_scan_ref(u, dt, B, C, A, D, h0, return_states=True)[2]
    fl = dict(dtype=ct, device=u.device)
    du, ddt = torch.empty((Bb, T, Di), **fl), torch.empty((Bb, T, Di), **fl)
    dB, dC = torch.empty(Bf.shape, **fl), torch.empty(Cf.shape, **fl)
    dA = torch.zeros(Af.shape, **fl)
    carry = torch.zeros((Bb, Di, Af.shape[1]), **fl) if dh is None \
        else dh.to(ct).clone()                           # a_{t+1} Ḡ_{t+1}
    for c in reversed(range(states.shape[1])):
        t0, t1 = c * STATE_EVERY, min((c + 1) * STATE_EVERY, T)
        hs = [states[:, c].to(ct)]                   # h_{t0-1} .. h_{t1-1}
        for t in range(t0, t1):
            hs.append(torch.exp(dtf[:, t, :, None] * Af) * hs[-1]
                      + (dtf[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None])
        for t in reversed(range(t0, t1)):
            hp, ht = hs[t - t0], hs[t - t0 + 1]
            dtt, ut = dtf[:, t, :, None], uf[:, t, :, None]
            a = torch.exp(dtt * Af)
            G = dyf[:, t, :, None] * Cf[:, t, None] + carry
            dC[:, t] = (ht * dyf[:, t, :, None]).sum(1)
            dB[:, t] = (G * dtt * ut).sum(1)
            ddt[:, t] = (G * (Af * a * hp + ut * Bf[:, t, None])).sum(-1)
            du[:, t] = dtf[:, t] * (G * Bf[:, t, None]).sum(-1) \
                + Df * dyf[:, t]
            dA += (G * dtt * a * hp).sum(0)
            carry = a * G
    dD = (uf * dyf).sum((0, 1))
    return (du.to(u.dtype), ddt, dB, dC, dA, dD,
            carry if need_dh0 else None)
