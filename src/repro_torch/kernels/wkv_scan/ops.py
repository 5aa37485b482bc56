"""Public op: the WKV6 scan in the model's layout, with its gradient.

The counterpart of `repro.kernels.wkv_scan.ops.wkv`.  The reference's
`use_kernel=` and `interpret=` arguments are gone: the device of the
tensors decides (CUDA kernel for CUDA tensors, the plain version for CPU
tensors).  Its transpose + reshape copies are gone too: the kernel reads
the [B, T, H, N] tensors through their strides.

When autograd needs a gradient (grad enabled and an input that requires
it), the call goes through `WKVScan`: its forward launches the kernel
with the chunk-boundary states and saves the inputs, the final state and
those states; its backward launches `wkv_scan_bwd` (CUDA tensors) or
runs `wkv_scan_bwd_ref` (CPU tensors).  Otherwise the kernel runs as in
serving, with no states and nothing saved.  The forward launch is the
custom op `repro_torch::wkv_forward`, so that selective activation
checkpointing (`models.transformer`'s remat "dots") can name it and keep
its outputs instead of launching it again in the recompute.  The
kernels are called through the `kernel` module's names, so a caller may
swap them for the plain versions (chip_smoke.py's plain path does).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel as K


@torch.library.custom_op("repro_torch::wkv_forward", mutates_args=())
def wkv_forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w_log: torch.Tensor, u: torch.Tensor,
                s0: Optional[torch.Tensor]) \
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`wkv_scan(..., return_states=True)` as a dispatcher op: (o, S,
    states), r/k/v/w_log [B,H,T,N], u [H,N]."""
    B, H, _, N = r.shape
    return K.wkv_scan(r, k, v, w_log, u[None].expand(B, H, N), s0,
                      return_states=True)


class WKVScan(torch.autograd.Function):
    """`wkv_scan` with its backward: r/k/v/w_log [B,H,T,N], u [H,N]
    (shared by the batch), s0 [B,H,N,N] or None -> (o [B,H,T,N], S
    [B,H,N,N]), both f32."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, s0):
        o, S, states = wkv_forward(r, k, v, w_log, u, s0)
        ctx.save_for_backward(r, k, v, w_log, u, s0, S, states)
        ctx.set_materialize_grads(False)
        return o, S

    @staticmethod
    def backward(ctx, do, dS):
        r, k, v, w_log, u, s0, S, states = ctx.saved_tensors
        B, H, T, N = r.shape
        if do is None:
            do = torch.zeros((B, H, T, N), dtype=torch.float32,
                             device=r.device)
        need_ds0 = s0 is not None and ctx.needs_input_grad[5]
        dr, dk, dv, dw, du, ds0 = K.wkv_scan_bwd(
            r, k, v, w_log, u[None].expand(B, H, N), do, dS, s0, states,
            S=S, need_ds0=need_ds0)
        return dr, dk, dv, dw, du, ds0


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_log: torch.Tensor, u: torch.Tensor,
        s0: Optional[torch.Tensor] = None, *,
        state_out: Optional[torch.Tensor] = None):
    """r/k/v/w_log [B,T,H,N] (any strides, N contiguous); u [H,N]; s0
    [B,H,N,N] f32 or None (zeros) -> (o [B,T,H,N] f32, S [B,H,N,N] f32).
    The final state is written into `state_out` when given (it may be
    `s0`: the state is then updated in place); under autograd (training)
    there is no `state_out`."""
    B, T, H, N = r.shape
    rt, kt, vt, wt = (x.transpose(1, 2) for x in (r, k, v, w_log))
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (r, k, v, w_log, u,
                                                        s0)):
        if state_out is not None:
            raise ValueError("wkv: state_out is written in place, which "
                             "autograd cannot follow; pass none when a "
                             "gradient is needed")
        o, S = WKVScan.apply(rt, kt, vt, wt, u, s0)
    else:
        o, S = K.wkv_scan(rt, kt, vt, wt, u[None].expand(B, H, N), s0,
                          state_out=state_out)
    return o.transpose(1, 2), S
