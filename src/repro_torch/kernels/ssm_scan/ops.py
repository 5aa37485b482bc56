"""Public op: the selective scan, with its gradient.

The counterpart of `repro.kernels.ssm_scan.ops.selective_scan`.  The
reference's `use_kernel=` and `interpret=` arguments are gone: the device
of the tensors decides (the CUDA kernel for CUDA tensors, the plain
version for CPU tensors).  The model's layout is the kernel's, so the op
passes its tensors through as they are (views included: the kernel reads
them through their strides).

When autograd needs a gradient (grad enabled and an input that requires
it), the call goes through `SSMScan`: its forward launches the kernel
with the chunk-boundary states and saves the inputs and those states;
its backward launches `ssm_scan_bwd` (CUDA tensors) or runs
`ssm_scan_bwd_ref` (CPU tensors).  Otherwise the kernel runs as in
serving, with no states and nothing saved.  The forward launch is the
custom op `repro_torch::ssm_forward`, so that selective activation
checkpointing (`models.transformer`'s remat "dots") can name it and keep
its outputs.  The kernels are called through the `kernel` module's
names, so a caller may swap them for the plain versions (chip_smoke.py's
plain path does).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel as K


@torch.library.custom_op("repro_torch::ssm_forward", mutates_args=())
def ssm_forward(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                h0: Optional[torch.Tensor]) \
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ssm_scan(..., return_states=True)` as a dispatcher op: (y, h,
    states)."""
    return K.ssm_scan(u, dt, B, C, A, D, h0, return_states=True)


class SSMScan(torch.autograd.Function):
    """`ssm_scan` with its backward: u/dt [Bb,T,Di], B/C [Bb,T,N], A
    [Di,N], D [Di], h0 [Bb,Di,N] or None -> (y [Bb,T,Di], h [Bb,Di,N]),
    both f32."""

    @staticmethod
    def forward(ctx, u, dt, B, C, A, D, h0):
        y, h, states = ssm_forward(u, dt, B, C, A, D, h0)
        ctx.save_for_backward(u, dt, B, C, A, D, h0, states)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, B, C, A, D, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        need_dh0 = h0 is not None and ctx.needs_input_grad[6]
        return K.ssm_scan_bwd(u, dt, B, C, A, D, dy, dh, h0, states,
                              need_dh0=need_dh0)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   state_out: Optional[torch.Tensor] = None):
    """u/dt [Bb,T,Di]; B/C [Bb,T,N]; A [Di,N]; D [Di]; h0 [Bb,Di,N] f32 or
    None (zeros) -> (y [Bb,T,Di] f32 with D·u added, h [Bb,Di,N] f32).
    The final state is written into `state_out` when given (it may be
    `h0`: the state is then updated in place); under autograd (training)
    there is no `state_out`."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (u, dt, B, C, A, D, h0)):
        if state_out is not None:
            raise ValueError("selective_scan: state_out is written in "
                             "place, which autograd cannot follow; pass "
                             "none when a gradient is needed")
        return SSMScan.apply(u, dt, B, C, A, D, h0)
    return K.ssm_scan(u, dt, B, C, A, D, h0, state_out=state_out)
