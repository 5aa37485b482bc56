"""Public op: the selective scan.

The counterpart of `repro.kernels.ssm_scan.ops.selective_scan`.  The
reference's `use_kernel=` and `interpret=` arguments are gone: the device
of the tensors decides (the CUDA kernel for CUDA tensors, the plain
version for CPU tensors).  The model's layout is the kernel's, so the op
passes its tensors through as they are (views included: the kernel reads
them through their strides)."""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import ssm_scan


def selective_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   state_out: Optional[torch.Tensor] = None):
    """u/dt [Bb,T,Di]; B/C [Bb,T,N]; A [Di,N]; D [Di]; h0 [Bb,Di,N] f32 or
    None (zeros) -> (y [Bb,T,Di] f32 with D·u added, h [Bb,Di,N] f32).
    The final state is written into `state_out` when given (it may be
    `h0`: the state is then updated in place)."""
    return ssm_scan(u, dt, B, C, A, D, h0, state_out=state_out)
