"""Public op: the WKV6 scan in the model's layout.

The counterpart of `repro.kernels.wkv_scan.ops.wkv`.  The reference's
`use_kernel=` and `interpret=` arguments are gone: the device of the
tensors decides (CUDA kernel for CUDA tensors, the plain version for CPU
tensors).  Its transpose + reshape copies are gone too: the kernel reads
the [B, T, H, N] tensors through their strides."""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import wkv_scan


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_log: torch.Tensor, u: torch.Tensor,
        s0: Optional[torch.Tensor] = None, *,
        state_out: Optional[torch.Tensor] = None):
    """r/k/v/w_log [B,T,H,N] (any strides, N contiguous); u [H,N]; s0
    [B,H,N,N] f32 or None (zeros) -> (o [B,T,H,N] f32, S [B,H,N,N] f32).
    The final state is written into `state_out` when given (it may be
    `s0`: the state is then updated in place)."""
    B, T, H, N = r.shape
    o, S = wkv_scan(*(x.transpose(1, 2) for x in (r, k, v, w_log)),
                    u[None].expand(B, H, N), s0, state_out=state_out)
    return o.transpose(1, 2), S
