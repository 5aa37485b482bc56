"""Public op: attention in the model's layout, with its gradient.

The reference's `attention_bshd` transposes q, k and v to [B,H,S,hd]
copies for the Pallas kernel and transposes the output back; here the
transposes are views (the CUDA kernel reads through strides) and the
kernel's output comes back in the model's layout.  The reference's
`use_kernel=` and `interpret=` arguments are gone: the device of the
tensors decides (CUDA kernel for CUDA tensors, the plain version for CPU
tensors).

When autograd needs a gradient (grad enabled and an input that requires
it), the call goes through `FlashAttention`: its forward launches the
kernel with the row log-sum-exp and saves q, k, v, o and lse; its
backward launches `flash_attention_bwd` (CUDA tensors) or runs
`attention_bwd_ref` (CPU tensors).  Otherwise the kernel runs as in
serving, with no lse and nothing saved.  The forward launch is the
custom op `repro_torch::flash_forward`, so that selective activation
checkpointing (`models.transformer`'s remat "dots") can name it and keep
its outputs instead of launching it again in the recompute.
"""

from __future__ import annotations

import torch

from ..cuda_build import on_cuda
from .kernel import flash_attention, flash_attention_bwd
from .ref import attention_bwd_ref


@torch.library.custom_op("repro_torch::flash_forward", mutates_args=())
def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention(..., return_lse=True)` as a dispatcher op: (o,
    lse)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           return_lse=True)


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with its backward: q [B,H,S,hd], k/v [B,K,T,hd]
    -> o [B,H,S,hd]."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if on_cuda(q) else attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout: q [B,S,H,hd], k/v [B,T,K,hd] -> [B,S,H,hd]."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = FlashAttention.apply(qt, kt, vt, bool(causal), int(window))
    else:
        o = flash_attention(qt, kt, vt, causal=causal, window=window)
    return o.transpose(1, 2)
