"""Public op: attention in the model's layout.

The reference's `attention_bshd` transposes q, k and v to [B,H,S,hd]
copies for the Pallas kernel and transposes the output back; here the
transposes are views (the CUDA kernel reads through strides) and the
kernel's output comes back in the model's layout.  The reference's
`use_kernel=` and `interpret=` arguments are gone: the device of the
tensors decides (CUDA kernel for CUDA tensors, the plain version for CPU
tensors)."""

from __future__ import annotations

import torch

from .kernel import flash_attention


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout: q [B,S,H,hd], k/v [B,T,K,hd] -> [B,S,H,hd]."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)
