"""Public op: decode attention over a GQA cache.

The reference's `use_kernel=` and `interpret=` arguments are gone: the
device of the tensors decides (CUDA kernel for CUDA tensors, the plain
version for CPU tensors)."""

from __future__ import annotations

import torch

from .kernel import decode_attention


def decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_len) -> torch.Tensor:
    """q [B,H,hd]; k/v [B,K,T,hd] (any strides: a [B,T,K,hd] cache passed
    as `cache.transpose(1, 2)` is read in place) -> [B,H,hd] over the
    first `valid_len` slots."""
    return decode_attention(q, k, v, valid_len)
