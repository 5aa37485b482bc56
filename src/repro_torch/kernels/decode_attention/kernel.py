"""CUDA kernel for Hopper: one-token GQA decode attention.

`decode_attention` binds `fa_decode` of `src/repro_torch/csrc/attention.cu`
(the file it shares with flash attention; its header states the design
and the bound on the card).  It replaces the Pallas TPU kernel
`repro.kernels.decode_attention.kernel.decode_attention`:

    q [B, H, hd], k/v [B, K, T, hd], H = K * G, valid_len  ->  [B, H, hd]

attention of each query row over the first `valid_len` cache slots of
its kv-head, online softmax in f32, output in q's dtype; f32 / bf16 /
f16, hd in {32, 64, 128}, any G.  `valid_len` is a plain int in
[1, T] (outside it raises).  T need not be a multiple of a block (the
Pallas kernel asserts T % 256 == 0 above 256).  k and v are read through
their strides, so `ops.decode_gqa` passes the model's [B, T, K, hd]
cache as a transposed view, never a copy; cache rows are read in 16-byte
vectors, so k and v must start on 16 bytes and their strides must be
multiples of 16 bytes.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
return the plain version, `ref.decode_attention_ref`.
`decode_attention.launches` counts real kernel launches only.
"""

from __future__ import annotations

import math

import torch

from ..cuda_build import check, i32, on_cuda, reset_counts, stream
from ..flash_attention.kernel import (DTYPE_CODES, attention_lib,
                                      check_operands, strides)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len) -> torch.Tensor:
    """q [B,H,hd]; k/v [B,K,T,hd]; valid_len in [1, T] -> [B,H,hd].
    Replaces the TPU `decode_attention`."""
    if not on_cuda(q):
        from .ref import decode_attention_ref
        return decode_attention_ref(q, k, v, valid_len)
    B, H, K, T, hd = check_operands(q, k, v, 3)
    valid_len = i32(valid_len, "valid_len")
    if not 1 <= valid_len <= T:
        raise ValueError(f"valid_len {valid_len} outside [1, T = {T}]")
    vec = 16 // q.element_size()        # elements per 16-byte load
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(t.stride(d) % vec for d in (0, 1, 2)):
            raise ValueError(f"{name} must start on 16 bytes with strides "
                             "that are multiples of 16 bytes")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    bh, bth = (0, 1), (0, 2, 1)         # q/out (b, h); k/v (b, t, h)
    st = strides((q, bh), (k, bth), (v, bth), (out, bh))
    check(attention_lib().fa_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
        B, H, K, valid_len, hd, DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
        stream()), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
KERNELS = (decode_attention,)


def reset_launches() -> dict:
    """Zero `decode_attention.launches`; returns the count before."""
    return reset_counts(KERNELS)
