"""CUDA kernel for Hopper: one-token GQA decode attention.

`decode_attention` binds `fa_decode` of `src/repro_torch/csrc/attention.cu`
(the file it shares with flash attention; its header states the design
and the bound on the card).  It replaces the Pallas TPU kernel
`repro.kernels.decode_attention.kernel.decode_attention`:

    q [B, H, hd], k/v [B, K, T, hd], H = K * G, valid_len  ->  [B, H, hd]

attention of each query row over the first `valid_len` cache slots of
its kv-head, online softmax in f32, output in q's dtype; f32 / bf16 /
f16, hd in {32, 64, 128}, any G.  bf16 and f16 run on the tensor cores
(P rounded once to the input type before the PV product), f32 on f32
FMA.  `valid_len` is a plain int in [1, T] (outside it raises).  T need
not be a multiple of a block (the Pallas kernel asserts T % 256 == 0
above 256).  k and v are read through
their strides, so `ops.decode_gqa` passes the model's [B, T, K, hd]
cache as a transposed view, never a copy; cache rows are read in 16-byte
vectors, so k and v must start on 16 bytes and their strides must be
multiples of 16 bytes.

Split-KV (bf16 / f16): `decode_splits` picks how many blocks share one
(batch, kv-head, group of query rows), each over one of `split_ranges`'s
contiguous ranges of [0, valid_len), which the kernel is given; the
blocks form one thread-block cluster and merge their partial softmax
states in rank order inside the same launch, so a call is still one
launch and its result does not depend on timing.  It splits only a small
grid over a long cache (one long sequence); the serve batch (B = 8)
runs unsplit.  f32 never splits.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
return the plain version, `ref.decode_attention_ref`.
`decode_attention.launches` counts real kernel launches only;
`decode_attention.split_launches` those of them that split the cache,
and `decode_attention.last_split` is the last launch's split.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..cuda_build import check, i32, on_cuda, reset_counts, stream
from ..flash_attention.kernel import (DTYPE_CODES, attention_lib,
                                      check_operands, check_rows_16b,
                                      strides)

SPLITS = (1, 2, 4, 8)               # blocks per cluster (portable at most 8)
# split until the grid has this many blocks while every range keeps
# SPLIT_MIN_ROWS rows.  Tuned on an H100 at the shapes the serve runs
# decode (`chip_smoke.py`'s decode split sweep, PERF.md §6): batch 8 at
# 1,088 slots (Qwen 128 blocks, Jamba 64) is fastest unsplit — ranges of
# 544 rows do not pay for their cluster merge — and one sequence at
# 8,256 slots (16 blocks) fastest at 8 ranges of 1,032 rows
SPLIT_TARGET_BLOCKS = 128
SPLIT_MIN_ROWS = 1024


def query_groups(G: int, dtype: torch.dtype) -> tuple[int, int]:
    """(NG, groups): the query rows of one kv-head a block holds — 16 on
    the tensor-core route (bf16, f16: one mma row tile), on the f32 route
    the least of 1, 2, 4, 8 that covers G, 8 above — and the groups of NG
    rows that cover G.  The kernel is launched with this NG."""
    if dtype == torch.float32:
        ng = next((n for n in (1, 2, 4) if n >= G), 8)
    else:
        ng = 16
    return ng, -(-G // ng)


def decode_splits(valid_len: int, blocks: int) -> int:
    """The split the kernel runs with: the least of `SPLITS` that gives
    `blocks` (the grid without a split) x split >= SPLIT_TARGET_BLOCKS,
    as long as every range keeps at least SPLIT_MIN_ROWS rows (so 1 for a
    short valid_len)."""
    n = SPLITS[0]
    for nxt in SPLITS[1:]:
        if blocks * n >= SPLIT_TARGET_BLOCKS or \
                valid_len // nxt < SPLIT_MIN_ROWS:
            break
        n = nxt
    return n


def split_ranges(valid_len: int, n_split: int) -> list[tuple[int, int]]:
    """The slots [lo, hi) of each rank, the bounds the kernel is given:
    [r·valid_len // n_split, (r+1)·valid_len // n_split)."""
    return [(r * valid_len // n_split, (r + 1) * valid_len // n_split)
            for r in range(n_split)]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len) -> torch.Tensor:
    """q [B,H,hd]; k/v [B,K,T,hd]; valid_len in [1, T] -> [B,H,hd].
    Replaces the TPU `decode_attention`."""
    return run_decode(q, k, v, valid_len)


def run_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_len, n_split: int | None = None) -> torch.Tensor:
    """`decode_attention` with the split given (bf16 / f16: one of
    `SPLITS`; f32: 1), or `decode_splits`'s choice when None."""
    if not on_cuda(q):
        from .ref import decode_attention_ref
        return decode_attention_ref(q, k, v, valid_len)
    B, H, K, T, hd = check_operands(q, k, v, 3)
    valid_len = i32(valid_len, "valid_len")
    if not 1 <= valid_len <= T:
        raise ValueError(f"valid_len {valid_len} outside [1, T = {T}]")
    check_rows_16b(("k", k), ("v", v))
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ng, groups = query_groups(H // K, q.dtype)
    if n_split is None:
        n_split = 1 if q.dtype == torch.float32 else \
            decode_splits(valid_len, B * K * groups)
    elif n_split not in (SPLITS[:1] if q.dtype == torch.float32 else SPLITS):
        raise ValueError(f"n_split {n_split} not taken for {q.dtype}")
    bh, bth = (0, 1), (0, 2, 1)         # q/out (b, h); k/v (b, t, h)
    st = strides((q, bh), (k, bth), (v, bth), (out, bh))
    bounds = [lo for lo, _ in split_ranges(valid_len, n_split)] + [valid_len]
    check(attention_lib().fa_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
        (ctypes.c_int * len(bounds))(*bounds), B, H, K, hd,
        DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), n_split, ng, stream()),
        "decode_attention")
    decode_attention.launches += 1
    decode_attention.split_launches += n_split > 1
    decode_attention.last_split = n_split
    return out


decode_attention.launches = 0
decode_attention.split_launches = 0
decode_attention.last_split = None
KERNELS = (decode_attention,)


def reset_launches() -> dict:
    """Zero `decode_attention.launches` (and `split_launches`); returns
    the count before."""
    decode_attention.split_launches = 0
    return reset_counts(KERNELS)
