"""CUDA kernel for Hopper: RSS set-membership resolve + page gather.

`rss_gather` binds `vg_rss_gather` of `src/repro_torch/csrc/gather.cu`
(built with nvcc for sm_90a into `build/repro_torch/` at first use,
loaded with ctypes).  It replaces the Pallas TPU kernel
`repro.kernels.rss_gather.kernel.rss_gather` and returns what that
kernel's plain reference returns, bit for bit:

    data      [P, K, E]  page payloads, any dtype (copied as raw bytes)
    ts        [P, K]     int32 commit timestamp per slot (0 = initial)
    member_ts [M]        int32 member timestamps above `floor`, sorted
                         ascending (the kernel binary-searches it)
    floor     scalar     compressed-snapshot watermark
    out       [P, E]     payload of the newest slot whose ts is <= floor
                         or a member (ties: lowest slot; none: slot 0)

Unlike the Pallas kernel there is no `P % 8` or `E % 512` limit: any
P >= 0, K >= 1, E >= 0.  The Pallas kernel sums a one-hot product over
K, which turns a NaN or Inf in an unselected slot into NaN and a
selected -0.0 into +0.0; this kernel copies bits, as the reference's
`take_along_axis` does.

Device choice: CUDA tensors launch the kernel (or raise); CPU tensors
return the plain version from `ref.py`.  `rss_gather.launches` counts
real kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import (check, i32, load, on_cuda, reset_counts, stream,
                          tensor_arg)


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vg_version_gather.argtypes = [p, p, ll, i, ll, i, p, p]
    lib.vg_rss_gather.argtypes = [p, p, p, i, ll, i, ll, i, p, p]
    lib.vg_version_gather.restype = ctypes.c_int
    lib.vg_rss_gather.restype = ctypes.c_int


def gather_lib():
    return load("gather", _bind)


def gather_args(data: torch.Tensor, ts: torch.Tensor):
    """Validated (data ptr, ts ptr, P, K, row bytes, empty output) of a
    gather launch; the output is [P, E] of data's dtype on its device."""
    if data.dim() != 3:
        raise ValueError(f"data must be [P, K, E], got {tuple(data.shape)}")
    P, K, E = data.shape
    if tuple(ts.shape) != (P, K):
        raise ValueError(f"ts {tuple(ts.shape)} != {(P, K)}")
    if K < 1:
        raise ValueError("need K >= 1 version slots")
    dev = data.device
    ptrs = (tensor_arg(data, "data", dev, 3, dtype=None),
            tensor_arg(ts, "ts", dev, 2))
    out = torch.empty((P, E), dtype=data.dtype, device=dev)
    return ptrs, P, K, E * data.element_size(), out


def rss_gather(data: torch.Tensor, ts: torch.Tensor,
               member_ts: torch.Tensor, floor=0) -> torch.Tensor:
    """RSS membership read: [P, E] payloads of the newest member-visible
    slot per page.  Replaces the TPU `rss_gather`."""
    if not on_cuda(data):
        from .ref import rss_gather_ref
        return rss_gather_ref(data, ts, member_ts, floor)
    (dp, tp), P, K, row_bytes, out = gather_args(data, ts)
    mp = tensor_arg(member_ts, "member_ts", data.device, 1)
    floor = i32(floor, "floor")
    if out.numel() == 0:
        return out
    check(gather_lib().vg_rss_gather(dp, tp, mp, member_ts.numel(), P, K,
                               row_bytes, floor, out.data_ptr(), stream()),
          "rss_gather")
    rss_gather.launches += 1
    return out


rss_gather.launches = 0
KERNELS = (rss_gather,)


def reset_launches() -> dict:
    """Zero `rss_gather.launches`; returns the count before."""
    return reset_counts(KERNELS)
