"""CUDA kernel for Hopper: SI-V visibility resolve + page gather.

`version_gather` binds `vg_version_gather` of
`src/repro_torch/csrc/gather.cu` (the kernel it shares with
`rss_gather`, compiled without the member search).  It replaces the
Pallas TPU kernel `repro.kernels.version_gather.kernel.version_gather`
and returns what that kernel's plain reference returns, bit for bit:

    data [P, K, E]   page payloads, any dtype (copied as raw bytes)
    ts   [P, K]      int32 commit timestamp per slot (0 = initial)
    watermark        scalar int32 snapshot horizon
    out  [P, E]      payload of the newest slot with ts <= watermark
                     (ties: lowest slot; none visible: slot 0)

No `P % 8` or `E % 512` limit; bits are copied (see `rss_gather.kernel`
for the one-hot NaN / -0.0 behaviour of the Pallas kernel that this
kernel does not copy).  CUDA tensors launch the kernel (or raise); CPU
tensors return the plain version from `ref.py`.
"""

from __future__ import annotations

import torch

from ..cuda_build import check, i32, on_cuda, reset_counts, stream
from ..rss_gather.kernel import gather_args, gather_lib


def version_gather(data: torch.Tensor, ts: torch.Tensor,
                   watermark) -> torch.Tensor:
    """SI-V snapshot read: [P, E] payloads of the newest slot at or below
    `watermark` per page.  Replaces the TPU `version_gather`."""
    if not on_cuda(data):
        from .ref import version_gather_ref
        return version_gather_ref(data, ts, watermark)
    (dp, tp), P, K, row_bytes, out = gather_args(data, ts)
    watermark = i32(watermark, "watermark")
    if out.numel() == 0:
        return out
    check(gather_lib().vg_version_gather(dp, tp, P, K, row_bytes, watermark,
                                   out.data_ptr(), stream()),
          "version_gather")
    version_gather.launches += 1
    return out


version_gather.launches = 0
KERNELS = (version_gather,)


def reset_launches() -> dict:
    """Zero `version_gather.launches`; returns the count before."""
    return reset_counts(KERNELS)
