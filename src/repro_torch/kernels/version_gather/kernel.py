"""CUDA kernel for Hopper: SI-V visibility resolve + page gather.

`version_gather` binds `vg_version_gather` of
`src/repro_torch/csrc/gather.cu` (the kernels it shares with
`rss_gather`, compiled without the member test).  It replaces the
Pallas TPU kernel `repro.kernels.version_gather.kernel.version_gather`
and returns what that kernel's plain reference returns, bit for bit:

    data [P, K, E]   page payloads, any dtype (copied as raw bytes)
    ts   [P, K]      int32 commit timestamp per slot (0 = initial)
    watermark        scalar int32 snapshot horizon
    out  [P, E]      payload of the newest slot with ts <= watermark
                     (ties: lowest slot; none visible: slot 0)

No `P % 8` or `E % 512` limit; bits are copied (see `rss_gather.kernel`
for the one-hot NaN / -0.0 behaviour of the Pallas kernel that this
kernel does not copy, and for the routes, which `rss_gather.kernel.plan`
chooses for both wrappers).  CUDA tensors launch the kernel (or raise);
CPU tensors return the plain version from `ref.py`.
`version_gather.route_launches` counts real launches by route and
`version_gather.last_route` is the last launch's `GatherLaunch`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..cuda_build import check, i32, on_cuda, reset_counts, stream
from ..rss_gather.kernel import (ROUTES, gather_args, gather_lib,
                                 launch_args, launch_plan)


def version_gather(data: torch.Tensor, ts: torch.Tensor, watermark, *,
                   route: Optional[str] = None) -> torch.Tensor:
    """SI-V snapshot read: [P, E] payloads of the newest slot at or below
    `watermark` per page.  Replaces the TPU `version_gather`.  `route`
    forces a route on the card (see `rss_gather.kernel.plan`)."""
    if not on_cuda(data):
        from .ref import version_gather_ref
        return version_gather_ref(data, ts, watermark)
    (dp, tp), P, K, row_bytes, out = gather_args(data, ts)
    watermark = i32(watermark, "watermark")
    if out.numel() == 0:
        return out
    launch = launch_plan(data, out, P, K, row_bytes, route)
    check(gather_lib().vg_version_gather(dp, tp, P, K, row_bytes, watermark,
                                         out.data_ptr(),
                                         *launch_args(launch), stream()),
          "version_gather")
    version_gather.route_launches[launch.route] += 1
    version_gather.last_route = launch
    return out


version_gather.last_route = None    # `GatherLaunch` of the last launch
# kernel launches by route: the wrapper's one count (`launch_count`)
version_gather.route_launches = dict.fromkeys(ROUTES, 0)
KERNELS = (version_gather,)


def reset_launches() -> dict:
    """Zero `version_gather.route_launches`; returns the launches
    before."""
    return reset_counts(KERNELS)
