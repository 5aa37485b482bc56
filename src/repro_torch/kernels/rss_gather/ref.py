"""Plain PyTorch version of the rss_gather kernel (RSS membership read).

Runs on the CPU (the tests, and the wrapper for CPU tensors) and on CUDA
(`chip_smoke.py` holds the kernel against it on the card).  Membership is
`torch.isin`, which equals the reference's broadcast compare against the
member array for any order of members.
"""

from __future__ import annotations

import torch


def rss_visible_slots_ref(ts: torch.Tensor, member_ts: torch.Tensor,
                          floor=0) -> torch.Tensor:
    """ts [P,K] int32, member_ts [M] int32, scalar floor -> [P] slot index
    of the newest slot whose ts is at-or-below `floor` (compressed-
    snapshot watermark; 0 = initial versions only) or a member (ties:
    lowest slot; no visible slot: slot 0).  M == 0 with floor 0 resolves
    every page to its newest ts == 0 slot."""
    if member_ts.numel() == 0:
        is_member = ts <= floor
    else:
        is_member = (ts <= floor) | torch.isin(ts, member_ts)
    masked = torch.where(is_member, ts, -1)
    best = masked.max(dim=1, keepdim=True).values
    k = ts.shape[1]
    idx = torch.arange(k, dtype=torch.int32, device=ts.device)[None, :]
    return torch.where(masked == best, idx, k).min(dim=1).values.to(
        torch.int32)


def gather_slots(data: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """data [P,K,E], slot [P] -> [P,E]: each page's chosen slot, bits
    copied (no arithmetic, so NaN, Inf and -0.0 pass unchanged)."""
    rows = torch.arange(data.shape[0], device=data.device)
    return data[rows, slot.long()]


def rss_gather_ref(data: torch.Tensor, ts: torch.Tensor,
                   member_ts: torch.Tensor, floor=0) -> torch.Tensor:
    """data [P,K,E], ts [P,K], sorted member_ts [M], scalar floor -> [P,E]:
    payload of the newest slot whose commit-ts is floor-covered or in the
    RSS member-ts set."""
    return gather_slots(data, rss_visible_slots_ref(ts, member_ts, floor))
