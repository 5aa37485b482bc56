"""Plain PyTorch version of the version_gather kernel (SI-V read)."""

from __future__ import annotations

import torch

from ..rss_gather.ref import gather_slots, rss_visible_slots_ref


def version_gather_ref(data: torch.Tensor, ts: torch.Tensor,
                       watermark) -> torch.Tensor:
    """data [P,K,E], ts [P,K] int32, scalar watermark -> [P,E]: payload of
    the newest slot with ts <= watermark (ties: lowest slot index; no
    visible slot: slot 0) — the RSS read with no members and the
    watermark as its floor."""
    no_members = ts.new_zeros((0,))
    return gather_slots(data, rss_visible_slots_ref(ts, no_members,
                                                    int(watermark)))
