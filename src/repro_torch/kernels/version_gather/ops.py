"""Public op: snapshot_read — the SI-V read over a paged store.

The reference's `use_kernel=` and `interpret=` arguments are gone: the
device of the store's tensors decides (CUDA kernel for a CUDA store, its
plain PyTorch version for a CPU store)."""

from __future__ import annotations

import torch

from .kernel import version_gather


def snapshot_read(store: dict, watermark) -> torch.Tensor:
    """SI-V read over a paged store {'data': [P,K,E], 'ts': [P,K] int32}:
    [P, E] payloads of the newest slot with ts <= watermark per page."""
    return version_gather(store["data"], store["ts"], watermark)
