"""Public op: snapshot_read_members — the RSS membership read over a paged
store.

The reference's `use_kernel=` and `interpret=` arguments are gone: the
device of the store's tensors decides (CUDA kernel for a CUDA store, its
plain PyTorch version for a CPU store)."""

from __future__ import annotations

import numpy as np
import torch

from .kernel import rss_gather


def member_tensor(member_ts, dev: torch.device) -> torch.Tensor:
    """Member timestamps as the sorted int32 array the kernels
    binary-search: a host array-like is uploaded to `dev`; a tensor is
    sorted where it lies (a tensor on another device than the store's is
    the wrapper's to reject)."""
    if isinstance(member_ts, torch.Tensor):
        return member_ts.reshape(-1).to(torch.int32).sort().values
    arr = np.sort(np.asarray(member_ts, np.int32).reshape(-1))
    return torch.from_numpy(arr).to(dev)


def snapshot_read_members(store: dict, member_ts, floor=0) -> torch.Tensor:
    """RSS membership read over a paged store {'data': [P,K,E], 'ts':
    [P,K] int32}: [P, E] payloads of the newest slot per page whose ts is
    at or below `floor` or in `member_ts`.

    member_ts holds the member commit timestamps ABOVE the snapshot floor,
    sorted ascending (the commit-seq image of an exported `RssSnapshot`:
    `PagedMirror.member_seqs_for(snap)` with `snap.floor_seq`); every
    version at ts <= floor is a floor-covered member's."""
    mem = member_tensor(member_ts, store["ts"].device)
    return rss_gather(store["data"], store["ts"], mem, floor)
