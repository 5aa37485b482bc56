"""The port's one device rule.

Entry points (`tensorstore.PagedMirror`, `mvcc.SingleNodeHTAP` /
`MultiNodeHTAP`, `mvcc.run_single_node` / `run_multi_node` /
`run_sessions`) take a `device=` argument:

    None / "cuda"  — the default: tensors live on the GPU and every kernel
                     wrapper launches its CUDA kernel.  Raises when CUDA is
                     not available; nothing continues quietly on the CPU.
    "cpu"          — tensors live on the CPU and every wrapper takes its
                     plain PyTorch version (tests, machines without a GPU).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) \
        -> torch.device:
    """Resolve an entry point's `device=` argument: None means "cuda".
    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
