"""Hand-written CUDA kernels for Hopper (sm_90a) + their plain PyTorch
versions.

version_gather — SI-V snapshot visibility gather (the paper's hot spot)
rss_gather     — RSS set-membership visibility gather (previous-version
                 read)
rss_scan_agg   — fused RSS visibility resolve + on-device aggregate
                 (scalar, grouped flat-lane, grouped chunked) and the
                 materialized-view delta fold
flash_attention  — causal / sliding-window GQA attention over a whole
                 sequence (prefill), online softmax in fp32
decode_attention — one-token GQA attention over a KV cache (decode)
wkv_scan       — the RWKV6 WKV recurrence (data-dependent per-channel
                 decay), from a zero or a given state
ssm_scan       — the Mamba selective scan (input-dependent decay
                 exp(dt A), D·u fused), from a zero or a given state

A wrapper launches its CUDA kernel for CUDA tensors and takes the plain
version for CPU tensors; nothing else picks between them.  The device of
the tensors comes from the entry point (`config.resolve_device`).  Every
source under `csrc/` is built by `cuda_build.build()`, one nvcc each, at
first use.
"""

from .config import resolve_device

__all__ = ["resolve_device"]
