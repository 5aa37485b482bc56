"""Config helpers shared by the per-architecture files."""

from __future__ import annotations

import dataclasses

from ..models.config import LayerSpec, ModelConfig


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests: same pattern/period,
    small width/depth/vocab.  One forward/train step must run on CPU."""
    d_model = 128
    head_dim = 32
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if cfg.n_kv_heads >= cfg.n_heads:      # MHA-style (qwen1.5, codeqwen)
        n_kv = n_heads
    elif cfg.n_kv_heads == 1:
        n_kv = 1
    else:
        n_kv = 2
    overrides = dict(
        n_layers=2 * cfg.period,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=256,
        vocab_size=512,
        rwkv_head_dim=32,
        mamba_d_state=8,
        mamba_dt_rank=8,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_capacity_factor=8.0,   # drop-free: decode/prefill == forward
        encoder_len=64,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        remat="none",
        microbatches=1,
        fsdp=False,
        mrope_sections=(4, 6, 6) if cfg.mrope_sections else (),
    )
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **overrides)
