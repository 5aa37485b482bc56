"""Model zoo of the port: config-driven stacks for every config of
`repro_torch.configs` (the dense attention path with RoPE or M-RoPE, MoE,
Mamba and Jamba's hybrid period, RWKV6, Whisper's encoder-decoder with
cross-attention)."""

from .config import LayerSpec, ModelConfig, SHAPES, ShapeConfig
from .convert import params_from_numpy
from .transformer import (cache_spec, decode_step, embed_inputs, forward,
                          init_cache, init_params, loss_fn, prefill)

__all__ = [
    "LayerSpec", "ModelConfig", "ShapeConfig", "SHAPES",
    "init_params", "forward", "prefill", "decode_step", "init_cache",
    "cache_spec", "embed_inputs", "params_from_numpy", "loss_fn",
]
