"""Model zoo of the port: config-driven decoder stacks (the dense
attention path, MoE, Mamba and Jamba's hybrid period, RWKV6; M-RoPE,
cross-attention and the encoder wait for later slices)."""

from .config import LayerSpec, ModelConfig, SHAPES, ShapeConfig
from .convert import params_from_numpy
from .transformer import (cache_spec, decode_step, embed_inputs, forward,
                          init_cache, init_params, prefill)

__all__ = [
    "LayerSpec", "ModelConfig", "ShapeConfig", "SHAPES",
    "init_params", "forward", "prefill", "decode_step", "init_cache",
    "cache_spec", "embed_inputs", "params_from_numpy",
]
