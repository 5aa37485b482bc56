"""Qwen2-VL 72B [arXiv:2409.12191]: M-RoPE, GQA kv=8, vision stub frontend."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    qkv_bias=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    mlp_act="swiglu", norm="rmsnorm",
    remat="dots", microbatches=4, fsdp=True, zero2=True,
    train_sharding="fsdp2d", moment_dtype="bfloat16",
)
