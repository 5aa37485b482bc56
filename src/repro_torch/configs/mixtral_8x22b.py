"""Mixtral 8x22B [arXiv:2401.04088]: 56L, GQA kv=8, 8-expert top-2 MoE, SWA."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    pattern=(LayerSpec(mixer="attn", mlp="moe"),),
    n_experts=8, top_k=2,
    sliding_window=4096, rope_theta=1_000_000.0,
    mlp_act="swiglu", norm="rmsnorm",
    remat="dots", microbatches=4, fsdp=True, zero2=True, train_sharding="fsdp2d", moment_dtype="bfloat16",
)
