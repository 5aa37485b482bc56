"""Mixtral 8x7B [arXiv:2401.04088]: 32L, GQA kv=8, 8-expert top-2 MoE, SWA."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    pattern=(LayerSpec(mixer="attn", mlp="moe"),),
    n_experts=8, top_k=2,
    sliding_window=4096, rope_theta=1_000_000.0,
    mlp_act="swiglu", norm="rmsnorm",
    remat="dots", microbatches=2, fsdp=True, zero2=True, train_sharding="fsdp2d",
)
