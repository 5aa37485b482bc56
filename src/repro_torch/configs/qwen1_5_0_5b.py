"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: QKV bias, MHA, 152k vocab."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    qkv_bias=True,
    mlp_act="swiglu", norm="rmsnorm",
    remat="dots", microbatches=1, fsdp=False,
    train_sharding="fsdp2d",
)
