"""RWKV-6 Finch 3B [arXiv:2404.05892]: attention-free, data-dependent decay."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    pattern=(LayerSpec(mixer="rwkv", mlp="rwkv_cmix"),),
    rwkv_head_dim=64,
    norm="layernorm",
    remat="dots", microbatches=1, fsdp=True, zero2=True, train_sharding="fsdp2d",
)
