"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: qwen1.5 arch, QKV bias, MHA."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    qkv_bias=True, rope_theta=1_000_000.0,
    mlp_act="swiglu", norm="rmsnorm",
    remat="dots", microbatches=2, fsdp=True, zero2=True, train_sharding="fsdp2d",
)
