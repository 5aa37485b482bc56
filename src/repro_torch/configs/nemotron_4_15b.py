"""Nemotron-4 15B [arXiv:2402.16819]: squared-ReLU MLP, GQA kv=8,
partial rotary (50%), LayerNorm, 256k vocab."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    mlp_act="relu2", norm="layernorm", rope_fraction=0.5,
    remat="dots", microbatches=2, fsdp=True, zero2=True, train_sharding="fsdp2d",
)
