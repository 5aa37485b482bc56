"""Granite-34B code [arXiv:2405.04324]: 88L deep, MQA (kv=1).

2-matrix GELU MLP (gpt_bigcode lineage) — with the assigned dims this lands
on the published 34B total; a gated MLP would overshoot to 47B."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    mlp_act="gelu", norm="layernorm",
    remat="dots", microbatches=2, fsdp=True, zero2=True, train_sharding="fsdp2d",
)
