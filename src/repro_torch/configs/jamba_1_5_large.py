"""Jamba-1.5-Large 398B [arXiv:2403.19887]: Mamba+attention 1:7 interleave,
16-expert top-2 MoE on every other layer.  Period of 8: attention at
position 4, Mamba elsewhere; MoE on odd positions."""

from ..models.config import LayerSpec, ModelConfig


def _pattern():
    specs = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer=mixer, mlp=mlp))
    return tuple(specs)


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    pattern=_pattern(),
    n_experts=16, top_k=2,
    mamba_expand=2, mamba_d_state=16, mamba_d_conv=4,
    mlp_act="swiglu", norm="rmsnorm",
    remat="dots", microbatches=8, fsdp=True, zero2=True, train_sharding="fsdp2d", moment_dtype="bfloat16",
)
