"""Whisper-tiny [arXiv:2212.04356]: enc-dec, conv frontend stubbed
(input_specs provides precomputed frame embeddings).  RoPE replaces the
learned positional embeddings so parameters stay shape-independent
(deviation noted in DESIGN.md)."""

from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    pattern=(LayerSpec(mixer="attn", mlp="dense", cross_attn=True),),
    is_encoder_decoder=True, n_encoder_layers=4, encoder_len=1500,
    mlp_act="gelu", norm="layernorm",
    remat="none", microbatches=1, fsdp=False,
)
