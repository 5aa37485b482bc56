"""Model / shape / run configuration dataclasses.

A model is a stack of `n_layers` blocks described by a repeating *pattern* of
`LayerSpec`s (period).  Uniform decoders have a period of 1; Jamba's period is
8 (attention at position 4, Mamba elsewhere, MoE on odd positions); Whisper is
an encoder stack + a decoder stack (cross-attention in the decoder).

Parameters of each period position are stacked across periods (the
reference applies the stack with `lax.scan`; the port loops over periods
in Python).

A copy of `repro.models.config` (which has no jax in it): same fields,
same defaults, same parameter counts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # 'attn' | 'mamba' | 'rwkv'
    mlp: str = "dense"         # 'dense' | 'moe' | 'rwkv_cmix' | 'none'
    causal: bool = True        # False for encoder (bidirectional) attention
    cross_attn: bool = False   # decoder block with cross-attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)

    # ---- attention options
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0         # nemotron-style partial rotary
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t,h,w) sections
    sliding_window: int = 0            # 0 -> full attention; else SWA window

    # ---- mlp options
    mlp_act: str = "swiglu"            # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"              # rmsnorm | layernorm

    # ---- MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25

    # ---- Mamba (hybrid archs)
    mamba_expand: int = 2
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0             # 0 -> ceil(d_model/16)

    # ---- RWKV6
    rwkv_head_dim: int = 64

    # ---- encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500            # whisper 30 s of audio frames

    # ---- frontend stubs
    input_kind: str = "tokens"         # 'tokens' | 'embeds' (vlm/audio stub)

    # ---- dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ---- runtime knobs (per-arch defaults; shapes may override)
    remat: str = "full"                # full | dots | none
    unroll_layers: bool = False        # python-loop layers (cost-model HLO)
    scan_chunk: int = 0                # 0=defaults, -1=single-chunk (cost)
    microbatches: int = 1              # gradient-accumulation steps
    fsdp: bool = True                  # shard params/opt over the data axis
    zero2: bool = False                # ZeRO-2: opt-state sharded over data,
                                       # params model-sharded only (no
                                       # per-layer all-gathers in fwd/bwd)
    train_sharding: str = "tp"         # "tp": model axis = tensor parallel;
                                       # "fsdp2d": no TP — batch over data,
                                       # params/opt FSDP over data×model
                                       # (weight gathers cost << activation
                                       # psums at large tokens/device)
    moment_dtype: str = "float32"      # optimizer moments dtype

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.mamba_dt_rank == 0:
            object.__setattr__(self, "mamba_dt_rank",
                               -(-self.d_model // 16))
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: n_layers {self.n_layers} % period " \
            f"{len(self.pattern)} != 0"

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid (any state-based mixer) or all
        attention sliding-window.  Pure full-attention archs are excluded
        (per assignment)."""
        if any(spec.mixer in ("mamba", "rwkv") for spec in self.pattern):
            return True
        return all(spec.mixer != "attn" or self.sliding_window > 0
                   for spec in self.pattern)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------- param counting
    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        total = v * d                     # embed
        total += v * d                    # lm head (untied)
        total += d                        # final norm
        mlp_gated = self.mlp_act in ("swiglu", "geglu")

        def attn_params() -> int:
            p = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            if self.qkv_bias:
                p += nh * hd + 2 * nkv * hd
            return p

        def dense_mlp() -> int:
            return (3 if mlp_gated else 2) * d * f

        def moe_mlp() -> int:
            return self.n_experts * (3 if mlp_gated else 2) * d * f \
                + d * self.n_experts

        def mamba_params() -> int:
            di, ds, dt = self.mamba_d_inner, self.mamba_d_state, self.mamba_dt_rank
            p = d * 2 * di                      # in_proj (x and z)
            p += di * self.mamba_d_conv         # depthwise conv
            p += di * (dt + 2 * ds)             # x -> dt, B, C
            p += dt * di                        # dt_proj
            p += di * ds + di + di              # A_log, D, dt bias
            p += di * d                         # out_proj
            return p

        def rwkv_params() -> int:
            # time-mix: r,k,v,g,o projections + data-dependent decay lora
            p = 5 * d * d
            p += d * 64 + 64 * d                # w lora (decay)
            p += 5 * (d * 32 + 32 * d)          # x lora mixers (tokenshift)
            p += 2 * d                          # time_first (u), decay base
            return p

        def rwkv_cmix() -> int:
            return d * f + f * d                # k, v projections (r gate: +d*d)

        for i in range(self.n_layers):
            spec = self.pattern[i % self.period]
            total += 2 * d                       # norms
            if spec.mixer == "attn":
                total += attn_params()
                if spec.cross_attn:
                    total += attn_params() + d
            elif spec.mixer == "mamba":
                total += mamba_params()
            elif spec.mixer == "rwkv":
                total += rwkv_params()
            if spec.mlp == "dense":
                total += dense_mlp()
            elif spec.mlp == "moe":
                total += moe_mlp()
            elif spec.mlp == "rwkv_cmix":
                total += rwkv_cmix() + d * d
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                total += 2 * d + attn_params() + dense_mlp()
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_gated = self.mlp_act in ("swiglu", "geglu")
        per_expert = (3 if mlp_gated else 2) * d * f
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.pattern[i % self.period].mlp == "moe")
        return self.param_count() \
            - n_moe_layers * (self.n_experts - self.top_k) * per_expert


@dataclass(frozen=True)
class ShapeConfig:
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}
