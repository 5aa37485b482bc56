"""Model assembly for the dense attention path, MoE, Mamba (and so
Jamba's hybrid period) and RWKV6: init / forward / prefill / decode,
driven by `ModelConfig`, ported from `repro.models.transformer`.

The parameter tree is the reference's: a nested dict of tensors,
`{"embed", "lm_head", "final_norm", "blocks"}`, where `blocks` holds one
dict per pattern position whose leaves are stacked over periods
(leading dim `cfg.n_periods`).  A MoE layer may hold a share of the
experts (`init_params(..., experts=)`): its expert leaves hold those
experts only, and its int32 leaf `expert_ids` names them (the one leaf
the reference's tree lacks).  The reference applies the stack with
`lax.scan`; here a Python loop runs over periods.  Remat (training) is
not ported, nor is the sharding `hint`, which is the identity on one
device.

Caches, per pattern position, stacked over periods:
  attention -> (k, v) buffers [n_periods, B, T_cache, K, hd]
  mamba     -> {"ssm": [n_periods, B, Di, N] (f32),
               "conv": [n_periods, B, d_conv-1, Di]}
  rwkv      -> {"shift": [n_periods, B, D], "wkv": [n_periods, B, H, N, N]
               (f32), "cmix_shift": [n_periods, B, D]}
allocated once per request (at the serving length for attention) and
written IN PLACE by `prefill` and by each `decode_step` (the reference
returns new arrays; the values are equal slot for slot).

Patterns with cross-attention or an encoder, and M-RoPE, raise
NotImplementedError: they are not ported yet (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.config import resolve_device
from . import layers as L
from .config import LayerSpec, ModelConfig

Params = dict
ROADMAP_ITEM = "ROADMAP queue 1 item 7"


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ('bfloat16', 'float32')."""
    return getattr(torch, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    why = []
    for spec in cfg.pattern:
        if spec.mixer not in ("attn", "mamba", "rwkv"):
            why.append(f"{spec.mixer} mixer")
        if spec.mlp not in ("dense", "moe", "rwkv_cmix"):
            why.append(f"{spec.mlp} mlp")
        if spec.cross_attn:
            why.append("cross-attention")
    if cfg.is_encoder_decoder:
        why.append("encoder")
    if cfg.mrope_sections:
        why.append("M-RoPE")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(sorted(set(why)))} not ported yet "
            f"({ROADMAP_ITEM})")


def _device(device) -> torch.device:
    """`resolve_device`, plus "meta" (shapes without storage, the
    counterpart of `jax.eval_shape`)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _stack(trees: list) -> Params:
    """Stack a list of same-shaped nested dicts leaf by leaf (dim 0); one
    tree becomes views with a leading dim of 1 (no copy)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return first[None] if len(trees) == 1 else torch.stack(trees)


def _index(tree, i: int):
    """Period i of a stacked nested dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------ block init
def _block_init(spec: LayerSpec, cfg: ModelConfig, dtype, generator,
                device, experts) -> Params:
    p: Params = {"norm1": L.norm_init(cfg.d_model, cfg.norm, dtype, device)}
    if spec.mixer == "attn":
        p["mixer"] = L.attn_init(cfg, dtype, generator, device)
    elif spec.mixer == "mamba":
        p["mixer"] = L.mamba_init(cfg, dtype, generator, device)
    else:
        p["mixer"] = L.rwkv_init(cfg, dtype, generator, device)
    p["norm2"] = L.norm_init(cfg.d_model, cfg.norm, dtype, device)
    if spec.mlp == "dense":
        p["mlp"] = L.mlp_init(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype,
                              generator, device)
    elif spec.mlp == "moe":
        p["mlp"] = L.moe_init(cfg, dtype, generator, device, experts)
    else:
        p["mlp"] = L.rwkv_cmix_init(cfg, dtype, generator, device)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None, *, experts=None) -> Params:
    """Random parameters at the reference's scales, drawn from
    `generator` (a torch.Generator on `device`).  `device=None` means
    "cuda" and raises without a GPU; "meta" gives the tree's shapes
    and dtypes without storage (pass generator=None).  `experts`: the
    global ids of the experts every MoE layer holds (None: all of
    `cfg.n_experts`), e.g. this card's share of an expert-parallel
    deployment."""
    check_supported(cfg)
    dev = _device(device)
    dtype = torch_dtype(cfg.param_dtype)
    d, v = cfg.d_model, cfg.vocab_size
    params: Params = {
        "embed": L._normal((v, d), 0.02, dtype, generator, dev),
        "lm_head": L._normal((d, v), 1.0 / math.sqrt(d), dtype, generator,
                             dev),
        "final_norm": L.norm_init(d, cfg.norm, dtype, dev),
    }
    params["blocks"] = tuple(
        _stack([_block_init(spec, cfg, dtype, generator, dev, experts)
                for _ in range(cfg.n_periods)])
        for spec in cfg.pattern)
    return params


# ----------------------------------------------------------------- block apply
def _apply_mlp(pp: Params, spec: LayerSpec, cfg: ModelConfig,
               x: torch.Tensor, cmix_shift: Optional[torch.Tensor] = None,
               decode: bool = False) -> torch.Tensor:
    """x + mlp(norm2(x)) (dense, MoE or RWKV's channel-mix).  RWKV's
    channel-mix token-shifts norm2(x): the
    token before x[:, 0] is zero, or in `decode` the cache's
    `cmix_shift` [B,D]; when `cmix_shift` is given, norm2(x)[:, -1] is
    written into it IN PLACE (the reference's prefill and decode store
    that value)."""
    h = L.norm_apply(pp["norm2"], x, cfg.norm)
    if spec.mlp == "dense":
        y = L.mlp_apply(pp["mlp"], h, cfg.mlp_act)
    elif spec.mlp == "moe":
        y = L.moe_apply(pp["mlp"], h, cfg)
    else:
        h_prev = cmix_shift[:, None] if decode else \
            F.pad(h, (0, 0, 1, 0))[:, :h.shape[1]]
        y = L.rwkv_cmix_apply(pp["mlp"], h, h_prev)
        if cmix_shift is not None:
            cmix_shift.copy_(h[:, -1])
    return x + y.to(x.dtype)


def _block_full(pp: Params, spec: LayerSpec, cfg: ModelConfig,
                x: torch.Tensor, positions) -> torch.Tensor:
    h = L.norm_apply(pp["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        y = L.attention(pp["mixer"], h, cfg, positions=positions,
                        causal=spec.causal)
    elif spec.mixer == "mamba":
        y, _ = L.mamba_apply(pp["mixer"], h, cfg)
    else:
        y, _ = L.rwkv_apply(pp["mixer"], h, cfg)
    x = x + y.to(x.dtype)
    return _apply_mlp(pp, spec, cfg, x)


def _cmix_shift(spec: LayerSpec, ce: dict, i: int):
    """Period i's channel-mix shift in a cache entry (None for a dense
    MLP)."""
    return ce["cmix_shift"][i] if spec.mlp == "rwkv_cmix" else None


def _layers(params: Params, cfg: ModelConfig):
    """(period index, pattern spec, that layer's params) in model order."""
    for i in range(cfg.n_periods):
        for j, spec in enumerate(cfg.pattern):
            yield i, j, spec, _index(params["blocks"][j], i)


# --------------------------------------------------------------------- forward
def embed_inputs(params: Params, cfg: ModelConfig, batch: dict) \
        -> torch.Tensor:
    """Token embedding of batch["tokens"] [B, S].  (The reference's
    frontend stubs, `vision_embeds` and `embeds`, belong to the M-RoPE and
    encoder configs, which are not ported yet.)"""
    return params["embed"][batch["tokens"]]


def _positions(batch: dict, S: int, device) -> torch.Tensor:
    pos = batch.get("positions")
    return torch.arange(S, device=device) if pos is None else pos


def forward(params: Params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Scoring forward -> logits [B,S,V]."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch)
    positions = _positions(batch, x.shape[1], x.device)
    for _i, _j, spec, pp in _layers(params, cfg):
        x = _block_full(pp, spec, cfg, x, positions)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return x @ params["lm_head"]


# --------------------------------------------------------------------- serving
def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Cache layout for a serving session: per pattern position, a dict
    of name -> (shape, dtype): "k", "v" for attention (for SWA archs the
    rolling window, for full attention `seq_len` entries); "ssm" (f32)
    and "conv" for Mamba; "shift", "wkv" (f32) for RWKV's time-mix,
    "cmix_shift" for its channel-mix."""
    check_supported(cfg)
    d, hd, nkv = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    T = min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len
    cdt = torch_dtype(cfg.compute_dtype)
    np_, N = cfg.n_periods, cfg.rwkv_head_dim
    per_pos = []
    for spec in cfg.pattern:
        entry = {}
        if spec.mixer == "attn":
            entry["k"] = ((np_, batch, T, nkv, hd), cdt)
            entry["v"] = ((np_, batch, T, nkv, hd), cdt)
        elif spec.mixer == "mamba":
            di = cfg.mamba_d_inner
            entry["ssm"] = ((np_, batch, di, cfg.mamba_d_state),
                            torch.float32)
            entry["conv"] = ((np_, batch, cfg.mamba_d_conv - 1, di), cdt)
        else:
            entry["shift"] = ((np_, batch, d), cdt)
            entry["wkv"] = ((np_, batch, d // N, N, N), torch.float32)
        if spec.mlp == "rwkv_cmix":
            entry["cmix_shift"] = ((np_, batch, d), cdt)
        per_pos.append(entry)
    return {"blocks": tuple(per_pos)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> dict:
    """Zeroed caches of `cache_spec` on `device` (None: "cuda")."""
    dev = _device(device)
    spec = cache_spec(cfg, batch, seq_len)
    return {"blocks": tuple(
        {k: torch.zeros(shape, dtype=dt, device=dev)
         for k, (shape, dt) in entry.items()}
        for entry in spec["blocks"])}


def prefill(params: Params, cfg: ModelConfig, batch: dict, *,
            cache_len: int):
    """Process the prompt; returns (last-token logits [B,V], cache).

    cache_len: capacity of the per-layer attention cache (>= prompt len
    for full attention; the SWA window for sliding-window archs; RWKV's
    and Mamba's states do not grow with it).  The cache is allocated
    here, on the embedding's device, and filled in place."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    positions = _positions(batch, S, x.device)
    cache = init_cache(cfg, B, cache_len, x.device)
    for i, j, spec, pp in _layers(params, cfg):
        ce = cache["blocks"][j]
        h = L.norm_apply(pp["norm1"], x, cfg.norm)
        if spec.mixer == "attn":
            y = L.attention_prefill(pp["mixer"], h, cfg, positions=positions,
                                    kv_cache=(ce["k"][i], ce["v"][i]))
        elif spec.mixer == "mamba":
            y, _ = L.mamba_apply(pp["mixer"], h, cfg, state={
                "ssm": ce["ssm"][i], "conv": ce["conv"][i]})
        else:
            y, _ = L.rwkv_apply(pp["mixer"], h, cfg, state={
                "shift": ce["shift"][i], "wkv": ce["wkv"][i]})
        x = x + y.to(x.dtype)
        x = _apply_mlp(pp, spec, cfg, x, _cmix_shift(spec, ce, i))
    x = L.norm_apply(params["final_norm"], x[:, -1:], cfg.norm)
    logits = x @ params["lm_head"]
    return logits[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, cache_len: int):
    """One decode step.  tokens [B,1]; cache from `prefill` /
    `init_cache`, updated in place; cache_len: number of tokens already
    in the cache (a plain int, so the step makes no host-device sync).
    Returns (logits [B,V], cache)."""
    check_supported(cfg)
    x = params["embed"][tokens]
    for i, j, spec, pp in _layers(params, cfg):
        ce = cache["blocks"][j]
        h = L.norm_apply(pp["norm1"], x, cfg.norm)
        if spec.mixer == "attn":
            y = L.attention_decode(pp["mixer"], h, cfg,
                                   (ce["k"][i], ce["v"][i]),
                                   pos=cache_len, cache_len=cache_len)
        elif spec.mixer == "mamba":
            y, _ = L.mamba_decode(pp["mixer"], h, cfg, {
                "ssm": ce["ssm"][i], "conv": ce["conv"][i]})
        else:
            y, _ = L.rwkv_decode(pp["mixer"], h, cfg, {
                "shift": ce["shift"][i], "wkv": ce["wkv"][i]})
        x = x + y.to(x.dtype)
        x = _apply_mlp(pp, spec, cfg, x, _cmix_shift(spec, ce, i),
                       decode=True)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return (x @ params["lm_head"])[:, 0], cache
