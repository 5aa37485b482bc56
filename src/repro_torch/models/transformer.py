"""Model assembly for every family of `repro_torch.configs`: the dense
attention path (with M-RoPE for Qwen2-VL), MoE, Mamba (and so Jamba's
hybrid period), RWKV6 and Whisper's encoder-decoder: init / forward /
prefill / decode, driven by `ModelConfig`, ported from
`repro.models.transformer`.

The parameter tree is the reference's: a nested dict of tensors,
`{"embed", "lm_head", "final_norm", "blocks"}`, where `blocks` holds one
dict per pattern position whose leaves are stacked over periods
(leading dim `cfg.n_periods`); an encoder-decoder adds `enc_blocks`
(stacked over `cfg.n_encoder_layers`) and `enc_final_norm`, and each of
its cross-attention blocks `norm_x` and `cross`.  A MoE layer may hold
a share of the experts (`init_params(..., experts=)`): its expert leaves
hold those experts only, and its int32 leaf `expert_ids` names them
(the one leaf the reference's tree lacks).  The reference applies the
stack with `lax.scan`; here a Python loop runs over periods.

Tensor parallel (serving): under `models.sharding.with_mesh(mesh,
group)` a rank holds its pieces of the weights (`parallel.tensor`:
heads, d_ff (an expert's too), Mamba's d_inner and vocab over "model")
and the stack sums the partial outputs of the row-parallel products
over "model" (`psum`) where the reference's `hint` makes GSPMD reduce:
the mixer's and cross-attention's output, the MLP's, and the embedding
of a vocab-sharded table (`embed_tokens`); the layers read their local
head counts and channels from the weights (a Mamba mixer sums its
`x_proj` product over "model" itself), the cache holds the rank's KV
heads and Mamba channels, and the logits stay vocab-sharded (the
reference's `hint(logits, "data", None, "model")`).  RWKV6's time mix
and channel mix are replicated (the rules keep their heads whole), so
each rank computes their whole outputs and nothing is summed there
(`_partial`: a hint on a replicated value is no collective in GSPMD);
only its embedding and logits are cut.  On one device `psum` is the
identity.

Sharded training: under `with_mesh(layout)` (this rank's
`parallel.fsdp.Layout`) a rank holds its pieces of every leaf under the
reference's training placement, and `forward` asks `gatherer` for whole
leaves: the top-level leaves (embedding, lm_head, final norms) once, and
each period's leaves (every pattern position's, one gather) inside the
function that `_remat` checkpoints, as the encoder's layers are.  Under
remat "dots" or "full" the backward's recompute gathers the period
again, so a rank holds one period's whole weights at a time (FSDP's
reshard after the forward) and a step gathers each period twice; under
"none" (Whisper) the gathered weights stay for the backward, one gather
a period.  `loss_fn` divides the rank's NLL sum by the count of
unmasked positions over the whole batch (`batch_sum`), so the ranks'
losses sum to the reference's masked mean.

Serving a training placement: under `with_mesh(view)` (this rank's
`parallel.fsdp.ServeView`) `prefill` and `decode_step` gather the
top-level leaves once a call and each layer's leaves just before that
layer runs (the encoder's a layer at a time too), so a rank holds one
layer's whole weights beside its pieces; `psum` is the identity and the
cache whole-headed, as on one device.

Training: `loss_fn` is the reference's causal-LM cross entropy (f32
logsumexp, labels < 0 masked).  `cfg.remat` checkpoints each period as
the reference's `_remat` wraps its scan body: "none"; "full", one
`torch.utils.checkpoint` (non-reentrant) a period, whose backward runs
the period's forward again; "dots", selective checkpointing that keeps
the outputs of the matrix products and of the kernels' forward ops
(`repro_torch::flash_forward`, `repro_torch::wkv_forward`,
`repro_torch::ssm_forward`) and recomputes the rest (the reference's
`checkpoint_dots`).  Per train step (a microbatch) on CUDA each
attention layer launches the flash forward once under "none" and
"dots" and twice under "full", and its backward once; each RWKV6 layer
launches `wkv_scan` (chunked route, with its chunk-boundary states) and
`wkv_scan_bwd` the same way, and each Mamba layer `ssm_scan` and
`ssm_scan_bwd`.

Caches, per pattern position, stacked over periods:
  attention -> (k, v) buffers [n_periods, B, T_cache, K, hd]
  mamba     -> {"ssm": [n_periods, B, Di, N] (f32),
               "conv": [n_periods, B, d_conv-1, Di]}
  rwkv      -> {"shift": [n_periods, B, D], "wkv": [n_periods, B, H, N, N]
               (f32), "cmix_shift": [n_periods, B, D]}
  cross-attention -> "xk", "xv" [n_periods, B, encoder_len, K, hd], the
               encoder output's K/V, written once by `prefill`
allocated once per request (at the serving length for attention) and
written IN PLACE by `prefill` and by each `decode_step` (the reference
returns new arrays; the values are equal slot for slot).

Inputs beside `tokens`: `positions` [S] or [B,S]; `mrope_positions`
[3,B,S] (M-RoPE configs); `vision_embeds` [B,S_v,D], zero-padded to S
and added to the token embeddings (the VLM merge stub); `embeds` [B,S,D]
in place of `tokens`; `enc_embeds` [B,encoder_len,D], the encoder's
input (the stubbed audio frontend's frames).

Every config runs and trains: an encoder-decoder's gradient runs the
flash backward non-causal over the encoder's frames and at S != T over
the cross-attention's keys, an M-RoPE config's rotates through
`layers.apply_mrope` under autograd.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.config import resolve_device
from ..tree import (leaves, leaves_with_path, path_key, replace_leaves,
                    tree_map)
from . import layers as L
from .config import LayerSpec, ModelConfig
from .sharding import batch_sum, gatherer, model_index, psum

Params = dict
# the encoder's blocks: bidirectional attention and a dense MLP
ENC_SPEC = LayerSpec(mixer="attn", mlp="dense", causal=False)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ('bfloat16', 'float32')."""
    return getattr(torch, name)


def _device(device) -> torch.device:
    """`resolve_device`, plus "meta" (shapes without storage, the
    counterpart of `jax.eval_shape`)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _stacked(n: int, draw) -> Params:
    """n trees from `draw()`, stacked leaf by leaf (dim 0).  One tree
    becomes views with a leading dim of 1 (no copy); more are drawn in
    order, each copied into the stacked leaves and dropped before the
    next is drawn, so no more than one tree is held beside the stack."""
    first = draw()
    if n == 1:
        return tree_map(lambda t: t[None], first)
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    tree_map(lambda dst, src: dst[0].copy_(src), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda dst, src: dst[i].copy_(src), out, draw())
    return out


def _index(tree, i: int):
    """Period i of a stacked nested dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------ block init
def _pieces(piece, prefix: str, tree) -> Params:
    """`tree` with each leaf replaced by `piece(path, leaf)` (path the
    "/"-joined path under `prefix`)."""
    return replace_leaves(tree, {
        p: piece(path_key((prefix, *p)), t)
        for p, t in leaves_with_path(tree)})


def _block_init(spec: LayerSpec, cfg: ModelConfig, dtype, generator,
                device, experts, keep, prefix: str) -> Params:
    """One block's parameters, each part cut by `keep(path, leaf)` (paths
    under `prefix`) as soon as it is drawn; a MoE layer's expert
    matrices one expert at a time (`moe_init(keep=)`), so a rank never
    holds a whole layer of experts."""
    part = lambda name, tree: _pieces(keep, f"{prefix}/{name}", tree)
    p: Params = {"norm1": part("norm1", L.norm_init(cfg.d_model, cfg.norm,
                                                    dtype, device))}
    if spec.mixer == "attn":
        p["mixer"] = part("mixer", L.attn_init(cfg, dtype, generator,
                                               device))
    elif spec.mixer == "mamba":
        p["mixer"] = part("mixer", L.mamba_init(cfg, dtype, generator,
                                                device))
    else:
        p["mixer"] = part("mixer", L.rwkv_init(cfg, dtype, generator,
                                               device))
    if spec.cross_attn:
        p["norm_x"] = part("norm_x", L.norm_init(cfg.d_model, cfg.norm,
                                                 dtype, device))
        p["cross"] = part("cross", L.attn_init(cfg, dtype, generator,
                                               device, cross=True))
    p["norm2"] = part("norm2", L.norm_init(cfg.d_model, cfg.norm, dtype,
                                           device))
    if spec.mlp == "dense":
        p["mlp"] = part("mlp", L.mlp_init(cfg.d_model, cfg.d_ff,
                                          cfg.mlp_act, dtype, generator,
                                          device))
    elif spec.mlp == "moe":
        p["mlp"] = L.moe_init(cfg, dtype, generator, device, experts,
                              keep=lambda name, t: keep(
                                  f"{prefix}/mlp/{name}", t))
    else:
        p["mlp"] = part("mlp", L.rwkv_cmix_init(cfg, dtype, generator,
                                                device))
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None, *, experts=None, piece=None) -> Params:
    """Random parameters at the reference's scales, drawn from
    `generator` (a torch.Generator on `device`).  `device=None` means
    "cuda" and raises without a GPU; "meta" gives the tree's shapes
    and dtypes without storage (pass generator=None).  `experts`: the
    global ids of the experts every MoE layer holds (None: all of
    `cfg.n_experts`), e.g. this card's share of an expert-parallel
    deployment.  `piece(path, t)`: what to keep of each leaf as it is
    drawn (a rank's slice: `parallel.tensor.init_local_params`), the
    draws unchanged; a stacked leaf is handed one period at a time, a
    MoE layer's expert matrix one expert at a time (a leaf of one
    expert, [1, D, F])."""
    dev = _device(device)
    dtype = torch_dtype(cfg.param_dtype)
    d, v = cfg.d_model, cfg.vocab_size
    keep = piece or (lambda path, t: t)
    params: Params = {
        "embed": keep("embed", L._normal((v, d), 0.02, dtype, generator,
                                         dev)),
        "lm_head": keep("lm_head", L._normal(
            (d, v), 1.0 / math.sqrt(d), dtype, generator, dev)),
        "final_norm": _pieces(keep, "final_norm",
                              L.norm_init(d, cfg.norm, dtype, dev)),
    }
    params["blocks"] = tuple(
        _stacked(cfg.n_periods, lambda j=j, spec=spec: _block_init(
            spec, cfg, dtype, generator, dev, experts, keep, f"blocks/{j}"))
        for j, spec in enumerate(cfg.pattern))
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = _stacked(
            cfg.n_encoder_layers, lambda: _block_init(
                ENC_SPEC, cfg, dtype, generator, dev, None, keep,
                "enc_blocks"))
        params["enc_final_norm"] = _pieces(
            keep, "enc_final_norm", L.norm_init(d, cfg.norm, dtype, dev))
    return params


# ----------------------------------------------------------------- block apply
# the layer kinds whose weights the serving layout replicates (RWKV6's
# time mix and channel mix): their outputs are whole on every rank
REPLICATED = ("rwkv", "rwkv_cmix")


def _partial(kind: str, y: torch.Tensor) -> torch.Tensor:
    """The output `y` of a layer of `kind` summed over "model" where the
    layout cuts its weights (`psum`: a row-parallel product's partial
    sums), `y` itself where it replicates them."""
    return y if kind in REPLICATED else psum(y)


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
    return x + _partial(spec.mlp, y.to(x.dtype))


def _block_full(pp: Params, spec: LayerSpec, cfg: ModelConfig,
                x: torch.Tensor, positions, mrope_positions=None,
                enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = L.norm_apply(pp["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        y = L.attention(pp["mixer"], h, cfg, positions=positions,
                        causal=spec.causal, mrope_positions=mrope_positions)
    elif spec.mixer == "mamba":
        y, _ = L.mamba_apply(pp["mixer"], h, cfg)
    else:
        y, _ = L.rwkv_apply(pp["mixer"], h, cfg)
    x = x + _partial(spec.mixer, y.to(x.dtype))
    if spec.cross_attn and enc_out is not None:
        h = L.norm_apply(pp["norm_x"], x, cfg.norm)
        x = x + psum(L.attention(pp["cross"], h, cfg, positions=positions,
                                 causal=False, kv_x=enc_out, rope=False))
    return _apply_mlp(pp, spec, cfg, x)


def _cmix_shift(spec: LayerSpec, ce: dict, i: int):
    """Period i's channel-mix shift in a cache entry (None for a dense
    MLP)."""
    return ce["cmix_shift"][i] if spec.mlp == "rwkv_cmix" else None


def _layers(params: Params, cfg: ModelConfig, gather=None):
    """(period index, pattern position, pattern spec, that layer's
    params) in model order; `gather` (a `models.sharding.gatherer`):
    each layer's whole leaves from its pieces, gathered as it is
    reached."""
    for i in range(cfg.n_periods):
        for j, spec in enumerate(cfg.pattern):
            pp = _index(params["blocks"][j], i)
            if gather is not None:
                pp = gather({f"blocks/{j}": pp}, i)[f"blocks/{j}"]
            yield i, j, spec, pp


def _gathered(params: Params):
    """(`params` with its top-level leaves whole, the gather for its
    layers), from `models.sharding.gatherer`: the identity on one device
    and under tensor parallelism."""
    gather = gatherer()
    top = {k: v for k, v in params.items()
           if k not in ("blocks", "enc_blocks")}
    return dict(params, **gather(top)), gather


# --------------------------------------------------------------------- encoder
def _encode(params: Params, cfg: ModelConfig,
            enc_embeds: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stub frontend embeddings [B,T,D]:
    bidirectional attention blocks with RoPE at positions 0..T-1, then
    `enc_final_norm`.  The frames come in the parameter dtype, as the
    reference's serve launcher hands them (bf16); other frames are
    refused: the reference would promote f32 frames against bf16 weights
    to an f32 encoder, or keep an f32 model's residual stream in bf16
    frames' dtype, neither of which the port runs."""
    dtype = params["enc_final_norm"]["w"].dtype
    if enc_embeds.dtype != dtype:
        raise TypeError(f"enc_embeds are {enc_embeds.dtype}; the encoder "
                        f"takes frames in the parameter dtype {dtype}")
    x = enc_embeds
    positions = torch.arange(x.shape[1], device=x.device)
    gather = gatherer()

    def layer(x, i, pp):
        pp = gather({"enc_blocks": pp}, i)["enc_blocks"]
        return _block_full(pp, ENC_SPEC, cfg, x, positions)

    layer = _remat(layer, cfg, params["enc_blocks"])
    for i in range(cfg.n_encoder_layers):
        x = layer(x, i, _index(params["enc_blocks"], i))
    return L.norm_apply(params["enc_final_norm"], x, cfg.norm)


def _enc_out(params: Params, cfg: ModelConfig, batch: dict):
    """The encoder's output for an encoder-decoder config, else None."""
    if not cfg.is_encoder_decoder:
        return None
    return _encode(params, cfg, batch["enc_embeds"])


# --------------------------------------------------------------------- forward
def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """The rows of `table` at `tokens`.  A table of fewer than `vocab`
    rows is a rank's piece of a vocab-sharded one (rows [m * Vl,
    (m + 1) * Vl) for its piece m of the model axis): the rank looks up
    the tokens in its rows, gives zeros for the others, and the pieces
    are summed over "model" (exact: one piece is nonzero)."""
    rows = table.shape[0]
    if rows == vocab:
        return table[tokens]
    m, n = model_index()
    if rows * n != vocab:
        raise ValueError(f"an embedding of {rows} rows on a model axis of "
                         f"{n} for a vocabulary of {vocab}")
    local = tokens - m * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].masked_fill(~mine[..., None], 0)
    return psum(x)


def embed_inputs(params: Params, cfg: ModelConfig, batch: dict) \
        -> torch.Tensor:
    """Token / stub-frontend embedding: the embedding of batch["tokens"]
    [B, S], plus batch["vision_embeds"] [B, S_v, D] (cast to its dtype,
    zero-padded to S: the VLM merge stub) where given, S_v > S refused
    with a ValueError; without tokens, batch["embeds"] [B, S, D] cast to
    the parameter dtype."""
    if "tokens" not in batch:
        return batch["embeds"].to(torch_dtype(cfg.param_dtype))
    x = embed_tokens(params["embed"], batch["tokens"], cfg.vocab_size)
    ve = batch.get("vision_embeds")
    if ve is not None:
        pad = x.shape[1] - ve.shape[1]
        if pad < 0:          # the reference's add fails to broadcast there
            raise ValueError(f"vision_embeds {tuple(ve.shape)} are longer "
                             f"than the token embeddings {tuple(x.shape)}")
        x = x + F.pad(ve.to(x.dtype), (0, 0, 0, pad))
    return x


def _positions(batch: dict, S: int, device) -> torch.Tensor:
    pos = batch.get("positions")
    return torch.arange(S, device=device) if pos is None else pos


# ops whose outputs remat "dots" keeps: the matrix products, and the
# kernels' forward ops (their backwards read o and lse, the scans' chunk
# states): a recompute would launch them again
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
         torch.ops.repro_torch.flash_forward.default,
         torch.ops.repro_torch.wkv_forward.default,
         torch.ops.repro_torch.ssm_forward.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig, params=None):
    """`fn` under `cfg.remat` (see the module docstring) when autograd
    records a gradient of `params` (None: of anything); as it is
    otherwise (serving, scoring)."""
    if cfg.remat == "none" or not torch.is_grad_enabled() or (
            params is not None
            and not any(x.requires_grad for x in leaves(params))):
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    kw = {} if cfg.remat == "full" else {"context_fn": partial(
        create_selective_checkpoint_contexts, _dots_policy)}
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def forward(params: Params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Training / scoring forward -> logits [B,S,V]."""
    params, gather = _gathered(params)
    x = embed_inputs(params, cfg, batch)
    positions = _positions(batch, x.shape[1], x.device)
    mrope_positions = batch.get("mrope_positions")
    enc_out = _enc_out(params, cfg, batch)

    def period(x, i, *pps):
        pps = gather({f"blocks/{j}": pp for j, pp in enumerate(pps)}, i)
        pps = [pps[f"blocks/{j}"] for j in range(len(cfg.pattern))]
        for spec, pp in zip(cfg.pattern, pps):
            x = _block_full(pp, spec, cfg, x, positions, mrope_positions,
                            enc_out)
        return x

    period = _remat(period, cfg, params)
    for i in range(cfg.n_periods):
        x = period(x, i, *(_index(b, i) for b in params["blocks"]))
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return x @ params["lm_head"]


def loss_fn(params: Params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Causal-LM cross entropy: f32 logsumexp over the vocabulary, the
    mean NLL of the positions whose label is >= 0.  Under a training mesh
    a rank's rows' NLL sum over the whole batch's count of such
    positions: the ranks' losses sum to the mean."""
    logits = forward(params, cfg, batch).float()
    labels = batch["labels"]
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - picked) * mask
    return nll.sum() / batch_sum(mask.sum()).clamp_min(1.0)


# --------------------------------------------------------------------- serving
def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, *,
               model: int = 1) -> dict:
    """Cache layout for a serving session: per pattern position, a dict
    of name -> (shape, dtype): "k", "v" for attention (for SWA archs the
    rolling window, for full attention `seq_len` entries); "ssm" (f32)
    and "conv" for Mamba; "shift", "wkv" (f32) for RWKV's time-mix,
    "cmix_shift" for its channel-mix; "xk", "xv" (`encoder_len`
    entries) for cross-attention.  `model`: the size of the model axis
    a rank's cache is cut over, its KV heads and Mamba's `d_inner`
    channels over it (as `launch.shardings.cache_shardings` places
    them)."""
    attn = any(spec.mixer == "attn" or spec.cross_attn
               for spec in cfg.pattern)
    names = ["n_kv_heads"] * attn + ["mamba_d_inner"] * any(
        spec.mixer == "mamba" for spec in cfg.pattern)
    for name in names:
        if getattr(cfg, name) % model:
            raise ValueError(f"{name} {getattr(cfg, name)} over a model "
                             f"axis of {model}")
    d, hd, nkv = cfg.d_model, cfg.head_dim, cfg.n_kv_heads // model
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
            di = cfg.mamba_d_inner // model
            entry["ssm"] = ((np_, batch, di, cfg.mamba_d_state),
                            torch.float32)
            entry["conv"] = ((np_, batch, cfg.mamba_d_conv - 1, di), cdt)
        else:
            entry["shift"] = ((np_, batch, d), cdt)
            entry["wkv"] = ((np_, batch, d // N, N, N), torch.float32)
        if spec.mlp == "rwkv_cmix":
            entry["cmix_shift"] = ((np_, batch, d), cdt)
        if spec.cross_attn:
            entry["xk"] = ((np_, batch, cfg.encoder_len, nkv, hd), cdt)
            entry["xv"] = ((np_, batch, cfg.encoder_len, nkv, hd), cdt)
        per_pos.append(entry)
    return {"blocks": tuple(per_pos)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None, *, model: int = 1) -> dict:
    """Zeroed caches of `cache_spec` on `device` (None: "cuda")."""
    dev = _device(device)
    spec = cache_spec(cfg, batch, seq_len, model=model)
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
    here, on the embedding's device, and filled in place; a
    cross-attention layer's "xk"/"xv" take the encoder output's K/V
    once, and its attention runs over them.  Under a serving view of a
    training placement the top-level leaves are gathered once and each
    layer's just before it runs (`_gathered`, `_layers(gather=)`)."""
    params, gather = _gathered(params)
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    positions = _positions(batch, S, x.device)
    mrope_positions = batch.get("mrope_positions")
    enc_out = _enc_out(params, cfg, batch)
    cache = init_cache(cfg, B, cache_len, x.device,
                       model=model_index()[1])
    for i, j, spec, pp in _layers(params, cfg, gather):
        ce = cache["blocks"][j]
        h = L.norm_apply(pp["norm1"], x, cfg.norm)
        if spec.mixer == "attn":
            y = L.attention_prefill(pp["mixer"], h, cfg, positions=positions,
                                    kv_cache=(ce["k"][i], ce["v"][i]),
                                    mrope_positions=mrope_positions)
        elif spec.mixer == "mamba":
            y, _ = L.mamba_apply(pp["mixer"], h, cfg, state={
                "ssm": ce["ssm"][i], "conv": ce["conv"][i]})
        else:
            y, _ = L.rwkv_apply(pp["mixer"], h, cfg, state={
                "shift": ce["shift"][i], "wkv": ce["wkv"][i]})
        x = x + _partial(spec.mixer, y.to(x.dtype))
        if spec.cross_attn and enc_out is not None:
            h = L.norm_apply(pp["norm_x"], x, cfg.norm)
            x = x + psum(L.cross_attention_prefill(
                pp["cross"], h, cfg, enc_out, (ce["xk"][i], ce["xv"][i])))
        x = _apply_mlp(pp, spec, cfg, x, _cmix_shift(spec, ce, i))
    x = L.norm_apply(params["final_norm"], x[:, -1:], cfg.norm)
    logits = x @ params["lm_head"]
    return logits[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, cache_len: int):
    """One decode step.  tokens [B,1]; cache from `prefill` /
    `init_cache`, updated in place; cache_len: number of tokens already
    in the cache (a plain int, so the step makes no host-device sync).
    The new token sits at position cache_len (on all three M-RoPE
    streams); a cross-attention layer reads its "xk"/"xv" over
    `encoder_len` slots.  Returns (logits [B,V], cache).  Gathers as
    `prefill` does."""
    params, gather = _gathered(params)
    x = embed_tokens(params["embed"], tokens, cfg.vocab_size)
    for i, j, spec, pp in _layers(params, cfg, gather):
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
        x = x + _partial(spec.mixer, y.to(x.dtype))
        if spec.cross_attn:
            h = L.norm_apply(pp["norm_x"], x, cfg.norm)
            y = L.attention_decode(pp["cross"], h, cfg,
                                   (ce["xk"][i], ce["xv"][i]), pos=cache_len,
                                   cache_len=cfg.encoder_len, cross=True)
            x = x + psum(y.to(x.dtype))
        x = _apply_mlp(pp, spec, cfg, x, _cmix_shift(spec, ce, i),
                       decode=True)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return (x @ params["lm_head"])[:, 0], cache
