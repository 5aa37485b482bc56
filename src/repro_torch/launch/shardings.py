"""Parameter / state / input partition rules for meshes of cards, ported
from `repro.launch.shardings` (the pure logic over a leaf's path and
shape).

Strategy:
  * "model"  — tensor parallel: attention heads / d_ff / vocab (lm_head),
  * "data"   — batch; doubles as the FSDP axis for params/opt of big archs,
  * "pod"    — outer data parallel (training) / replication boundary (HTAP).

A spec is a plain tuple with one entry a dim: None (replicated), an axis
name, or a tuple of axis names (the reference's `PartitionSpec`
entries).  Every spec is sanitized against the mesh: a dim that is not
divisible by its axis size falls back to replication for that dim (e.g.
whisper's 6 heads on a 16-way model axis, granite's single KV head).
The tree functions return {"/"-joined leaf path: spec} over the leaves
of the tree they are given (the paths of `repro_torch.tree`, which are
the reference's); a MoE layer's `expert_ids` (the port's one extra
leaf) is replicated by the catch-all rule.
"""

from __future__ import annotations

import re
from typing import Optional

from ..models.config import ModelConfig
from ..tree import leaves_with_path, path_key
from .mesh import Mesh, dp_axes

Spec = tuple


# --------------------------------------------------------------- sanitation
def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def sanitize(mesh: Mesh, shape: tuple[int, ...], spec: Spec) -> Spec:
    """Drop axes whose size does not divide the dim; drop unknown axes.
    One entry a dim of `shape`."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        if not all(a in mesh.axis_names for a in axes):
            out.append(None)
            continue
        if dim % _axis_size(mesh, axis) != 0:
            out.append(None)
            continue
        out.append(axis)
    return tuple(out)


def shards(mesh: Mesh, spec: Spec) -> int:
    """The number of pieces a leaf is cut into under `spec` (each card
    of the mesh holds one piece; the other axes replicate it)."""
    n = 1
    for axis in spec:
        n *= _axis_size(mesh, axis)
    return n


# ------------------------------------------------------------- param rules
# matched against the "/"-joined tree path of each leaf; first match wins.
# L = leading stacked-period dim (present under blocks/enc_blocks).
def _param_rules(cfg: ModelConfig, fsdp: Optional[str]):
    F = fsdp  # alias; None disables FSDP for that dim
    return [
        (r"embed$",                 ("model", None)),
        (r"lm_head$",               (None, "model")),
        # attention
        (r"(mixer|cross)/wq$",      (None, F, "model")),
        (r"(mixer|cross)/wk$",      (None, F, "model")),
        (r"(mixer|cross)/wv$",      (None, F, "model")),
        (r"(mixer|cross)/wo$",      (None, "model", F)),
        (r"(mixer|cross)/b[qkv]$",  (None, None)),
        # dense mlp
        (r"mlp/w_(up|gate)$",       (None, F, "model")),
        (r"mlp/w_down$",            (None, "model", F)),
        # moe
        (r"mlp/router$",            (None, None, None)),
        (r"mlp/w_(up|gate)$",       (None, None, F, "model")),  # [L,E,D,F]
        (r"mlp/w_down$",            (None, None, "model", F)),  # [L,E,F,D]
        # mamba
        (r"mixer/in_proj$",         (None, F, "model")),
        (r"mixer/out_proj$",        (None, "model", F)),
        (r"mixer/conv_[wb]$",       (None, None, "model")),
        (r"mixer/x_proj$",          (None, "model", None)),
        (r"mixer/dt_proj$",         (None, None, "model")),
        (r"mixer/(A_log)$",         (None, "model", None)),
        (r"mixer/(D|dt_bias)$",     (None, "model")),
        # rwkv (heads often indivisible -> replicate outputs, FSDP inputs)
        (r"mixer/w[rkvgo]$",        (None, F, None)),
        (r"mixer/(w_lora_a|mix_lora_a)$", (None, F, None)),
        (r"mixer/.*$",              (None,)),
        (r"mlp/w[kvr]$",            (None, F, None)),
        # norms / everything else replicated
        (r".*",                     ()),
    ]


def _moe_aware(path: str, shape: tuple[int, ...], rules) -> Spec:
    """Pick the matching rule; disambiguate mlp w_up/w_down by rank (MoE
    weights are rank-4 with the stacked period dim)."""
    for pat, spec in rules:
        if re.search(pat, path):
            if re.search(r"mlp/w_(up|gate|down)$", path):
                want_rank4 = len(shape) == 4
                is_moe_rule = len(spec) == 4
                if want_rank4 != is_moe_rule:
                    continue
            return spec
    return ()


def _fsdp2d_spec(path: str, shape: tuple[int, ...]) -> Spec:
    """fsdp2d: every weight sharded over ("data","model") on its first
    big dim; embed/lm_head replicated (read once per step); no TP axis."""
    F = ("data", "model")
    if re.search(r"(embed|lm_head)$", path):
        return ()
    stacked = path.startswith(("blocks", "enc_blocks"))
    lead = (None,) if stacked else ()
    body = shape[1:] if stacked else shape
    if not body:
        return ()
    # put the FSDP axes on the largest dim of the body
    big = max(range(len(body)), key=lambda i: body[i])
    spec = [None] * len(body)
    spec[big] = F
    return tuple(list(lead) + spec)


def param_path_spec(cfg: ModelConfig, path: str,
                    shape: tuple[int, ...], *,
                    force_zero2: bool = False) -> Spec:
    """Spec for a parameter leaf given its tree path (unsanitized).

    ZeRO-2 (cfg.zero2 or force_zero2): parameters carry only the "model"
    axis — no per-layer all-gathers in fwd/bwd; the data axis shards the
    optimizer state instead (see opt_shardings).  The embedding table is
    fully replicated in ZeRO-2."""
    if cfg.train_sharding == "fsdp2d" and not force_zero2:
        return _fsdp2d_spec(path, shape)
    zero2 = force_zero2 or cfg.zero2
    fsdp = None if zero2 else ("data" if cfg.fsdp else None)
    if zero2 and re.search(r"embed$", path):
        return ()
    rules = _param_rules(cfg, fsdp)
    spec = _moe_aware(path, shape, rules)
    stacked = path.startswith(("blocks", "enc_blocks"))
    if not stacked:
        # drop the leading placeholder for unstacked leaves
        entries = list(spec)
        if entries and entries[0] is None and len(entries) > len(shape):
            spec = tuple(entries[1:])
    return spec


def _paths(tree) -> list[tuple[str, tuple[int, ...]]]:
    return [(path_key(p), tuple(x.shape)) for p, x in leaves_with_path(tree)]


def param_shardings(mesh: Mesh, cfg: ModelConfig, params, *,
                    force_zero2: bool = False) -> dict:
    """{path: sanitized spec} over a parameter(-shaped) tree."""
    return {p: sanitize(mesh, shape, param_path_spec(
        cfg, p, shape, force_zero2=force_zero2))
            for p, shape in _paths(params)}


# --------------------------------------------------------------- opt state
def opt_shardings(mesh: Mesh, cfg: ModelConfig, opt, params) -> dict:
    """Adam moments follow their parameters — except under ZeRO-2, where
    moments keep the data-axis (FSDP) sharding while params do not: the
    optimizer state is the thing worth sharding.  Keys "m/<path>",
    "v/<path>" (and "ef/<path>"), "count"."""
    if cfg.zero2 and cfg.train_sharding != "fsdp2d":
        z3 = cfg.with_overrides(zero2=False, fsdp=True)
        pshard = param_shardings(mesh, z3, params)
    else:
        pshard = param_shardings(mesh, cfg, params)
    out = {"count": ()}
    for key in ("m", "v", "ef"):
        if key in opt:
            out.update({f"{key}/{p}": s for p, s in pshard.items()})
    return out


# -------------------------------------------------------------- batch/cache
def _batch_spec(mesh: Mesh, path: str, shape: tuple[int, ...], dp) -> Spec:
    if path == "mrope_positions":            # [3,B,S]
        return sanitize(mesh, shape, (None, dp, None))
    return sanitize(mesh, shape, (dp,) + (None,) * (len(shape) - 1))


def batch_shardings(mesh: Mesh, cfg: ModelConfig, batch, *,
                    dp: Optional[tuple] = None) -> dict:
    """{key: spec}: the batch dim over the data-parallel axes (`dp`,
    default `dp_axes(mesh)`; training passes `train_dp_axes`)."""
    dp = dp_axes(mesh) if dp is None else dp
    return {p: _batch_spec(mesh, p, shape, dp) for p, shape in _paths(batch)}


def _cache_spec(mesh: Mesh, path: str, shp: tuple[int, ...], dp) -> Spec:
    model_n = mesh.shape["model"]
    if path.endswith(("/k", "/v", "/xk", "/xv")):
        K = shp[3]
        if K % model_n == 0:
            return sanitize(mesh, shp, (None, dp, None, "model", None))
        return sanitize(mesh, shp, (None, dp, "model", None, None))
    if path.endswith("/ssm"):                 # [L,B,Di,N]
        return sanitize(mesh, shp, (None, dp, "model", None))
    if path.endswith("/conv"):                # [L,B,k-1,Di]
        return sanitize(mesh, shp, (None, dp, None, "model"))
    if path.endswith("/wkv"):                 # [L,B,H,N,N]
        return sanitize(mesh, shp, (None, dp, None, None, None))
    if path.endswith(("/shift", "/cmix_shift")):   # [L,B,D]
        return sanitize(mesh, shp, (None, dp, None))
    return sanitize(mesh, shp, (None, dp) + (None,) * (len(shp) - 2))


def cache_shardings(mesh: Mesh, cfg: ModelConfig, cache) -> dict:
    """KV: [L,B,T,K,hd] — batch over dp; heads over model when divisible,
    else sequence over model (flash-decoding split-KV).  SSM/RWKV states:
    batch over dp, inner dim over model when divisible."""
    dp = dp_axes(mesh)
    return {p: _cache_spec(mesh, p, shape, dp) for p, shape in _paths(cache)}
