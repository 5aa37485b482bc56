"""Meta-tensor input specs for every (arch x shape x mode) cell, ported
from `repro.launch.specs`: where the reference builds sharding-annotated
`ShapeDtypeStruct`s, the port builds each tree on the "meta" device
(shapes and dtypes, no storage) beside its specs from
`launch.shardings` ({leaf path: spec}), as a `Placed`:
  * train  : "state" ({"params", "opt", "step"}) and "batch" for the
             train step, with the AdamW config ("opt_cfg")
  * prefill: "params" (serving) and "batch", and "cache", the cache the
             prefill fills
  * decode : "params" (serving), "tokens", "cache" and "cache_len" for
             one decode step
A single-tensor tree's one leaf has the path "".

Serving keeps its parameters resident (model-sharded) unless a model
shard passes SERVE_RESIDENT_LIMIT (`serving_fallback`); there
`params_specs(serving=True)` falls back to the training placement,
which `serve.ServingEngine(group=, specs=)` serves gathered.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from ..models.config import ModelConfig, ShapeConfig
from ..models.transformer import cache_spec, init_params
from ..optim import adamw
from .mesh import Mesh, dp_axes, train_dp_axes
from .shardings import (batch_shardings, cache_shardings, opt_shardings,
                        param_shardings, sanitize)

META = torch.device("meta")
CARD_BYTES = 80e9             # an H100 80GB HBM3's device memory
# bytes a card of resident serving parameters: three quarters of the
# card, the rest left to the KV cache and activations
SERVE_RESIDENT_LIMIT = 0.75 * CARD_BYTES


class Placed(NamedTuple):
    """A tree of meta tensors and its specs by leaf path."""
    tree: object
    specs: dict


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


@lru_cache(maxsize=None)
def meta_params(cfg: ModelConfig):
    """The parameter tree of `cfg` on "meta" (built once a config: it
    holds no storage, and nothing writes it)."""
    return init_params(cfg, None, META)


def serving_fallback(mesh: Mesh, cfg: ModelConfig) -> bool:
    """Whether `params_specs(mesh, cfg, serving=True)` falls back to the
    training placement: a model shard of `cfg` in bf16 (2 bytes a
    parameter over the model axis) passes SERVE_RESIDENT_LIMIT.  A
    server then gathers the pieces a layer at a time
    (`serve.ServingEngine(group=, specs=)`)."""
    return 2 * cfg.param_count() / mesh.shape["model"] > \
        SERVE_RESIDENT_LIMIT


def params_specs(mesh: Mesh, cfg: ModelConfig, *,
                 serving: bool = False) -> Placed:
    params = meta_params(cfg)
    # serving wants params RESIDENT (model-sharded, no per-step
    # gathers); fall back to FSDP only when a model shard exceeds
    # SERVE_RESIDENT_LIMIT (no config on a 16-way model axis;
    # jamba-398B, mixtral-8x22B and qwen2-vl-72B on a 2-way one)
    force_zero2 = serving and not serving_fallback(mesh, cfg)
    return Placed(params, param_shardings(mesh, cfg, params,
                                          force_zero2=force_zero2))


def state_specs(mesh: Mesh, cfg: ModelConfig,
                opt_cfg: Optional[adamw.AdamWConfig] = None):
    """(Placed {"params", "opt", "step"}, the AdamW config)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(moment_dtype=cfg.moment_dtype)
    pspec = params_specs(mesh, cfg)
    opt = adamw.init(pspec.tree, opt_cfg)
    specs = {f"params/{p}": s for p, s in pspec.specs.items()}
    specs.update({f"opt/{p}": s for p, s in
                  opt_shardings(mesh, cfg, opt, pspec.tree).items()})
    specs["step"] = ()
    tree = {"params": pspec.tree, "opt": opt,
            "step": _meta((), torch.int32)}
    return Placed(tree, specs), opt_cfg


def batch_specs(mesh: Mesh, cfg: ModelConfig, batch: int, seq_len: int,
                *, labels: bool = True, train: bool = False) -> Placed:
    tree = {"tokens": _meta((batch, seq_len), torch.int32)}
    if labels:
        tree["labels"] = _meta((batch, seq_len), torch.int32)
    if cfg.mrope_sections:
        tree["mrope_positions"] = _meta((3, batch, seq_len), torch.int32)
        tree["vision_embeds"] = _meta(
            (batch, max(seq_len // 4, 1), cfg.d_model), torch.bfloat16)
    if cfg.is_encoder_decoder:
        tree["enc_embeds"] = _meta(
            (batch, cfg.encoder_len, cfg.d_model), torch.bfloat16)
    dp = train_dp_axes(mesh, cfg) if train else None
    return Placed(tree, batch_shardings(mesh, cfg, tree, dp=dp))


def cache_specs(mesh: Mesh, cfg: ModelConfig, batch: int,
                seq_len: int) -> Placed:
    spec = cache_spec(cfg, batch, seq_len)
    tree = {"blocks": tuple({k: _meta(shape, dt) for k, (shape, dt)
                             in entry.items()} for entry in spec["blocks"])}
    return Placed(tree, cache_shardings(mesh, cfg, tree))


def prefill_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """The cache a prefill of `seq_len` tokens fills: the sliding window
    for SWA archs, else the whole prompt."""
    return min(cfg.sliding_window, seq_len) if cfg.sliding_window \
        else seq_len


def input_specs(arch_cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    """Returns (mode, {name: Placed, ...}) for the cell (train also
    "opt_cfg")."""
    cfg = arch_cfg
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        state, opt_cfg = state_specs(mesh, cfg)
        return "train", {"state": state,
                         "batch": batch_specs(mesh, cfg, B, S, train=True),
                         "opt_cfg": opt_cfg}
    if shape.kind == "prefill":
        return "prefill", {
            "params": params_specs(mesh, cfg, serving=True),
            "batch": batch_specs(mesh, cfg, B, S, labels=False),
            "cache": cache_specs(mesh, cfg, B, prefill_cache_len(cfg, S))}
    # decode: one new token against a seq_len-deep cache
    dp = dp_axes(mesh)
    return "decode", {
        "params": params_specs(mesh, cfg, serving=True),
        "tokens": Placed(_meta((B, 1), torch.int32),
                         {"": sanitize(mesh, (B, 1), (dp, None))}),
        "cache": cache_specs(mesh, cfg, B, S),
        "cache_len": Placed(_meta((), torch.int32), {"": ()}),
    }
