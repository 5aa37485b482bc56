"""Training step builder: microbatched gradient accumulation, AdamW,
metrics; ported from `repro.train.step`.

`make_train_step(cfg, opt_cfg)` returns `train_step(state, batch) ->
(new_state, metrics)`.  Gradients are `torch.autograd.grad` of
`models.loss_fn` with respect to detached copies of the floating-point
leaves that require grad (views of the same storage: the state's
tensors are never written).  With `cfg.microbatches` = A > 1 the batch is
split along its batch dim and the A gradients are summed in
`opt_cfg.moment_dtype`, then divided by A, as the reference's `lax.scan`
does; the loss is the mean of the A losses.  The step returns new
tensors and leaves `state` as it was (see `optim.adamw`).

An encoder-decoder's frames (`enc_embeds`) are rounded to the parameter
dtype at the step's entry (`frames_in_param_dtype`), before the
microbatch split: the encoder takes them in that dtype, as the
reference's serve launcher hands them (its trainer would promote the
pipeline's f32 frames against bf16 weights to an f32 encoder).
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.transformer import init_params, loss_fn, torch_dtype
from ..optim import adamw
from ..tree import leaves, leaves_with_path, replace_leaves, tree_map


def init_state(generator, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
               params=None, device=None) -> dict:
    """{"params", "opt", "step"}: `params`, or parameters drawn from
    `generator` on `device` (None means "cuda" and raises without a
    GPU)."""
    if params is None:
        params = init_params(cfg, generator, device)
    return {"params": params,
            "opt": adamw.init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def _split_microbatches(batch: dict, A: int) -> dict:
    """[B, ...] -> [A, B/A, ...]; mrope_positions has its batch at dim 1."""
    out = {}
    for k, x in batch.items():
        if k == "mrope_positions":            # [3, B, S]
            B = x.shape[1]
            out[k] = x.reshape(3, A, B // A, *x.shape[2:]).transpose(0, 1)
        else:
            B = x.shape[0]
            out[k] = x.reshape(A, B // A, *x.shape[1:])
    return out


def frames_in_param_dtype(cfg: ModelConfig, batch: dict) -> dict:
    """`batch` with its `enc_embeds` (an encoder-decoder's frames) in the
    parameter dtype; as it is otherwise."""
    x = batch.get("enc_embeds")
    dtype = torch_dtype(cfg.param_dtype)
    if x is None or x.dtype == dtype:
        return batch
    return dict(batch, enc_embeds=x.to(dtype))


def _value_and_grad(params, cfg: ModelConfig, batch: dict):
    """(loss, grads): grads in each leaf's dtype, f32 zeros for a leaf
    that is not floating point (a MoE layer's `expert_ids`)."""
    live = {p: x.detach().requires_grad_()
            for p, x in leaves_with_path(params) if x.is_floating_point()}
    loss = loss_fn(replace_leaves(params, live), cfg, batch)
    got = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    grads = replace_leaves(params, got, lambda x: torch.zeros(
        x.shape, dtype=torch.float32, device=x.device))
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    A = max(cfg.microbatches, 1)
    acc_dt = torch_dtype(opt_cfg.moment_dtype)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        batch = frames_in_param_dtype(cfg, batch)
        if A == 1:
            loss, grads = _value_and_grad(params, cfg, batch)
        else:
            mbs = _split_microbatches(batch, A)
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dt, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(A):
                l, g = _value_and_grad(params, cfg,
                                       {k: x[i] for k, x in mbs.items()})
                gsum = tree_map(lambda a, b: a + b.to(acc_dt), gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: (g / A).float(), gsum)
            loss = lsum / A
        new_params, new_opt, om = adamw.update(grads, state["opt"], params,
                                               opt_cfg)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **om}

    return train_step
