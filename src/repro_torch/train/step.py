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

On a mesh of ranks (`make_train_step(cfg, opt_cfg, group)`, this rank's
`parallel.MeshGroup`) the state holds the rank's pieces under the
reference's training placement (`parallel.fsdp`) and `batch` the rank's
rows of the global batch (`Layout.rows`, which the step exposes as
`train_step.layout`): its rows of each of the A microbatches, in block
order.  Each microbatch's loss is the rank's NLL sum over the global
microbatch's count of unmasked positions, so the ranks' losses sum to
the reference's masked mean of the whole microbatch (a mean of the
ranks' means would not, where their counts differ); the gradients land
as f32 pieces under the optimizer's spec, summed over the ranks
(`fsdp.Gather`); the metrics are the whole batch's, equal on every rank.

An encoder-decoder's frames (`enc_embeds`) are rounded to the parameter
dtype at the step's entry (`frames_in_param_dtype`), before the
microbatch split: the encoder takes them in that dtype, as the
reference's serve launcher hands them (its trainer would promote the
pipeline's f32 frames against bf16 weights to an f32 encoder).
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.sharding import with_mesh
from ..models.transformer import init_params, loss_fn, torch_dtype
from ..optim import adamw
from ..parallel.fsdp import Layout
from ..tree import leaves, leaves_with_path, path_key, replace_leaves, \
    tree_map


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


def _sharded_value_and_grad(params, cfg: ModelConfig, batch: dict,
                            layout: Layout):
    """(the whole batch's loss, the rank's f32 gradient pieces) on the
    rank's pieces and rows (module docstring); f32 zeros of the
    optimizer's piece for a leaf that is not floating point."""
    live = {p: x.detach().requires_grad_()
            for p, x in leaves_with_path(params) if x.is_floating_point()}
    with with_mesh(layout):
        loss = loss_fn(replace_leaves(params, live), cfg, batch)
    # outside the mesh's context, as the autograd engine runs a card's
    # backward on its own thread: the model binds the layout it needs
    loss.backward()
    got = layout.take_grads()
    grads = replace_leaves(params, {
        p: got[path_key(p)] if p in live else torch.zeros(
            layout.piece_shape(f"opt/m/{path_key(p)}"),
            dtype=torch.float32, device=x.device)
        for p, x in leaves_with_path(params)})
    return layout.batch_sum(loss), grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    group=None):
    """`train_step(state, batch) -> (new_state, metrics)`; with `group`
    (a mesh of several devices) the sharded step of the module
    docstring, its `Layout` as `train_step.layout`.  Its gradients alone
    are `train_step.value_and_grad(params, batch) -> (loss, grads)` (a
    microbatch's; under a group the whole batch's loss and the rank's
    f32 pieces)."""
    A = max(cfg.microbatches, 1)
    acc_dt = torch_dtype(opt_cfg.moment_dtype)
    layout = None
    if group is not None and group.mesh.size > 1:
        layout = Layout(group, cfg, opt_cfg)

    def value_and_grad(params, batch):
        if layout is None:
            return _value_and_grad(params, cfg, batch)
        return _sharded_value_and_grad(params, cfg, batch, layout)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        batch = frames_in_param_dtype(cfg, batch)
        if A == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            mbs = _split_microbatches(batch, A)
            gsum = None
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(A):
                l, g = value_and_grad(params,
                                      {k: x[i] for k, x in mbs.items()})
                gsum = tree_map(lambda b: b.to(acc_dt), g) if gsum is None \
                    else tree_map(lambda a, b: a + b.to(acc_dt), gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: (g / A).float(), gsum)
            loss = lsum / A
        new_params, new_opt, om = adamw.update(grads, state["opt"], params,
                                               opt_cfg, layout=layout)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **om}

    train_step.layout = layout
    train_step.value_and_grad = value_and_grad
    return train_step
