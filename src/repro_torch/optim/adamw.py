"""AdamW with global-norm clipping, a configurable moment dtype and an
optional int8 error-feedback gradient-compression stage, ported from
`repro.optim.adamw` as functions on the same nested dicts.

Not `torch.optim.AdamW`: `update` returns new tensors and never writes
into `params` or `state`, as the reference does.  It takes over `grads`:
each gradient leaf is dropped from its dict once its update is done, so
that on a card that holds two versions of the moments the gradients go
as the new moments come.  A trainer publishes
each version's tree into `VersionedParamStore`, which keeps a reference
to it; an in-place update would change a version a reader has pinned.
Leaves that are not floating point (a MoE layer's `expert_ids`) are
carried unchanged.  A leaf is updated in slices of UPDATE_SLICE
elements, each written into the new tensors: the arithmetic is
elementwise, so the result is the same, and a stacked leaf's f32
temporaries (RWKV6-3B's channel-mix keys: 734 M elements, 2.9 GB each)
stay a slice's size on a card that holds two versions of the moments.

On a mesh of ranks (`layout=`, this rank's `parallel.fsdp.Layout`) the
trees hold the rank's pieces: the global norm is the whole tree's (each
piece's squared sum summed over the mesh, a piece that several ranks
hold counted once), the int8 compression scales each leaf by the whole
leaf's max (the pieces' maxima, max-reduced over the mesh), and the
update runs on the pieces (under ZeRO-2 on the slice of the whole
parameter beside the moments' pieces, all-gathered back after).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.transformer import torch_dtype
from ..tree import leaves, leaves_with_path, path_key, replace_leaves, \
    tree_map, tree_unzip

UPDATE_SLICE = 1 << 24              # elements of a leaf updated at once


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    compress: bool = False            # int8 error-feedback compression


def init(params, cfg: AdamWConfig) -> dict:
    """Zero moments in `cfg.moment_dtype` (and f32 error-feedback
    residuals with `compress`) beside each leaf, and an int32 step count,
    on the parameters' device."""
    mdt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=leaves(params)[0].device)}
    if cfg.compress:
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum over leaves of their f32 sums of squares (under a
    `layout`, of the whole tree's: see the module docstring)."""
    if layout is None:
        return torch.sqrt(sum(x.float().square().sum()
                              for x in leaves(tree)))
    sq = torch.stack([x.float().square().sum()
                      * layout.norm_weight(path_key(p))
                      for p, x in leaves_with_path(tree)])
    return torch.sqrt(layout.mesh_sum(sq).sum())


def _compress_int8(g: torch.Tensor, ef: torch.Tensor, amax=None):
    """Simulated int8 compression with error feedback: the value that
    crosses the DP boundary is the dequantized int8; the quantization
    error stays in `ef` and is added to the next step's gradient.
    `amax`: the whole leaf's max |g + ef| where `g` is a piece.
    Returns (dequantized, new residual)."""
    gf = g.float() + ef
    amax = gf.abs().max() if amax is None else amax
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def _take(tree, path: tuple):
    """The leaf at `path`, removed from its dict (a leaf held by a tuple
    or a list stays)."""
    for key in path[:-1]:
        tree = tree[key]
    return tree.pop(path[-1]) if isinstance(tree, dict) else tree[path[-1]]


def update(grads, state: dict, params, cfg: AdamWConfig, *, layout=None):
    """Returns (new_params, new_state, {"grad_norm": ...}); `params` and
    `state` are left as they are, `grads` is taken over (its leaves are
    removed as they are used).  `layout`: the rank's training layout,
    the trees its pieces (module docstring)."""
    count = state["count"] + 1
    new_ef = None
    if cfg.compress:
        amax = ()
        if layout is not None:
            local = torch.stack([
                (g.float() + e).abs().max()
                for g, e in zip(leaves(grads), leaves(state["ef"]))])
            amax = (replace_leaves(grads, dict(zip(
                [p for p, _ in leaves_with_path(grads)],
                layout.mesh_max(local).unbind()))),)
        grads, new_ef = tree_unzip(
            tree_map(_compress_int8, grads, state["ef"], *amax), grads, 2)
    gnorm = global_norm(grads, layout)
    clip_scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                             max=1.0)
    mdt = torch_dtype(cfg.moment_dtype)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()

    def upd(path, p, g, m, v):
        if not p.is_floating_point():
            return p, m, v
        key = path_key(path)
        if layout is not None:
            p = layout.param_in(key, p)
        out = tuple(torch.empty(p.shape, dtype=dt, device=p.device)
                    for dt in (p.dtype, mdt, mdt))   # contiguous
        flat = [x.reshape(-1) for x in (p, g, m, v, *out)]
        for lo in range(0, p.numel(), UPDATE_SLICE):
            p_, g_, m_, v_, po, mo, vo = (x[lo:lo + UPDATE_SLICE]
                                          for x in flat)
            g_ = g_.float() * clip_scale
            m32 = m_.float() * cfg.b1 + g_ * (1 - cfg.b1)
            v32 = v_.float() * cfg.b2 + g_.square() * (1 - cfg.b2)
            mh = m32 / b1c
            vh = v32 / b2c
            step = cfg.lr * (mh / (torch.sqrt(vh) + cfg.eps)
                             + cfg.weight_decay * p_.float())
            po.copy_(p_.float() - step)
            mo.copy_(m32)
            vo.copy_(v32)
        if layout is not None:
            out = (layout.param_out(key, out[0]),) + out[1:]
        return out

    moments = {k: dict(leaves_with_path(state[k])) for k in ("m", "v")}
    new = {path: upd(path, p, _take(grads, path), moments["m"][path],
                     moments["v"][path])
           for path, p in leaves_with_path(params)}
    new_params, m, v = (replace_leaves(params, {k: t[i] for k, t in
                                                new.items()})
                        for i in range(3))
    new_state = {"m": m, "v": v, "count": count}
    if new_ef is not None:
        new_state["ef"] = new_ef
    return new_params, new_state, {"grad_norm": gnorm}
