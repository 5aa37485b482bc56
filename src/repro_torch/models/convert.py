"""Carry the JAX package's parameters into the port.

`params_from_numpy(cfg, tree, device)` takes the reference's parameter
pytree with numpy leaves (`jax.tree.map(np.asarray, params)`: ml_dtypes
bfloat16 arrays for bf16 leaves) and returns the port's tree, leaf for
leaf, after checking every key, shape and dtype against `init_params`'
tree for `cfg` (which may mix dtypes: RWKV6 keeps its decay, bonus,
ddlerp bases, groupnorm affine and channel-mix lerps in f32 beside bf16
matrices; Mamba its dt_bias, A_log and D, MoE its router).  bf16 leaves
cross through an int16 view, bit for bit.  With `experts=` the MoE
layers take that share of the reference's experts: their [n_periods, E,
...] expert leaves are sliced to those experts, and the port's
`expert_ids` leaf names them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensorstore.paged import _torch_from_numpy
from .config import ModelConfig
from .transformer import Params, _device, init_params


EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


def params_from_numpy(cfg: ModelConfig, tree, device=None, *,
                      experts=None) -> Params:
    """The port's parameter tree from a numpy pytree of the reference's
    (on `device`; None means "cuda"), every MoE layer holding `experts`
    (global ids; None: all).  Raises ValueError on any missing or extra
    key, or a leaf of another shape or dtype."""
    dev = _device(device)
    want = init_params(cfg, None, "meta", experts=experts)
    held = np.arange(cfg.n_experts) if experts is None else \
        np.asarray(list(experts))

    def share(ref, got):
        """A reference MoE dict as the port's share of it."""
        got = dict(got)
        for k in EXPERT_LEAVES:
            if k in got:
                got[k] = np.asarray(got[k])[:, held]
        got["expert_ids"] = np.broadcast_to(held.astype(np.int32),
                                            ref["expert_ids"].shape)
        return got

    def carry(ref, got, path):
        if isinstance(ref, dict) and "expert_ids" in ref \
                and isinstance(got, dict) and "expert_ids" not in got:
            got = share(ref, got)
        if isinstance(ref, dict):
            if not isinstance(got, dict) or set(got) != set(ref):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"{path or 'params'}: keys {have} != "
                                 f"{sorted(ref)}")
            return {k: carry(ref[k], got[k], f"{path}/{k}") for k in ref}
        if isinstance(ref, tuple):
            if not isinstance(got, (tuple, list)) or len(got) != len(ref):
                raise ValueError(f"{path}: expected a sequence of "
                                 f"{len(ref)}, got {type(got).__name__}")
            return tuple(carry(r, g, f"{path}[{i}]")
                         for i, (r, g) in enumerate(zip(ref, got)))
        arr = np.asarray(got)
        t = _torch_from_numpy(arr)
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"{path}: {arr.dtype}{list(arr.shape)} != "
                             f"{ref.dtype}{list(ref.shape)}")
        return t.to(dev)

    return carry(want, tree, "")
