"""Tensor-parallel placement of a model over a mesh of ranks: the ported
partition rules (`launch.shardings`) applied to parameter trees, the
batch split over "data", and the collectives of greedy decoding over
vocab-sharded logits.

The serving layout (`serve_specs`) is the Megatron rules of
`launch.shardings` with neither FSDP nor ZeRO-2: query/KV heads and
d_ff over "model" (`wq`/`wk`/`wv`/`w_up`/`w_gate` by columns, `wo`/
`w_down` by rows), the vocabulary over "model" (`embed` by rows,
`lm_head` by columns), norms replicated, nothing over "data", which
splits the batch.  Two placements differ from the reference's.  The
QKV biases, which the rules replicate, are cut as their products'
columns are: a rank adds only those columns, so it holds only them.
And the reference's serving placement replicates the embedding when a
ZeRO-2 shard fits a card (`launch.specs.params_specs(serving=True)`);
the port cuts it, a quarter of the table a rank at model 4, for one
all-reduce of the embedded prompt (ROADMAP queue 3).

A leaf's piece on a rank: along each dim whose spec names axes, the
dim is cut into as many equal blocks as the axes have ranks together,
and the rank keeps the block of its coordinates on them (row-major in
the spec's order of axes, as GSPMD places a `NamedSharding`).

`init_local_params` draws a rank's tree without ever holding the whole
model: `init_params`' own draws, in its order and from the same
generator, each leaf cut to the rank's piece as it is drawn (a stacked
leaf one period at a time), so the rank's tree equals the piece of the
unsharded tree of the same seed.  `shard_params` and `init_local_params`
cut by the serving layout unless given another {leaf path: spec} tree
(the training layout of `parallel.fsdp`); `gather_piece` puts a leaf
back together from the ranks' pieces.

Refused on a mesh of more than one device (`check_tp`, ValueError):
a model degree that does not divide the KV heads (GSPMD would reshard
part-heads; the port keeps whole heads on a rank), d_ff or the
vocabulary; and the families whose sharded slices come later (Mamba,
MoE, RWKV, encoder-decoder: `LATER`).  Training (`check_train`) refuses
tensor-parallel training (a "tp" layout on a model axis of more than one
rank) and a mesh with a "pod" axis (`TRAIN_LATER`), and nothing else: a
dim the mesh does not divide is replicated by `sanitize`, as the
reference places it.
"""

from __future__ import annotations

import math

import torch

from ..launch.mesh import Mesh
from ..launch.shardings import param_shardings
from ..models.config import ModelConfig
from ..models.transformer import init_params
from ..tree import leaves_with_path, path_key, replace_leaves

# the families a mesh of several devices does not run yet, each with its
# later slice
LATER = {
    "mamba": 'ROADMAP queue 1, "Sharded Mamba" (d_inner over model)',
    "rwkv": 'ROADMAP queue 1, "Sharded RWKV" (the replicated mixer)',
    "moe": 'ROADMAP queue 1, "Sharded MoE" (the experts\' d_ff over model)',
    "encdec": 'ROADMAP queue 1, "Sharded Whisper" (the encoder and '
              'cross-attention)',
}
DEVIATION = 'ROADMAP queue 3, "Whole heads on a rank"'
# the training placements a mesh does not run yet, each with its later
# slice
TRAIN_LATER = {
    "tp": 'ROADMAP queue 1, "Tensor-parallel training" (train_sharding '
          '"tp" at model > 1, Whisper\'s encoder and cross-attention '
          'with it)',
    "pod": 'ROADMAP queue 1, "Training on a pod mesh" (the batch over '
           '(pod, data) while fsdp2d cuts the weights over (data, '
           'model))',
}


def check_tp(cfg: ModelConfig, mesh: Mesh) -> None:
    """Raise ValueError where the port does not run `cfg` on `mesh` (see
    the module docstring); nothing on a mesh of one device."""
    if mesh.size == 1:
        return
    where = f"{cfg.name} on a mesh of {mesh.size} devices {mesh.shape}"
    if cfg.is_encoder_decoder:
        raise ValueError(f"{where}: an encoder-decoder is a later slice "
                         f"({LATER['encdec']})")
    for spec in cfg.pattern:
        for kind in (spec.mixer, spec.mlp):
            if kind in LATER:
                raise ValueError(f"{where}: {kind} layers are a later "
                                 f"slice ({LATER[kind]})")
    m = mesh.shape["model"]
    for name in ("n_kv_heads", "d_ff", "vocab_size"):
        n = getattr(cfg, name)
        if n % m:
            raise ValueError(
                f"{where}: a model degree of {m} does not divide {name} "
                f"{n}; GSPMD would cut part-heads or reshard, the port "
                f"keeps whole pieces on a rank ({DEVIATION})")


def check_train(cfg: ModelConfig, mesh: Mesh) -> None:
    """Raise ValueError where the port does not train `cfg` on `mesh`
    (see the module docstring); nothing on a mesh of one device."""
    if mesh.size == 1:
        return
    where = f"training {cfg.name} on a mesh of {mesh.size} devices " \
            f"{mesh.shape}"
    if "pod" in mesh.axis_names:
        raise ValueError(f"{where}: a pod axis is a later slice "
                         f"({TRAIN_LATER['pod']})")
    if cfg.train_sharding != "fsdp2d" and mesh.shape.get("model", 1) > 1:
        raise ValueError(f"{where}: train_sharding "
                         f"{cfg.train_sharding!r} cuts heads and d_ff over "
                         f"a model axis of {mesh.shape['model']}, a later "
                         f"slice ({TRAIN_LATER['tp']})")


def serve_specs(mesh: Mesh, cfg: ModelConfig, params) -> dict:
    """{leaf path: spec} of the serving layout (module docstring) over a
    tree shaped like `params` (a "meta" tree will do)."""
    tp = cfg.with_overrides(train_sharding="tp", fsdp=False, zero2=False)
    specs = param_shardings(mesh, tp, params)
    for path, spec in specs.items():
        head, _, name = path.rpartition("/")
        if name in ("bq", "bk", "bv"):          # as w[qkv]'s columns
            specs[path] = spec[:-1] + (specs[f"{head}/w{name[1]}"][-1],)
    return specs


def local_slice(t: torch.Tensor, spec: tuple, mesh: Mesh,
                coords: dict) -> torch.Tensor:
    """The piece of `t` under `spec` on the rank at `coords` (a copy, so
    the whole leaf can be freed)."""
    piece = t
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not cut "
                             f"into {n} pieces ({spec})")
        size = t.shape[dim] // n
        piece = piece.narrow(dim, idx * size, size)
    return piece if piece is t else piece.contiguous().clone()


def gather_piece(x: torch.Tensor, spec: tuple, group) -> torch.Tensor:
    """The whole leaf from the ranks' pieces `x` under `spec` (every
    rank calls it and gets the whole leaf); `x` itself where nothing is
    cut."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = group.all_gather(x, axis if isinstance(axis, tuple)
                                 else (axis,), dim=dim)
    return x


def shard_params(cfg: ModelConfig, params, mesh: Mesh, coords: dict,
                 specs: dict = None):
    """The rank at `coords`' tree of `params` (a whole tree) under
    `specs` ({leaf path: spec}), the serving layout by default."""
    if specs is None:
        check_tp(cfg, mesh)
        specs = serve_specs(mesh, cfg, params)
    return replace_leaves(params, {
        p: local_slice(t, specs[path_key(p)], mesh, coords)
        for p, t in leaves_with_path(params)})


def init_local_params(cfg: ModelConfig, generator: torch.Generator,
                      mesh: Mesh, coords: dict, device=None,
                      specs: dict = None):
    """The rank at `coords`' tree of `init_params(cfg, generator,
    device)` (equal to `shard_params` of it under the same `specs`, the
    serving layout by default), drawn without holding the whole model
    (module docstring)."""
    if specs is None:
        check_tp(cfg, mesh)
        specs = serve_specs(mesh, cfg, init_params(cfg, None, "meta"))

    def piece(path: str, t: torch.Tensor) -> torch.Tensor:
        spec = specs[path]
        if path.startswith(("blocks", "enc_blocks")):
            spec = spec[1:]              # one period of a stacked leaf
        return local_slice(t, spec, mesh, coords)

    return init_params(cfg, generator, device, piece=piece)


def _batch_dim(key: str, x: torch.Tensor):
    """The batch dim of a serving input (`launch.shardings
    .batch_shardings`): 1 of `mrope_positions` [3,B,S], none of 1-D
    `positions` [S], else 0."""
    if key == "mrope_positions":
        return 1
    if key == "positions" and x.dim() == 1:
        return None
    return 0


def split_batch(batch: dict, group) -> dict:
    """The rank's rows of every input of `batch` over "data"."""
    n, r = group.data_size, group.data_rank
    out = {}
    for k, x in batch.items():
        dim = _batch_dim(k, x)
        if dim is None or n == 1:
            out[k] = x
            continue
        if x.shape[dim] % n:
            raise ValueError(f"{k} {tuple(x.shape)}: a batch of "
                             f"{x.shape[dim]} over a data axis of {n}")
        b = x.shape[dim] // n
        out[k] = x.narrow(dim, r * b, b)
    return out


def gather_vocab(logits: torch.Tensor, group) -> torch.Tensor:
    """Vocab-sharded logits [..., V / model] as the whole [..., V]."""
    return group.all_gather(logits, "model", dim=-1)


def greedy(logits: torch.Tensor, group) -> torch.Tensor:
    """`logits.argmax(-1)` over the whole vocabulary of vocab-sharded
    logits [B, V / model], as global token ids [B]: each rank's (max,
    global index) gathered over "model", the lowest index among equal
    maxima kept, as `torch.argmax` keeps the first."""
    idx = logits.argmax(dim=-1)
    if group is None or group.model_size == 1:
        return idx
    best = logits.gather(-1, idx[:, None])[:, 0]
    gidx = idx + group.model_rank * logits.shape[-1]
    pair = torch.stack([best.double(), gidx.double()], dim=0)     # [2, B]
    every = group.all_gather(pair[None], "model", dim=0)       # [m, 2, B]
    vals, ids = every[:, 0], every[:, 1]
    top = vals.max(dim=0).values
    ids = torch.where(vals == top, ids, math.inf)
    return ids.min(dim=0).values.to(idx.dtype)
