"""Tensor-parallel placement of a model over a mesh of ranks: the ported
partition rules (`launch.shardings`) applied to parameter trees, the
batch split over "data", and the collectives of greedy decoding over
vocab-sharded logits.

The serving layout (`serve_specs`) is the Megatron rules of
`launch.shardings` with neither FSDP nor ZeRO-2: query/KV heads and
d_ff over "model" (`wq`/`wk`/`wv`/`w_up`/`w_gate` by columns, `wo`/
`w_down` by rows; a MoE layer's experts each by their d_ff, the router
replicated), Mamba's `d_inner` over "model" (`conv_w`, `dt_proj`,
`dt_bias`, `A_log`, `D` and the rows of `x_proj` and `out_proj` by
channel), the vocabulary over "model" (`embed` by rows, `lm_head` by
columns), RWKV's time mix and channel mix whole (only its vocabulary is
cut), norms replicated, nothing over "data", which splits the batch.
Five placements differ from the reference's.  RWKV6's time mix: the
rules mean to replicate it (its heads are often indivisible), but their
attention patterns match its `wk` and `wv` (cut by columns) and `wo`
(by rows) before its own, so GSPMD cuts those three over "model" (at a
16-way model axis into part-heads, 2.5 of RWKV6-3B's 40) and reshards
around the recurrence; the port keeps every leaf of it whole, so a rank
runs the whole recurrence on its rows and sums nothing
(`models.transformer.REPLICATED`).  The QKV biases, which the rules
replicate, are cut as their products' columns are: a rank adds only
those columns, so it holds only them.  Mamba's `conv_b`,
which the rules replicate (their three-entry spec meets a two-dim leaf
in `sanitize`), is cut with `conv_w`'s channels for the same reason.
Mamba's `in_proj` [D, 2·Di] holds x's Di columns and then z's: the
rules cut it in m contiguous blocks, so at model 4 two ranks would hold
x and two z (GSPMD reshards there); the port cuts each half over
"model" (a `Paired` spec entry), so a rank's piece is [its x columns |
its z columns], the same channels.  And the reference's serving
placement replicates the embedding when a ZeRO-2 shard fits a card
(`launch.specs.params_specs(serving=True)`); the port cuts it, a
quarter of the table a rank at model 4, for one all-reduce of the
embedded prompt (ROADMAP queue 3).

A leaf's piece on a rank: along each dim whose spec names axes, the
dim is cut into as many equal blocks as the axes have ranks together,
and the rank keeps the block of its coordinates on them (row-major in
the spec's order of axes, as GSPMD places a `NamedSharding`); a
`Paired` dim is cut so block by block.

`init_local_params` draws a rank's tree without ever holding the whole
model: `init_params`' own draws, in its order and from the same
generator, each leaf cut to the rank's piece as it is drawn (a stacked
leaf one period at a time), so the rank's tree equals the piece of the
unsharded tree of the same seed, an expert share (`experts=`) too.
`shard_params` and `init_local_params` cut by the serving layout unless
given another {leaf path: spec} tree (the training layout of
`parallel.fsdp`); `gather_piece` puts a leaf back together from the
ranks' pieces.

Refused on a mesh of more than one device (`check_tp`, ValueError):
a model degree that does not divide a dim the layout cuts (GSPMD would
reshard part-heads; the port keeps whole heads on a rank): the
vocabulary, and where the config has such layers the KV heads, d_ff and
Mamba's `d_inner` (RWKV6 has none, so only its vocabulary is checked);
and the encoder-decoder, whose sharded slice comes later (`LATER`).
Training (`check_train`) refuses tensor-parallel training (a "tp"
layout on a model axis of more than one rank, `TRAIN_LATER`), and
nothing else: a dim the mesh does not divide is replicated by
`sanitize`, as the reference places it, and the pod mesh trains
(`parallel.fsdp`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..launch.mesh import Mesh
from ..launch.shardings import param_shardings
from ..models.config import ModelConfig
from ..models.transformer import REPLICATED, init_params
from ..tree import leaves_with_path, path_key, replace_leaves
from .group import piece_index

# the families a mesh of several devices does not run yet, each with its
# later slice
LATER = {
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
    m = mesh.shape["model"]
    for name in cut_dims(cfg):
        n = getattr(cfg, name)
        if n % m:
            raise ValueError(
                f"{where}: a model degree of {m} does not divide {name} "
                f"{n}; GSPMD would cut part-heads or reshard, the port "
                f"keeps whole pieces on a rank ({DEVIATION})")


def cut_dims(cfg: ModelConfig) -> list:
    """The config's dims that the serving layout cuts over "model": the
    vocabulary, the KV heads of its attention layers, the d_ff of its
    dense and MoE MLPs, Mamba's `d_inner`."""
    kinds = {k for spec in cfg.pattern for k in (spec.mixer, spec.mlp)}
    if any(spec.cross_attn for spec in cfg.pattern):
        kinds.add("attn")
    return [name for name, kind in (("n_kv_heads", {"attn"}),
                                    ("d_ff", {"dense", "moe"}),
                                    ("vocab_size", None),
                                    ("mamba_d_inner", {"mamba"}))
            if kind is None or kinds & kind]


def check_train(cfg: ModelConfig, mesh: Mesh) -> None:
    """Raise ValueError where the port does not train `cfg` on `mesh`
    (see the module docstring); nothing on a mesh of one device."""
    if mesh.size == 1:
        return
    where = f"training {cfg.name} on a mesh of {mesh.size} devices " \
            f"{mesh.shape}"
    if cfg.train_sharding != "fsdp2d" and mesh.shape.get("model", 1) > 1:
        raise ValueError(f"{where}: train_sharding "
                         f"{cfg.train_sharding!r} cuts heads and d_ff over "
                         f"a model axis of {mesh.shape['model']}, a later "
                         f"slice ({TRAIN_LATER['tp']})")


@dataclass(frozen=True)
class Paired:
    """A spec entry for a dim of two equal halves side by side, each cut
    over `axis` (an axis name or a tuple of them) on its own: a rank's
    piece is its piece of the first half, then of the second.  Mamba's
    `in_proj` [D, 2·Di] (x's columns, then z's) in the serving layout."""
    axis: object


def serve_specs(mesh: Mesh, cfg: ModelConfig, params) -> dict:
    """{leaf path: spec} of the serving layout (module docstring) over a
    tree shaped like `params` (a "meta" tree will do)."""
    tp = cfg.with_overrides(train_sharding="tp", fsdp=False, zero2=False)
    specs = param_shardings(mesh, tp, params)
    for path, spec in specs.items():
        head, _, name = path.rpartition("/")
        parts = path.split("/")
        if parts[0] == "blocks" and parts[2] in ("mixer", "mlp") and \
                getattr(cfg.pattern[int(parts[1])], parts[2]) in REPLICATED:
            specs[path] = (None,) * len(spec)   # RWKV's mixes whole
        elif name in ("bq", "bk", "bv"):        # as w[qkv]'s columns
            specs[path] = spec[:-1] + (specs[f"{head}/w{name[1]}"][-1],)
        elif name == "conv_b":                  # as conv_w's channels
            specs[path] = spec[:-1] + (specs[f"{head}/conv_w"][-1],)
        elif name == "in_proj" and spec[-1] is not None:
            specs[path] = spec[:-1] + (Paired(spec[-1]),)
    return specs


def _axes(entry) -> tuple:
    """The axes a spec entry cuts its dim over, and the dim's blocks (2
    for `Paired`, else 1), each cut over them."""
    parts = 2 if isinstance(entry, Paired) else 1
    axis = entry.axis if parts > 1 else entry
    return (axis if isinstance(axis, tuple) else (axis,)), parts


def local_slice(t: torch.Tensor, spec: tuple, mesh: Mesh,
                coords: dict) -> torch.Tensor:
    """The piece of `t` under `spec` on the rank at `coords` (a copy, so
    the whole leaf can be freed)."""
    piece = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes, parts = _axes(entry)
        n = math.prod(mesh.shape[a] for a in axes)
        idx = piece_index(coords, axes, mesh)
        if t.shape[dim] % (parts * n):
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not cut "
                             f"into {parts * n} pieces ({spec})")
        size = t.shape[dim] // (parts * n)
        cut = [block.narrow(dim, idx * size, size)
               for block in piece.chunk(parts, dim)]
        piece = cut[0] if parts == 1 else torch.cat(cut, dim)
    return piece if piece is t else piece.contiguous().clone()


def gather_piece(x: torch.Tensor, spec: tuple, group) -> torch.Tensor:
    """The whole leaf from the ranks' pieces `x` under `spec` (every
    rank calls it and gets the whole leaf); `x` itself where nothing is
    cut."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes, parts = _axes(entry)
        pieces = group.all_gather(x, axes, dim=dim)
        if parts > 1:     # [rank 0's halves | rank 1's | ...] -> halves
            ranks = pieces.chunk(pieces.shape[dim] // x.shape[dim], dim)
            halves = [r.chunk(parts, dim) for r in ranks]
            pieces = torch.cat([h[j] for j in range(parts)
                                for h in halves], dim)
        x = pieces
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
                      specs: dict = None, *, experts=None):
    """The rank at `coords`' tree of `init_params(cfg, generator,
    device, experts=experts)` (equal to `shard_params` of it under the
    same `specs`, the serving layout by default), drawn without holding
    the whole model (module docstring)."""
    if specs is None:
        check_tp(cfg, mesh)
        specs = serve_specs(mesh, cfg, init_params(cfg, None, "meta",
                                                   experts=experts))

    def piece(path: str, t: torch.Tensor) -> torch.Tensor:
        spec = specs[path]
        if path.startswith(("blocks", "enc_blocks")):
            spec = spec[1:]              # one period of a stacked leaf
        return local_slice(t, spec, mesh, coords)

    return init_params(cfg, generator, device, experts=experts,
                       piece=piece)


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
