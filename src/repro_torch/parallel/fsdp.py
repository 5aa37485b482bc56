"""Sharded training over a mesh of ranks: the reference's training
placements (`launch.shardings.param_shardings` / `opt_shardings` /
`launch.mesh.train_dp_axes`) run with torch.distributed, one process a
rank.

The reference jits its train step over a mesh and lets GSPMD place it;
a GSPMD program equals its unsharded program, so the port's sharded step
gives the unsharded step's loss, `grad_norm` and, once the pieces are
gathered, its parameters and moments.  The placement is a *storage*
layout:

- a rank keeps its piece of each parameter, moment and error-feedback
  leaf (`TrainSpecs.state`, the spec tree of `launch.specs.state_specs`);
- before a layer's compute it all-gathers that layer's whole weights
  (`Gather`, called by the model stack through `models.sharding
  .gatherer`): the top-level leaves once a microbatch, a period's leaves
  inside the period's remat, one collective for every leaf cut over the
  same axes;
- each rank computes whole layers on its rows of the batch: its rows of
  every microbatch (`Layout.rows`, over the batch axes `train_dp_axes`),
  every rank in every microbatch; ranks that differ only on axes that do
  not cut the batch compute the same rows;
- in the backward, `Gather` sums the whole gradient over the batch ranks
  in f32 whatever the leaf's dtype (the reference widens its summed
  gradients to f32 before AdamW) and keeps the rank's piece under the
  optimizer's spec, each rank's rows counted once (`Layout._reduce`):
  where the leaf is cut (on one dim), the rank takes the blocks of its
  own coordinates on the cut axes that do not cut the batch,
  reduce-scatters them over the cut axes that do and all-reduces its
  piece over the batch axes that do not cut the leaf; where it is whole
  (fsdp2d's `embed` and `lm_head`, a leaf `sanitize` left whole) it is
  all-reduced over the batch axes;
- AdamW updates the pieces (`optim.adamw.update(..., layout=)`), its
  global norm the pieces' squared sums all-reduced with each piece
  counted once, its int8 compression scaled by the whole leaf's max.

This covers fsdp2d ("model" folded into the batch axes on a (data,
model) mesh) and the "tp" placement on a mesh whose model axis is 1:
FSDP over "data" with `fsdp=True`, ZeRO-2 with `zero2=True` (parameters
replicated, moments and gradients cut over "data", each updated piece
all-gathered back into the replicated parameter) and plain data
parallelism (Whisper-tiny's).  On the reference's pod mesh ("pod",
"data", "model") the batch goes over ("pod", "data") alone while fsdp2d
cuts every weight over ("data", "model") (`launch.mesh.train_dp_axes`,
`launch.shardings`): a weight's gradient is reduce-scattered over
"data" from the blocks of the rank's "model" coordinate and all-reduced
over "pod", so the pod replicas hold equal pieces, bit for bit, after
every step; FSDP and ZeRO-2 there are hybrid sharded (cut over "data",
summed over "pod" too).  `parallel.tensor.check_train` refuses the
rest.

Serving reads the same pieces (`ServeView`, with no optimizer state): a
`serve.ServingEngine(group=, specs=)` over a store of the rank's pieces
of every version (the versions `Trainer(group=)` publishes, or a model
placed by the training placement that `launch.specs.params_specs(
serving=True)` falls back on) gathers one layer's whole weights just
before the layer runs and computes whole layers on the rank's rows, as
GSPMD regathers a training placement inside the reference's jitted
prefill and decode.  `Layout` and `ServeView` share `Placement`: the
specs, the gather and the row cut.

`init_local_state` draws a rank's state without holding the whole model
(equal to `shard_state` of `train.step.init_state` of the same seed);
`shard_state` / `gather_state` cut a whole state into the rank's pieces
and put it back together.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.config import resolve_device
from ..launch.mesh import Mesh, train_dp_axes
from ..launch.shardings import opt_shardings, param_shardings
from ..models.config import ModelConfig
from ..models.transformer import init_params
from ..optim import adamw
from ..tree import leaves_with_path, path_key, replace_leaves
from .group import piece_index
from .tensor import (_batch_dim, check_train, gather_piece,
                     init_local_params, local_slice)

# the batch cut's one rule the reference does not have
ROWS_ITEM = 'ROADMAP queue 3, "Every rank in every microbatch"'


class TrainSpecs(NamedTuple):
    """{state leaf path: spec} ("params/...", "opt/m/...", "opt/v/...",
    "opt/ef/...", "opt/count", "step") and the axes that cut the batch."""
    state: dict
    batch: tuple


def train_specs(mesh: Mesh, cfg: ModelConfig, params, opt) -> TrainSpecs:
    """The reference's training placement over trees shaped like
    `params` and `opt` ("meta" trees will do)."""
    specs = {f"params/{p}": s
             for p, s in param_shardings(mesh, cfg, params).items()}
    specs.update({f"opt/{p}": s
                  for p, s in opt_shardings(mesh, cfg, opt, params).items()})
    specs["step"] = ()
    return TrainSpecs(specs, train_dp_axes(mesh, cfg))


def _cuts(spec: tuple, mesh: Mesh) -> list:
    """[(dim, axes)] of the dims `spec` cuts, axes of one rank left out."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = tuple(a for a in (axis if isinstance(axis, tuple)
                                 else (axis,)) if mesh.shape[a] > 1)
        if axes:
            out.append((dim, axes))
    return out


def piece_shape(shape: tuple, spec: tuple, mesh: Mesh) -> tuple:
    """The shape of a rank's piece of a leaf of `shape` under `spec`."""
    out = list(shape)
    for dim, axes in _cuts(spec, mesh):
        out[dim] //= math.prod(mesh.shape[a] for a in axes)
    return tuple(out)


class Gather(torch.autograd.Function):
    """Forward: the whole leaves of a rank's pieces (`Layout._gather`).
    Backward: the whole gradients summed over the batch ranks in f32,
    the rank's pieces kept in the layout (`Layout._reduce`, read by
    `Layout.take_grads`); the pieces themselves get no gradient, so an
    f32 sum is never rounded back to a bf16 leaf's dtype."""

    @staticmethod
    def forward(ctx, layout, keys, period, *pieces):
        ctx.layout, ctx.keys, ctx.period = layout, keys, period
        ctx.trained = [x.is_floating_point() for x in pieces]
        layout.gathers += 1
        out = layout._gather(keys, period is not None, pieces)
        ctx.mark_non_differentiable(*[o for o, t in zip(out, ctx.trained)
                                      if not t])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        layout = ctx.layout
        layout.reduce_scatters += 1
        layout._reduce([k for k, t in zip(ctx.keys, ctx.trained) if t],
                       ctx.period,
                       [g for g, t in zip(grads, ctx.trained) if t])
        return (None, None, None) + (None,) * len(grads)


def _flatten(units: dict):
    """The leaves of {prefix: subtree}: their (prefix, path) pairs, their
    state keys and the leaves, in one order."""
    paths, keys, pieces = [], [], []
    for prefix, tree in units.items():
        for p, x in leaves_with_path(tree):
            paths.append((prefix, p))
            keys.append(path_key((prefix, *p)))
            pieces.append(x)
    return paths, keys, pieces


def _rebuild(units: dict, paths: list, whole) -> dict:
    """`units` with each leaf replaced by its whole leaf from `whole`."""
    out = {}
    for prefix, tree in units.items():
        got = {p: w for (q, p), w in zip(paths, whole) if q == prefix}
        out[prefix] = got[()] if () in got else replace_leaves(tree, got)
    return out


class Placement:
    """A rank's pieces under a placement `parallel.fsdp` stores: its
    `MeshGroup`, the specs of its pieces (`TrainSpecs`: {state leaf path:
    spec}, the parameters' under "params/...", and the batch axes), the
    count of its gathers, the gather of whole leaves from the ranks'
    pieces (`_gather`) and the cut of a global batch to the rank's rows
    (`rows`).  `Layout` trains on it, `ServeView` serves from it;
    `models.sharding.with_mesh` runs the model stack on either.  Refuses
    what `check_train` refuses."""
    gathers_pieces = True
    trains = False

    def __init__(self, group, cfg: ModelConfig, specs: TrainSpecs,
                 shapes: dict):
        check_train(cfg, group.mesh)
        self.group, self.cfg, self.mesh = group, cfg, group.mesh
        self.specs, self._shapes = specs, shapes
        # the batch axes of more than one rank
        self._batch = tuple(a for a in specs.batch
                            if self.mesh.shape.get(a, 1) > 1)
        self.batch_size = math.prod(self.mesh.shape[a] for a in self._batch)
        self.batch_rank = piece_index(group.coords, self._batch, self.mesh)
        self.gathers = 0

    @property
    def batch_axes(self) -> tuple:
        """The axes of more than one rank that cut the batch."""
        return self._batch

    # ----------------------------------------------------------- specs
    def spec(self, key: str, stacked: bool = False) -> tuple:
        """The spec of state leaf `key`; `stacked`: of one period."""
        spec = self.specs.state[key]
        return spec[1:] if stacked else spec

    def piece_shape(self, key: str) -> tuple:
        """The shape of this rank's piece of state leaf `key`."""
        return piece_shape(self._shapes[key], self.spec(key), self.mesh)

    def _cut(self, spec: tuple):
        """(dim, axes) of the one dim `spec` cuts, None for a whole leaf.
        The placements the port stores cut a leaf on one dim at most
        (module docstring); ValueError otherwise."""
        cuts = _cuts(spec, self.mesh)
        if not cuts:
            return None
        if len(cuts) > 1:
            raise ValueError(f"a leaf cut {spec} on mesh {self.mesh.shape}:"
                             f" the port cuts one dim")
        return cuts[0]

    def _pieces(self, axes: tuple) -> int:
        """The number of pieces a dim cut over `axes` has."""
        return math.prod(self.mesh.shape[a] for a in axes)

    def _gather(self, keys, stacked, pieces) -> list:
        out = list(pieces)
        buckets: dict = {}
        for i, (key, x) in enumerate(zip(keys, pieces)):
            cut = self._cut(self.spec(f"params/{key}", stacked))
            if cut is not None:
                buckets.setdefault((cut[1], x.dtype), []).append((i, cut[0]))
        for (axes, _), members in buckets.items():
            flat = torch.cat([pieces[i].reshape(-1) for i, _ in members])
            every = self.group.all_gather(flat, axes).view(
                self._pieces(axes), -1)
            off = 0
            for i, dim in members:
                x = pieces[i]
                p = every[:, off:off + x.numel()].reshape(-1, *x.shape)
                out[i] = p.movedim(0, dim).flatten(dim, dim + 1)
                off += x.numel()
        return out

    # --------------------------------------------------------- the batch
    def rows(self, batch: dict, microbatches: int = 1) -> dict:
        """The rank's rows of a global batch: each of the `microbatches`
        contiguous blocks of rows (the reference's split) cut over the
        batch ranks in piece order, the rank's rows of the blocks in
        block order (so the step's split of them gives its rows of each
        block).  ValueError where the ranks do not divide a block."""
        A, n, r = max(microbatches, 1), self.batch_size, self.batch_rank
        out = {}
        for k, x in batch.items():
            dim = _batch_dim(k, x)
            if dim is None or n == 1:
                out[k] = x
                continue
            B = x.shape[dim]
            if B % A or (B // A) % n:
                raise ValueError(
                    f"{k} {tuple(x.shape)}: {A} microbatches of {B / A:g} "
                    f"rows over {n} batch ranks {self._batch}; the port "
                    f"runs every rank in every microbatch ({ROWS_ITEM})")
            out[k] = x.unflatten(dim, (A, n, B // A // n)).select(
                dim + 1, r).flatten(dim, dim + 1).contiguous()
        return out


class Layout(Placement):
    """A rank's training placement: its `MeshGroup`, the specs of its
    pieces (`train_specs` of `cfg` and `opt_cfg`), and the counts of its
    gathers and reduce-scatters (`Gather` calls, forward and backward;
    the step reads them).  `models.sharding.with_mesh(layout)` runs the
    model stack on it."""
    trains = True

    def __init__(self, group, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
        self.opt_cfg = opt_cfg
        meta = init_params(cfg, None, "meta")
        self.meta = {"params": meta, "opt": adamw.init(meta, opt_cfg)}
        super().__init__(group, cfg,
                         train_specs(group.mesh, cfg, meta, self.meta["opt"]),
                         {path_key(p): tuple(x.shape)
                          for p, x in leaves_with_path(self.meta)})
        self.reduce_scatters = 0
        self._grads: dict = {}

    @property
    def param_specs(self) -> dict:
        """{parameter leaf path: spec}: the placement of the parameters
        alone (what `Trainer(group=)` publishes under, and what
        `ServingEngine(group=, specs=)` serves)."""
        return {k.removeprefix("params/"): s
                for k, s in self.specs.state.items()
                if k.startswith("params/")}

    # ------------------------------------------------------- the model
    def gather(self, units: dict, period=None) -> dict:
        """{prefix: subtree of pieces} as whole leaves, one `Gather`
        (`period`: the index of the period of stacked leaves the pieces
        are, None for unstacked leaves)."""
        paths, keys, pieces = _flatten(units)
        return _rebuild(units, paths,
                        Gather.apply(self, tuple(keys), period, *pieces))

    def _reduce(self, keys, period, grads) -> None:
        """Each whole gradient summed over the batch ranks in f32, each
        rank's rows counted once, the rank's piece under the optimizer's
        spec added to `_grads` (at `period` of a stacked leaf).  A cut
        leaf's pieces: the blocks of the rank's own coordinates on the cut
        axes that do not cut the batch (its peers there computed the same
        rows, so hold the same gradient), reduce-scattered over the cut
        axes that do, all-reduced over the batch axes that do not cut the
        leaf (on the pod mesh under fsdp2d: "model", "data", "pod")."""
        whole, buckets = [], {}
        for key, g in zip(keys, grads):
            cut = self._cut(self.spec(f"opt/m/{key}", period is not None))
            g = g.float()
            if cut is None:
                whole.append((key, g))
                continue
            dim, axes = cut
            n = self._pieces(axes)
            # [n, the piece's elements]: row k is piece k
            rows = g.unflatten(dim, (n, -1)).movedim(dim, 0).reshape(n, -1)
            buckets.setdefault(axes, []).append((key, g, dim, rows))
        for axes, members in buckets.items():
            flat = torch.cat([rows for *_, rows in members], dim=1)
            # rows by coordinate on each cut axis; keep the rank's own on
            # the axes that do not cut the batch (last first, so the
            # earlier dims keep their places)
            flat = flat.view(*(self.mesh.shape[a] for a in axes), -1)
            for i in reversed(range(len(axes))):
                if axes[i] not in self._batch:
                    flat = flat.select(i, self.group.coords[axes[i]])
            summed = tuple(a for a in axes if a in self._batch)
            flat = flat.reshape(-1, flat.shape[-1])
            mine = self.group.reduce_scatter(flat, summed, dim=0)[0] \
                if summed else flat[0]
            self.group.all_reduce(mine, tuple(a for a in self._batch
                                              if a not in axes))
            off = 0
            for key, g, dim, rows in members:
                shape = list(g.shape)
                shape[dim] //= self._pieces(axes)
                self._add(key, period,
                          mine[off:off + rows.shape[1]].view(shape))
                off += rows.shape[1]
        if whole:
            flat = torch.cat([g.reshape(-1) for _, g in whole])
            self.group.all_reduce(flat, self._batch)
            off = 0
            for key, g in whole:
                self._add(key, period,
                          flat[off:off + g.numel()].view(g.shape))
                off += g.numel()

    def _add(self, key: str, period, g: torch.Tensor) -> None:
        got = self._grads.setdefault(key, {})
        got[period] = g if period not in got else got[period] + g

    def take_grads(self) -> dict:
        """{leaf path: the rank's f32 gradient piece} since the last
        call, a stacked leaf's periods stacked."""
        out = {}
        for key, got in self._grads.items():
            if None in got:
                out[key] = got[None]
                continue
            if sorted(got) != list(range(len(got))):
                raise RuntimeError(f"{key}: gradients of periods "
                                   f"{sorted(got)}")
            out[key] = torch.stack([got[i] for i in range(len(got))])
        self._grads = {}
        return out

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`x` (no gradient) summed over the batch ranks, a new tensor."""
        return self.group.all_reduce(x.detach().clone(), self._batch)

    # -------------------------------------------------------- the optimizer
    def norm_weight(self, key: str) -> float:
        """1 where this rank is the first of the ranks that hold the same
        piece of gradient leaf `key` (its coordinate 0 on every axis that
        does not cut it), else 0: summed over the mesh, each piece counts
        once."""
        cut = self._cut(self.spec(f"opt/m/{key}"))
        axes = () if cut is None else cut[1]
        return float(all(c == 0 for a, c in self.group.coords.items()
                         if a not in axes))

    def mesh_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.all_reduce(x, "mesh")

    def mesh_max(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.all_reduce(x, "mesh", op="max")

    def param_in(self, key: str, p: torch.Tensor) -> torch.Tensor:
        """The piece of parameter `p` that AdamW updates beside the
        moments' pieces: `p` itself, or under ZeRO-2 (a whole parameter,
        cut moments) its slice under the moments' spec."""
        pspec, mspec = self.spec(f"params/{key}"), self.spec(f"opt/m/{key}")
        pcut, mcut = self._cut(pspec), self._cut(mspec)
        if pcut == mcut:
            return p
        if pcut is not None:
            raise ValueError(f"{key}: parameter cut {pspec}, moments "
                             f"{mspec}; the port updates a piece of a whole "
                             f"parameter only")
        return local_slice(p, mspec, self.mesh, self.group.coords)

    def param_out(self, key: str, p: torch.Tensor) -> torch.Tensor:
        """The updated piece of `param_in` back in the parameter's
        layout (under ZeRO-2 all-gathered into the whole parameter)."""
        pspec, mspec = self.spec(f"params/{key}"), self.spec(f"opt/m/{key}")
        if self._cut(pspec) == self._cut(mspec):
            return p
        return gather_piece(p, mspec, self.group)


class ServeView(Placement):
    """A rank's serving view of a placement that `parallel.fsdp` stores
    (fsdp2d, FSDP, ZeRO-2, data parallel): its `MeshGroup`, the config
    and the {parameter leaf path: spec} of its pieces, with no optimizer
    config and no moments.  `models.sharding.with_mesh(view)` serves on
    it: the model stack asks `gather` for the top-level leaves once a
    prefill or decode call and for ONE layer's leaves just before that
    layer runs, so a rank holds its pieces and one layer's whole weights
    at a time, and computes whole layers on its rows of the batch
    (`rows`, over the placement's batch axes).  It keeps no autograd
    state: `gather` is `_gather`'s all-gather alone (no `Gather` node, no
    gradient sink, no reduce-scatter).

    Refused (ValueError): what `check_train` refuses ("tp" at model >
    1), a spec tree whose paths are not the parameter tree's or that
    cuts a leaf on more than one dim; `check` refuses pinned pieces
    whose shapes are not the specs' pieces, naming the leaf."""

    def __init__(self, group, cfg: ModelConfig, specs: dict):
        check_train(cfg, group.mesh)
        meta = init_params(cfg, None, "meta")
        shapes = {f"params/{path_key(p)}": tuple(x.shape)
                  for p, x in leaves_with_path(meta)}
        state = {f"params/{k}": tuple(s) for k, s in specs.items()}
        if set(state) != set(shapes):
            raise ValueError(
                f"specs of {cfg.name}: {sorted(set(state) - set(shapes))} "
                f"are not leaves of its parameter tree, "
                f"{sorted(set(shapes) - set(state))} have no spec")
        super().__init__(group, cfg,
                         TrainSpecs(state, train_dp_axes(group.mesh, cfg)),
                         shapes)
        for key, spec in state.items():
            if any(e is not None and not isinstance(e, (str, tuple))
                   for e in spec):
                raise ValueError(f"{key}: spec {spec} is not a placement "
                                 f"parallel.fsdp stores")
            self._cut(spec)

    def check(self, params) -> None:
        """Raise ValueError, naming the leaf, where `params` is not this
        rank's pieces of the config's parameter tree under the specs."""
        seen = set()
        for p, x in leaves_with_path(params):
            key = f"params/{path_key(p)}"
            if key not in self._shapes:
                raise ValueError(f"pinned leaf {path_key(p)} is not in "
                                 f"{self.cfg.name}'s parameter tree")
            want = self.piece_shape(key)
            if tuple(x.shape) != want:
                raise ValueError(
                    f"pinned leaf {path_key(p)} is {tuple(x.shape)}: its "
                    f"piece under spec {self.spec(key)} on mesh "
                    f"{self.mesh.shape} is {want}")
            seen.add(key)
        if seen != set(self._shapes):
            raise ValueError(f"pinned tree lacks leaves "
                             f"{sorted(set(self._shapes) - seen)}")

    def gather(self, units: dict, period=None) -> dict:
        """{prefix: subtree of pieces} as whole leaves, one collective for
        each set of axes and dtype (`period`: the index of the period of
        stacked leaves the pieces are, None for unstacked leaves)."""
        self.gathers += 1
        paths, keys, pieces = _flatten(units)
        return _rebuild(units, paths,
                        self._gather(keys, period is not None, pieces))


def rank_device(group, device=None) -> torch.device:
    """The group's device, or `device` where they agree (ValueError
    otherwise); a card raises without a GPU."""
    dev = resolve_device(group.device if device is None else device)
    if dev.type == group.device.type and dev.index is None:
        dev = group.device
    if dev != group.device:
        raise ValueError(f"rank {group.rank} is on {group.device}, the "
                         f"state asked for on {dev}")
    return dev


def init_local_state(cfg: ModelConfig, generator: torch.Generator, group,
                     opt_cfg: adamw.AdamWConfig = None, device=None) -> dict:
    """This rank's pieces of `train.step.init_state(generator, cfg,
    opt_cfg)`: the parameters drawn as `init_params` draws them, each
    leaf cut as it is drawn (`parallel.tensor.init_local_params`), zero
    moment pieces and step; on the group's device."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(moment_dtype=cfg.moment_dtype)
    layout = Layout(group, cfg, opt_cfg)
    dev = rank_device(group, device)
    params = init_local_params(cfg, generator, group.mesh, group.coords,
                               dev, specs=layout.param_specs)
    opt = replace_leaves(layout.meta["opt"], {
        p: torch.zeros(layout.piece_shape(f"opt/{path_key(p)}"),
                       dtype=x.dtype, device=dev)
        for p, x in leaves_with_path(layout.meta["opt"])})
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def shard_state(state: dict, layout: Layout) -> dict:
    """The rank's pieces of a whole state."""
    return replace_leaves(state, {
        p: local_slice(x, layout.spec(path_key(p)), layout.mesh,
                       layout.group.coords)
        for p, x in leaves_with_path(state)})


def gather_state(state: dict, layout: Layout) -> dict:
    """The whole state from the ranks' pieces (every rank calls it and
    gets the whole state)."""
    return replace_leaves(state, {
        p: gather_piece(x, layout.spec(path_key(p)), layout.group)
        for p, x in leaves_with_path(state)})
