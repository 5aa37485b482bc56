"""Sharded execution of the model stack over a mesh of ranks, the port of
`repro.models.sharding`'s hints.

The reference's model code calls `hint(x, "data", None, "model")`-style
constraints that GSPMD turns into shardings under `with_mesh(mesh)`;
where a hint asks for a replicated value that a row-parallel product
left as partial sums (the mixer's and the MLP's outputs, the embedding
of a vocab-sharded table: `repro.models.transformer`, "2 collectives /
layer, Megatron minimum"), GSPMD puts an all-reduce.  The port places
explicitly: under `with_mesh(group)` (this rank's
`parallel.MeshGroup`) each rank holds its pieces of the weights
(`parallel.tensor.shard_params`), and the model stack calls `psum`
where the reference's hint makes GSPMD reduce, summing the bf16 (or
f32) partial outputs over the "model" axis.  `model_index()` gives the
rank's piece of that axis, for the rows of a vocab-sharded embedding.

Training on a mesh (`with_mesh(layout)`, this rank's
`parallel.fsdp.Layout`) runs no tensor parallelism: under fsdp2d "model"
is a batch axis, and every weight is whole once gathered.  There `psum`
and `model_index` are the identity, `gatherer` hands the model stack
the whole leaves of its pieces (the layout's `Gather`: all-gathered in
the forward, the gradient reduce-scattered into the piece in the
backward), and `batch_sum` sums a count over the batch ranks (the loss's
masked positions of the global batch).

Serving a training placement (`with_mesh(view)`, this rank's
`parallel.fsdp.ServeView`) runs no tensor parallelism either: `psum`
and `model_index` are the identity (every weight is whole once gathered,
so the caches hold every head and channel and the embedding is looked
up in the whole table), and `gatherer` hands the model stack the view's
gather, one layer's leaves at a time, with no autograd state.

Without an active mesh, or on a mesh of one device, every function here
is the identity (one card).  A mesh of more devices activated as a
`launch.mesh.Mesh`, with no process group executing it, is a plan (`launch.dryrun`), not an execution: `hint`
and `psum` refuse it with a ValueError.  `psum` under a serving group
also refuses a tensor that requires a gradient: tensor-parallel training
is a later slice (`ROADMAP_ITEM`).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ..launch.mesh import Mesh

ROADMAP_ITEM = 'ROADMAP queue 1, "Tensor-parallel training"'

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def with_mesh(mesh):
    """Activate `mesh`: a `launch.mesh.Mesh` to plan on, this rank's
    `parallel.MeshGroup` to serve on its mesh (tensor parallel over
    "model"), this rank's `parallel.fsdp.Layout` to train on its mesh or
    `parallel.fsdp.ServeView` to serve a training placement on it (no
    tensor parallelism: the pieces gathered), or None (one device)."""
    if mesh is None:
        active = None
    elif isinstance(mesh, Mesh):
        active = (mesh, None, None)
    elif getattr(mesh, "gathers_pieces", False):
        active = (mesh.group.mesh, mesh.group, mesh)
    else:
        active = (mesh.mesh, mesh, None)
    tok = _MESH.set(active)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def _planning(what: str, shape, mesh) -> ValueError:
    return ValueError(
        f"{what} on {tuple(shape)} over a mesh of {mesh.size} devices "
        f"{mesh.shape} with no process group executing it: a mesh without "
        f"one plans (launch.dryrun); run the ranks under "
        f"with_mesh(group) ({ROADMAP_ITEM})")


def active_group():
    """The rank's `MeshGroup` under an active mesh of several devices,
    else None (one device)."""
    active = _MESH.get()
    if active is None or active[0].size == 1:
        return None
    mesh, group, _ = active
    if group is None:
        raise _planning("a sharded model", (), mesh)
    return group


def placement():
    """The rank's `parallel.fsdp` placement (a training `Layout` or a
    `ServeView`) under an active mesh of several devices, else None."""
    active = _MESH.get()
    if active is None or active[0].size == 1:
        return None
    return active[2]


def training():
    """The rank's training `Layout` under an active training mesh of
    several devices, else None."""
    active = placement()
    return active if active is not None and active.trains else None


def gatherer():
    """`gather(units, period=None)`, bound to the placement active now:
    {path prefix: subtree of this rank's pieces} as the whole leaves
    under a training mesh or a serving view, in one gather (`period`:
    the index of the period of stacked leaves the subtrees are, None for
    unstacked leaves); `units` itself otherwise.  Bound at the call, so
    the backward's recompute, which the autograd engine runs on a card's
    own thread outside this context, gathers too."""
    active = placement()
    if active is None:
        return lambda units, period=None: units
    return active.gather


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` (no gradient) over the batch ranks under a
    training mesh, a new tensor; `x` itself otherwise."""
    layout = training()
    return x if layout is None else layout.batch_sum(x)


def hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """`x` itself: with no mesh, on one device, and under a process group,
    where the port has placed every tensor explicitly; raises ValueError
    for a mesh of several devices that no group executes."""
    active = _MESH.get()
    if active is None or active[0].size == 1 or active[1] is not None:
        return x
    raise _planning(f"hint {spec}", x.shape, active[0])


def model_index() -> tuple[int, int]:
    """(this rank's coordinate on "model", the axis' size): (0, 1) on one
    device."""
    group = active_group()
    if group is None or placement() is not None:
        return (0, 1)
    return (group.model_rank, group.model_size)


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks of "model" (the partial outputs of a
    row-parallel product), IN PLACE; `x` itself on one device, under a
    training mesh and under a serving view (no tensor parallelism)."""
    group = active_group()
    if group is None or group.model_size == 1 or placement() is not None:
        return x
    if x.requires_grad:
        raise ValueError(f"psum of {tuple(x.shape)} under autograd: the "
                         f"port serves tensor parallel on a mesh; "
                         f"tensor-parallel training is a later slice "
                         f"({ROADMAP_ITEM})")
    return group.all_reduce(x, "model")

