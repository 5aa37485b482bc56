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

Without an active mesh, or on a mesh of one device, every function here
is the identity (one card).  A mesh of more devices activated as a
`launch.mesh.Mesh`, with no process group executing it, is a plan (`launch.dryrun`), not an execution: `hint`
and `psum` refuse it with a ValueError.  `psum` also refuses a tensor
that requires a gradient: sharded training is a later slice
(`ROADMAP_ITEM`).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ..launch.mesh import Mesh

ROADMAP_ITEM = 'ROADMAP queue 1, "Sharded execution, later slices"'

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def with_mesh(mesh):
    """Activate `mesh`: a `launch.mesh.Mesh` to plan on, this rank's
    `parallel.MeshGroup` to execute on its mesh, or None (one device)."""
    if mesh is None:
        active = None
    elif isinstance(mesh, Mesh):
        active = (mesh, None)
    else:
        active = (mesh.mesh, mesh)
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
    mesh, group = active
    if group is None:
        raise _planning("a sharded model", (), mesh)
    return group


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
    return (0, 1) if group is None else (group.model_rank, group.model_size)


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks of "model" (the partial outputs of a
    row-parallel product), IN PLACE; `x` itself on one device."""
    group = active_group()
    if group is None or group.model_size == 1:
        return x
    if x.requires_grad:
        raise ValueError(f"psum of {tuple(x.shape)} under autograd: the "
                         f"port serves on a mesh; sharded training is a "
                         f"later slice ({ROADMAP_ITEM})")
    return group.all_reduce(x, "model")

