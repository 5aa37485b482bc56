"""Activation-sharding hints, ported from `repro.models.sharding`.

The reference's model code calls `hint(x, "data", None, "model")`-style
constraints that GSPMD turns into shardings under `with_mesh(mesh)`.
The port runs a model on one card: `hint` returns its input when no mesh
is active or the active mesh has one device.  A mesh of more devices is
refused, not ignored: a logical mesh larger than this process's devices
(`launch.mesh.make_production_mesh`) is for planning only
(`launch.dryrun`), and sharded execution over several cards is not
ported (ROADMAP queue 1, "Sharded execution").  The port's model stack
does not call `hint`.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

ROADMAP_ITEM = 'ROADMAP queue 1, "Sharded execution"'

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def with_mesh(mesh):
    """Activate a mesh (`launch.mesh.Mesh`) for `hint`."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """`x` itself where no mesh is active or the mesh has one device;
    raises ValueError for a larger mesh (see the module docstring)."""
    mesh = _MESH.get()
    if mesh is None or mesh.size == 1:
        return x
    raise ValueError(
        f"hint {spec} on {tuple(x.shape)} over a mesh of {mesh.size} "
        f"devices {mesh.shape}: the port runs a model on one device; a "
        f"larger mesh plans (launch.dryrun) and sharded execution is not "
        f"ported ({ROADMAP_ITEM})")
