"""Meshes of H100 cards, ported from `repro.launch.mesh`.

A `Mesh` is a description: its axis names and their sizes.  The reference's GSPMD meshes
place arrays; this one only names the layout that `launch.shardings`
plans for.

Single pod: 16 x 16 = 256 cards, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 cards, axes ("pod", "data", "model"); the
"pod" axis is the HTAP boundary (OLTP/training pod 0 ships its WAL to
the OLAP/serving pod 1 asynchronously) and acts as an outer
data-parallel axis for training plans.

`make_production_mesh` gives those two as logical meshes, for planning
only (`launch.dryrun`): no process holds their cards.  `make_host_mesh`
covers the CUDA devices of this process (world size 1 on a one-card
machine).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..kernels.config import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes (`shape`: name -> size, in axis order, as a
    jax mesh's `.shape`)."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(device=None) -> Mesh:
    """A ("data", "model") mesh of (n, 1) over this process's n devices:
    every CUDA device (`device=None` means "cuda" and raises without a
    GPU), or the one CPU with `device="cpu"`."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh((n, 1), ("data", "model"))


def dp_axes(mesh: Mesh) -> tuple:
    """Axes batch is sharded over (pod absorbs into data-parallel)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def train_dp_axes(mesh: Mesh, cfg) -> tuple:
    """Batch axes for training: fsdp2d folds the model axis into data
    parallelism when the global batch divides the full chip count."""
    base = dp_axes(mesh)
    if getattr(cfg, "train_sharding", "tp") == "fsdp2d" \
            and "pod" not in mesh.axis_names:
        return base + ("model",)
    return base

