"""Process groups over a `launch.mesh.Mesh`: the ranks that execute a
sharded model, one process a rank.

A rank's coordinates on the mesh follow the reference's device order:
row-major over the mesh's axes, the last axis ("model") fastest, so on a
("data", "model") mesh of (2, 2) rank 1 is (data 0, model 1) and rank 2
is (data 1, model 0).  `MeshGroup` holds a rank's coordinates, its
device and a sub-group for every set of the mesh's axes (the ranks
that differ only in those axes).  A collective takes a name or a tuple
of the mesh's axis names: "model" (tensor parallel: the ranks that hold
the other pieces of the same weights), "data" (the batch: the ranks
over `launch.mesh.dp_axes`, ("pod", "data") on a pod mesh) and "mesh"
(all the ranks) by name, a tuple as it is.  Pieces over several axes
are in GSPMD's order: row-major over the coordinates on the axes in the
order given (`parallel.tensor.local_slice`'s order).  On the reference's
pod mesh ("pod", "data", "model") the training placement needs groups
beside "model" and "data": fsdp2d gathers its weights over ("data",
"model"), reduce-scatters their gradients over "data" and sums them
over "pod" (`parallel.fsdp`).

Nothing is chosen behind the caller's back: the backend and every rank's
device are arguments.  "nccl" needs one card a rank and refuses two ranks
on one device before any NCCL call; "gloo" serves the CPU and ranks that
share a card, its collectives on a card's tensors passing through host
memory (gloo reduces and gathers host buffers).  A rank on the CPU runs
`CPU_THREADS` intra-op threads, so several ranks fit the cores of one
machine.

`spawn(fn, mesh, backend=, devices=, args=, tmpdir=)` starts one process
a rank (the "spawn" start method), each running `fn(group, *args)` once
its group is up; the rendezvous is a file in a new directory under
`tmpdir` (`init_method="file://..."`), so concurrent spawns never race
for a port.  `fn` must be importable at module level (it is pickled by name),
and its result is saved by the rank and returned to the caller in rank
order.  A rank that raises ends the others and the error reaches the
caller.
"""

from __future__ import annotations

import datetime
import math
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh, dp_axes

BACKENDS = ("gloo", "nccl")
CPU_THREADS = 1
# how long a collective may wait for its peers before the group fails
TIMEOUT_S = 600


def coords_of(mesh: Mesh, rank: int) -> dict:
    """{axis: coordinate} of `rank` (row-major, the last axis fastest)."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside a mesh of {mesh.size}")
    out = {}
    for name, size in reversed(tuple(zip(mesh.axis_names,
                                         mesh.axis_sizes))):
        out[name] = rank % size
        rank //= size
    return {name: out[name] for name in mesh.axis_names}


def axis_ranks(mesh: Mesh, axes: Sequence[str]) -> list[list[int]]:
    """The partition of the mesh's ranks into groups that differ only in
    `axes` (each group in rank order, the groups in order of their first
    rank)."""
    groups: dict = {}
    for rank in range(mesh.size):
        c = coords_of(mesh, rank)
        key = tuple(v for a, v in c.items() if a not in axes)
        groups.setdefault(key, []).append(rank)
    return list(groups.values())


def check_devices(mesh: Mesh, backend: str, devices) -> list:
    """The ranks' devices, one a rank, as `torch.device`s; raises
    ValueError for an unknown backend, a count that is not the mesh's, a
    card without its index, and under "nccl" a rank off the card or two
    ranks on one card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    devs = [torch.device(d) for d in devices]
    if len(devs) != mesh.size:
        raise ValueError(f"{len(devs)} devices for a mesh of {mesh.size} "
                         f"ranks {mesh.shape}: give one a rank")
    for r, d in enumerate(devs):
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"rank {r}: device {d} is neither cpu nor cuda")
        if d.type == "cuda" and d.index is None:
            raise ValueError(f"rank {r}: name the card (cuda:N), not {d}")
    if backend == "nccl":
        off = [r for r, d in enumerate(devs) if d.type != "cuda"]
        if off:
            raise ValueError(f"nccl runs on cards: ranks {off} are on "
                             f"{[str(devs[r]) for r in off]}")
        seen: dict = {}
        for r, d in enumerate(devs):
            if d in seen:
                raise ValueError(
                    f"nccl needs one card a rank: ranks {seen[d]} and {r} "
                    f"share {d} (use gloo for ranks that share a card)")
            seen[d] = r
    return devs


@dataclass
class MeshGroup:
    """One rank's view of the mesh: its coordinates, device and the
    process group of each set of axes of more than one rank and fewer
    than the mesh's (keyed by the axes in mesh order)."""
    mesh: Mesh
    rank: int
    backend: str
    device: torch.device
    coords: dict = field(default_factory=dict)
    groups: dict = field(default_factory=dict)
    # the ranks of each sub-group in `groups`, in rank order
    members: dict = field(default_factory=dict)

    @property
    def model_size(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def data_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in dp_axes(self.mesh)
                         if a in self.mesh.shape)

    @property
    def data_rank(self) -> int:
        rank = 0
        for a in dp_axes(self.mesh):
            if a in self.mesh.shape:
                rank = rank * self.mesh.shape[a] + self.coords[a]
        return rank

    def _axes(self, axis) -> tuple:
        """The mesh axes a collective runs over: "model", "data" (the
        batch axes, `dp_axes`) and "mesh" (every axis) by name, or a
        tuple of axis names as it is."""
        if isinstance(axis, str):
            if axis == "mesh":
                return self.mesh.axis_names
            if axis == "data":
                return tuple(a for a in dp_axes(self.mesh)
                             if a in self.mesh.shape)
            return (axis,)
        return tuple(axis)

    def _group(self, axis):
        """(process group, its ranks in rank order, this rank's piece
        index over the axes) of `axis` (see `_axes`); the group is None
        where it has one rank."""
        axes = self._axes(axis)
        unknown = [a for a in axes if a not in self.mesh.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in mesh "
                             f"{self.mesh.shape}")
        ranks = next(r for r in axis_ranks(self.mesh, axes)
                     if self.rank in r)
        index = piece_index(self.coords, axes, self.mesh)
        if len(ranks) == 1:
            return None, ranks, index
        if len(ranks) == self.mesh.size:
            return dist.group.WORLD, ranks, index
        for name, g in self.groups.items():
            if self.members.get(name) == ranks:
                return g, ranks, index
        raise ValueError(f"no process group over {axes} on mesh "
                         f"{self.mesh.shape}")

    def _order(self, ranks: list, axes) -> list:
        """Each member's piece index over `axes`, in group order."""
        axes = self._axes(axes)
        return [piece_index(coords_of(self.mesh, r), axes, self.mesh)
                for r in ranks]

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer a collective runs on: gloo reduces and gathers
        host memory, so a card's tensor is copied there."""
        return x.cpu() if self.backend == "gloo" and x.is_cuda else x

    def all_reduce(self, x: torch.Tensor, axis, op: str = "sum") \
            -> torch.Tensor:
        """Reduce `x` ("sum" or "max") over the ranks of `axis`, IN
        PLACE; returns x."""
        g = self._group(axis)[0]
        if g is None:
            return x
        buf = self._host(x)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=g)
        if buf is not x:
            x.copy_(buf)
        return x

    def all_gather(self, x: torch.Tensor, axis, dim: int = 0) \
            -> torch.Tensor:
        """The ranks' `x` of `axis` (one axis or several) concatenated
        along `dim` in piece order (row-major over the axes' coordinates,
        see the module docstring)."""
        g, ranks, _ = self._group(axis)
        if g is None:
            return x
        buf = self._host(x.contiguous())
        parts = [torch.empty_like(buf) for _ in ranks]
        dist.all_gather(parts, buf, group=g)
        ordered = [None] * len(ranks)
        for part, k in zip(parts, self._order(ranks, axis)):
            ordered[k] = part
        if buf.device == x.device:
            return torch.cat(ordered, dim=dim)
        # gloo on a card: each host part copied into its place on the card
        # (no whole concatenation in host memory first)
        shape = list(x.shape)
        shape[dim] *= len(ranks)
        out = x.new_empty(shape)
        for k, part in enumerate(ordered):
            out.narrow(dim, k * x.shape[dim], x.shape[dim]).copy_(part)
        return out

    def reduce_scatter(self, x: torch.Tensor, axis, dim: int = 0) \
            -> torch.Tensor:
        """This rank's piece along `dim` of the sum of the ranks' `x`
        over `axis` (one axis or several; pieces in the order of
        `all_gather`), a new tensor.  Gloo has no reduce-scatter: there
        the whole sum is all-reduced and the rank keeps its slice (n
        times the bytes a reduce-scatter moves); NCCL runs
        `reduce_scatter_tensor`.  The sum is in `x`'s dtype: a caller
        that sums gradients passes them in f32."""
        g, ranks, k = self._group(axis)
        if g is None:
            return x
        n = len(ranks)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not cut "
                             f"into {n} pieces")
        size = x.shape[dim] // n
        if self.backend == "gloo":
            buf = self._host(x)
            buf = buf.clone() if buf is x else buf     # x stays as it is
            dist.all_reduce(buf, group=g)
            return buf.narrow(dim, k * size, size).contiguous().to(x.device)
        # chunk j goes to the group's rank j: its piece of the order
        inp = torch.stack([x.narrow(dim, j * size, size)
                           for j in self._order(ranks, axis)])
        out = torch.empty_like(inp[0])
        dist.reduce_scatter_tensor(out, inp, group=g)
        return out

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.mesh.size > 1:
            dist.barrier()


def piece_index(coords: dict, axes, mesh: Mesh) -> int:
    """The piece a rank at `coords` holds of a dim cut over `axes`:
    row-major over its coordinates on them, in their order."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def init_group(mesh: Mesh, rank: int, *, backend: str, devices,
               init_method: str) -> MeshGroup:
    """Join the process group of `mesh` as `rank` (every rank calls this
    with the same mesh, backend, devices and `init_method`) and make the
    sub-groups of its axes.  Returns the rank's `MeshGroup`."""
    devs = check_devices(mesh, backend, devices)
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(CPU_THREADS)
    dist.init_process_group(
        backend, init_method=init_method, world_size=mesh.size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    coords = coords_of(mesh, rank)
    groups, members = {}, {}
    # every rank creates every sub-group, in one order
    for axes in sub_axes(mesh):
        for ranks in axis_ranks(mesh, axes):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axes], members[axes] = g, ranks
    return MeshGroup(mesh, rank, backend, dev, coords, groups, members)


def sub_axes(mesh: Mesh) -> list:
    """The sets of the mesh's axes (each in mesh order) whose ranks form
    groups of more than one rank and fewer than the mesh's, one set for
    each partition of the ranks (an axis of one rank adds none)."""
    names, seen, out = mesh.axis_names, set(), []
    for bits in range(1, 2 ** len(names)):
        axes = tuple(a for i, a in enumerate(names) if bits >> i & 1)
        parts = tuple(map(tuple, axis_ranks(mesh, axes)))
        if 1 < len(parts[0]) < mesh.size and parts not in seen:
            seen.add(parts)
            out.append(axes)
    return out


def _worker(rank: int, fn: Callable, mesh: Mesh, backend: str, devices,
            init_method: str, args: tuple, out_dir: str) -> None:
    group = init_group(mesh, rank, backend=backend, devices=devices,
                       init_method=init_method)
    try:
        result = fn(group, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, mesh: Mesh, *, backend: str, devices,
          tmpdir, args: tuple = ()) -> list[Any]:
    """Run `fn(group, *args)` in one process a rank of `mesh` (see the
    module docstring); returns the ranks' results in rank order."""
    check_devices(mesh, backend, devices)
    out = Path(tempfile.mkdtemp(prefix="spawn", dir=tmpdir))
    init = f"file://{(out / 'rendezvous').resolve()}"
    torch.multiprocessing.start_processes(
        _worker, args=(fn, mesh, backend, [str(d) for d in devices], init,
                       args, str(out)),
        nprocs=mesh.size, start_method="spawn", join=True)
    # the ranks' own results, written by `_worker`
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(mesh.size)]
