"""Fault-tolerant checkpointing: atomic save, restore onto a device;
ported from `repro.checkpoint.manager` with its on-disk layout.

Layout:  <dir>/step_<N>/  arrays.npz + manifest.json ;  <dir>/LATEST
Keys are tree paths ("params/blocks/0/mixer/wq", dict keys sorted as
`jax.tree_util` flattens them).  Writes go to a temp dir then
`os.replace` (atomic on POSIX), so a crash mid-save never corrupts the
latest checkpoint.  npz cannot hold bf16 or fp8, so those leaves are
stored through an unsigned view of their bits (uint16 / uint8) with the
type's name in the manifest, as the reference stores them: a checkpoint
either package writes restores in the other.  Optional async save runs
in a daemon thread off a host copy.

A sharded state (`group=`, this rank's `parallel.MeshGroup`, and
`specs=`, {leaf path: spec} of its pieces, `parallel.fsdp.Layout
.specs.state`): `save`, called by every rank, gathers each leaf whole
from one replica of its pieces (the ranks at coordinate 0 on every axis
that does not cut it: on the pod mesh pod 0's, never once per pod
replica) and rank 0 writes the format above, so any mesh, or either
package on one device, restores it; `restore(..., group=, specs=)`
keeps the rank's piece of each leaf under the specs of its own mesh,
which need not be the saver's (the reference's elastic `restore(...,
shardings=)`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..kernels.config import resolve_device
from ..parallel.tensor import gather_piece, local_slice
from ..tree import leaves_with_path, path_key, replace_leaves, tree_map

# dtype name -> (torch dtype, the signed integer view torch and numpy
# share, the unsigned view npz stores)
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.uint8)}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf's bits on the host as npz stores them."""
    t = t.detach().cpu()
    name = _dtype_name(t)
    if name in _EXOTIC:
        _, signed, stored = _EXOTIC[name]
        return t.view(signed).numpy().view(stored)
    return t.numpy()


def save(state, step: int, ckpt_dir: str, *, keep: int = 3, group=None,
         specs: Optional[dict] = None) -> Optional[str]:
    """Write `state` as step `step` (atomic), keeping the newest `keep`;
    returns the step's directory.  With `group` and `specs` (a sharded
    state: module docstring) every rank calls it, rank 0 writes and
    returns the directory, the others None once it is written."""
    if group is not None and group.mesh.size > 1:
        return _save_sharded(state, step, ckpt_dir, keep, group, specs)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {path_key(p): x for p, x in leaves_with_path(state)}
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: _to_numpy(x) for k, x in flat.items()})
    manifest = {"step": step,
                "leaves": {k: {"shape": list(x.shape),
                               "dtype": _dtype_name(x)}
                           for k, x in flat.items()}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                    # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _save_sharded(state, step, ckpt_dir, keep, group, specs):
    """Each leaf gathered whole by the ranks of one replica of its pieces
    (rank 0's), kept on rank 0's host only; rank 0 writes; every rank
    waits for the write."""
    host = {}
    for p, x in leaves_with_path(state):
        spec = specs[path_key(p)]
        cut = {a for e in spec if e is not None
               for a in (e if isinstance(e, tuple) else (e,))}
        if any(c for a, c in group.coords.items() if a not in cut):
            continue            # another replica of the same pieces
        whole = gather_piece(x, spec, group)
        if group.rank == 0:
            host[p] = whole.detach().to("cpu", copy=True)
    out = None
    if group.rank == 0:
        out = save(replace_leaves(state, host), step, ckpt_dir, keep=keep)
    group.barrier()
    return out


def save_async(state, step: int, ckpt_dir: str, *,
               keep: int = 3) -> threading.Thread:
    """Copy to host memory synchronously, write to disk in background."""
    host_state = tree_map(lambda t: t.detach().to("cpu", copy=True), state)
    t = threading.Thread(target=save, args=(host_state, step, ckpt_dir),
                         kwargs={"keep": keep}, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, template, *, step: Optional[int] = None,
            device=None, group=None, specs: Optional[dict] = None):
    """Restore into the structure of `template` (a tree of tensors, e.g.
    on the "meta" device), each leaf converted to its template leaf's
    dtype and placed on `device` (None means "cuda" and raises without a
    GPU).  With `group` and `specs` each leaf is the rank's piece under
    its spec (the template's leaves whole or pieces: only their dtypes
    are read)."""
    cut = group is not None and group.mesh.size > 1
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    arrays = np.load(os.path.join(d, "arrays.npz"))
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def leaf(path, like):
        key = path_key(path)
        arr = arrays[key]
        saved = manifest["leaves"][key]["dtype"]
        if saved in _EXOTIC:
            dt, signed, stored = _EXOTIC[saved]
            t = torch.from_numpy(arr.view(stored)).view(signed).view(dt)
        else:
            t = torch.from_numpy(arr)
        if cut:
            t = local_slice(t, specs[key], group.mesh, group.coords)
        return t.to(device=dev, dtype=like.dtype)

    return replace_leaves(template, {
        p: leaf(p, x) for p, x in leaves_with_path(template)})


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
