"""Per-card residency of every (arch x shape) cell on a mesh of cards,
the port's counterpart of `repro.launch.dryrun`.

The reference lowers and compiles each cell on 512 placeholder TPU
devices.  The port builds each cell's inputs on the "meta" device
(`launch.specs`: parameters, optimizer state, batch and KV cache as the
step takes them, no storage), places them under the partition rules of
`launch.shardings`, and reports the bytes each card of the mesh holds
of each: a leaf's bytes divided by the pieces its spec cuts it into.
Cells of `repro_torch.configs.iter_cells()`; long_500k is skipped for
full-attention archs, as the reference does.  Serving keeps its
parameters resident (cut over the model axis only) where they fit
`specs.SERVE_RESIDENT_LIMIT` a card, three quarters of an H100 80GB.
No compiler, collective or TPU constant is involved.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..configs import SHAPES, get_config, iter_cells, list_archs
from ..tree import leaves_with_path, path_key
from .mesh import Mesh, make_production_mesh
from .shardings import shards
from .specs import input_specs

# the groups of a cell's inputs: (group, input name, path prefix)
GROUPS = {
    "train": (("params", "state", "params/"), ("opt", "state", "opt/"),
              ("opt", "state", "step"), ("batch", "batch", "")),
    "prefill": (("params", "params", ""), ("batch", "batch", ""),
                ("cache", "cache", "")),
    "decode": (("params", "params", ""), ("batch", "tokens", ""),
               ("batch", "cache_len", ""), ("cache", "cache", "")),
}


def leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def residency(mesh: Mesh, mode: str, specs: dict) -> dict:
    """Bytes a card of `mesh` holds of each group ("params", "opt",
    "batch", "cache") of a cell's inputs, and "total"."""
    out = {"params": 0, "opt": 0, "batch": 0, "cache": 0}
    for group, name, prefix in GROUPS[mode]:
        placed = specs[name]
        for path, leaf in leaves_with_path(placed.tree):
            key = path_key(path)
            if not key.startswith(prefix):
                continue
            n = shards(mesh, placed.specs[key])
            if leaf_bytes(leaf) % n:
                raise ValueError(f"{key}: {tuple(leaf.shape)} does not "
                                 f"divide into {n} pieces")
            out[group] += leaf_bytes(leaf) // n
    out["total"] = sum(out.values())
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh: Mesh = None) -> dict:
    """The cell's report on `mesh` (default: the production mesh, one pod
    or two)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return {"arch": arch, "shape": shape_name, "skipped":
                "full-attention arch (long_500k requires sub-quadratic)"}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mode, specs = input_specs(cfg, shape, mesh)
    return {"arch": arch, "shape": shape_name, "mode": mode,
            "mesh": list(mesh.axis_sizes), "axes": list(mesh.axis_names),
            "n_devices": mesh.size,
            "bytes_per_card": residency(mesh, mode, specs)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a, s, _ in iter_cells()]
    else:
        archs = [args.arch] if args.arch else list_archs()
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch} × {shape} × {'multi' if mp else 'single'}-pod"
            try:
                r = run_cell(arch, shape, multi_pod=mp)
            except Exception as e:
                print(f"[FAIL] {tag}: {e}", flush=True)
                results.append({"arch": arch, "shape": shape,
                                "multi_pod": mp, "error": str(e)})
                continue
            if "skipped" in r:
                print(f"[SKIP] {tag}: {r['skipped']}", flush=True)
            else:
                b = r["bytes_per_card"]
                print(f"[OK]   {tag}: per card params={b['params']:.3e}B "
                      f"opt={b['opt']:.3e}B batch={b['batch']:.3e}B "
                      f"cache={b['cache']:.3e}B total={b['total']:.3e}B",
                      flush=True)
            results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    nfail = sum(1 for r in results if "error" in r)
    print(f"{len(results)} cells, {nfail} failures")
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())
