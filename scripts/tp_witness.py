#!/usr/bin/env python3
"""The sharded serve phase of `chip_smoke.py` beside two witnesses, on one
GPU: what its check (s1) reads is set apart from a sharding fault.

    python3 scripts/tp_witness.py
    python3 scripts/tp_witness.py --device cpu --smoke

Check (s1) holds each rank's logits, gathered over "model", against the
unsharded kernel path's on the same weights and tokens (bf16, max |d| /
max |logit|).  Three readings, each on the phase's own configuration
(Qwen2-VL-72B at the published widths, `chip_smoke.TP_DEPTH` layers),
batch and weights (torch.Generator seed 0):

  floor      the unsharded model's bf16 noise floor under attention
             (`chip_smoke._attn_noise_floor`: its plain prefill against
             itself with every attention output moved by 1e-6 of itself,
             each rounded to bf16) at the phase's depth
  bf16 psum  the phase as `chip_smoke.py` runs it: the ranks sum their
             bf16 partial outputs over "model" in bf16
  f32 psum   the same phase with every bf16 sum over "model" taken in
             f32 and rounded once

A sharding fault (a wrong piece, a missing or doubled sum) moves the
logits by their own size, far above the floor, whatever the precision
of the sum.  bf16 rounding reads near the floor; a sum in f32 removes
only the roundings of the reduction itself.  Each reading is printed
with the phase's own report; the script exits 1 where a phase fails its
checks.  `--device cpu --smoke` is a rehearsal on the plain versions at
the smoke variant (mesh (1, 2)).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the ranks' functions, importable from this script by name (the ranks
# are "spawn" processes); each runs `chip_smoke.tp_rank`
def bf16_rank(group, *args):
    return _chip_smoke().tp_rank(group, *args)


def f32_rank(group, *args):
    import torch

    reduce = group.all_reduce

    def all_reduce(x, axis):
        if x.dtype != torch.bfloat16:
            return reduce(x, axis)
        return x.copy_(reduce(x.float(), axis))

    group.all_reduce = all_reduce
    return _chip_smoke().tp_rank(group, *args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    sys.path.insert(0, str(HERE / "src"))
    cs = _chip_smoke()
    mesh = cs.TP_MESH
    if args.smoke:
        cs.SERVE_SMOKE = True
        cs.TP_B, cs.TP_S, cs.TP_STEPS, cs.TP_PUBLISH_AT = 2, 24, 4, 2
        mesh = (1, 2)
    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        from repro_torch.kernels import cuda_build

        print(cs.card_line(), flush=True)
        cuda_build.build(["attention"])
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import init_params

    cfg = get_config(cs.TP_ARCH)
    cfg = smoke_variant(cfg) if cs.SERVE_SMOKE else cfg
    cfg = cfg.with_overrides(n_layers=min(cs.TP_DEPTH[cs.TP_ARCH],
                                          cfg.n_layers))
    dev = torch.device(args.device)
    batch = cs.serve_batch(torch, np, cfg, cs.TP_ARCH, cs.TP_B, cs.TP_S,
                           dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev)
    with torch.no_grad():
        floor = cs._attn_noise_floor(torch, cfg, params, batch, cs.TP_S)
    print(f"witness floor: {cfg.name} {cfg.n_layers} layers, "
          f"{cs.TP_B} x {cs.TP_S}: {floor}", flush=True)
    del params, batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    failed = 0
    for name, rank in (("bf16 psum", bf16_rank), ("f32 psum", f32_rank)):
        print(f"witness {name}:", flush=True)
        cs.tp_rank = rank
        try:
            cs.tp_serve_phase(torch, np, device=args.device,
                              mesh_shape=mesh)
        except AssertionError as e:
            failed += 1
            print(f"witness {name}: failed: {e}", flush=True)
        if on_card:
            torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
