#!/usr/bin/env python3
"""A train phase of `chip_smoke.py` rerun under other settings on one GPU:
a witness for the losses that the phase prints.

    python3 scripts/train_witness.py [--arch qwen2-vl-72b] [--steps 8]
    python3 scripts/train_witness.py --device cpu --smoke --batch 2 --seq 16

Trains `chip_smoke.train_config(arch)` (Qwen2-VL-72B: the published
widths at one layer) on the train phase's batch (8 x 1,024 tokens, the
config's microbatches, the pipeline's vision stub on M-RoPE positions)
for --steps steps, from the same weights and data (torch.Generator seed
0) in each of these runs:

  kernels   the train phase's own step: the hand-written kernels, bf16,
            AdamW at the config's learning rate (3e-4)
  plain     the same step on the plain attention
            (`chip_smoke.plain_attention`, forward and backward)
  lr/10     the kernels at a tenth of the learning rate
  lr 0      the kernels with no update: the data's loss at the initial
            weights, step by step
  f32 m, v  the kernels with the AdamW moments (and the microbatches'
            gradient sum) in f32 where the config keeps them in bf16

Each run prints its losses, its gradient norms, the kernels' launches
(none on the plain run), its seconds and its peak device memory.  Where
the plain run's losses track the kernels', the kernels do not make the
losses' course; where the smaller step's losses fall and lr 0's stay
flat, the learning rate does; where the f32 moments' track the bf16
ones', the moments' precision does not.  A run that does not fit the
card prints so and the others go on.  `--device cpu` is a rehearsal on
the plain versions (with `--smoke`: the config's smoke variant).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(torch, cs, cfg, *, lr: float, plain: bool, moments: str, B: int,
        S: int, steps: int, device: str) -> None:
    import contextlib

    from repro_torch.kernels.cuda_build import launch_count, reset_counts
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import Trainer

    on_card = device == "cuda"
    fwd, bwd, fwd_key, bwd_key, _ = cs._train_wrappers(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=lr, moment_dtype=moments)
    tr = Trainer(cfg, batch=B, seq_len=S, seed=0, opt=opt, device=device)
    reset_counts((fwd, bwd))
    t0 = time.perf_counter()
    with cs.plain_attention() if plain else contextlib.nullcontext():
        log = tr.run(steps)
    wall = time.perf_counter() - t0
    losses = [float(m["loss"]) for m in log]
    norms = [float(m["grad_norm"]) for m in log]
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    print(f"witness {'plain' if plain else 'kernels'} lr {lr:g} moments "
          f"{moments}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{', '.join(f'{x:.4f}' for x in norms)}; launches {fwd_key} "
          f"{launch_count(fwd)}, {bwd_key} {launch_count(bwd)}; "
          f"{wall:.1f} s; peak {peak:.2f} GB", flush=True)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("witness: a loss or gradient norm is not "
                             "finite")
    del tr, log
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-vl-72b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(HERE / "src"))
    cs = _chip_smoke()
    cs.TRAIN_SMOKE = args.smoke
    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        from repro_torch.kernels import cuda_build

        print(cs.card_line(), flush=True)
        cuda_build.build(["attention"])
    from repro_torch.optim.adamw import AdamWConfig

    cfg = cs.train_config(args.arch)
    B = args.batch or cs.TRAIN_BATCH.get(args.arch, cs.TRAIN_B)
    S = args.seq or cs.TRAIN_SEQ.get(args.arch, cs.TRAIN_S)
    lr = AdamWConfig().lr                  # the Trainer's default
    print(f"witness {args.arch}: {cfg.n_layers} layer(s), {B} x {S} tokens "
          f"in {max(cfg.microbatches, 1)} microbatch(es), {args.steps} "
          f"steps, {args.device}", flush=True)
    failed = 0
    m = cfg.moment_dtype
    for lr_i, plain, moments in ((lr, False, m), (lr, True, m),
                                 (lr / 10, False, m), (0.0, False, m),
                                 (lr, False, "float32")):
        try:
            run(torch, cs, cfg, lr=lr_i, plain=plain, moments=moments, B=B,
                S=S, steps=args.steps, device=args.device)
        except torch.cuda.OutOfMemoryError as e:
            failed += 1
            print(f"witness {'plain' if plain else 'kernels'} lr {lr_i:g} "
                  f"moments {moments}: does not fit "
                  f"({str(e).splitlines()[0]})", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
