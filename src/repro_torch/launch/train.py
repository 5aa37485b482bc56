"""Training launcher, ported from `repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --steps 20 --batch 4 --seq 64 --ckpt-dir build/ckpt \
      [--device cpu]

Runs the host training loop (`train.Trainer`: checkpoints every
--ckpt-every steps under --ckpt-dir, the straggler monitor, and under
--publish RSS publication into a `VersionedParamStore`) on one device:
"cuda" unless --device says otherwise (the default raises without a
GPU; only --device cpu runs on the CPU).  Prints what the reference
prints: the first three and last three steps' metrics as JSON lines,
the final loss and the stragglers flagged, and under --publish the
published versions.  Planning for a mesh of cards is `launch.dryrun`.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--publish", action="store_true",
                    help="publish versions to an RSS store (HTAP mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_config, smoke_variant
    from ..optim import AdamWConfig
    from ..tensorstore import VersionedParamStore
    from ..train import Trainer

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.microbatches:
        cfg = cfg.with_overrides(microbatches=args.microbatches)
    store = VersionedParamStore(slots=2) if args.publish else None
    tr = Trainer(cfg, batch=args.batch, seq_len=args.seq,
                 opt=AdamWConfig(lr=args.lr, moment_dtype=cfg.moment_dtype),
                 seed=args.seed, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, store=store,
                 device=args.device)
    logs = tr.run(args.steps)
    for m in logs[:3] + logs[-3:]:
        print(json.dumps(m))
    print(f"final loss: {logs[-1]['loss']:.4f}  "
          f"stragglers flagged: {len(tr.monitor.flagged)}")
    if store is not None:
        print(f"published versions: {store.stats['publishes']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
