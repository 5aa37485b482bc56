"""Quickstart on the PyTorch/CUDA port (`repro_torch`): train a model,
publish versions to the RSS store, serve wait-free snapshot reads while
training continues.  The twin of `examples/quickstart.py`.

    PYTHONPATH=src python examples/pt_quickstart.py --smoke          # GPU
    PYTHONPATH=src python examples/pt_quickstart.py --smoke --device cpu

On "cuda" the attention layers run the flash kernel forward and its
hand-written backward; on "cpu" the plain PyTorch versions.  Without
--smoke the model is Qwen1.5-0.5B at its published widths (GPU only).
"""

import argparse

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.serve import ServingEngine
from repro_torch.tensorstore import VersionedParamStore
from repro_torch.train import Trainer


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (seconds, any device)")
    args = ap.parse_args()

    # 1. pick an architecture — reduced config with --smoke
    cfg = get_config("qwen1.5-0.5b")
    cfg = smoke_variant(cfg) if args.smoke else cfg
    batch, seq = (4, 32) if args.smoke else (8, 1024)
    print(f"arch: {cfg.name}  ({cfg.n_layers}L d={cfg.d_model}) on "
          f"{args.device}")

    # 2. the versioned parameter store is the HTAP boundary: the trainer is
    #    the OLTP writer, serving pins RSS snapshots (wait-/abort-free reads)
    store = VersionedParamStore(slots=2)
    trainer = Trainer(cfg, batch=batch, seq_len=seq, store=store,
                      device=args.device)

    print("training 5 steps (each step commits a version to the WAL)...")
    logs = trainer.run(5)
    print(f"  loss: {logs[0]['loss']:.3f} -> {logs[-1]['loss']:.3f}")
    print(f"  published versions: {store.stats['publishes']}")

    # 3. serving replays the WAL (Algorithm 1) and reads through the RSS
    engine = ServingEngine(cfg, store, max_seq=64, device=args.device)
    engine.refresh()
    res = engine.generate({"tokens": torch.ones((2, 8), dtype=torch.int32)},
                          6)
    print(f"generated tokens: {tuple(res.tokens.shape)}, snapshot lsn "
          f"{res.snapshot_lsn}, freshness lag {res.freshness_lag}")

    # 4. wait-freedom: pin a snapshot, keep training — neither side blocks
    pin, _ = store.pin_snapshot()
    trainer.run(3)
    store.release(pin)
    print(f"trained 3 more steps while a reader was pinned "
          f"(ring slots: {store.n_slots}; no waits, no aborts)")


if __name__ == "__main__":
    main()
