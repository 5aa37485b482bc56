"""End-to-end HTAP driver on the PyTorch/CUDA port (`repro_torch`): a
~100M-parameter model trained while a serving engine reads RSS-pinned
snapshots between steps.  The twin of `examples/htap_train_serve.py`.

    PYTHONPATH=src python examples/pt_htap_train_serve.py --steps 200
    PYTHONPATH=src python examples/pt_htap_train_serve.py --smoke --device cpu

This is the paper's multinode architecture end-to-end: trainer = OLTP
primary, the WAL carries its commit records, the serving side replays
them (Algorithm 1) and never waits or aborts.  Unlike the reference's
driver, which calls `Trainer.run(start + n)` again from step 0 between
serve batches, the steps run once, in order, and a batch is served after
every `--serve-every`-th step (`Trainer.run(..., after_step=)`).
"""

import argparse
import time

import torch

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.serve import ServingEngine
from repro_torch.tensorstore import VersionedParamStore
from repro_torch.train import Trainer


def model_100m() -> ModelConfig:
    # ~104M params: 12L, d=640, untied 32k vocab
    return ModelConfig(
        name="demo-100m", family="dense",
        n_layers=12, d_model=640, n_heads=10, n_kv_heads=10, head_dim=64,
        d_ff=1792, vocab_size=32_000,
        pattern=(LayerSpec(mixer="attn", mlp="dense"),),
        mlp_act="swiglu", norm="rmsnorm",
        remat="none", microbatches=1, fsdp=False,
        param_dtype="float32", compute_dtype="float32",
    )


def model_tiny() -> ModelConfig:
    # CI smoke shape: same code paths, seconds not minutes
    return ModelConfig(
        name="demo-tiny", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        pattern=(LayerSpec(mixer="attn", mlp="dense"),),
        mlp_act="swiglu", norm="rmsnorm",
        remat="none", microbatches=1, fsdp=False,
        param_dtype="float32", compute_dtype="float32",
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--serve-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + few steps (CI demo-rot check)")
    args = ap.parse_args()

    if args.smoke:
        args.steps, args.batch, args.seq = 10, 2, 32
        args.serve_every = 5
    cfg = model_tiny() if args.smoke else model_100m()
    print(f"model: {cfg.param_count()/1e6:.0f}M params on {args.device}")
    store = VersionedParamStore(slots=2)
    trainer = Trainer(cfg, batch=args.batch, seq_len=args.seq, store=store,
                      publish_every=5, device=args.device)
    engine = ServingEngine(cfg, store, max_seq=args.seq + 32,
                           device=args.device)
    prompt = {"tokens": torch.ones((2, 16), dtype=torch.int32)}
    served = []

    def serve(i, metrics):
        if (i + 1) % args.serve_every and i + 1 != args.steps:
            return
        # OLAP side: refresh RSS from the WAL, read a consistent snapshot
        engine.refresh()
        res = engine.generate(prompt, 8)
        served.append(res.snapshot_lsn)
        print(f"step {i + 1:4d}  loss {metrics['loss']:.4f}  "
              f"served batch @lsn {res.snapshot_lsn} "
              f"(freshness lag {res.freshness_lag})  "
              f"slots {store.n_slots}")

    t0 = time.time()
    trainer.run(args.steps, after_step=serve)
    dt = time.time() - t0
    assert all(b > a for a, b in zip(served, served[1:])), served
    print(f"\n{args.steps} train steps + {len(served)} serve batches in "
          f"{dt:.1f}s — zero reader waits, zero reader aborts, "
          f"{store.stats['publishes']} versions published")
    losses = [m["loss"] for m in trainer.metrics_log]
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
