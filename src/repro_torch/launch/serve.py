"""Serving launcher, ported from `repro.launch.serve`: prefill + decode
against an RSS-pinned snapshot.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --smoke --prompt-len 16 --steps 8 [--device cpu]

A `Trainer` first runs --train-steps steps that publish into a
`VersionedParamStore`; a `ServingEngine` then refreshes and serves a
batch of all-ones prompts from the newest version, and the launcher
prints the tokens' shape, the snapshot's LSN and its lag, as the
reference does.  An M-RoPE config gets each prompt's index on its three
position streams; an encoder-decoder zero frames in the parameter dtype
(bf16 for every config of the repo, as the reference hands them).  On
"cuda" unless --device says otherwise (the default raises without a
GPU; only --device cpu runs on the CPU).
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=3,
                    help="concurrent trainer steps before serving")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_config, smoke_variant
    from ..models.transformer import torch_dtype
    from ..serve import ServingEngine
    from ..tensorstore import VersionedParamStore
    from ..train import Trainer

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    store = VersionedParamStore(slots=2)
    tr = Trainer(cfg, batch=2, seq_len=max(args.prompt_len, 16), store=store,
                 device=args.device)
    tr.run(args.train_steps)
    eng = ServingEngine(cfg, store, max_seq=args.prompt_len + args.steps + 8,
                        device=tr.device)
    eng.refresh()
    B, S = args.batch, args.prompt_len
    batch = {"tokens": torch.ones((B, S), dtype=torch.int32)}
    if cfg.mrope_sections:
        batch["mrope_positions"] = torch.arange(
            S, dtype=torch.int32).expand(3, B, S)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.zeros(
            (B, cfg.encoder_len, cfg.d_model),
            dtype=torch_dtype(cfg.param_dtype))
    res = eng.generate(batch, args.steps)
    print(f"arch={cfg.name} generated {tuple(res.tokens.shape)} tokens "
          f"@snapshot lsn {res.snapshot_lsn} (lag {res.freshness_lag})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
