"""Serving engine: batched prefill/decode over RSS-pinned snapshots.

The OLAP side of the HTAP boundary: every request batch pins a parameter
snapshot through the `VersionedParamStore` (wait-free — never blocks the
trainer, never aborts) and decodes against it.  Between request batches
the engine refreshes the RSS watermark by replaying the shipped WAL
(Algorithm 1 runs on the replica, per the paper's multinode
architecture).

Ported from `repro.serve.engine`.  The reference jit-compiles prefill and
decode; here they run eagerly, with the attention (dense models, Jamba's
attention layers), the WKV recurrence (RWKV6) and the selective scan
(Jamba's Mamba layers) in the Hopper kernels on "cuda".  The request's
cache is allocated once and written in place: for attention a KV cache
of `max_seq` slots; for RWKV6 the recurrent state — per layer a
[B, H, N, N] f32 WKV state and the two token shifts; for Mamba per layer
a [B, Di, N] f32 scan state and the last d_conv-1 conv inputs — the
recurrent states a fixed size whatever the length.  The cache length stays a Python int, so the decode
loop makes no host-device sync (the argmax it feeds back stays on the
device).  The reference's page-versioned KV cache option is not carried
over (it has no code in the reference engine either).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..kernels.config import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import check_supported, decode_step, prefill
from ..tensorstore.versioned import VersionedParamStore


@dataclass
class GenerationResult:
    tokens: Any                 # [B, n_steps]
    snapshot_lsn: int           # WAL position of the pinned version
    freshness_lag: int          # LSNs behind the newest committed version


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class ServingEngine:
    def __init__(self, cfg: ModelConfig, store: VersionedParamStore, *,
                 max_seq: int = 256, device=None):
        """`device=None` means "cuda" and raises without a GPU; the
        published parameter versions must live on that device."""
        check_supported(cfg)
        self.cfg = cfg
        self.store = store
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self._prefill = lambda p, b: prefill(p, cfg, b, cache_len=max_seq)
        self._decode = lambda p, t, c, n: decode_step(p, cfg, t, c, n)

    def refresh(self):
        """Replay shipped WAL; rebuild RSS (replica-side, asynchronous)."""
        return self.store.refresh()

    def _check_params(self, params) -> None:
        for t in _leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"pinned parameters are on {t.device}, "
                                 f"the engine serves on {self.device}")

    def generate(self, batch: dict, n_steps: int,
                 *, refresh_between_steps: bool = False) -> GenerationResult:
        """Prefill the prompt then decode `n_steps` tokens against ONE
        pinned snapshot (a protected read-only transaction: all reads
        observe the same consistent version even while the trainer keeps
        publishing).  batch["tokens"]: [B, S] token ids (a tensor or an
        array), with S + n_steps <= max_seq."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        S = tokens.shape[1]
        if S + n_steps > self.max_seq:
            raise ValueError(f"prompt {S} + {n_steps} steps exceeds "
                             f"max_seq {self.max_seq}")
        batch = {**batch, "tokens": tokens}
        pin, params = self.store.pin_snapshot()
        lsn = self.store.visible_lsn()
        try:
            self._check_params(params)
            logits, cache = self._prefill(params, batch)
            toks = []
            tok = logits.argmax(dim=-1)[:, None]
            n = S
            for _ in range(n_steps):
                toks.append(tok)
                logits, cache = self._decode(params, tok, cache, n)
                tok = logits.argmax(dim=-1)[:, None]
                n += 1
                if refresh_between_steps:
                    # watermark may advance; THIS transaction stays pinned
                    self.refresh()
            out = torch.cat(toks, dim=1) if toks else \
                tokens.new_zeros((tokens.shape[0], 0))
        finally:
            self.store.release(pin)
        return GenerationResult(tokens=out, snapshot_lsn=lsn,
                                freshness_lag=self.store.freshness_lag())
