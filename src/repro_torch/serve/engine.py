"""Serving engine: batched prefill/decode over RSS-pinned snapshots.

The OLAP side of the HTAP boundary: every request batch pins a parameter
snapshot through the `VersionedParamStore` (wait-free — never blocks the
trainer, never aborts) and decodes against it.  Between request batches
the engine refreshes the RSS watermark by replaying the shipped WAL
(Algorithm 1 runs on the replica, per the paper's multinode
architecture).

Ported from `repro.serve.engine`.  The reference jit-compiles prefill and
decode; here they run eagerly, with the attention (dense models, Jamba's
attention layers, Whisper's encoder, self- and cross-attention), the WKV
recurrence (RWKV6) and the selective scan (Jamba's Mamba layers) in the
Hopper kernels on "cuda"; Whisper's encoder runs once a request, in
prefill.  The request's cache is allocated once and written in place:
for attention a KV cache of `max_seq` slots, and for cross-attention the
encoder output's K/V (`encoder_len` slots, written once); for RWKV6 the
recurrent state — per layer a [B, H, N, N] f32 WKV state and the two
token shifts; for Mamba per layer a [B, Di, N] f32 scan state and the
last d_conv-1 conv inputs — the recurrent states a fixed size whatever
the length.  The cache length stays a Python int, so the decode loop
makes no host-device sync (the argmax it feeds back stays on the
device).  The reference's page-versioned KV cache option is not carried
over (it has no code in the reference engine either).

On a mesh of ranks (`group=`: this rank's `parallel.MeshGroup`; one
engine a rank, each over a store of the rank's pieces of every version,
`parallel.tensor`), the reference's single controller becomes a
protocol: rank 0 pins its newest visible version and every rank pins
that same commit (`VersionedParamStore.pin_version`), so a request
reads one consistent snapshot on every rank.  A commit LSN names one
version on every rank only while the ranks' stores take the same
writes, so every rank raises, naming the LSNs, and none serves another
version, where a rank's store lacks the commit or its WAL head is not
rank 0's (a rank that took a write more or fewer).  The batch, prompt inputs included, splits over "data"; the
model runs tensor parallel over "model" (`models.sharding`: the dense
attention decoders and the Mamba and MoE families, Jamba and Mixtral,
whose Mamba channels and experts' d_ff are cut too, and RWKV6, whose
time mix and channel mix stay whole on every rank and whose vocabulary
alone is cut; Whisper is refused by `parallel.tensor.check_tp`); on
the reference's pod mesh "data" is ("pod", "data"); the greedy
choice over the vocab-sharded logits is gathered over "model"
(`parallel.tensor.greedy`); and the tokens of the whole batch are
gathered over "data", so every rank returns the same result.

With `specs=` ({parameter leaf path: spec}) the ranks' stores hold
their pieces under a placement `parallel.fsdp` stores instead (the
training placement a `Trainer(group=)` publishes under, or the one
`launch.specs.params_specs(serving=True)` falls back on for a model
whose shard passes the resident limit), and the engine serves it
gathered (`parallel.fsdp.ServeView`): `check_train`'s rule applies in
place of `check_tp`, the batch is cut over the placement's batch axes
(`launch.mesh.train_dp_axes`: ("data", "model") under fsdp2d, ("pod",
"data") on the pod mesh; a batch they do not divide is refused), each
rank gathers one layer's whole weights before the layer runs and
computes whole layers on its rows, takes the greedy choice over the
whole vocabulary itself, and the tokens are gathered over the batch
axes in piece order.  The pin is the
same protocol.  The reference serves the training placement by GSPMD's
regathers inside its jitted prefill and decode, its batch over "data"
alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..kernels.config import resolve_device
from ..models.config import ModelConfig
from ..models.sharding import with_mesh
from ..models.transformer import decode_step, prefill
from ..parallel.fsdp import ServeView
from ..parallel.tensor import check_tp, greedy, split_batch
from ..tensorstore.versioned import VersionedParamStore
from ..tree import leaves


@dataclass
class GenerationResult:
    tokens: Any                 # [B, n_steps]
    snapshot_lsn: int           # WAL position of the pinned version
    freshness_lag: int          # LSNs behind the newest committed version


class ServingEngine:
    def __init__(self, cfg: ModelConfig, store: VersionedParamStore, *,
                 max_seq: int = 256, device=None, group=None,
                 specs: dict = None):
        """`device=None` means "cuda" and raises without a GPU; the
        published parameter versions must live on that device.  `group`:
        this rank's `MeshGroup`, on `device` (ValueError otherwise, and
        for a config `parallel.tensor.check_tp` refuses on its mesh);
        None, or a mesh of one device, serves on the one device.
        `specs`: the {leaf path: spec} placement of the store's pieces,
        served gathered (module docstring; ValueError where
        `parallel.fsdp.ServeView` refuses it); None: the resident
        tensor-parallel layout (`parallel.tensor.serve_specs`)."""
        self.cfg = cfg
        self.store = store
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.group = self.view = None
        if group is not None and group.mesh.size > 1:
            if group.device != self.device:
                raise ValueError(f"rank {group.rank} is on {group.device}, "
                                 f"the engine on {self.device}")
            if specs is None:
                check_tp(cfg, group.mesh)
            else:
                self.view = ServeView(group, cfg, specs)
            self.group = group
        self._prefill = lambda p, b: prefill(p, cfg, b, cache_len=max_seq)
        self._decode = lambda p, t, c, n: decode_step(p, cfg, t, c, n)

    def refresh(self):
        """Replay shipped WAL; rebuild RSS (replica-side, asynchronous)."""
        return self.store.refresh()

    def _check_params(self, params) -> None:
        for t in leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"pinned parameters are on {t.device}, "
                                 f"the engine serves on {self.device}")

    def generate(self, batch: dict, n_steps: int,
                 *, refresh_between_steps: bool = False) -> GenerationResult:
        """Prefill the prompt then decode `n_steps` tokens against ONE
        pinned snapshot (a protected read-only transaction: all reads
        observe the same consistent version even while the trainer keeps
        publishing).  batch["tokens"]: [B, S] token ids, with S + n_steps
        <= max_seq; beside it the model's other inputs
        (`mrope_positions`, `vision_embeds`, `enc_embeds`).  Every entry
        (a tensor or an array) is moved to the engine's device."""
        batch = {k: torch.as_tensor(x, device=self.device)
                 for k, x in batch.items()}
        tokens = batch["tokens"]
        S = tokens.shape[1]
        if S + n_steps > self.max_seq:
            raise ValueError(f"prompt {S} + {n_steps} steps exceeds "
                             f"max_seq {self.max_seq}")
        g, view = self.group, self.view
        if view is not None:
            batch = view.rows(batch)
        elif g is not None:
            batch = split_batch(batch, g)
        tokens = batch["tokens"]
        # the logits a rank holds: vocab-sharded under tensor
        # parallelism, the whole vocabulary under a view
        vocab_group = None if view is not None else g
        pin, params, lsn = self._pin()
        try:
            self._check_params(params)
            if view is not None:
                view.check(params)
            with with_mesh(view or g):
                logits, cache = self._prefill(params, batch)
                toks = []
                tok = greedy(logits, vocab_group)[:, None]
                n = S
                for _ in range(n_steps):
                    toks.append(tok)
                    logits, cache = self._decode(params, tok, cache, n)
                    tok = greedy(logits, vocab_group)[:, None]
                    n += 1
                    if refresh_between_steps:
                        # watermark may advance; THIS transaction stays
                        # pinned
                        self.refresh()
            out = torch.cat(toks, dim=1) if toks else \
                tokens.new_zeros((tokens.shape[0], 0))
            if view is not None:
                out = g.all_gather(out, view.batch_axes, dim=0)
            elif g is not None:
                out = g.all_gather(out, "data", dim=0)
        finally:
            self.store.release(pin)
        return GenerationResult(tokens=out, snapshot_lsn=lsn,
                                freshness_lag=self.store.freshness_lag())

    def _pin(self) -> tuple[int, Any, int]:
        """(pin id, params, commit LSN) of the version this request
        reads: the store's newest visible one, or on a mesh the one rank
        0 pinned (see the module docstring)."""
        g = self.group
        if g is None:
            pin, params = self.store.pin_snapshot()
            return pin, params, self.store.pinned_lsn(pin)
        pin, params, chosen = None, None, -1
        if g.rank == 0:
            try:
                pin, params = self.store.pin_snapshot()
                chosen = self.store.pinned_lsn(pin)
            except RuntimeError:            # nothing visible: all raise
                pass
        mine = torch.tensor([[chosen, self.store.visible_lsn(),
                              self.store.wal.head_lsn]], device=g.device)
        lsns = g.all_gather(mine, "mesh", dim=0).tolist()     # [ranks, 3]
        lsn = lsns[0][0]
        if lsn < 0:
            raise RuntimeError("rank 0 has no committed version inside RSS "
                               "yet; refresh() after the first publish")
        if g.rank != 0:
            try:
                pin, params = self.store.pin_version(lsn)
            except LookupError:
                pass
        held = g.all_gather(torch.tensor([pin is not None], dtype=torch.int64,
                                         device=g.device), "mesh").tolist()
        lacking = [r for r, ok in enumerate(held) if not ok]
        other = [r for r, row in enumerate(lsns) if row[2] != lsns[0][2]]
        if lacking or other:
            if pin is not None:
                self.store.release(pin)
            why = (f"ranks {lacking} hold no version there (their newest "
                   f"visible lsn {[lsns[r][1] for r in lacking]})"
                   if lacking else
                   f"the WALs of ranks {other} end at lsn "
                   f"{[lsns[r][2] for r in other]}, rank 0's at "
                   f"{lsns[0][2]}, so that lsn may name another version "
                   f"there")
            raise ValueError(f"rank 0 pinned the version committed at lsn "
                             f"{lsn}; {why}: no rank serves another "
                             f"version")
        return pin, params, lsn
