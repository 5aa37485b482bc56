"""Deterministic synthetic data pipeline, ported from
`repro.data.pipeline`: the same numpy streams, so the batches are
bit-identical to the reference's (tokens and labels int32, as JAX holds
them), placed on the trainer's device.

Batches are a pure function of (seed, step): the pipeline is resumable
by construction (its checkpoint state is a step counter).  The token
stream has a Zipf-ish marginal so losses move during smoke training runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.config import resolve_device
from ..models.config import ModelConfig


@dataclass
class PipelineState:
    step: int = 0


class SyntheticPipeline:
    def __init__(self, cfg: ModelConfig, *, batch: int, seq_len: int,
                 seed: int = 0, device=None):
        """`device=None` means "cuda" and raises without a GPU."""
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.device = resolve_device(device)
        self.state = PipelineState()

    # ------------------------------------------------------------------ state
    def checkpoint_state(self) -> dict:
        return {"step": self.state.step, "seed": self.seed}

    def restore_state(self, st: dict) -> None:
        self.state.step = int(st["step"])
        self.seed = int(st.get("seed", self.seed))

    # ------------------------------------------------------------------ batch
    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # Zipf-ish marginal over the vocab, cheap and deterministic
        v = self.cfg.vocab_size
        u = rng.random((self.batch, self.seq_len + 1))
        return np.minimum((u ** 3 * v).astype(np.int64), v - 1)

    def next_batch(self) -> dict:
        step = self.state.step
        self.state.step += 1
        return self.batch_at(step)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        toks = self._tokens(step).astype(np.int32)
        batch = {"tokens": self._put(toks[:, :-1]),
                 "labels": self._put(toks[:, 1:])}
        B, S = self.batch, self.seq_len
        if cfg.mrope_sections:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S))
            batch["mrope_positions"] = self._put(pos)
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 7]))
            batch["vision_embeds"] = self._put(
                rng.standard_normal((B, max(S // 4, 1), cfg.d_model),
                                    dtype=np.float32) * 0.02)
        if cfg.is_encoder_decoder:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 11]))
            batch["enc_embeds"] = self._put(
                rng.standard_normal((B, cfg.encoder_len, cfg.d_model),
                                    dtype=np.float32) * 0.02)
        return batch
