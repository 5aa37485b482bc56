"""Host training loop: checkpoint/restart fault tolerance, straggler
monitoring, and RSS publication (the OLTP side of the HTAP boundary);
ported from `repro.train.loop`.

Every training step is a write transaction: the loop runs the step and
publishes the new parameter version to the `VersionedParamStore` (which
appends begin/commit records to the WAL that the serving side replays).
The store keeps each published tree as given; the step never writes into
one (`optim.adamw`), so a reader's pinned version stays as published.

On a mesh of ranks (`group=`, this rank's `parallel.MeshGroup`; one
trainer a rank) the trainer draws the rank's pieces of the state
(`parallel.fsdp.init_local_state`), cuts each global batch of the
pipeline to the rank's rows (`Layout.rows`) and runs the sharded step;
with a `store` each rank publishes its own pieces into its own store,
so the ranks' versions line up by commit LSN; checkpoints are written
whole by rank 0 and restored as the rank's pieces.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..checkpoint import manager as ckpt
from ..data.pipeline import SyntheticPipeline
from ..kernels.config import resolve_device
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig
from ..parallel.fsdp import init_local_state, rank_device
from ..tensorstore.versioned import VersionedParamStore
from .step import init_state, make_train_step


@dataclass
class StragglerMonitor:
    """EMA step-time tracker; flags steps slower than `factor`x the EMA.

    On a real fleet the callback triggers mitigation (hot spare swap /
    within-step timeout); here it records and reports."""
    alpha: float = 0.1
    factor: float = 3.0
    ema: Optional[float] = None
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        straggler = self.ema is not None and dt > self.factor * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        if straggler:
            self.flagged.append((step, dt))
        return straggler


class Trainer:
    def __init__(self, cfg: ModelConfig, *, batch: int, seq_len: int,
                 opt: Optional[AdamWConfig] = None, seed: int = 0,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 publish_every: int = 1,
                 store: Optional[VersionedParamStore] = None, device=None,
                 group=None):
        """`device=None` means "cuda" and raises without a GPU, or with a
        `group` (a mesh of several devices) the rank's device, which
        `device` may only repeat (ValueError otherwise).  The
        parameters are drawn from a `torch.Generator` on the device seeded
        with `seed`; with a `store`, they are published as version 1."""
        self.cfg = cfg
        self.group = group if group is not None and group.mesh.size > 1 \
            else None
        self.device = resolve_device(device) if self.group is None else \
            rank_device(self.group, device)
        self.opt_cfg = opt or AdamWConfig(moment_dtype=cfg.moment_dtype)
        self.pipeline = SyntheticPipeline(cfg, batch=batch, seq_len=seq_len,
                                          seed=seed, device=self.device)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.publish_every = publish_every
        self.store = store
        self.monitor = StragglerMonitor()
        self.step_fn = make_train_step(cfg, self.opt_cfg, self.group)
        self.layout = self.step_fn.layout
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if self.layout is None:
            self.state = init_state(gen, cfg, self.opt_cfg,
                                    device=self.device)
        else:
            self.state = init_local_state(cfg, gen, self.group,
                                          self.opt_cfg, self.device)
        self.metrics_log: list[dict] = []
        if store is not None:
            store.publish(self.state["params"])   # version 1 = init
            store.refresh()

    # ------------------------------------------------------------- recovery
    def try_restore(self) -> bool:
        if self.ckpt_dir is None:
            return False
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return False
        self.state = ckpt.restore(self.ckpt_dir, self.state, step=step,
                                  device=self.device, **self._placed())
        self.pipeline.restore_state({"step": int(self.state["step"])})
        return True

    def _placed(self) -> dict:
        """The checkpoint manager's arguments for a sharded state."""
        if self.layout is None:
            return {}
        return {"group": self.group, "specs": self.layout.specs.state}

    def batch_at(self, i: int) -> dict:
        """Step i's batch: the pipeline's, or the rank's rows of it."""
        batch = self.pipeline.batch_at(i)
        if self.layout is None:
            return batch
        return self.layout.rows(batch, self.cfg.microbatches)

    # ----------------------------------------------------------------- train
    def run(self, n_steps: int, *, inject_failure_at: Optional[int] = None,
            after_step: Optional[Callable[[int, dict], None]] = None
            ) -> list[dict]:
        """Steps 0 .. n_steps - 1 (from a restored step after an injected
        failure).  `after_step(i, metrics)`, where given, runs after step
        i's publish and checkpoint (a reader served between steps)."""
        done = 0
        while done < n_steps:
            try:
                done = self._run_inner(done, n_steps, inject_failure_at,
                                       after_step)
            except RuntimeError as e:
                if "injected-failure" not in str(e):
                    raise
                # fault tolerance path: restore from latest checkpoint
                restored = self.try_restore()
                done = int(self.state["step"]) if restored else 0
            finally:
                inject_failure_at = None      # injections are one-shot
        return self.metrics_log

    def _run_inner(self, done: int, n_steps: int,
                   inject_failure_at: Optional[int], after_step) -> int:
        for i in range(done, n_steps):
            if inject_failure_at is not None and i == inject_failure_at:
                raise RuntimeError("injected-failure")
            t0 = time.perf_counter()
            batch = self.batch_at(i)
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            metrics.update(step=i, dt=dt,
                           straggler=self.monitor.observe(i, dt))
            self.metrics_log.append(metrics)
            if self.store is not None and (i + 1) % self.publish_every == 0:
                self.store.publish(self.state["params"])
            if self.ckpt_dir and (i + 1) % self.ckpt_every == 0:
                ckpt.save(self.state, i + 1, self.ckpt_dir, **self._placed())
            if after_step is not None:
                after_step(i, metrics)
        return n_steps
