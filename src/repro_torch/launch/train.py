"""Trainer: deterministic data, delta-compressed checkpoints, crash
restart, straggler accounting.

The port of the reference's ``repro/launch/train.py``; the ``Trainer`` runs on
one device:

* **restart-safe**: state = (step, params, opt) lives in the NeurStore
  checkpoint store (``CheckpointManager``); the data pipeline is
  step-indexed, so a resume from any step replays the exact token stream.
  The store's names and dtypes are the reference's, so a store written by
  either package's ``Trainer`` resumes in the other.
* **straggler mitigation**: per-step wall times feed an EWMA; steps slower
  than ``straggler_factor``× the EWMA are counted and surfaced via
  ``TrainReport`` and the ``on_straggler`` callback.
* **async checkpointing**: save threads overlap the next steps (the
  snapshot to host memory is taken before the call returns).
* **elastic restore**: :func:`restore_sharded` restores the parameters
  unsharded and places them by the live mesh's rules, whatever the mesh
  they were trained on (DTensors over a ``DeviceMesh``).

Usage:
    trainer = Trainer(cfg, ckpt_dir)            # device="cuda" by default
    report = trainer.fit(steps=100, batch=8, seq=128)
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..data import SyntheticLM
from ..kernels.ops import resolve_device
from ..models import init_params
from ..models.config import ModelConfig
from ..optim import adamw_init
from .steps import make_train_step

__all__ = ["TrainReport", "Trainer", "restore_sharded"]


@dataclasses.dataclass
class TrainReport:
    start_step: int
    end_step: int
    losses: list
    step_seconds: list
    n_stragglers: int
    resumed: bool

    @property
    def final_loss(self) -> float:
        return float(np.mean(self.losses[-5:]))


class Trainer:
    def __init__(self, cfg: ModelConfig, ckpt_dir: str, *,
                 n_microbatches: int = 1, lr: float = 3e-4, seed: int = 0,
                 ckpt_every: int = 50, straggler_factor: float = 3.0,
                 on_straggler=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mgr = CheckpointManager(ckpt_dir, device=self.device)
        self.data = SyntheticLM(cfg.vocab_size, seed=seed)
        self.step_fn = make_train_step(cfg, n_microbatches, lr=lr)
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self.seed = seed

    def _init_or_resume(self):
        latest = self.mgr.latest_step()
        if latest is not None:
            step, state = self.mgr.restore()
            return step, state["params"], state["opt"], True
        params = init_params(self.cfg, self.seed, self.device)
        return 0, params, adamw_init(params), False

    def fit(self, steps: int, batch: int, seq: int) -> TrainReport:
        start, params, opt, resumed = self._init_or_resume()
        losses, times = [], []
        ewma = None
        n_strag = 0
        for step in range(start, start + steps):
            t0 = time.perf_counter()
            b = self.data.batch(step, batch, seq)
            b = {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
            params, opt, metrics = self.step_fn(params, opt, b)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)
            times.append(dt)
            if step > start:  # first step includes the kernels' build — no signal
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if dt > self.straggler_factor * ewma and len(times) > 3:
                    n_strag += 1
                    if self.on_straggler is not None:
                        self.on_straggler(step, dt, ewma)
            if (step + 1) % self.ckpt_every == 0:
                self.mgr.save(step + 1, params, opt, blocking=False)
        self.mgr.save(start + steps, params, opt, blocking=True)
        self._params, self._opt = params, opt
        return TrainReport(start, start + steps, losses, times, n_strag,
                           resumed)

    def storage_report(self) -> dict:
        return self.mgr.storage_report()


def restore_sharded(mgr: CheckpointManager, mesh, ctx, step=None):
    """Elastic restore: load unsharded tensors, place them with the live
    mesh's rules (any topology). Returns (step, params as DTensors), or
    (None, None) when the store holds no checkpoint. Only the parameters
    are read from the store, as the reference returns only them; every
    rank restores the same tensors and keeps its own part of each. The
    placed parameters go to a step of ``launch.shardings.sharded`` as they
    are: on the ``"tp"`` route each rank keeps its ``model`` shards."""
    from . import shardings as shd

    step, state = mgr.restore(step, params_only=True)
    if state is None:
        return None, None
    specs = shd.param_specs_tree(state["params"], ctx)
    return step, shd.place(state["params"], specs, mesh)
