"""Fault-tolerant training loop (the reference's ``repro.train.trainer``).

* checkpoint/restart: resume from the newest committed checkpoint; the
  stateless data pipeline guarantees no batch is replayed or skipped.
* crash safety: checkpoints are atomic (tmp + rename + sentinel); a kill
  mid-save leaves the previous checkpoint in charge.
* straggler watchdog: an EMA of the step wall time; a step slower than
  ``straggler_factor`` x the EMA is logged and counted.

The model is an ``LM`` with fp32 masters on ``device``, built from a
``torch.Generator`` seeded with ``TrainerConfig.seed``; a step's wall time
ends when its loss is read back (which waits for the device).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.device import MULTI_CARD, DeviceLike, resolve_device
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.model import LM, init_params
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    grad_accum: int = 1
    seed: int = 0
    schedule_kwargs: Optional[Dict] = None


class Trainer:
    """Runs ``make_train_step`` over the pipeline's batches with
    checkpoints.

    Args:
        cfg, shape, tcfg, opt_cfg, data_cfg: as the reference's.
        mesh: must be None (several cards come with the multi-card item).
        device: where the model and the state live (None: the card).
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: TrainerConfig, mesh=None,
                 opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                 data_cfg: DataConfig = DataConfig(), *,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(f"Trainer over a mesh comes with "
                                      f"{MULTI_CARD}")
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg
        self.pipeline = Pipeline(cfg, shape, data_cfg)
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep)
        self.step_fn = TS.make_train_step(
            cfg, shape, opt_cfg=opt_cfg, grad_accum=tcfg.grad_accum,
            schedule_kwargs=tcfg.schedule_kwargs)
        self.model: Optional[LM] = None
        self.opt_state: Optional[Dict] = None
        self.start_step = 0
        self.step_time_ema: Optional[float] = None
        self.straggler_events = []
        self.history = []

    def init_or_restore(self) -> int:
        """Restore the newest committed step, or build the model from the
        seed; returns the first step to run."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, device=self.device)
            self.model = LM(self.cfg, device="meta", masters=True)
            self.model.load_state_dict(state["params"], strict=True,
                                       assign=True)
            self.opt_state = state["opt"]
            self.start_step = latest + 1
            log.info("resumed from step %d", latest)
            return self.start_step
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        self.model = init_params(self.cfg, device=self.device, generator=gen,
                                 masters=True)
        self.opt_state = adamw.init_state(dict(self.model.named_parameters()),
                                          self.opt_cfg)
        self.start_step = 0
        return 0

    def state(self) -> Dict:
        """What a checkpoint holds: the masters and the optimiser state."""
        return {"params": {n: p.detach()
                           for n, p in self.model.named_parameters()},
                "opt": self.opt_state}

    def _put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _watchdog(self, step: int, dt: float):
        if self.step_time_ema is None:
            self.step_time_ema = dt
            return
        if dt > self.tcfg.straggler_factor * self.step_time_ema:
            self.straggler_events.append((step, dt, self.step_time_ema))
            log.warning("straggler step %d: %.3fs vs EMA %.3fs",
                        step, dt, self.step_time_ema)
        d = self.tcfg.ema_decay
        self.step_time_ema = d * self.step_time_ema + (1 - d) * dt

    def run(self, num_steps: int, stop_after: Optional[int] = None) -> Dict:
        """Run to ``num_steps`` total; ``stop_after`` simulates preemption
        after that many *local* steps (with a save, as on SIGTERM)."""
        if self.model is None:
            self.init_or_restore()
        done = 0
        metrics = {}
        for step in range(self.start_step, num_steps):
            batch = self._put_batch(self.pipeline.batch_for_step(step))
            t0 = time.perf_counter()
            metrics = self.step_fn(self.model, self.opt_state, batch, step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if (step + 1) % self.tcfg.ckpt_every == 0 or \
                    step == num_steps - 1:
                self.ckpt.save(step, self.state())
            done += 1
            if stop_after is not None and done >= stop_after:
                if self.ckpt.latest_step() != step:
                    self.ckpt.save(step, self.state())
                break
        return {k: float(v) for k, v in metrics.items()} if metrics else {}
