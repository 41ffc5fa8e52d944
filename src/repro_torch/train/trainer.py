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

Over a mesh (a ``launch.mesh.ProcessMesh``: every rank of it runs its own
``Trainer`` with the same arguments) the trainer runs the partitioned
step: each rank builds the whole model from the seed and keeps its blocks
(``LM.shard``), or restores only its blocks, keeps its rows of each batch
(``Pipeline.shard_for_step``), and saves over the mesh (the whole leaves
assembled, rank 0 writing the files a one-process run writes).  Every
rank runs the straggler watchdog on its own step times and keeps its own
``history``; the losses are global, the same on every rank.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.device import DeviceLike, resolve_device
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
        mesh: None, or this rank's ``launch.mesh.ProcessMesh`` (a
            partitioned step; any arch).
        device: where the model and the state live (None: the card; the
            mesh's device over a mesh).

    Raises:
        TypeError: a mesh that is not a ``ProcessMesh``.
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: TrainerConfig, mesh=None,
                 opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                 data_cfg: DataConfig = DataConfig(), *,
                 device: DeviceLike = None):
        made = TS.make_train_step(
            cfg, shape, mesh, opt_cfg=opt_cfg, grad_accum=tcfg.grad_accum,
            schedule_kwargs=tcfg.schedule_kwargs)
        self.step_fn, self.specs = made if mesh is not None else (made,
                                                                  None)
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None and
                                     device is None else device)
        self.opt_cfg = opt_cfg
        self.pipeline = Pipeline(cfg, shape, data_cfg)
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep)
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
            mesh_kw = {} if self.mesh is None else {
                "mesh": self.mesh, "specs": self._ckpt_specs()}
            state = self.ckpt.restore(latest, device=self.device, **mesh_kw)
            self.model = LM(self.cfg, device="meta", masters=True)
            if self.mesh is not None:
                self.model.shard(self.mesh, self.specs["params"])
            self.model.load_state_dict(state["params"], strict=True,
                                       assign=True)
            self.opt_state = state["opt"]
            self.start_step = latest + 1
            log.info("resumed from step %d", latest)
            return self.start_step
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        self.model = init_params(self.cfg, device=self.device, generator=gen,
                                 masters=True)
        if self.mesh is not None:
            self.model.shard(self.mesh, self.specs["params"])
        self.opt_state = adamw.init_state(dict(self.model.named_parameters()),
                                          self.opt_cfg)
        self.start_step = 0
        return 0

    def state(self) -> Dict:
        """What a checkpoint holds: the masters and the optimiser state."""
        return {"params": {n: p.detach()
                           for n, p in self.model.named_parameters()},
                "opt": self.opt_state}

    def _ckpt_specs(self) -> Dict:
        """The specs of :meth:`state`'s leaves over the mesh."""
        return {"params": self.specs["params"], "opt": self.specs["opt"]}

    def _save(self, step: int) -> None:
        if self.mesh is None:
            self.ckpt.save(step, self.state())
        else:
            self.ckpt.save(step, self.state(), mesh=self.mesh,
                           specs=self._ckpt_specs())

    def _put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _host_batch(self, step: int) -> Dict:
        """The step's batch: this rank's rows of it over a mesh."""
        if self.mesh is None:
            return self.pipeline.batch_for_step(step)
        return self.pipeline.shard_for_step(step, self.mesh,
                                            self.tcfg.grad_accum)

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
            batch = self._put_batch(self._host_batch(step))
            t0 = time.perf_counter()
            metrics = self.step_fn(self.model, self.opt_state, batch, step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if (step + 1) % self.tcfg.ckpt_every == 0 or \
                    step == num_steps - 1:
                self._save(step)
            done += 1
            if stop_after is not None and done >= stop_after:
                if self.ckpt.latest_step() != step:
                    self._save(step)
                break
        return {k: float(v) for k, v in metrics.items()} if metrics else {}
