"""Deterministic, stateless-seeded data pipeline (the reference's
``repro.data.pipeline``, byte for byte).

``batch_for_step(step)`` is a pure function of (seed, step, shape), so a
restarted trainer resumes at step k and regenerates exactly the batch the
interrupted run would have seen.  Batches are numpy on the host; the
trainer moves them to the device.  Over a mesh each rank draws the
step's global batch from the seed and keeps its rows
(:meth:`Pipeline.shard_for_step`, ``launch.sharding.batch_shard``).

Two sources:
  synthetic  zipf-distributed token ids (heavy-tailed like real text)
  memmap     flat token file (binary uint16/uint32) sampled by stateless
             offsets
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32_000
    zipf_a: float = 1.2
    path: Optional[str] = None      # memmap token file (None => synthetic)
    token_dtype: str = "uint16"


class Pipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.data = dataclasses.replace(data, vocab_size=cfg.vocab_size)
        self._tokens = None
        if data.path:
            self._tokens = np.memmap(data.path, dtype=data.token_dtype,
                                     mode="r")

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.data.seed, step]))

    def _synthetic_tokens(self, rng, shape) -> np.ndarray:
        # Zipf sampling clipped into the vocab (heavy-tailed id frequency).
        raw = rng.zipf(self.data.zipf_a, size=shape)
        return (raw % (self.data.vocab_size - 2) + 2).astype(np.int32)

    def _memmap_tokens(self, rng, batch: int, seq: int) -> np.ndarray:
        n = self._tokens.shape[0] - (seq + 1)
        starts = rng.integers(0, n, size=batch)
        out = np.stack([self._tokens[s:s + seq + 1] for s in starts])
        return out.astype(np.int32)

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        """Training batch: tokens + next-token labels (+ modality stubs)."""
        rng = self._rng(step)
        b, s = self.shape.global_batch, self.shape.seq_len
        if self._tokens is not None:
            seqs = self._memmap_tokens(rng, b, s)
        else:
            seqs = self._synthetic_tokens(rng, (b, s + 1))
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        batch.update(self.modality_stubs(rng, b, s))
        return batch

    def shard_for_step(self, step: int, mesh,
                       grad_accum: int = 1) -> Dict[str, np.ndarray]:
        """This rank's rows of :meth:`batch_for_step` on a process mesh
        (``launch.sharding.batch_shard``: its data shard of each of the
        ``grad_accum`` micro-batches, in order)."""
        from repro_torch.launch.sharding import batch_shard
        return batch_shard(self.batch_for_step(step), self.cfg, mesh,
                           self.shape, grad_accum)

    def modality_stubs(self, rng, b: int, s: int) -> Dict[str, np.ndarray]:
        """Precomputed frame / patch embeddings for the audio (``encdec``)
        and ``vlm`` families, with M-RoPE's 3D positions."""
        cfg = self.cfg
        out: Dict[str, np.ndarray] = {}
        if cfg.family == "encdec":
            out["frames"] = rng.normal(
                size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            n_mm = min(s // 4, 1024)
            out["mm_embeds"] = rng.normal(
                size=(b, n_mm, cfg.d_model)).astype(np.float32)
            # M-RoPE 3D positions: temporal / height / width streams.
            t_pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
            grid = int(np.sqrt(max(n_mm, 1)))
            h_pos = t_pos.copy()
            w_pos = t_pos.copy()
            if grid > 0:
                hw = np.arange(n_mm, dtype=np.int32)
                h_pos[:, :n_mm] = hw // max(grid, 1)
                w_pos[:, :n_mm] = hw % max(grid, 1)
            out["positions_3d"] = np.stack([t_pos, h_pos, w_pos])
        return out
