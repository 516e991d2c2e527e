"""Deterministic synthetic token pipeline, copied from
`repro/data/pipeline.py` (numpy; the batches are identical bit for bit),
with `torch_batch` in place of `jax_batch`.

The pipeline is stateless given (seed, step): any batch can be recomputed
without coordination, so a restart resumes exactly. Mixture of n-gram-ish
Markov streams + copy spans so the loss actually decreases (pure uniform
tokens would pin CE at log V).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1
    copy_span: int = 32           # periodic copy task: repeat a window


class SyntheticLM:
    """Markov-chain token source with copy spans. Deterministic per
    (seed, step, row)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab_size, 4096)  # transition table kept small
        self._v = v
        # sparse-ish row-stochastic transition logits
        self._trans = rng.dirichlet(np.full(64, 0.5), size=v)
        self._next = rng.integers(0, v, size=(v, 64))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        B, T = cfg.global_batch, cfg.seq_len
        out = np.empty((B, T + 1), np.int32)
        for b in range(B):
            rng = np.random.default_rng(
                (cfg.seed * 0x9E3779B1 + step * 0x85EBCA77 + b) & 0xFFFFFFFF)
            toks = np.empty(T + 1, np.int32)
            toks[0] = rng.integers(0, self._v)
            i = 1
            while i < T + 1:
                if cfg.copy_span and i > cfg.copy_span and rng.random() < 0.05:
                    span = min(cfg.copy_span, T + 1 - i)
                    toks[i:i + span] = toks[i - cfg.copy_span:
                                            i - cfg.copy_span + span]
                    i += span
                else:
                    cur = toks[i - 1] % self._v
                    j = rng.choice(64, p=self._trans[cur])
                    toks[i] = self._next[cur, j]
                    i += 1
            out[b] = toks
        return {"tokens": out[:, :-1],
                "labels": out[:, 1:].astype(np.int32)}

    def torch_batch(self, step: int, device="cuda") -> dict[str, torch.Tensor]:
        """`batch(step)` as int32 tensors on `device` (one host-to-device
        copy per array)."""
        device = resolve_device(device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.batch(step).items()}
