"""Deterministic synthetic token pipeline, copied from
`repro/data/pipeline.py` (numpy; the batches are identical bit for bit),
with `torch_batch` in place of `jax_batch`, and the stub modality
frontends (`stub_frontend_inputs`).

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

    def torch_batch(self, step: int, device="cuda",
                    extra: dict | None = None) -> dict[str, torch.Tensor]:
        """`batch(step)` as int32 tensors on `device` (one host-to-device
        copy per array), `extra`'s entries merged in (the reference's
        `jax_batch(step, extra)`)."""
        device = resolve_device(device)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in self.batch(step).items()}
        if extra:
            batch.update(extra)
        return batch


def stub_frontend_inputs(cfg, family: str, global_batch: int,
                         seed: int = 0, device="cuda") -> dict:
    """The stub modality frontends: precomputed patch (vlm: `img_embeds`
    [B, n_img_tokens, D]) or frame (encdec: `frames` [B, enc_seq_len, D])
    embeddings, the reference's numpy draws (f32, x 0.02) as tensors on
    `device`; nothing for the other families."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if family == "vlm":
        key, n = "img_embeds", cfg.n_img_tokens
    elif family == "encdec":
        key, n = "frames", cfg.enc_seq_len
    else:
        return {}
    x = rng.standard_normal((global_batch, n, cfg.d_model)).astype(
        np.float32) * 0.02
    return {key: torch.from_numpy(x).to(device)}
