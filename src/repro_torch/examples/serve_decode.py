"""Batched serving example: prefill + greedy decode with KV caches, with the
power plane accounting energy per token and the phase-aware policy
undervolting during the memory-bound decode phase (paper §I's
'communication-light phases' argument, serving-side; port of
`examples/serve_decode.py`). Weights are random, drawn on the device from
seed 0.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import PhaseAware
from repro_torch.core.power_plane import StepProfile
from repro_torch.models import lm, registry
from repro_torch.models.common import resolve_device
from repro_torch.serve.engine import ServeEngine


CONFIG = ModelConfig(name="serve-demo", family="dense", n_layers=6,
                     d_model=256, n_heads=4, n_kv_heads=2, d_ff=768,
                     vocab_size=4096, tp=1)
BATCH, PROMPT, NEW = 4, 32, 48


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)

    cfg = CONFIG
    api = registry.build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n = sum(p.numel() for p in lm.tree_leaves(params))
    print(f"serving {n/1e6:.1f}M-param model, batch=4")

    B, Tp, new = BATCH, PROMPT, NEW
    # profiles: prefill is compute-bound, decode is HBM-bound — the policy
    # sees this through the roofline terms and adapts rails per phase
    prefill_profile = StepProfile(2.0 * n * B * Tp, 2.0 * n, 0.0)
    decode_profile = StepProfile(2.0 * n * B, 2.0 * n + 4e6 * B, 0.0)

    engine = ServeEngine(cfg, params, max_len=Tp + new + 8, batch_size=B,
                         prefill_profile=prefill_profile,
                         decode_profile=decode_profile,
                         policy=PhaseAware(), device=device)

    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, Tp))
    out = engine.generate(prompts.astype(np.int32), max_new_tokens=new)
    print(f"generated {out.shape[1]} tokens x {B} sequences")
    print("first sequence:", out[0][:16], "...")

    s = engine.summary()
    print(f"\nenergy: {s['energy_j']:.3f} J total, "
          f"{1e3*s['j_per_decoded_token']:.2f} mJ/token")
    print(f"rails after decode phase: v_core={s['v_core']:.3f} "
          f"v_io={s['v_io']:.3f} (undervolted: decode is HBM-bound, "
          f"core/ICI have slack)")

    # determinism check: greedy decode is reproducible
    engine2 = ServeEngine(cfg, params, max_len=Tp + new + 8, batch_size=B,
                          prefill_profile=prefill_profile,
                          decode_profile=decode_profile, device=device)
    out2 = engine2.generate(prompts.astype(np.int32), max_new_tokens=new)
    print("\ndeterministic generation:", bool((out == out2).all()))


if __name__ == "__main__":
    main()
