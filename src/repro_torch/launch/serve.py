"""Serving launcher: batched prefill + decode with the power plane (port of
`repro/launch/serve.py`, the `generate` path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2p5_14b \
        --tiny --max-new 32 [--device cpu]

Any ported architecture serves through it: the dense family (Qwen2.5,
MiniCPM), the ssm family (`--arch rwkv6_7b`, whose decode cache is the
recurrent state) and the hybrid family (`--arch zamba2_1p2b`: Mamba2
layers, whose decode cache is the conv and SSD state, and one shared
sliding-window attention block with a KV cache per occurrence).

Weights are random, drawn on the device from seed 0, as the JAX launcher
draws them. Unlike the JAX launcher, `--tiny` is honoured: without it the
full configuration is built.
`--control-path host` serves with the SW-path analogue,
`HostRailController(policy, n_chips=max(fleet_chips, 1))`: decisions
between steps, actuated through the simulated PMBus fleet. Routed serving
(`--router`) is not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.control_plane import (HostRailController,
                                            InGraphRailController)
from repro_torch.core.hwspec import FleetSpec
from repro_torch.core.policy import POLICIES, WorstChipGate
from repro_torch.core.power_plane import StepProfile
from repro_torch.models import lm, registry
from repro_torch.models.common import resolve_device
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--policy", choices=list(POLICIES), default="phase-aware")
    ap.add_argument("--control-path", choices=("in-graph", "host"),
                    default="in-graph")
    ap.add_argument("--fleet-chips", type=int, default=0,
                    help="serve on an [n_chips] fleet plane with per-chip "
                         "process variation (0 = scalar single-chip)")
    ap.add_argument("--fleet-seed", type=int, default=0)
    ap.add_argument("--router", choices=("none", "headroom", "roundrobin"),
                    default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.router != "none":
        raise NotImplementedError("--router is not yet ported")
    device = resolve_device(args.device)

    cfg = get_config(args.arch, tiny=args.tiny)
    api = registry.build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n = sum(p.numel() for p in lm.tree_leaves(params))

    policy = POLICIES[args.policy]
    fleet = (FleetSpec.sample(args.fleet_chips, seed=args.fleet_seed)
             if args.fleet_chips else None)
    if fleet is not None:
        policy = WorstChipGate(policy)
    controller = (InGraphRailController(policy)
                  if args.control_path == "in-graph"
                  else HostRailController(policy,
                                          n_chips=max(args.fleet_chips, 1)))
    engine = ServeEngine(
        cfg, params, max_len=args.prompt_len + args.max_new + 8,
        batch_size=args.batch,
        prefill_profile=StepProfile(2.0 * n * args.batch * args.prompt_len,
                                    2.0 * n, 0.0),
        decode_profile=StepProfile(2.0 * n * args.batch, 2.0 * n, 0.0),
        controller=controller, fleet=fleet,
        device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    out = engine.generate(prompts, max_new_tokens=args.max_new)
    print(f"{cfg.name} ({n/1e6:.1f}M): generated {out.shape} tokens")
    print("summary:", engine.summary())


if __name__ == "__main__":
    main()
