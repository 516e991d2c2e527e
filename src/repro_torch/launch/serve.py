"""Serving launcher: batched prefill + decode with the power plane, or a
routed traffic trace over the fleet (port of `repro/launch/serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2p5_14b \
        --tiny --max-new 32 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2p5_14b \
        --tiny --fleet-chips 16 --router headroom [--batch-cap 4] \
        [--migrate-after-ticks 6] [--device cpu]

Every decoder-only architecture serves through it: the dense family
(Qwen2.5, MiniCPM, Granite, Mistral-Large), the moe family (`--arch
qwen3_moe_30b_a3b`, `--arch grok1_314b`), the vlm family (`--arch
internvl2_2b`, tokens only, as the reference serves it), the ssm family
(`--arch rwkv6_7b`, whose decode cache is the recurrent state) and the
hybrid family (`--arch zamba2_1p2b`: Mamba2 layers, whose decode cache is
the conv and SSD state, and one shared sliding-window attention block
with a KV cache per occurrence). The encdec family (`--arch
whisper_base`) has no prefill and is refused, as the reference refuses
it.

Weights are random, drawn on the device from seed 0, as the JAX launcher
draws them. Unlike the JAX launcher, `--tiny` is honoured: without it the
full configuration is built (its parameter count sizes the roofline
profiles).
`--control-path host` serves with the SW-path analogue,
`HostRailController(policy, n_chips=max(fleet_chips, 1))`: decisions
between steps, actuated through the simulated PMBus fleet.
`--router headroom|roundrobin` routes a seeded bursty trace
(`--trace-requests`, `--trace-seed`) over the fleet instead of running
`generate` and prints the per-request SLO ledger's summary: a 0.02 s tick,
at most span / tick + 400 ticks, pinned chips kept eligible (the launcher
world has no error telemetry, so every chip walks to its policy floor and
reads as pinned). `--tick-path` picks the fused tick or the per-tick loop,
`--batch-cap` continuous batching over that many lanes a chip,
`--migrate-after-ticks` in-flight migration (headroom router only).
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
from repro_torch.serve.router import HeadroomRouter, RoundRobinRouter
from repro_torch.serve.traffic import bursty_trace


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
                    default="none",
                    help="route a seeded bursty traffic trace over the "
                         "fleet by per-rail voltage headroom (or the "
                         "round-robin baseline) instead of running "
                         "generate(); needs --fleet-chips")
    ap.add_argument("--trace-requests", type=int, default=48,
                    help="requests in the bursty trace (--router only)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--tick-path", choices=("auto", "fused", "loop"),
                    default="auto",
                    help="serve tick path (--router only): 'fused' the "
                         "one-function tick, 'loop' the per-tick host "
                         "loop, 'auto' fused for in-graph controllers")
    ap.add_argument("--fast-forward", action="store_true",
                    help="skip idle tick gaps (empty queue, no resident "
                         "work) by jumping simulated time to the next "
                         "arrival; fused tick path only")
    ap.add_argument("--batch-cap", type=int, default=0,
                    help="continuous batching: each chip decodes a "
                         "token-level batch over up to BATCH_CAP resident "
                         "lanes at the shared-roofline per-lane rate "
                         "(0 = the full-rate-per-slot model; --router "
                         "only; the cap becomes the router's capacity)")
    ap.add_argument("--migrate-after-ticks", type=int, default=0,
                    help="in-flight migration: move a chip's resident "
                         "decode lanes after its pinned/over-bound flag "
                         "held this many consecutive ticks (0 = off; "
                         "needs --router headroom)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.batch_cap < 0:
        ap.error(f"--batch-cap must be >= 0, got {args.batch_cap}")
    if args.migrate_after_ticks < 0:
        ap.error(f"--migrate-after-ticks must be >= 0, got "
                 f"{args.migrate_after_ticks}")
    if args.batch_cap and args.router == "none":
        ap.error("--batch-cap batches a router's lanes; pass --router "
                 "headroom (or roundrobin)")
    if args.migrate_after_ticks and args.router != "headroom":
        ap.error("--migrate-after-ticks needs the headroom router's "
                 "migration planner; pass --router headroom")
    if args.router != "none" and not args.fleet_chips:
        raise SystemExit("--router places work across a fleet; pass "
                         "--fleet-chips N")
    device = resolve_device(args.device)

    cfg = get_config(args.arch, tiny=args.tiny)
    if cfg.family == "encdec":
        raise SystemExit("whisper serving uses cross-attention: encode the "
                         "frames, then `registry.build(cfg).decode_fn` with "
                         "the encoder's `cross_kv` (models/encdec.py)")
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
    router = None
    if args.router != "none":
        # the launcher world has no error telemetry, so every chip walks to
        # its policy floor and reads as pinned: a drain-pinned router would
        # shed the whole trace, so pinned chips stay eligible here.
        # --batch-cap sets the lane capacity (lanes are the router's
        # slots); without it --batch slots a chip
        lanes = args.batch_cap or args.batch
        router = (HeadroomRouter(capacity=lanes, drain_pinned=False)
                  if args.router == "headroom"
                  else RoundRobinRouter(capacity=lanes))
    engine = ServeEngine(
        cfg, params, max_len=args.prompt_len + args.max_new + 8,
        batch_size=args.batch,
        prefill_profile=StepProfile(2.0 * n * args.batch * args.prompt_len,
                                    2.0 * n, 0.0),
        decode_profile=StepProfile(2.0 * n * args.batch, 2.0 * n, 0.0),
        controller=controller, fleet=fleet, router=router,
        batch_cap=args.batch_cap or None, device=device)
    if router is not None:
        trace = bursty_trace(args.trace_requests, seed=args.trace_seed)
        # a serving-scale tick so the seconds-long trace spans hundreds of
        # ticks; the run ends by the trace span plus drain slack, so a
        # saturated fleet reports unplaced work instead of spinning
        tick_s = 0.02
        span = trace.requests[-1].t_arrival_s if trace.requests else 0.0
        fused = {"auto": None, "fused": True, "loop": False}[args.tick_path]
        ledger = engine.serve_trace(trace, tick_s=tick_s,
                                    max_ticks=int(span / tick_s) + 400,
                                    fused=fused,
                                    fast_forward=args.fast_forward,
                                    migrate_after_ticks=(
                                        args.migrate_after_ticks or None))
        print(f"{cfg.name} ({n/1e6:.1f}M): routed {len(trace)} requests "
              f"over {engine.n_chips} chips ({args.router})")
        print("trace:", engine.last_trace)
        print("slo:", ledger.summary())
        print("summary:", engine.summary())
        return engine, ledger
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    out = engine.generate(prompts, max_new_tokens=args.max_new)
    print(f"{cfg.name} ({n/1e6:.1f}M): generated {out.shape} tokens")
    print("summary:", engine.summary())
    return engine, out


if __name__ == "__main__":
    main()
