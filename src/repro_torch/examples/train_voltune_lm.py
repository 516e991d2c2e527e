"""End-to-end training example: a real LM trained for a few hundred steps
with the full production stack — VolTune power plane (phase-aware policy +
host PMBus controller), error-feedback int8 gradient collectives,
step-atomic checkpointing with simulated failure recovery, straggler
mitigation, and telemetry (port of `examples/train_voltune_lm.py`).

The ef sync runs in its world of one (`StepConfig(grad_sync="ef_int8")`,
K10's fused pass a leaf on the card), where the reference wraps the step
in `shard_map` over a one-device `data` mesh. Weights are random, drawn on
the device from seed 0.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_voltune_lm
      [--steps 300] [--d-model 512 --layers 8]
      (~100M params: --d-model 768 --layers 12) [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.control_plane import HostRailController
from repro_torch.core.policy import PhaseAware, StaticNominal
from repro_torch.core.power_plane import (PowerPlaneState, StepProfile,
                                          account_step)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import lm, registry
from repro_torch.models.common import resolve_device
from repro_torch.optim import adamw
from repro_torch.optim.schedule import wsd
from repro_torch.train.step import StepConfig, make_train_step
from repro_torch.train.trainer import (FaultConfig, Trainer, TrainerConfig,
                                       initial_plane_and_ef)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--policy", choices=("phase-aware", "static"),
                    default="phase-aware")
    ap.add_argument("--grad-sync", choices=("auto", "ef_int8"),
                    default="ef_int8")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "voltune_train_ckpt"))
    ap.add_argument("--device", default="cuda")
    return ap


def model_config(args: argparse.Namespace) -> ModelConfig:
    return ModelConfig(
        name="voltune-demo-lm", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=args.d_model // 64,
        n_kv_heads=max(1, args.d_model // 128),
        d_ff=args.d_model * 4 * 2 // 3, vocab_size=4096, tp=1)


def main(argv=None) -> Trainer:
    """Trains and prints the reference's report; returns the trainer (its
    telemetry log, step times and summary)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_config(args)
    api = registry.build(cfg, remat="none")
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in lm.tree_leaves(params))
    print(f"model: {cfg.n_layers}L d={cfg.d_model} -> "
          f"{n_params/1e6:.1f}M params")

    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init_state(params, opt_cfg)
    plane, ef = initial_plane_and_ef(params)

    # roofline profile of this step (scale-correct for the energy model)
    tokens = args.batch * args.seq
    profile = StepProfile(
        flops_per_chip=6.0 * n_params * tokens,
        hbm_bytes_per_chip=14.0 * n_params + 8.0 * tokens * cfg.d_model,
        ici_bytes_per_chip=4.0 * n_params,
        grad_bytes_per_chip=4.0 * n_params)

    policy = PhaseAware() if args.policy == "phase-aware" else StaticNominal()

    def sched(s):
        return wsd(s, peak_lr=3e-4, warmup_steps=20,
                   stable_steps=int(args.steps * 0.7),
                   decay_steps=int(args.steps * 0.2))

    step_cfg = StepConfig(microbatches=1, grad_sync=args.grad_sync,
                          policy=policy)
    train_step = make_train_step(lambda p, b: api.loss_fn(p, b), opt_cfg,
                                 sched, profile, step_cfg)

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=0))
    # SW-path analogue: actuate the in-graph policy's decisions through the
    # simulated PMBus stack (achieved voltages are written back into the
    # plane)
    hc = HostRailController()
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=50, ckpt_dir=args.ckpt_dir,
        async_ckpt=True, controller=hc,
        faults=FaultConfig(fail_prob=0.004, straggler_prob=0.02,
                           straggler_factor=6.0, grace=1.5, seed=7),
        device=device)
    trainer = Trainer(train_step, data, tcfg,
                      {"params": params, "opt": opt, "plane": plane,
                       "ef": ef})

    print(f"training {args.steps} steps (policy={args.policy}, "
          f"grad_sync={args.grad_sync}, failure+straggler injection ON)...")
    log = trainer.run()

    records = list(log.records)
    head = sum(r.loss for r in records[:10]) / 10
    tail = sum(r.loss for r in records[-10:]) / 10
    s = trainer.summary()
    print(f"\nloss: {head:.4f} -> {tail:.4f}   "
          f"({'improved' if tail < head else 'NO IMPROVEMENT'})")
    print(f"energy: {s['energy_j']:.1f} J over {s['time_s']:.2f} modelled-s "
          f"(mean {s['mean_power_w']:.1f} W/chip)")
    print(f"fault tolerance: {s['restarts']} restarts, "
          f"{s['straggler_events']} stragglers mitigated, "
          f"{s['ckpt_writes']} checkpoints")
    print(f"rails at end: v_core={records[-1].v_core:.3f} "
          f"v_hbm={records[-1].v_hbm:.3f} v_io={records[-1].v_io:.3f} "
          f"comp_level={records[-1].comp_level}")

    # compare with the static-nominal baseline energy at identical step math
    if args.policy == "phase-aware":
        nominal_plane = PowerPlaneState.nominal(device=device)
        _, m = account_step(profile, nominal_plane)
        e_nominal = float(m["energy_step_j"]) * len(records)
        print(f"\nVolTune saving vs static-nominal margins: "
              f"{100*(1-s['energy_j']/e_nominal):.1f}% "
              f"({e_nominal:.1f} J -> {s['energy_j']:.1f} J) — "
              f"the paper's thesis, at training-system scale")
    return trainer


if __name__ == "__main__":
    main()
