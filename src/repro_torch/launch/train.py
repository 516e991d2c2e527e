"""Training launcher (port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
        --tiny --steps 4 [--device cpu]

The scalar train step (`make_train_step`) with AdamW and the WSD schedule,
driven through `Trainer.run`, for every architecture: the dense, moe,
ssm and hybrid families, the vlm family (`--arch internvl2_2b`: each
batch carries the stub frontend's `n_img_tokens` patch embeddings ahead
of `--seq` tokens) and the encdec family (`--arch whisper_base`: each
batch carries `enc_seq_len` stub frame embeddings), with the in-graph
controller in the step or (`--control-path host`) a `HostRailController`
between steps, actuated through the simulated PMBus. Weights are random,
drawn on the device from seed 0. Unlike the JAX launcher, `--tiny` is
honoured: without it the full configuration is built (with per-layer
remat, as the reference does for non-tiny configs).

`--ckpt-dir DIR` writes checkpoints there (every max(10, steps // 5)
steps and after the last, the reference's layout); without `--resume` the
directory is emptied first, as the reference launcher does. `--resume`
restores the latest checkpoint in `--ckpt-dir` and continues from its
step. Unlike the reference, which defaults to `/tmp/repro_train_ckpt`,
no directory means no checkpoint.

`--dry-run` runs the dry run of the architecture's `train_4k` cell on
both production meshes instead (`python -m repro_torch.launch.dryrun
--arch A --shape train_4k --mesh both`, in a process of its own, which
writes `reports/dryrun_single_multi.json` under the working directory)
and exits with its code, as the reference's launcher does.
"""

from __future__ import annotations

import argparse
import shutil

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.control_plane import HostRailController
from repro_torch.core.policy import POLICIES
from repro_torch.core.power_plane import StepProfile
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                       stub_frontend_inputs)
from repro_torch.models import lm, registry
from repro_torch.models.common import resolve_device
from repro_torch.optim import adamw
from repro_torch.optim.schedule import wsd
from repro_torch.train.step import StepConfig, make_train_step
from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                       initial_plane_and_ef)


class FrontendData(SyntheticLM):
    """`SyntheticLM` whose batches carry the model's stub frontend inputs
    (the reference launcher's `_Data`): the same draws every step."""

    def __init__(self, data_cfg: DataConfig, model_cfg):
        super().__init__(data_cfg)
        self.model_cfg = model_cfg

    def torch_batch(self, step: int, device="cuda", extra=None):
        return super().torch_batch(step, device, stub_frontend_inputs(
            self.model_cfg, self.model_cfg.family, self.cfg.global_batch,
            device=device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--policy", choices=list(POLICIES), default="phase-aware")
    ap.add_argument("--control-path", choices=("in-graph", "host"),
                    default="in-graph")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write checkpoints here (none without it)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dry_run:
        import subprocess
        import sys
        raise SystemExit(subprocess.call(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             args.arch, "--shape", "train_4k", "--mesh", "both"]))
    if args.resume and args.ckpt_dir is None:
        ap.error("--resume needs --ckpt-dir")
    device = resolve_device(args.device)

    cfg = get_config(args.arch, tiny=args.tiny)
    api = registry.build(cfg, remat="none" if args.tiny else "full")
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n = sum(p.numel() for p in lm.tree_leaves(params))
    print(f"{cfg.name}: {n/1e6:.1f}M params (tiny={args.tiny})")

    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init_state(params, opt_cfg)
    plane, ef = initial_plane_and_ef(params)
    tokens = args.batch * args.seq
    profile = StepProfile(6.0 * n * tokens, 14.0 * n, 4.0 * n, 4.0 * n)

    def sched(s):
        return wsd(s, peak_lr=3e-4, warmup_steps=10,
                   stable_steps=int(args.steps * 0.7),
                   decay_steps=int(args.steps * 0.2))

    policy = POLICIES[args.policy]
    in_graph = args.control_path == "in-graph"
    step = make_train_step(api.loss_fn, opt_cfg, sched, profile,
                           StepConfig(policy=policy if in_graph else None))
    data = FrontendData(DataConfig(cfg.vocab_size, args.seq, args.batch),
                        cfg)
    if args.ckpt_dir is not None and not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    controller = None if in_graph else HostRailController(policy)
    trainer = Trainer(step, data,
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=max(10, args.steps // 5),
                                    ckpt_dir=args.ckpt_dir,
                                    controller=controller, device=device),
                      {"params": params, "opt": opt, "plane": plane,
                       "ef": ef})
    if args.resume and trainer.maybe_restore():
        print(f"resumed from step {trainer.start_step}")
    log = trainer.run()
    rec = list(log.records)
    print(f"loss {rec[0].loss:.4f} -> {rec[-1].loss:.4f}; "
          f"summary: {trainer.summary()}")


if __name__ == "__main__":
    main()
