"""Elastic-scaling demo: train on a 4-way data-parallel mesh, checkpoint,
then restore the SAME checkpoint onto an 8-way mesh and continue — the
fault-tolerance path a deployment takes when nodes join or leave (port of
`examples/elastic_restart.py`).

The reference forces 8 host devices and jits one program over a mesh of 4
of them, then of all 8. Here each mesh is a gloo world of processes (4,
then 8) on `--device` (every rank on the one card with "cuda", the
default; "cpu" asks for the host), each rank running the placed (FSDP)
train step (`train.step.make_train_step(..., mesh=)`): params and f32
moments placed over `data` by `named_shardings`, the batch's rows split
over the ranks. The 4-rank world trains steps 0-9, writes the placed
checkpoint at step 10 (gathered whole, rank 0 writes) and then runs the
uninterrupted 20 steps from a fresh init; the 8-rank world restores the
checkpoint with `restore(shardings=)`, each rank reading its own block,
and trains steps 10-19. The continuity check is the reference's: the
restored step's loss within 1e-3 of the uninterrupted run's.

Weights: the port's init from seed 0, or `--params` (a pickle of the
reference's init as numpy arrays, carried over by
`registry.params_from_jax`, so the two packages' losses can be compared).
The checkpoint goes under `--ckpt-dir` (the reference's path by default),
emptied first. `main` returns the losses, the checkpoint's bytes, its save
and restore seconds and rank 0's kernel launches in each world.

Run:  PYTHONPATH=src python -m repro_torch.examples.elastic_restart
      [--device cpu] [--ckpt-dir DIR] [--params PKL]
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import sys
import time
import traceback

import torch

CKPT = "/tmp/voltune_elastic_ckpt"
SMALL, LARGE = 4, 8          # the two meshes' ranks
STEPS = 10                   # steps a phase
CONTINUITY_RTOL = 1e-3
WORLD_TIMEOUT_S = 600.0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=CKPT)
    ap.add_argument("--params", default=None)
    return ap


def _setup(device: str, params_path: str | None):
    """(cfg, loss_fn, fresh params on `device`, data, step factory)."""
    from repro_torch.configs import get_config
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import StepConfig, make_train_step
    cfg = get_config("minicpm_2b", tiny=True)
    api = registry.build(cfg, remat="none")

    def fresh():
        if params_path:
            with open(params_path, "rb") as f:
                return registry.params_from_jax(cfg, pickle.load(f), device)
        return api.init(torch.Generator(device=device).manual_seed(0))

    def sched(s):
        return wsd(s, peak_lr=1e-3, warmup_steps=2, stable_steps=40,
                   decay_steps=40)

    def build(mesh):
        return make_train_step(api.loss_fn, adamw.AdamWConfig(), sched,
                               StepProfile(5e9, 5e8, 2e8, 1.8e8),
                               StepConfig(), mesh=mesh)

    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 8, seed=0))
    return cfg, fresh, data, build


def _placed_state(params, mesh):
    """params and fresh f32 AdamW moments placed over `mesh` (FSDP over
    'data'), with a plane and ef residuals."""
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import named_shardings, place
    from repro_torch.train.trainer import initial_plane_and_ef
    opt = adamw.init_state(params, adamw.AdamWConfig())
    plane, ef = initial_plane_and_ef(params)
    return {"params": place(params, named_shardings(params, mesh)),
            "opt": place(opt, named_shardings(opt, mesh)),
            "plane": plane, "ef": ef}


def run_steps(step_fn, state, data, start: int, n: int, device) -> list:
    losses = []
    for s in range(start, start + n):
        p, o, pl, ef, m = step_fn(state["params"], state["opt"],
                                  state["plane"], state["ef"],
                                  data.torch_batch(s, device))
        state.update(params=p, opt=o, plane=pl, ef=ef)
        losses.append(float(m["loss"]))
    return losses


def small_world(rank, world, device, args) -> dict:
    """Phase 1 on the 4-rank mesh, its checkpoint, and the uninterrupted
    run."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    cfg, fresh, data, build = _setup(device, args.params)
    mesh = make_mesh((world,), ("data",), device.type)
    ops.reset_launch_counts()
    step_fn = build(mesh)
    state = _placed_state(fresh(), mesh)
    l1 = run_steps(step_fn, state, data, 0, STEPS, device)
    cm = CheckpointManager(args.ckpt_dir, async_save=False)
    t0 = time.perf_counter()
    cm.save(STEPS, {"params": state["params"], "opt": state["opt"]})
    save_s = time.perf_counter() - t0
    state3 = _placed_state(fresh(), mesh)
    ref = run_steps(step_fn, state3, data, 0, 2 * STEPS, device)
    return {"l1": l1, "ref": ref, "save_s": save_s,
            "ckpt_bytes": cm.timings.get("bytes", 0),
            "launches": ops.launch_counts()}


def large_world(rank, world, device, args) -> dict:
    """Phase 2: the checkpoint restored onto the 8-rank mesh, 10 steps."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import named_shardings
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg, _, data, build = _setup(device, args.params)
    mesh = make_mesh((world,), ("data",), device.type)
    like = {"params": registry.abstract_params(cfg)}
    like["opt"] = adamw.init_state(like["params"], adamw.AdamWConfig())
    shardings = {k: named_shardings(v, mesh) for k, v in like.items()}
    t0 = time.perf_counter()
    step, restored = CheckpointManager(args.ckpt_dir).restore(
        like, shardings=shardings)
    restore_s = time.perf_counter() - t0
    state = dict(restored)
    state["plane"], state["ef"] = initial_plane_and_ef(restored["params"])
    ops.reset_launch_counts()
    l2 = run_steps(build(mesh), state, data, step, STEPS, device)
    return {"step": step, "l2": l2, "restore_s": restore_s,
            "launches": ops.launch_counts()}


def _rank_entry(job: str, rank: int, world: int, device: str, args,
                out_dir: str) -> None:
    try:
        import torch.distributed as dist
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(out_dir,
                                                         f"{job}.store"),
            rank=rank, world_size=world)
        fn = small_world if job == "small" else large_world
        result = fn(rank, world, dev, args)
        if rank == 0:
            with open(os.path.join(out_dir, f"{job}.pkl"), "wb") as f:
                pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{job}.rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(job: str, world: int, device: str, args, out_dir: str
              ) -> dict:
    """`job` in a gloo world of `world` processes; rank 0's result. A rank
    that fails, or a world past WORLD_TIMEOUT_S, kills the rest and
    raises with the ranks' tracebacks."""
    import multiprocessing as mp
    # ranks forked from a server that imported torch once: under "spawn"
    # each of the 12 ranks spent seconds on its own `import torch`
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    procs = [ctx.Process(target=_rank_entry,
                         args=(job, r, world, device, args, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    if any(p.exitcode != 0 for p in procs):
        errs = []
        for r in range(world):
            path = os.path.join(out_dir, f"{job}.rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
        raise RuntimeError(f"{job} world of {world} failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n"
                           + "\n".join(errs))
    with open(os.path.join(out_dir, f"{job}.pkl"), "rb") as f:
        return pickle.load(f)


def main(argv=None, out=None) -> dict:
    """Run the demo; print its lines to `out` (stdout by default)."""
    out = out or sys.stdout
    args = parser().parse_args(argv)
    from repro_torch.models.common import resolve_device
    device = resolve_device(args.device).type
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build()          # once, before the ranks load it
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    os.makedirs(args.ckpt_dir)
    worlds = os.path.join(args.ckpt_dir, "worlds")
    os.makedirs(worlds)

    # --- phase 1: 4-rank mesh (and the uninterrupted run) ----------------
    small = run_world("small", SMALL, device, args, worlds)
    l1, ref = small["l1"], small["ref"]
    print(f"phase 1 ({SMALL} devices): steps 0-9, loss {l1[0]:.4f} -> "
          f"{l1[-1]:.4f}", file=out)
    print("checkpoint written at step 10", file=out)

    # --- phase 2: restore onto an 8-rank mesh -----------------------------
    large = run_world("large", LARGE, device, args, worlds)
    step, l2 = large["step"], large["l2"]
    print(f"phase 2 ({LARGE} devices): steps {step}-{step+9}, "
          f"loss {l2[0]:.4f} -> {l2[-1]:.4f}", file=out)

    # --- verify continuity: an uninterrupted 4-rank run matches -----------
    drift = abs(ref[10] - l2[0]) / max(abs(ref[10]), 1e-9)
    print(f"\ncontinuity check: restored-step loss {l2[0]:.5f} vs "
          f"uninterrupted {ref[10]:.5f} (rel drift {drift:.2e})", file=out)
    print("elastic restore onto a larger mesh: OK"
          if drift < CONTINUITY_RTOL
          else "WARNING: drift exceeds tolerance", file=out)
    shutil.rmtree(worlds, ignore_errors=True)
    return {"l1": l1, "l2": l2, "ref": ref, "step": step, "drift": drift,
            "save_s": small["save_s"], "restore_s": large["restore_s"],
            "ckpt_bytes": small["ckpt_bytes"],
            "launches": {"small": small["launches"],
                         "large": large["launches"]}}


if __name__ == "__main__":
    main(sys.argv[1:])
