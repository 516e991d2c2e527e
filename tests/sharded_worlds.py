"""The port's sharded worlds for the CPU tests (no tests here, no JAX).

`spawn_world(worker, world, out_dir)` starts `world` processes that join a
gloo world through a file store under `out_dir`; each runs `worker(rank,
world, out_dir)` and pickles what it returns to `out_dir/rank<r>.pkl`. A
rank that raises writes its traceback beside it; the parent joins every
rank with a timeout, kills the rest when one fails or hangs, and raises.

The inputs both packages read are made here from seeds with numpy
(`frame_errors`, `reduce_input`, `step_batches`, the routed world of
`test_torch_inputs`), so `tests/sharded_reference.py` (the reference's
forced-device runs) and the tests read the same numbers. The worlds:

- `sharding_world` (4 ranks, 16 chips): the sharded control round
  (`ROUNDS` rounds), `sharded_fleet_reduce`, the sharded fleet train step
  (`STEPS` steps, shard_control auto), a checkpoint of the sharded SOR
  state gathered on save and its remap re-sliced, a `Trainer(mesh=)` run
  through a failure and a restore, and the routed world served over the
  mesh (round-robin and headroom routers).
- `dp_world` (2 ranks): the collectives over a bound `data` axis and the
  ef train step of tiny MiniCPM under `shard_map_ef_step`.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

N = 16             # chips of the sharding world
RANKS = 4          # ranks of the sharding world
ROUNDS = 6         # sharded control rounds (past one refit at tick 4)
STEPS = 3          # sharded fleet train steps
STEP_FLEET_SEED = 7
ROUND_FLEET_SEED = 3
SOR_KNOBS = dict(capacity=16, refresh_every=4, decay=0.96, guard_v=0.004,
                 max_extension_v=0.12, ingest="frames")
PROFILE = (2e12, 8e9, 4e9, 3e9)
HBM_ERROR_BASE = 1e-4
# the Trainer run: a checkpoint after step 2, a failure drawn before step
# 3 (TRAINER_FAULTS' rng: 0.94, 0.51, 0.98, 0.08, 0.61, 0.38, 0.80), its
# restore from step 2 and steps 2 to 4 again
TRAINER_STEPS = 5
TRAINER_CKPT_EVERY = 2
TRAINER_FAULTS = dict(fail_prob=0.3, seed=4)
# the routed world served over the mesh
SERVE_REQUESTS = 16
SERVE_MAX_TICKS = 600
SERVE_CAPACITY = 3
DP_RANKS = 2
DP_STEPS = 3
DP_SEQ = 32
DP_BATCH = 4


def frame_errors(rounds: int = ROUNDS, n: int = N) -> np.ndarray:
    """Per-round measured errors of the round world, 1e-4 (1 + U[0, 1)),
    f32 [rounds, n]."""
    u = np.random.default_rng(100).uniform(size=(rounds, n))
    return (1e-4 * (1.0 + u)).astype(np.float32)


def reduce_input(n: int = N, fields: int = 5) -> np.ndarray:
    return (3.0 * np.random.default_rng(101).standard_normal(
        (n, fields))).astype(np.float32)


def step_batches(steps: int = STEPS) -> list[np.ndarray]:
    """The linear model's batches, [8, 4] f32 (the reference test's)."""
    return [np.full((8, 4), 0.1 * (i + 1), np.float32) for i in range(steps)]


def serve_trace_knobs() -> dict:
    return dict(seed=23, quiet_rate_hz=8.0, burst_rate_hz=40.0,
                decode_mean=48.0)


# -- the port's side -------------------------------------------------------------

def sor_config():
    from repro_torch.core import sor, telemetry
    return sor.SorConfig(rails=telemetry.ALL_RAIL_OBSERVABLES, **SOR_KNOBS)


def round_world(device="cpu"):
    """(plane, controller, SorState) of the round world on `device`."""
    from repro_torch.core.control_plane import InGraphRailController
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.core.policy import MultiRailClosedLoop
    from repro_torch.core.power_plane import PowerPlaneState
    fs = FleetSpec.sample(N, seed=ROUND_FLEET_SEED)
    ctrl = InGraphRailController(MultiRailClosedLoop(), sor=sor_config())
    return (PowerPlaneState.from_fleet(fs, device), ctrl,
            ctrl.init_sor(N, device=device))


def frame_at(plane, errs):
    """The round world's frame on `plane` with measured errors `errs`."""
    import torch

    from repro_torch.core.telemetry import as_frame
    m, dev = errs.shape[0], plane.device
    return as_frame({"grad_error": torch.from_numpy(errs.copy()).to(dev),
                     "t_chip_s": torch.full((m,), 1e-3, device=dev),
                     "straggle_rate": torch.full((m,), 1e-3, device=dev),
                     "hbm_error_rate": torch.full((m,), 1e-4, device=dev)},
                    state=plane)


def unsharded_rounds(plane, ctrl, ss, sl: slice = slice(None)):
    """ROUNDS unsharded rounds on the chips `sl` of the round world."""
    errs = frame_errors()
    for i in range(ROUNDS):
        plane, ss, _, _ = ctrl.control_round(plane, frame_at(plane,
                                                             errs[i, sl]), ss)
    return plane, ss


def state_arrays(plane, ss) -> dict:
    """The compared fields of a plane and a SorState as numpy arrays."""
    host = lambda t: t.detach().cpu().numpy().copy()
    out = {f: host(getattr(plane, f))
           for f in ("v_core", "v_hbm", "v_io", "energy_j")}
    out["history_v"] = host(ss.history.v)
    out["history_obs"] = host(ss.history.obs)
    for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
        out[f] = host(getattr(ss.estimate, f))
    out["tick"] = ss.tick
    return out


def fleet_step(fs, mesh=None, shard_control=None, device="cpu"):
    """The sharded fleet step of the reference's test (a linear model, the
    round world's SOR config, HBM errors on, the draws inert) and its
    initial state: (step, {'params', 'opt', 'plane', 'ef', 'sor'})."""
    import torch

    from repro_torch.core import sor
    from repro_torch.core.policy import MultiRailClosedLoop
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.optim import adamw
    from repro_torch.train.step import (FleetStepConfig, StepConfig,
                                        make_fleet_train_step,
                                        shard_fleet_state)
    from repro_torch.train.trainer import initial_plane_and_ef

    def loss_fn(p, b):
        return torch.mean((b @ p["w"]) ** 2), {}

    cfg = sor_config()
    opt_cfg = adamw.AdamWConfig(grad_clip_norm=1.0)
    step = make_fleet_train_step(
        loss_fn, opt_cfg, lambda s: 1e-3, StepProfile(*PROFILE),
        StepConfig(policy=MultiRailClosedLoop()),
        FleetStepConfig(spec=fs, hbm_error_base=HBM_ERROR_BASE, mesh=mesh,
                        shard_control=shard_control, sor=cfg))
    params = {"w": torch.ones(4, device=device)}
    plane, ef = initial_plane_and_ef(params, fleet=fs)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg),
             "plane": plane, "ef": ef, "sor": sor.init_state(cfg, fs.n_chips,
                                                             device=device)}
    if mesh is not None:
        state = shard_fleet_state(state, mesh)
    return step, state


def run_fleet_step(step, state):
    """STEPS steps; returns (state, the last metrics as floats/arrays)."""
    import torch
    dev = state["plane"].device
    for b in step_batches():
        (state["params"], state["opt"], state["plane"], state["ef"],
         state["sor"], metrics) = step(state["params"], state["opt"],
                                       state["plane"], state["ef"],
                                       state["sor"],
                                       torch.from_numpy(b).to(dev))
    return state, {k: np.array(v.cpu() if isinstance(v, torch.Tensor)
                               else v) for k, v in metrics.items()}


class LinearData:
    """The Trainer's data for the linear model: step i's batch."""

    def torch_batch(self, step: int, device="cpu"):
        import torch
        return torch.full((8, 4), 0.1 * (step % 3 + 1), device=device)


def trainer_run(ckpt_dir: str, mesh=None):
    """`Trainer.run` of the sharded fleet step through a failure and its
    restore: (trainer, its final state)."""
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.train.trainer import (FaultConfig, Trainer,
                                           TrainerConfig)
    fs = FleetSpec.sample(N, seed=STEP_FLEET_SEED)
    step, state = fleet_step(fs, mesh=mesh)
    cfg = TrainerConfig(total_steps=TRAINER_STEPS,
                        ckpt_every=TRAINER_CKPT_EVERY, ckpt_dir=ckpt_dir,
                        async_ckpt=False,
                        faults=FaultConfig(**TRAINER_FAULTS), fleet=fs,
                        sor=sor_config(), mesh=mesh, device="cpu")
    trainer = Trainer(step, LinearData(), cfg, state)
    trainer.run()
    return trainer, trainer.state


def routed_run(router: str, mesh=None, shard_control=None, device="cpu"):
    """The routed world (16 chips, learned) served over `mesh` (or not):
    (engine, ledger). Under a mesh the trace's observe reads the rank's
    block of the noise table and of the FleetSpec."""
    import test_torch_inputs as ti

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serve.router import HeadroomRouter, RoundRobinRouter
    from repro_torch.serve.traffic import bursty_trace
    import torch
    cfg = get_config("minicpm_2b", tiny=True)
    params = registry.build(cfg).init(
        torch.Generator(device=device).manual_seed(0))
    rt = (HeadroomRouter(capacity=SERVE_CAPACITY) if router == "headroom"
          else RoundRobinRouter(capacity=SERVE_CAPACITY))
    eng = ti.routed_engine(N, device, params=params, cfg=cfg, router=rt,
                           mesh=mesh, shard_control=shard_control)
    noise = ti.routed_noise(N, SERVE_MAX_TICKS)
    ti.routed_warm_up(eng, ti.routed_observe(eng.fleet_spec, noise, device))
    if eng.chip_block is None:
        observe = ti.routed_observe(eng.fleet_spec, noise, device)
    else:
        lo, hi = eng.chip_block
        observe = ti.routed_observe(
            ops.shard_chip_tree(eng.fleet_spec, mesh, N), noise[..., lo:hi],
            device)
    trace = bursty_trace(SERVE_REQUESTS, **serve_trace_knobs())
    ledger = eng.serve_trace(trace, observe=observe,
                             max_ticks=SERVE_MAX_TICKS,
                             error_bound=ti.ROUTED_BOUND)
    return eng, ledger


def serve_arrays(eng, ledger) -> dict:
    import test_torch_inputs as ti
    out = {"discrete": ti.ledger_discrete(eng, ledger),
           "fleet_energy_j": ledger.fleet_energy_j,
           "energy_j": [r.energy_j for r in ledger.records()],
           "summary": eng.summary()}
    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        out["plane_" + f] = getattr(eng.plane, f).cpu().numpy().copy()
    for f in ("v_frontier", "confidence"):
        out["sor_" + f] = getattr(eng._sor_state.estimate,
                                  f).cpu().numpy().copy()
    return out


def sharding_world(rank: int, world: int, out_dir: str) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import CheckpointManager, remap_sor
    from repro_torch.core.control_plane import sharded_control_round
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_chips_mesh
    mesh = make_chips_mesh(device_type="cpu")
    out = {"block": ops.chip_block(mesh, N)}
    lo, hi = out["block"]

    # the sharded control round
    plane, ctrl, ss = round_world()
    rnd = sharded_control_round(ctrl, mesh)
    p1, s1 = ops.shard_chip_tree(plane, mesh, N), ops.shard_chip_tree(ss,
                                                                      mesh, N)
    errs = frame_errors()
    conf = []
    for i in range(ROUNDS):
        p1, s1, conf_sum, conf_min = rnd(p1, frame_at(p1, errs[i, lo:hi]),
                                         s1)
        conf.append((float(conf_sum), float(conf_min)))
    out["round"] = state_arrays(p1, s1)
    out["round_conf"] = conf

    # its checkpoint, gathered on save (rank 0 writes), restored whole,
    # grown to 24 chips and re-sliced onto the mesh
    ck = os.path.join(out_dir, "ckpt_round")
    CheckpointManager(ck).save(1, {"plane": p1, "sor": s1}, mesh=mesh)
    _, restored = CheckpointManager(ck).restore(
        {"plane": plane, "sor": ctrl.init_sor(N, device="cpu")})
    grown = ops.shard_chip_tree(remap_sor(restored["sor"], 24), mesh, 24)
    out["grown_block"] = {"history_v": grown.history.v.numpy().copy(),
                          "confidence":
                              grown.estimate.confidence.numpy().copy()}

    # sharded_fleet_reduce on the rank's block
    x = torch.from_numpy(reduce_input()[lo:hi].copy())
    out["reduce"] = [a.numpy().copy()
                     for a in ops.sharded_fleet_reduce(x, mesh=mesh)]

    # the sharded fleet train step (shard_control resolves on)
    step, state = fleet_step(FleetSpec.sample(N, seed=STEP_FLEET_SEED),
                             mesh=mesh)
    state, metrics = run_fleet_step(step, state)
    out["step"] = state_arrays(state["plane"], state["sor"])
    out["step_metrics"] = metrics
    out["step_w"] = state["params"]["w"].detach().numpy().copy()

    # Trainer(mesh=) through a failure and its restore
    trainer, tstate = trainer_run(os.path.join(out_dir, "ckpt_trainer"),
                                  mesh=mesh)
    out["trainer"] = state_arrays(tstate["plane"], tstate["sor"])
    out["trainer_restarts"] = trainer.restarts
    out["trainer_losses"] = [r.loss for r in trainer.log.records]

    # the routed world over the mesh
    for router in ("roundrobin", "headroom"):
        eng, ledger = routed_run(router, mesh=mesh)
        out["serve_" + router] = serve_arrays(eng, ledger)
    dist.barrier()
    return out


def dp_inputs(rank: int, n: int = 1000) -> np.ndarray:
    """Rank `rank`'s payload for the collectives, f32 [n]."""
    return np.random.default_rng(200 + rank).standard_normal(n).astype(
        np.float32)


def dp_world(rank: int, world: int, out_dir: str) -> dict:
    import torch

    from repro_torch.core import ecollectives as ec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.kernels import ops
    mesh = make_mesh((world,), ("data",), "cpu")
    group = ops.axis_group(mesh, "data")[0]
    x = torch.from_numpy(dp_inputs(rank))
    out = {}
    with ec.bound_axes({"data": group}):
        out["axis_size"] = ec.axis_size("data")
        out["psum_lossless"] = ec.psum_lossless(x, "data").numpy()
        out["psum_int8"] = ec.psum_int8(x, "data").numpy()
        out["psum_int8_topk"] = ec.psum_int8_topk(x, "data", 0.25).numpy()
        out["pmean"] = ec.pmean(x, "data").numpy()
        for level in (0, 1, 2):
            out[f"reduce_{level}"] = ec.reduce_gradients(
                {"a": x, "b": {"c": x[:300] * 2}}, "data", level)["b"][
                    "c"].numpy()
    out["ef"] = dp_ef_run(mesh)
    return out


def dp_config(get_config):
    """Tiny MiniCPM in f32, the ef step parity tests' model
    (`tests/test_torch_ecollectives.py`), from either package's configs."""
    import dataclasses
    return dataclasses.replace(get_config("minicpm_2b", tiny=True),
                               dtype="float32")


DP_PROFILE = dict(flops_per_chip=2e12, hbm_bytes_per_chip=8e9,
                  ici_bytes_per_chip=4e9, grad_bytes_per_chip=3e9)


def dp_schedule(wsd):
    return lambda s: wsd(s, peak_lr=1e-3, warmup_steps=2, stable_steps=50,
                         decay_steps=50)


def dp_ef_run(mesh=None) -> dict:
    """The ef train step of tiny MiniCPM in f32 (the reference's init, given
    to both packages by the test) with BERBounded, under
    `shard_map_ef_step` over `mesh`'s data axis: per step the loss and
    grad_error, and after the last the params, residuals and plane."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import BERBounded
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_map
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import (StepConfig, make_train_step,
                                        shard_map_ef_step)
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg = dp_config(get_config)
    with open(os.environ["DP_PARAMS"], "rb") as f:
        params = registry.params_from_jax(cfg, pickle.load(f), device="cpu")
    step = make_train_step(registry.build(cfg, remat="full").loss_fn,
                           adamw.AdamWConfig(), dp_schedule(wsd),
                           StepProfile(**DP_PROFILE),
                           StepConfig(grad_sync="ef_int8",
                                      policy=BERBounded()))
    if mesh is not None:
        step = shard_map_ef_step(step, mesh)
    opt = adamw.init_state(params, adamw.AdamWConfig())
    plane, ef = initial_plane_and_ef(params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, DP_SEQ, DP_BATCH))
    losses, errors = [], []
    for i in range(DP_STEPS):
        params, opt, plane, ef, metrics = step(params, opt, plane, ef,
                                               data.torch_batch(i, "cpu"))
        losses.append(float(metrics["loss"]))
        errors.append(float(metrics["grad_error"]))
    host = lambda t: tree_map(lambda a: a.detach().float().numpy().copy(), t)
    return {"loss": losses, "grad_error": errors, "params": host(params),
            "ef": host(ef), "v_io": float(plane.v_io),
            "comp_level": int(plane.comp_level)}


# -- spawning a world ------------------------------------------------------------

def _entry(worker_name: str, rank: int, world: int, out_dir: str,
           env: dict) -> None:
    os.environ.update(env)
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(out_dir, "store"),
            rank=rank, world_size=world)
        result = globals()[worker_name](rank, world, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(worker_name: str, world: int, out_dir: str,
                timeout_s: float = 240.0, env: dict | None = None
                ) -> list[dict]:
    """Run `worker_name` (a function of this module) in a gloo world of
    `world` processes on the CPU; returns every rank's result in rank
    order. Raises with the first rank's traceback when a rank fails, and
    when the world outlasts `timeout_s` (its processes are killed)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    os.makedirs(out_dir, exist_ok=True)
    procs = [ctx.Process(target=_entry, args=(worker_name, r, world,
                                              out_dir, env or {}))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(
            f"{worker_name} world of {world} failed (exit codes "
            f"{[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
