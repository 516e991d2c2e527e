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
- `elastic_save_world` (4 ranks) and `elastic_restore_world` (8 and 1):
  a placed checkpoint of tiny MiniCPM written on a (data, model) mesh of
  2 x 2 and restored (`restore(shardings=)`) onto `(data,)` meshes of 8
  and of 1; the reference's checkpoint restored placed.
- `fsdp_world` (4 ranks): the placed (FSDP) train step of every family of
  `FSDP_ARCHS` (f32 tiny configs, params and f32 moments placed by
  `named_shardings`), over a `(data, model)` mesh of 2 x 2 and a `(data,)`
  mesh of 4, under `mesh_context`; rank 0 also runs `placed_oracle`, the
  one-process run the ranks' blocks equal bit for bit (on the 2 x 2 mesh
  the step computes tensor-parallel over 'model', and the oracle splits
  each DP rank's pass over the model ranks, `tp_loss_and_grads`).
- `tp_world` (4 ranks, (data 2, model 2)): every family of `TP_ARCHS`
  served placed (`tp_serve`: prefill and greedy decode on params placed by
  `named_shardings`) against `tp_serve_oracle`, the TP_TRAIN placed train
  steps (the int8 moments among them) against `placed_oracle`, and one
  step's collectives under `CommDebugMode` (`tp_comm_counts`).

The placed runs are device-agnostic (`fsdp_run(..., device=)`), so the
card's `tiny_fsdp` phase (`chip_smoke.py`) runs the same code on cuda.
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


# -- placed (FSDP) training -------------------------------------------------------

FSDP_RANKS = 4
FSDP_STEPS = 2
FSDP_SEQ = 32
FSDP_BATCH = 4
# (arch, placement profile): the dense, moe (expert parallelism), encdec
# (enc_blocks, dec_blocks), hybrid (the mamba rules) and ssm (the rwkv
# rules) families
FSDP_ARCHS = (("minicpm_2b", {}), ("qwen3_moe_30b_a3b", {"moe_ep": True}),
              ("whisper_base", {}), ("zamba2_1p2b", {}), ("rwkv6_7b", {}))
# mesh name -> (shape, axes)
FSDP_MESHES = {"data2_model2": ((2, 2), ("data", "model")),
               "data4": ((4,), ("data",))}


# the reference's wide-FSDP rule overrides (`launch/dryrun.py`
# `_profile_settings`): no tensor parallelism
NO_TP = {"heads": None, "kv_heads": None, "ff": None, "vocab": None,
         "ssm_heads": None, "experts": None}


def fsdp_rules(mesh_name: str, arch: str) -> dict | None:
    """The `mesh_context` rule overrides of a run: none on the 2-D mesh
    (the moe_ep profile's experts over 'model' for the MoE, as the
    reference's dry run sets them); NO_TP on the 1-D mesh, which has no
    'model' axis."""
    if "model" not in FSDP_MESHES[mesh_name][1]:
        return dict(NO_TP)
    if dict(FSDP_ARCHS)[arch].get("moe_ep"):
        return {"experts": "model", "ff": None}
    return None


def fsdp_config(get_config, arch: str):
    """`arch`'s tiny config in f32; a variant after '@', "e<n>", gives it
    n experts (`TP_ARCHS`' tiny Grok-1 with 3)."""
    import dataclasses
    name, _, variant = arch.partition("@")
    cfg = dataclasses.replace(get_config(name, tiny=True), dtype="float32")
    if variant:
        cfg = dataclasses.replace(cfg, n_experts=int(variant[1:]))
    return cfg


def fsdp_schedule(wsd):
    return lambda s: wsd(s, peak_lr=1e-3, warmup_steps=2, stable_steps=50,
                         decay_steps=50)


def fsdp_frontend_seed(step: int) -> int:
    return 1000 + step


def fsdp_batch(cfg, step: int, device="cpu") -> dict:
    """Step `step`'s global batch: FSDP_BATCH rows of FSDP_SEQ tokens, the
    stub frontend's frames for the encdec family."""
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           stub_frontend_inputs)
    data = SyntheticLM(DataConfig(cfg.vocab_size, FSDP_SEQ, FSDP_BATCH))
    extra = stub_frontend_inputs(cfg, cfg.family, FSDP_BATCH,
                                 seed=fsdp_frontend_seed(step), device=device)
    return data.torch_batch(step, device, extra=extra)


def fsdp_params(arch: str, device="cpu"):
    """(cfg, params) of `arch` on `device`: the reference's init from
    FSDP_PARAMS' pickle when the environment names one (the CPU tests),
    else the port's init from seed 0 drawn on the CPU (the card's phase,
    which holds its runs to a cpu run of the same weights)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = fsdp_config(get_config, arch)
    path = os.environ.get("FSDP_PARAMS")
    if path:
        with open(path, "rb") as f:
            tree = pickle.load(f)[arch]
        return cfg, registry.params_from_jax(cfg, tree, device=device)
    from repro_torch.models.lm import tree_map
    return cfg, tree_map(lambda a: a.to(device), registry.build(cfg).init(
        torch.Generator().manual_seed(0)))


def fsdp_step(cfg, mesh=None):
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import StepConfig, make_train_step
    return make_train_step(registry.build(cfg, remat="full").loss_fn,
                           adamw.AdamWConfig(), fsdp_schedule(wsd),
                           StepProfile(**DP_PROFILE), StepConfig(),
                           mesh=mesh)


def _host(t):
    """A tensor (a DTensor's local block) as a numpy f32 copy."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.detach().float().cpu().numpy().copy()


def fsdp_run(arch: str, mesh_name: str, mesh, device="cpu") -> dict:
    """FSDP_STEPS placed steps of `arch` on `mesh`: per step the loss and
    grad norm, and after the last this rank's blocks of the params and the
    first moment."""
    from repro_torch.models.lm import tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg, params = fsdp_params(arch, device)
    kw = dict(FSDP_ARCHS)[arch]
    opt = adamw.init_state(params, adamw.AdamWConfig())
    plane, ef = initial_plane_and_ef(params)
    params = shd.place(params, shd.named_shardings(params, mesh, **kw))
    opt = shd.place(opt, shd.named_shardings(opt, mesh, **kw))
    step = fsdp_step(cfg, mesh)
    losses, norms = [], []
    with shd.mesh_context(mesh, fsdp_rules(mesh_name, arch)):
        for i in range(FSDP_STEPS):
            params, opt, plane, ef, metrics = step(
                params, opt, plane, ef, fsdp_batch(cfg, i, device))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    return {"loss": losses, "grad_norm": norms,
            "params": tree_map(_host, params),
            "m": tree_map(_host, opt["m"]),
            "coord": tuple(mesh.get_coordinate())}


def tp_dims(shard: dict, names: tuple, dp: tuple = ()) -> dict:
    """{leaf path: the tensor dim the TP forward cuts along 'model'
    (`sharding.tp_cuts`: the placement's own block, or the MoE `w_out`'s
    ff where its experts do not divide), or None} of a tree of
    `NamedSharding`s."""
    from repro_torch.models.lm import tree_map
    from repro_torch.optim.adamw import get_path, leaf_paths
    from repro_torch.parallel import sharding as shd
    dims = tree_map(lambda sh: sh.shard_dims, shard)
    cuts = shd.tp_cuts(dims, tuple(names), dp)
    out = {}
    for path in leaf_paths(shard):
        c = get_path(cuts, path)
        out[path] = c[0][1] if c else None
    return out


def tp_loss_and_grads(loss_fn, params, batch, tdims: dict, m: int,
                      ctx=None):
    """The TP split of one DP rank's loss and gradients in one process:
    each of the `m` model ranks' blocks of the params (`tdims`: each leaf's
    TP dim or None) through `loss_fn` in a thread of its own
    (`sharding.run_model_ranks`, the collectives' sums in rank order), one
    `autograd.grad` over every rank's loss, and each leaf's gradient whole
    (the ranks' blocks joined; a replicated leaf's, rank 0's, which every
    rank holds). `ctx(r)` is a context each rank's forward runs under.
    `loss_fn` must not recompute under a checkpoint (its collectives would
    run in the backward's thread): remat "none", the same bits (the
    tests' worlds check it). Returns (loss, metrics, grads) as
    `_accumulate_grads` does."""
    import contextlib

    import torch

    from repro_torch.optim.adamw import get_path, leaf_paths
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import _accumulate_grads, _tree
    paths = leaf_paths(params)
    if m == 1 or all(tdims[p] is None for p in paths):
        with (ctx(0) if ctx else contextlib.nullcontext()):
            return _accumulate_grads(loss_fn, params, batch, 1)

    def block(a, d, r):
        if d is None:
            return a.detach().clone()
        n = a.shape[d] // m
        return a.detach().narrow(d, r * n, n).contiguous()

    ranks = [[block(get_path(params, p), tdims[p], r).requires_grad_(True)
              for p in paths] for r in range(m)]

    def fwd(r):
        with (ctx(r) if ctx else contextlib.nullcontext()):
            return loss_fn(_tree(paths, ranks[r]), batch)

    outs = shd.run_model_ranks(m, fwd)
    flat = [leaf for r in range(m) for leaf in ranks[r]]
    gs = torch.autograd.grad([o[0] for o in outs], flat,
                             materialize_grads=True)
    n = len(paths)
    whole = [gs[j] if tdims[p] is None else
             torch.cat([gs[r * n + j] for r in range(m)], tdims[p])
             for j, p in enumerate(paths)]
    return (outs[0][0].detach(),
            {k: v.detach() for k, v in outs[0][1].items()},
            _tree(paths, whole))


def placed_oracle(cfg, params, loss_fn, batches, steps: list,
                  placement: dict | None = None, shares: bool = True,
                  host: bool = True, opt_cfg=None) -> dict:
    """The placed run in one process: each step each DP rank's rows in
    turn through the same loss and gradient, split over the model ranks
    as the TP forward splits it (`tp_loss_and_grads`), the gradients added
    in rank order in f32 and divided by the DP count, the norm block by
    block in rank order (each leaf's placement under
    `named_shardings(**placement)` on that step's mesh, with int8 moments
    too), the same AdamW on whole leaves.
    `steps` gives each step's (mesh shape, axes) (the elastic restart
    changes them); `batches(i)` is step i's global batch. `shares`: replay
    the whole batch's statistics (`sharding.batch_mean`, the MoE's) as
    the placed step reads them, at the cost of a forward a rank a step.
    `loss_fn` recomputes nothing under a checkpoint (remat "none").
    Returns the losses and the norms, and (`host`) the whole params and
    first moment (int8: its decoded values) as numpy arrays; `params` is
    updated in place either way."""
    import torch

    from repro_torch.models.lm import tree_map
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import get_path, leaf_paths
    from repro_torch.optim.schedule import wsd
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import _tree
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    int8 = opt_cfg.state_dtype == "int8"
    opt = adamw.init_state(params, opt_cfg)
    sched = fsdp_schedule(wsd)
    paths = leaf_paths(params)
    losses, norms = [], []
    for i, (shape, names) in enumerate(steps):
        mesh = shd.SpecMesh(tuple(names), tuple(shape))
        dp = tuple(j for j, a in enumerate(names) if a in ("pod", "data"))
        n_dp = int(np.prod([shape[j] for j in dp]))
        m = dict(zip(names, shape)).get("model", 1)
        shard = shd.named_shardings(params, mesh, **(placement or {}))
        tdims = tp_dims(shard, tuple(names), dp)
        batch = batches(i)
        k = next(iter(batch.values())).shape[0] // n_dp
        rows = [{key: v[r * k:(r + 1) * k] for key, v in batch.items()}
                for r in range(n_dp)]
        stats = (_global_shares(loss_fn, params, rows, tdims, m) if shares
                 else {})
        per_rank, rank_losses = [], []
        for r in range(n_dp):
            loss, _, grads = tp_loss_and_grads(
                loss_fn, params, rows[r], tdims, m,
                lambda _t, r=r: shd.batch_context(lambda x: stats[
                    r, x.cpu().numpy().tobytes()]))
            per_rank.append(grads)
            rank_losses.append(loss.reshape(1))
        avg = []
        for path in paths:
            acc = get_path(per_rank[0], path).to(torch.float32, copy=True)
            for r in range(1, n_dp):
                acc.add_(get_path(per_rank[r], path))
            avg.append(acc.div_(n_dp))
        del per_rank
        total = None
        for path, g in zip(paths, avg):
            sh = get_path(shard, path)
            for coord in shd.distinct_coords(sh):
                blk = g[shd.block_index(tuple(g.shape), sh, coord)]
                sq = blk.contiguous().to(torch.float32,
                                         copy=True).square_().sum()
                total = sq if total is None else total + sq
        gnorm = torch.sqrt(total)
        acc = rank_losses[0].to(torch.float32, copy=True)
        for x in rank_losses[1:]:
            acc.add_(x)
        losses.append(float(acc.div_(n_dp)[0]))
        norms.append(float(gnorm))
        adamw.apply_updates(params, _tree(paths, avg), opt,
                            sched(opt["step"]), opt_cfg, grad_norm=gnorm)
        del avg
    out = {"loss": losses, "grad_norm": norms}
    if host:
        m1 = opt["m"]
        if int8:
            m1 = _tree(paths, [adamw._q_decode(get_path(m1, p), get_path(
                params, p).shape) for p in paths])
        out.update(params=tree_map(_host, params), m=tree_map(_host, m1))
    return out


def _global_shares(loss_fn, params, rows: list, tdims: dict | None = None,
                   m: int = 1) -> dict:
    """What `sharding.batch_mean` gives each DP rank in the placed step:
    a forward per rank (split over the `m` model ranks as
    `tp_loss_and_grads` splits it; model rank 0's calls) records its
    calls' local values; call i's mean is their rank-order sum over the
    ranks divided by their count. Returns {(rank, the local value's
    bytes): the mean} (the value identifies the call, the recompute of a
    checkpointed layer included); raises where one rank's value would
    stand for two calls with different means."""
    import torch

    from repro_torch.parallel import sharding as shd
    seen: list = [[] for _ in rows]
    for r, rr in enumerate(rows):
        def record(t, r=r):
            return shd.batch_context(
                lambda x: (seen[r].append(x.clone()) if t == 0 else None)
                or x)
        with torch.no_grad():
            if m == 1 or tdims is None:
                with record(0):
                    loss_fn(params, rr)
            else:
                tp_loss_and_grads_forward(loss_fn, params, rr, tdims, m,
                                          record)
    out: dict = {}
    for i in range(len(seen[0])):
        acc = seen[0][i].to(torch.float32, copy=True)
        for r in range(1, len(rows)):
            acc.add_(seen[r][i])
        acc.div_(len(rows))
        for r in range(len(rows)):
            key = (r, seen[r][i].cpu().numpy().tobytes())
            if key in out and not torch.equal(out[key], acc):
                raise AssertionError("a rank's batch statistic stands for "
                                     "two calls with different means")
            out[key] = acc
    return out


def tp_loss_and_grads_forward(loss_fn, params, batch, tdims: dict, m: int,
                              ctx):
    """The forward of `tp_loss_and_grads` alone (no gradient): each model
    rank's loss, in rank order."""
    from repro_torch.optim.adamw import get_path, leaf_paths
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import _tree
    paths = leaf_paths(params)

    def block(a, d, r):
        if d is None:
            return a
        n = a.shape[d] // m
        return a.narrow(d, r * n, n).contiguous()

    def fwd(r):
        with ctx(r):
            return loss_fn(_tree(paths, [block(get_path(params, p), tdims[p],
                                               r) for p in paths]), batch)[0]

    return shd.run_model_ranks(m, fwd)


def fsdp_oracle(arch: str, mesh_name: str, device="cpu") -> dict:
    """`placed_oracle` of `fsdp_run`'s run."""
    from repro_torch.models import registry
    cfg, params = fsdp_params(arch, device)
    return placed_oracle(
        cfg, params, registry.build(cfg, remat="none").loss_fn,
        lambda i: fsdp_batch(cfg, i, device),
        [FSDP_MESHES[mesh_name]] * FSDP_STEPS, dict(FSDP_ARCHS)[arch],
        shares=cfg.family == "moe")


def fsdp_world(rank: int, world: int, out_dir: str) -> dict:
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for arch, _ in FSDP_ARCHS:
        for name, (shape, axes) in FSDP_MESHES.items():
            mesh = make_mesh(shape, axes, "cpu")
            out[arch, name] = fsdp_run(arch, name, mesh)
            if rank == 0:
                out[arch, name, "oracle"] = fsdp_oracle(arch, name)
    return out


# -- tensor parallelism over 'model' ------------------------------------------------

TP_RANKS = 4
TP_MESH = ((2, 2), ("data", "model"))
# every family's tiny config served placed (prefill and decode), with its
# placement profile: dense (MHA; Granite's MQA, whose one kv head stays
# replicated; Mistral-Large's head_dim 16), moe (Qwen3-MoE under moe_ep;
# Grok-1 under the default rules: `w_gate`/`w_in` by d_model, `w_out` by
# its 4 experts over 'model', the card's ('model',) layout; and with 3
# experts, which do not divide over 'model', so `w_out`'s ff lies over
# 'data' and each rank's ff rows are moved to it, the production meshes'
# layout), vlm, encdec, hybrid and ssm
TP_ARCHS = (("minicpm_2b", {}), ("granite_20b", {}),
            ("qwen3_moe_30b_a3b", {"moe_ep": True}), ("grok1_314b", {}),
            ("grok1_314b@e3", {}), ("mistral_large_123b", {}),
            ("internvl2_2b", {}), ("whisper_base", {}), ("zamba2_1p2b", {}),
            ("rwkv6_7b", {}))
# the placed train steps this world adds to `fsdp_world`'s (whose 2 x 2
# runs cover the dense, moe_ep, encdec, hybrid and ssm ones): the vlm, and
# the int8 AdamW moments the reference's dry run gives its two largest
# models (`INT8_OPT`), Grok-1 in both MoE layouts
TP_TRAIN = (("internvl2_2b", "float32"), ("grok1_314b", "int8"),
            ("grok1_314b@e3", "int8"), ("mistral_large_123b", "int8"))
# the placed steps whose collectives are counted: tiny MiniCPM, and tiny
# Grok-1 in both MoE layouts
TP_COMM = ("minicpm_2b", "grok1_314b", "grok1_314b@e3")
TP_BATCH = 4
TP_PROMPT = 8
TP_NEW = 4


def tp_rules(arch: str) -> dict | None:
    """The `mesh_context` overrides of `arch`'s profile (the moe_ep one's
    experts over 'model'; none for the default rules)."""
    if dict(TP_ARCHS)[arch].get("moe_ep"):
        return {"experts": "model", "ff": None}
    return None


def tp_prompt(cfg, device="cpu"):
    """The prompt: TP_BATCH rows of TP_PROMPT tokens (SyntheticLM step 0's
    first columns), int32."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(cfg.vocab_size, FSDP_SEQ, TP_BATCH))
    return data.torch_batch(0, device)["tokens"][:, :TP_PROMPT].contiguous()


def tp_frames_np(cfg) -> np.ndarray:
    """The encdec decode's frames, [TP_BATCH, enc_seq_len, D] f32 (the
    stub frontend's draw, seed 5)."""
    rng = np.random.default_rng(5)
    return (rng.standard_normal((TP_BATCH, cfg.enc_seq_len, cfg.d_model))
            .astype(np.float32) * 0.02)


def tp_frames(cfg, device="cpu"):
    import torch
    return torch.from_numpy(tp_frames_np(cfg)).to(device)


def tp_cross_kv(cfg, params, device="cpu"):
    """The encdec decode's stacked cross K/V of `tp_frames`, made whole in
    one process (the placed decode takes each rank's block of it)."""
    import torch

    from repro_torch.models import encdec
    with torch.no_grad():
        return encdec.cross_kv(params, encdec.encode(
            params, tp_frames(cfg, device), cfg), cfg)


def _greedy(cfg, logits):
    """This rank's rows' greedy tokens [b, 1] from its (vocab block of
    the) last logits, the padded vocab masked (the encdec decode leaves it
    unmasked)."""
    import torch

    from repro_torch.models import common
    from repro_torch.parallel import sharding as shd
    logits = common.mask_padded_vocab(logits[:, -1].clone(), cfg.vocab_size,
                                      cfg.vocab_padded)
    return shd.vocab_argmax(logits, cfg.vocab_padded)[:, None].to(
        torch.int32)


def tp_serve(arch: str, mesh, device="cpu") -> dict:
    """The placed prefill (the encdec family: the stacked cross K/V, made
    whole) and TP_NEW greedy decode steps of `arch` on `mesh`, under its
    profile's `mesh_context`: this rank's blocks of every step's logits,
    the tokens it fed, and its blocks of the cache after the last."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    cfg, params = fsdp_params(arch, device)
    api = registry.build(cfg)
    placed = shd.place(params, shd.named_shardings(params, mesh,
                                                   **dict(TP_ARCHS)[arch]))
    prompt = tp_prompt(cfg, device)
    data_group = mesh.get_group("data")

    def global_tokens(local):
        parts = [torch.empty_like(local) for _ in range(mesh.size(0))]
        dist.all_gather(parts, local.contiguous(), group=data_group)
        return torch.cat(parts)

    logits_out, fed = [], []
    with torch.no_grad(), shd.mesh_context(mesh, tp_rules(arch)):
        if cfg.family == "encdec":
            xkv = tp_cross_kv(cfg, params, device)
            cache = shd.place_blocks(
                *_encdec_cache(cfg, mesh, device), mesh)
            tok, start = prompt[:, :1], 0
        else:
            logits, cache, start = api.prefill_fn(placed, prompt,
                                                  TP_PROMPT + TP_NEW)
            logits_out.append(_host(logits))
            tok = global_tokens(_greedy(cfg, logits.to_local()))
        for i in range(TP_NEW):
            fed.append(tok.cpu().numpy().copy())
            batch = {"tokens": tok, "cur_index": start + i}
            if cfg.family == "encdec":
                batch["cross_kv"] = xkv
            logits, cache = api.decode_fn(placed, cache, batch)
            logits_out.append(_host(logits))
            tok = global_tokens(_greedy(cfg, logits.to_local()))
    from repro_torch.models.lm import tree_map
    return {"logits": logits_out, "tokens": fed,
            "cache": tree_map(_host, cache),
            "coord": tuple(mesh.get_coordinate())}


def _encdec_cache(cfg, mesh, device):
    """(this rank's zero blocks, specs, whole abstract cache) of the encdec
    decode cache on `mesh` (the family has no prefill to make it)."""
    import torch

    from repro_torch.models import encdec
    from repro_torch.parallel import sharding as shd
    whole = encdec.init_decode_cache(cfg, TP_BATCH, TP_PROMPT + TP_NEW,
                                     "meta")
    axes = shd.serve_batch_axes(mesh, TP_BATCH)
    specs = shd.serve_cache_pspecs(whole, mesh, batch_axes=axes)

    def zeros(w, spec):
        idx = shd.block_index(tuple(w.shape), shd.NamedSharding(mesh, spec),
                              tuple(mesh.get_coordinate()))
        return torch.zeros(tuple(s.stop - s.start for s in idx),
                           dtype=w.dtype, device=device)
    return shd._tree_map(zeros, whole, specs), specs, whole


def tp_serve_oracle(arch: str, device="cpu") -> dict:
    """`tp_serve` in one process: each DP rank's rows in turn, split over
    the model ranks (`sharding.run_model_ranks`: one thread a rank, the
    reductions' sums in rank order). Returns {(data, model) coordinate:
    what that rank of `tp_serve` returns}."""
    import torch

    from repro_torch.models import encdec, lm
    from repro_torch.models.lm import tree_map
    from repro_torch.parallel import sharding as shd
    cfg, params = fsdp_params(arch, device)
    (n_dp, m), names = TP_MESH
    shard = shd.named_shardings(params, shd.SpecMesh(names, (n_dp, m)),
                                **dict(TP_ARCHS)[arch])
    tdims = tp_dims(shard, names, (0,))
    prompt = tp_prompt(cfg, device)
    k = TP_BATCH // n_dp
    xkv = tp_cross_kv(cfg, params, device) if cfg.family == "encdec" \
        else None
    out = {}
    for d in range(n_dp):
        rows = slice(d * k, (d + 1) * k)

        def rank(r):
            p = tree_map(lambda a, t: a if t is None else a.narrow(
                t, r * (a.shape[t] // m), a.shape[t] // m).contiguous(),
                params, _tdim_tree(params, tdims))
            logits_out, fed = [], []
            if cfg.family == "encdec":
                kv = {key: v[:, rows].narrow(
                    3, r * (v.shape[3] // m), v.shape[3] // m).contiguous()
                    if v.shape[3] % m == 0 else v[:, rows].contiguous()
                    for key, v in xkv.items()}
                cache = encdec.init_decode_cache(
                    cfg, k, TP_PROMPT + TP_NEW, device, model_ranks=m)
                tok, start = prompt[rows, :1], 0
            else:
                logits, cache, start = lm.prefill(p, prompt[rows], cfg,
                                                  TP_PROMPT + TP_NEW)
                logits_out.append(_host(logits))
                tok = _greedy(cfg, logits)
            for i in range(TP_NEW):
                fed.append(tok.cpu().numpy().copy())
                if cfg.family == "encdec":
                    logits, cache = encdec.decode_step(p, cache, kv, tok,
                                                       start + i, cfg)
                else:
                    logits, cache = lm.decode_step(p, cache, tok, start + i,
                                                   cfg)
                logits_out.append(_host(logits))
                tok = _greedy(cfg, logits)
            return {"logits": logits_out, "tokens": fed,
                    "cache": tree_map(_host, cache)}

        with torch.no_grad():
            for r, res in enumerate(shd.run_model_ranks(m, rank)):
                out[d, r] = res
    return out


def _tdim_tree(params, tdims: dict):
    from repro_torch.train.step import _tree
    return _tree(list(tdims), list(tdims.values()))


def tp_train_run(arch: str, state_dtype: str, mesh, device="cpu") -> dict:
    """FSDP_STEPS placed steps of `arch` (`fsdp_run`'s, with the AdamW
    moments in `state_dtype`): losses, norms, this rank's blocks of the
    params and of the first moment (int8: its codes and scales)."""
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_map
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import StepConfig, make_train_step
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg, params = fsdp_params(arch, device)
    kw = dict(TP_ARCHS)[arch]
    opt_cfg = adamw.AdamWConfig(state_dtype=state_dtype)
    opt = adamw.init_state(params, opt_cfg)
    plane, ef = initial_plane_and_ef(params)
    params = shd.place(params, shd.named_shardings(params, mesh, **kw))
    opt = shd.place(opt, shd.named_shardings(opt, mesh, **kw))
    step = make_train_step(registry.build(cfg, remat="full").loss_fn,
                           opt_cfg, fsdp_schedule(wsd),
                           StepProfile(**DP_PROFILE), StepConfig(),
                           mesh=mesh)
    losses, norms = [], []
    with shd.mesh_context(mesh, tp_rules(arch)):
        for i in range(FSDP_STEPS):
            params, opt, plane, ef, metrics = step(
                params, opt, plane, ef, fsdp_batch(cfg, i, device))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    out = {"loss": losses, "grad_norm": norms,
           "params": tree_map(_host, params),
           "m": tree_map(_host, opt["m"]),
           "coord": tuple(mesh.get_coordinate())}
    if state_dtype == "int8":
        out["restored"] = _placed_round_trip(
            {"params": params, "opt": opt}, mesh, kw)
    return out


def _placed_round_trip(state, mesh, kw) -> bool:
    """The placed state saved (`CheckpointManager.save`) and restored onto
    the same mesh (`restore(shardings=)`): whether every rank's blocks
    come back bit for bit (a collective; the checkpoint under the rank
    0's directory of the world's store)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.models.lm import tree_map
    from repro_torch.parallel import sharding as shd
    root = [tempfile.mkdtemp(prefix="tp_ckpt_") if dist.get_rank() == 0
            else None]
    dist.broadcast_object_list(root, src=0)
    mgr = CheckpointManager(root[0])
    mgr.save(FSDP_STEPS, state)
    dist.barrier()
    like = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device="meta"), state)
    _, back = mgr.restore(like, shardings={
        k: shd.named_shardings(v, mesh, **kw) for k, v in like.items()})
    same = all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(
        shd._leaves_of(state), shd._leaves_of(back)))
    dist.barrier()
    if dist.get_rank() == 0:
        import shutil
        shutil.rmtree(root[0], ignore_errors=True)
    return same


def tp_train_oracle(arch: str, state_dtype: str, device="cpu") -> dict:
    """`placed_oracle` of `tp_train_run`'s run."""
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    cfg, params = fsdp_params(arch, device)
    return placed_oracle(
        cfg, params, registry.build(cfg, remat="none").loss_fn,
        lambda i: fsdp_batch(cfg, i, device), [TP_MESH] * FSDP_STEPS,
        dict(TP_ARCHS)[arch], shares=cfg.family == "moe",
        opt_cfg=adamw.AdamWConfig(state_dtype=state_dtype))


def tp_comm_counts(mesh, arch: str = "minicpm_2b", device="cpu") -> dict:
    """One placed step of tiny `arch` (f32 moments) under `CommDebugMode`:
    its collective counts by op, and each leaf's placement, by path
    (`tests/test_torch_tp.py` derives the counts the step's placement
    implies from them)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.power_plane import StepProfile
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import get_path, leaf_paths
    from repro_torch.optim.schedule import wsd
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import StepConfig, make_train_step
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg, params = fsdp_params(arch, device)
    shard = shd.named_shardings(params, mesh)
    opt = adamw.init_state(params, adamw.AdamWConfig())
    plane, ef = initial_plane_and_ef(params)
    placed = shd.place(params, shard)
    opt = shd.place(opt, shd.named_shardings(opt, mesh))
    step = make_train_step(registry.build(cfg, remat="none").loss_fn,
                           adamw.AdamWConfig(), fsdp_schedule(wsd),
                           StepProfile(**DP_PROFILE), StepConfig(),
                           mesh=mesh)
    with shd.mesh_context(mesh), CommDebugMode() as comm:
        step(placed, opt, plane, ef, fsdp_batch(cfg, 0, device))
    return {"counts": {str(k): v for k, v in
                       comm.get_comm_counts().items()},
            "dims": {path: get_path(shard, path).shard_dims
                     for path in leaf_paths(shard)}}


def tp_world(rank: int, world: int, out_dir: str) -> dict:
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*TP_MESH, "cpu")
    out = {("comm", arch): tp_comm_counts(mesh, arch) for arch in TP_COMM}
    for arch, _ in TP_ARCHS:
        out["serve", arch] = tp_serve(arch, mesh)
        if rank == 0:
            out["serve", arch, "oracle"] = tp_serve_oracle(arch)
    for arch, dtype in TP_TRAIN:
        out["train", arch] = tp_train_run(arch, dtype, mesh)
        if rank == 0:
            out["train", arch, "oracle"] = tp_train_oracle(arch, dtype)
    return out


# -- elastic restore ------------------------------------------------------------

ELASTIC_SAVE_MESH = ((2, 2), ("data", "model"))
ELASTIC_STEP = 1            # the placed steps before the checkpoint
ELASTIC_BATCH = dict(seq=32, batch=8)


def elastic_setup(device="cpu"):
    """(cfg, its abstract params, the step factory, step i's batch) of the
    elastic example's model: tiny MiniCPM (bf16), 8 rows of 32 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import StepConfig, make_train_step
    cfg = get_config("minicpm_2b", tiny=True)
    data = SyntheticLM(DataConfig(cfg.vocab_size, ELASTIC_BATCH["seq"],
                                  ELASTIC_BATCH["batch"]))

    def build(mesh):
        return make_train_step(registry.build(cfg, remat="none").loss_fn,
                               adamw.AdamWConfig(), fsdp_schedule(wsd),
                               StepProfile(**DP_PROFILE), StepConfig(),
                               mesh=mesh)

    return (cfg, registry.abstract_params(cfg), build,
            lambda i: data.torch_batch(i, device))


def _abstract_state(abstract):
    from repro_torch.optim import adamw
    return {"params": abstract,
            "opt": adamw.init_state(abstract, adamw.AdamWConfig())}


def _restore_placed(path, mesh):
    """The checkpoint at `path` restored onto `mesh` (params and opt
    placed by `named_shardings`): (step, state)."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.parallel import sharding as shd
    _, abstract, _, _ = elastic_setup()
    like = _abstract_state(abstract)
    return CheckpointManager(path).restore(
        like, shardings={k: shd.named_shardings(v, mesh)
                         for k, v in like.items()})


def _blocks(state) -> dict:
    from repro_torch.models.lm import tree_map
    return {k: tree_map(_host, v) for k, v in state.items()}


def elastic_save_world(rank: int, world: int, out_dir: str) -> dict:
    """On a (data, model) mesh of 2 x 2: the reference's tiny MiniCPM init
    (ELASTIC_PARAMS) placed with fresh f32 moments, ELASTIC_STEP placed
    steps, the checkpoint `port_ckpt` saved under ELASTIC_DIR; the whole
    state gathered (rank 0 returns it); and the reference's checkpoint
    `ref_ckpt` restored placed on the same mesh (each rank's blocks)."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg, _, build, batch = elastic_setup()
    mesh = make_mesh(*ELASTIC_SAVE_MESH, "cpu")
    with open(os.environ["ELASTIC_PARAMS"], "rb") as f:
        params = registry.params_from_jax(cfg, pickle.load(f), "cpu")
    opt = adamw.init_state(params, adamw.AdamWConfig())
    plane, ef = initial_plane_and_ef(params)
    params = shd.place(params, shd.named_shardings(params, mesh))
    opt = shd.place(opt, shd.named_shardings(opt, mesh))
    step = build(mesh)
    for i in range(ELASTIC_STEP):
        params, opt, plane, ef, _ = step(params, opt, plane, ef, batch(i))
    state = {"params": params, "opt": opt}
    root = os.environ["ELASTIC_DIR"]
    CheckpointManager(os.path.join(root, "port_ckpt")).save(ELASTIC_STEP,
                                                            state)
    from repro_torch.models.lm import tree_map
    whole = {k: tree_map(shd.full_tensor, v) for k, v in state.items()}
    _, from_ref = _restore_placed(os.path.join(root, "ref_ckpt"), mesh)
    return {"whole": _blocks(whole) if rank == 0 else None,
            "from_ref": _blocks(from_ref),
            "coord": tuple(mesh.get_coordinate())}


def elastic_restore_world(rank: int, world: int, out_dir: str) -> dict:
    """`port_ckpt` restored onto a `(data,)` mesh of the whole world: each
    rank's blocks, and one placed step from there (its loss)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import initial_plane_and_ef
    _, _, build, batch = elastic_setup()
    mesh = make_mesh((world,), ("data",), "cpu")
    step_no, state = _restore_placed(
        os.path.join(os.environ["ELASTIC_DIR"], "port_ckpt"), mesh)
    out = {"step": step_no, "blocks": _blocks(state),
           "coord": tuple(mesh.get_coordinate())}
    plane, ef = initial_plane_and_ef(state["params"])
    _, _, _, _, m = build(mesh)(state["params"], state["opt"], plane, ef,
                                batch(step_no))
    out["loss"] = float(m["loss"])
    return out


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

