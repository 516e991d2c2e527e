"""The reference's sharded runs on forced host devices, for the port's
sharding tests: run in a process of its own, because XLA's host device
count is fixed when JAX starts (the reference tests' recipe,
`XLA_FLAGS=--xla_force_host_platform_device_count=N`).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src:.:tests python tests/sharded_reference.py sharding OUT
    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        PYTHONPATH=src:.:tests python tests/sharded_reference.py dp OUT

`sharding` (4 devices): the sharded control round, the sharded fleet
train step and the routed world served over a `chips` mesh, on the inputs
of `sharded_worlds`. `dp` (2 devices): the reference's `shard_map_ef_step`
on tiny MiniCPM over a `data` mesh of 2. Pickles a dict of numpy arrays to
OUT.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import sharded_worlds as sw
import test_torch_inputs as ti


def _host(a):
    return np.asarray(jax.device_get(a)).copy()


def _state(plane, ss) -> dict:
    out = {f: _host(getattr(plane, f))
           for f in ("v_core", "v_hbm", "v_io", "energy_j")}
    out["history_v"] = _host(ss.history.v)
    out["history_obs"] = _host(ss.history.obs)
    for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
        out[f] = _host(getattr(ss.estimate, f))
    out["tick"] = int(ss.tick)
    return out


def _cfg():
    from repro.core import sor
    return sor.SorConfig(rails=sor.ALL_RAIL_OBSERVABLES, **sw.SOR_KNOBS)


def round_run(mesh) -> dict:
    from repro.core.control_plane import (InGraphRailController,
                                          sharded_control_round)
    from repro.core.hwspec import FleetSpec
    from repro.core.policy import MultiRailClosedLoop
    from repro.core.power_plane import PowerPlaneState
    from repro.core.telemetry import as_frame
    from repro.kernels import ops
    fs = FleetSpec.sample(sw.N, seed=sw.ROUND_FLEET_SEED)
    ctrl = InGraphRailController(MultiRailClosedLoop(), sor=_cfg())
    plane, ss = PowerPlaneState.from_fleet(fs), ctrl.init_sor(sw.N)
    rnd = jax.jit(sharded_control_round(ctrl, mesh))
    p1 = ops.shard_chip_tree(plane, mesh, sw.N)
    s1 = ops.shard_chip_tree(ss, mesh, sw.N)
    errs = sw.frame_errors()
    conf = []
    for i in range(sw.ROUNDS):
        m = sw.N
        frame = as_frame({"grad_error": jnp.asarray(errs[i]),
                          "t_chip_s": jnp.full((m,), 1e-3),
                          "straggle_rate": jnp.full((m,), 1e-3),
                          "hbm_error_rate": jnp.full((m,), 1e-4)}, state=p1)
        p1, s1, conf_sum, conf_min = rnd(p1, frame, s1)
        conf.append((float(conf_sum), float(conf_min)))
    return dict(_state(p1, s1), conf=conf)


def step_run(mesh) -> dict:
    from repro.core.hwspec import FleetSpec
    from repro.core.policy import MultiRailClosedLoop
    from repro.core.power_plane import StepProfile
    from repro.core import sor
    from repro.kernels import ops
    from repro.optim import adamw
    from repro.train.step import (FleetStepConfig, StepConfig,
                                  jit_train_step, make_fleet_train_step)
    from repro.train.trainer import initial_plane_and_ef
    fs = FleetSpec.sample(sw.N, seed=sw.STEP_FLEET_SEED)
    cfg = _cfg()

    def loss_fn(p, b):
        return jnp.mean((b @ p["w"]) ** 2), {}

    opt_cfg = adamw.AdamWConfig(grad_clip_norm=1.0)
    step = jit_train_step(make_fleet_train_step(
        loss_fn, opt_cfg, lambda s: 1e-3, StepProfile(*sw.PROFILE),
        StepConfig(policy=MultiRailClosedLoop()),
        FleetStepConfig(spec=fs, hbm_error_base=sw.HBM_ERROR_BASE,
                        mesh=mesh, sor=cfg)), donate=False)
    p = {"w": jnp.ones((4,), jnp.float32)}
    opt = adamw.init_state(p, opt_cfg)
    plane, ef = initial_plane_and_ef(p, fleet=fs)
    ss = sor.init_state(cfg, fs.n_chips)
    plane = ops.shard_chip_tree(plane, mesh, fs.n_chips)
    ss = ops.shard_chip_tree(ss, mesh, fs.n_chips)
    for b in sw.step_batches():
        p, opt, plane, ef, ss, metrics = step(p, opt, plane, ef, ss,
                                              jnp.asarray(b))
    return dict(_state(plane, ss), w=_host(p["w"]),
                metrics={k: _host(v) for k, v in metrics.items()})


def _j_observe(fs, noise):
    """The routed world's observe in jnp, its noise read from the shared
    table (`tests/test_torch_serve_trace.py`'s)."""
    table = jnp.asarray(noise)
    v_on = {}
    for rail, src in ti.routed_onset_sources(fs).items():
        base, spread = ti.ROUTED_ONSETS[rail]
        v_on[rail] = base + spread * (jnp.asarray(src) - 1.0)

    def err(v, v_onset, nz):
        return ti.ROUTED_BOUND * nz * 10.0 ** jnp.clip(
            ti.ROUTED_LOG_SLOPE * (v_onset - v), -6.0, 3.0)

    def observe(plane, frame, tick, busy_frac):
        nz = table[tick + ti.ROUTED_WARMUP]
        shift = ti.ROUTED_LOAD_SHIFT_V * busy_frac
        return dataclasses.replace(
            frame,
            grad_error=err(plane.v_io, v_on["VDD_IO"] + shift, nz[0]),
            extras={**frame.extras,
                    "straggle_rate": err(plane.v_core, v_on["VDD_CORE"],
                                         nz[1]),
                    "hbm_error_rate": err(plane.v_hbm,
                                          v_on["VDD_HBM"] + shift, nz[2])})

    return observe


def serve_run(router: str, mesh) -> dict:
    from benchmarks import serve_router as sr
    from repro.configs import get_config
    from repro.core import control_plane as jcp
    from repro.core.hwspec import FleetSpec
    from repro.core.power_plane import StepProfile
    from repro.core.power_plane import account_fleet_and_observe
    from repro.models import registry
    from repro.serve import router as jrouter
    from repro.serve.engine import ServeEngine
    from repro.serve.traffic import bursty_trace
    fs = FleetSpec.sample(sw.N, seed=ti.ROUTED_SEED)
    walk = sr._EnvelopeBlindWalk(floors=dict(sr.POLICY_FLOORS),
                                 backoff=1.01, name="envelope-blind-walk")
    ctrl = jcp.InGraphRailController(walk, sor=sr.SOR_CFG)
    cfg = get_config("minicpm_2b", tiny=True)
    params = registry.build(cfg).init(jax.random.PRNGKey(0))
    profile = StepProfile(**ti.ROUTED_PROFILE)
    rt = (jrouter.HeadroomRouter(capacity=sw.SERVE_CAPACITY)
          if router == "headroom"
          else jrouter.RoundRobinRouter(capacity=sw.SERVE_CAPACITY))
    eng = ServeEngine(cfg, params, max_len=24, batch_size=2,
                      prefill_profile=profile, decode_profile=profile,
                      fleet=fs, controller=ctrl, router=rt, mesh=mesh)
    observe = _j_observe(fs, ti.routed_noise(sw.N, sw.SERVE_MAX_TICKS))
    idle = jnp.zeros((sw.N,), jnp.float32)
    for w in range(ti.ROUTED_WARMUP):
        eng.plane, frame, _ = account_fleet_and_observe(
            eng.decode_profile, eng.plane, eng.fleet_spec)
        eng._control_tick(observe(eng.plane, frame, w - ti.ROUTED_WARMUP,
                                  idle))
    ledger = eng.serve_trace(
        bursty_trace(sw.SERVE_REQUESTS, **sw.serve_trace_knobs()),
        observe=observe, max_ticks=sw.SERVE_MAX_TICKS,
        error_bound=ti.ROUTED_BOUND)
    out = {"discrete": ti.ledger_discrete(eng, ledger),
           "fleet_energy_j": ledger.fleet_energy_j,
           "energy_j": [r.energy_j for r in ledger.records()],
           "sharded": eng._sharded_round is not None}
    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        out["plane_" + f] = _host(getattr(eng.plane, f))
    return out


def dp_run(mesh, params_path: str) -> dict:
    """The reference's `shard_map_ef_step` over a `data` mesh: what it
    returns (its `out_specs=P()` hand back one device's residual, plane
    and grad_error)."""
    from repro.configs import get_config
    from repro.core.policy import BERBounded
    from repro.core.power_plane import StepProfile
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import registry
    from repro.optim import adamw
    from repro.optim.schedule import wsd
    from repro.train.step import (StepConfig, make_train_step,
                                  shard_map_ef_step)
    from repro.train.trainer import initial_plane_and_ef
    cfg = sw.dp_config(get_config)
    with open(params_path, "rb") as f:
        params = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
    raw = make_train_step(registry.build(cfg, remat="full").loss_fn,
                          adamw.AdamWConfig(), sw.dp_schedule(wsd),
                          StepProfile(**sw.DP_PROFILE),
                          StepConfig(grad_sync="ef_int8",
                                     policy=BERBounded()))
    step = jax.jit(shard_map_ef_step(raw, mesh))
    opt = adamw.init_state(params, adamw.AdamWConfig())
    plane, ef = initial_plane_and_ef(params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, sw.DP_SEQ, sw.DP_BATCH))
    losses, errors = [], []
    for i in range(sw.DP_STEPS):
        params, opt, plane, ef, metrics = step(params, opt, plane, ef,
                                               data.jax_batch(i))
        losses.append(float(metrics["loss"]))
        errors.append(float(metrics["grad_error"]))
    host = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jax.device_get(t))
    return {"loss": losses, "grad_error": errors, "params": host(params),
            "ef": host(ef), "v_io": float(plane.v_io),
            "comp_level": int(plane.comp_level)}


def main(argv) -> None:
    which, out_path = argv[1], argv[2]
    devs = jax.devices()
    if which == "sharding":
        mesh = Mesh(np.array(devs[:sw.RANKS]), ("chips",))
        out = {"devices": len(devs), "round": round_run(mesh),
               "step": step_run(mesh)}
        for router in ("roundrobin", "headroom"):
            out["serve_" + router] = serve_run(router, mesh)
    elif which == "dp":
        mesh = Mesh(np.array(devs[:sw.DP_RANKS]), ("data",))
        out = {"devices": len(devs), "ef": dp_run(mesh, argv[3])}
    else:
        raise SystemExit(f"unknown run {which!r}")
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv)
