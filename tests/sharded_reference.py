"""The reference's sharded runs on forced host devices, for the port's
sharding tests: run in a process of its own, because XLA's host device
count is fixed when JAX starts (the reference tests' recipe,
`XLA_FLAGS=--xla_force_host_platform_device_count=N`).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src:.:tests python tests/sharded_reference.py sharding OUT
    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        PYTHONPATH=src:.:tests python tests/sharded_reference.py dp OUT
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src:.:tests python tests/sharded_reference.py fsdp OUT \\
        PARAMS ARCH:MESH ...

`sharding` (4 devices): the sharded control round, the sharded fleet
train step and the routed world served over a `chips` mesh, on the inputs
of `sharded_worlds`. `dp` (2 devices): the reference's `shard_map_ef_step`
on tiny MiniCPM over a `data` mesh of 2. `fsdp` (4 devices): the
reference's train step jitted with params and moments placed by
`named_shardings` and the batch over `data`, under `mesh_context`, for
each named family of `sharded_worlds.FSDP_ARCHS` on the named mesh of
`FSDP_MESHES` (an ARCH:MESH:int8 case with the int8 AdamW moments).
`tp_serve` (4 devices): the reference's placed prefill and greedy decode
steps of each named family of `sharded_worlds.TP_ARCHS`, jitted on the
(data 2, model 2) mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src:.:tests python tests/sharded_reference.py tp_serve \\
        OUT PARAMS ARCH ...

Pickles a dict of numpy arrays to OUT.
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


def fsdp_run(arch: str, mesh_name: str, params_np,
             state_dtype: str = "float32") -> dict:
    """FSDP_STEPS placed steps of `arch` (AdamW moments in `state_dtype`):
    the losses and grad norms, the whole params and first moment (int8:
    its decoded values) after the last, and each device's index of every
    params leaf (`devices_indices_map`, devices in mesh order)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.core.power_plane import StepProfile
    from repro.data.pipeline import (DataConfig, SyntheticLM,
                                     stub_frontend_inputs)
    from repro.models import registry
    from repro.optim import adamw
    from repro.optim.schedule import wsd
    from repro.parallel import sharding as shd
    from repro.train.step import StepConfig, make_train_step
    from repro.train.trainer import initial_plane_and_ef
    cfg = sw.fsdp_config(get_config, arch)
    shape, axes = sw.FSDP_MESHES[mesh_name]
    mesh = Mesh(np.array(jax.devices()[:sw.FSDP_RANKS]).reshape(shape),
                axes)
    kw = {**dict(sw.TP_ARCHS), **dict(sw.FSDP_ARCHS)}[arch]
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_cfg = adamw.AdamWConfig(state_dtype=state_dtype)
    opt = adamw.init_state(params, opt_cfg)
    plane, ef = initial_plane_and_ef(params)
    psh = shd.named_shardings(params, mesh, **kw)
    osh = shd.named_shardings(opt, mesh, **kw)
    params, opt = jax.device_put(params, psh), jax.device_put(opt, osh)
    raw = make_train_step(registry.build(cfg, remat="full").loss_fn,
                          opt_cfg, sw.fsdp_schedule(wsd),
                          StepProfile(**sw.DP_PROFILE), StepConfig())
    rules = (sw.fsdp_rules(mesh_name, arch) if arch in dict(sw.FSDP_ARCHS)
             else sw.tp_rules(arch))

    def run(p, o, pl, e, b):
        with shd.mesh_context(mesh, rules):
            return raw(p, o, pl, e, b)

    bsh = NamedSharding(mesh, P("data"))
    data = SyntheticLM(DataConfig(cfg.vocab_size, sw.FSDP_SEQ,
                                  sw.FSDP_BATCH))
    batches = [data.jax_batch(i, stub_frontend_inputs(
        cfg, cfg.family, sw.FSDP_BATCH, seed=sw.fsdp_frontend_seed(i)))
        for i in range(sw.FSDP_STEPS)]
    step = jax.jit(run, in_shardings=(
        psh, osh, None, None, {k: bsh for k in batches[0]}),
        out_shardings=(psh, osh, None, None, None))
    losses, norms = [], []
    for b in batches:
        params, opt, plane, ef, m = step(params, opt, plane, ef, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    devs = list(mesh.devices.flat)

    def index(sh, leaf):
        idx = sh.devices_indices_map(leaf.shape)
        return [[(s.start or 0, s.stop if s.stop is not None else n)
                 for s, n in zip(idx[d], leaf.shape)] for d in devs]

    host = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jax.device_get(t))
    m = opt["m"]
    if state_dtype == "int8":
        m = jax.tree_util.tree_map(
            lambda p, e: adamw._q_decode(e, p.shape), params, m,
            is_leaf=lambda x: isinstance(x, dict) and "q" in x)
    return {"loss": losses, "grad_norm": norms, "params": host(params),
            "m": host(m),
            "index": jax.tree_util.tree_map(index, psh, params)}


def tp_serve_run(arch: str, params_np) -> dict:
    """`sharded_worlds.tp_serve` in the reference: its prefill (the
    encdec family: the cross K/V made whole) and TP_NEW greedy decode
    steps jitted with params placed by `named_shardings`, the batch by
    its dry run's `batch_pspecs` and the cache by `cache_pspecs`, under
    `mesh_context` on the (data 2, model 2) mesh: each step's whole
    logits and the tokens fed."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import encdec, registry
    from repro.parallel import sharding as shd
    cfg = sw.fsdp_config(get_config, arch)
    shape, axes = sw.TP_MESH
    mesh = Mesh(np.array(jax.devices()[:sw.TP_RANKS]).reshape(shape), axes)
    api = registry.build(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    psh = shd.named_shardings(params, mesh, **dict(sw.TP_ARCHS)[arch])
    params = jax.device_put(params, psh)
    rules = sw.tp_rules(arch)
    data = SyntheticLM(DataConfig(cfg.vocab_size, sw.FSDP_SEQ, sw.TP_BATCH))
    prompt = jnp.asarray(data.batch(0)["tokens"][:, :sw.TP_PROMPT])
    bsh = NamedSharding(mesh, P("data"))
    max_len = sw.TP_PROMPT + sw.TP_NEW

    def greedy(logits):
        lg = np.array(jax.device_get(logits), np.float32)[:, -1]
        lg[:, cfg.vocab_size:] = -np.inf
        return jnp.asarray(lg.argmax(-1)[:, None].astype(np.int32))

    def decode(p, c, b):
        with shd.mesh_context(mesh, rules):
            return api.decode_fn(p, c, b)

    logits_out, fed = [], []
    if cfg.family == "encdec":
        from repro.data.pipeline import stub_frontend_inputs
        frames = jnp.asarray(np.asarray(sw.tp_frames_np(cfg)))
        xkv = encdec.cross_kv(params, encdec.encode(params, frames, cfg),
                              cfg)
        cache = api.init_decode_cache(sw.TP_BATCH, max_len)
        tok, start = prompt[:, :1], 0
    else:
        def prefill(p, t):
            with shd.mesh_context(mesh, rules):
                return api.prefill_fn(p, t, max_len)
        logits, cache, start = jax.jit(
            prefill, in_shardings=(psh, bsh), static_argnums=())(params,
                                                                 prompt)
        start = int(start)
        logits_out.append(np.asarray(jax.device_get(logits), np.float32))
        tok = greedy(logits)
    csh = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s),
        shd.cache_pspecs(cache, mesh, batch_axes=("data",)))
    cache = jax.device_put(cache, csh)
    step = jax.jit(decode, in_shardings=(psh, csh, None),
                   out_shardings=(None, csh))
    for i in range(sw.TP_NEW):
        fed.append(np.asarray(tok))
        batch = {"tokens": tok, "cur_index": jnp.int32(start + i)}
        if cfg.family == "encdec":
            batch["cross_kv"] = xkv
        logits, cache = step(params, cache, batch)
        logits_out.append(np.asarray(jax.device_get(logits), np.float32))
        tok = greedy(logits)
    return {"logits": logits_out, "tokens": fed}


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
    elif which == "fsdp":
        with open(argv[3], "rb") as f:
            params = pickle.load(f)
        out = {"devices": len(devs)}
        for case in argv[4:]:
            arch, name, *dtype = case.split(":")
            out[(arch, name, *dtype)] = fsdp_run(arch, name, params[arch],
                                                 *dtype)
    elif which == "tp_serve":
        with open(argv[3], "rb") as f:
            params = pickle.load(f)
        out = {"devices": len(devs)}
        for arch in argv[4:]:
            out[arch] = tp_serve_run(arch, params[arch])
    else:
        raise SystemExit(f"unknown run {which!r}")
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv)
