"""The chip axis over `torch.distributed` (the port's `launch/mesh.py`,
`ops.{chip_specs, shard_chip_tree, sharded_fleet_reduce}`,
`sor.partition_specs`, `control_plane.sharded_control_round`, the sharded
fleet step, `Trainer(mesh=)`, the gathered checkpoint and `ServeEngine(mesh=)`)
against the reference.

The port's side runs in a gloo world of 4 processes on the CPU
(`sharded_worlds.sharding_world`, one world for the module, spawned and
joined with a timeout); the reference's sharded runs on 4 forced host
devices in one subprocess (`sharded_reference.py sharding`, started
beside it), and its unsharded functions per slice in this process. The
one-rank cases (the forced single-device pins, the validations) run in a
gloo world of one in this process.

Tolerances:
- Discrete outputs (ticks, SOR confidence and sample counts, ledgers'
  placement times, tokens and defers, launch counts) are exact.
- A rank's block against the port's unsharded function on the same slice:
  bit for bit. Against the unsharded function on the whole fleet: bit for
  bit where the CPU arithmetic does not depend on the lane count; the
  routed world's SOR estimate is not, because the plain refit's window
  sums (`Tensor.sum` over the ring's slots) block the reduction by the
  inner extent (4 lanes against 16 part by ~2e-6 in a sum), and the
  uncentred fit amplifies that (measured 2.6e-3 V on v_frontier): held at
  SERVE_SOR_ATOL there.
- Against the reference: the rails' and fits' trajectories through the
  refit from 4 samples part as the unsharded packages do (ROADMAP "Known
  disagreements": measured 4.3e-4 V on v_io, 1.2e-2 dex intercept, 0.4 %
  slope, 1.5e-3 V v_frontier, the same gaps as port-global against
  reference-global), held at ROUND_TOL; the fleet step within STEP_RTOL;
  the routed world by the reference's own multi-device contract
  (`tests/test_serve_scale.py:389-413`: placement times, tokens and
  defers exact, near-tie chip choices may flip), the fleet energy within
  SERVE_ENERGY_RTOL.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import sharded_worlds as sw
from repro_torch.checkpoint.ckpt import CheckpointManager, remap_sor
from repro_torch.core import sor as tsor
from repro_torch.core.control_plane import (InGraphRailController,
                                            sharded_control_round)
from repro_torch.core.hwspec import FleetSpec
from repro_torch.core.policy import (MultiRailClosedLoop, PhaseAware,
                                     WorstChipGate)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240
REF_TIMEOUT_S = 300
FIELDS = ("v_core", "v_hbm", "v_io", "energy_j", "history_v", "history_obs",
          "intercept", "slope", "v_frontier", "confidence", "n_eff")
EXACT = ("v_core", "v_hbm", "history_obs", "confidence", "n_eff")
ROUND_TOL = {"v_io": 5e-4, "history_v": 5e-4, "energy_j": 1e-6,
             "intercept": 2.5e-2, "slope": 2.5e-2, "v_frontier": 3e-3}
STEP_RTOL = 1e-6
SERVE_SOR_ATOL = 5e-3
# the reference's contract, 1e-3 (measured 5e-8 round-robin); the headroom
# router's chip choices flip at near-ties as the unsharded packages' do
# (ROADMAP "Known disagreements"), and the fleet energy then parts as the
# unsharded SLO summaries do, within 2 % (measured 3.7e-3)
SERVE_ENERGY_RTOL = {"roundrobin": 1e-3, "headroom": 0.02}


@pytest.fixture(scope="module")
def worlds():
    """(the port's 4 ranks' results, the reference's 4-device results)."""
    out = tempfile.mkdtemp(prefix="sharding_")
    ref_path = os.path.join(out, "reference.pkl")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT,
                                           os.path.join(ROOT, "tests")]))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "sharded_reference.py"),
         "sharding", ref_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = sw.spawn_world("sharding_world", sw.RANKS,
                               os.path.join(out, "world"), WORLD_TIMEOUT_S)
        _, err = ref.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    with open(ref_path, "rb") as f:
        return ranks, pickle.load(f), out


@pytest.fixture(scope="module")
def mesh1():
    """A `chips` mesh over a gloo world of one in this process."""
    store = dist.FileStore(tempfile.mktemp(prefix="store_"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield tmesh.make_chips_mesh(device_type="cpu")
    finally:
        ops._host_groups.cache_clear()
        dist.destroy_process_group()


def _cat(ranks, key, fields=FIELDS):
    return {f: np.concatenate([r[key][f] for r in ranks], axis=-1)
            for f in fields}


def _slice_tree(tree, sl, n=sw.N):
    return ops._map_tree(
        lambda a: a[..., sl].contiguous()
        if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[-1] == n
        else a, tree)


def _ref_rounds(sl):
    """The reference's unsharded round on the chips `sl`, jitted."""
    from repro.core import sor as jsor
    from repro.core.control_plane import InGraphRailController as JCtrl
    from repro.core.hwspec import FleetSpec as JFleet
    from repro.core.policy import MultiRailClosedLoop as JPolicy
    from repro.core.power_plane import PowerPlaneState as JPlane
    from repro.core.telemetry import as_frame
    fs = JFleet.sample(sw.N, seed=sw.ROUND_FLEET_SEED)
    ctrl = JCtrl(JPolicy(), sor=jsor.SorConfig(
        rails=jsor.ALL_RAIL_OBSERVABLES, **sw.SOR_KNOBS))
    take = lambda t: jax.tree_util.tree_map(
        lambda a: a[..., sl] if jnp.ndim(a) >= 1 and jnp.shape(a)[-1] == sw.N
        else a, t)
    plane, ss = take(JPlane.from_fleet(fs)), take(ctrl.init_sor(sw.N))
    rj = jax.jit(lambda p, f, s: ctrl.control_round(p, f, s))
    errs = sw.frame_errors()
    for i in range(sw.ROUNDS):
        m = errs[i, sl].shape[0]
        frame = as_frame({"grad_error": jnp.asarray(errs[i, sl]),
                          "t_chip_s": jnp.full((m,), 1e-3),
                          "straggle_rate": jnp.full((m,), 1e-3),
                          "hbm_error_rate": jnp.full((m,), 1e-4)}, state=plane)
        plane, ss, _, _ = rj(plane, frame, ss)
    out = {f: np.asarray(getattr(plane, f)) for f in ("v_core", "v_hbm",
                                                      "v_io", "energy_j")}
    out.update(history_v=np.asarray(ss.history.v),
               history_obs=np.asarray(ss.history.obs))
    for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
        out[f] = np.asarray(getattr(ss.estimate, f))
    return out


def _close_to_reference(got, want, label):
    for f in FIELDS:
        if f in EXACT:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"{label} {f}")
        else:
            np.testing.assert_allclose(got[f], want[f], rtol=0,
                                       atol=ROUND_TOL[f],
                                       err_msg=f"{label} {f}")


# -- meshes and placements ---------------------------------------------------------

def test_mesh_helpers_name_their_axes(mesh1):
    assert mesh1.mesh_dim_names == ("chips",) and mesh1.size() == 1
    dbg = tmesh.make_debug_mesh(data=1, model=1, device_type="cpu")
    assert dbg.mesh_dim_names == ("data", "model")
    assert tmesh.dp_axes(dbg) == ("data",)
    pod = tmesh.make_debug_mesh(data=1, model=1, pod=1, device_type="cpu")
    assert tmesh.dp_axes(pod) == ("pod", "data")
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="length"):
        tmesh.make_mesh((1,), ("data", "model"), "cpu")
    assert ops.chip_block(mesh1, 16) == (0, 16)
    with pytest.raises(ValueError, match="axes"):
        ops.axis_group(mesh1, "data")


def test_chip_specs_shards_the_trailing_chip_axis_like_the_reference():
    from torch.distributed.tensor import Replicate, Shard

    from repro.core import sor as jsor
    from repro.core.control_plane import InGraphRailController as JCtrl
    from repro.core.policy import MultiRailClosedLoop as JPolicy
    plane, ctrl, ss = sw.round_world()
    specs = ops.chip_specs(ss, sw.N)
    assert specs.history.v == Shard(-1)
    assert specs.estimate.v_frontier == Shard(-1)
    assert specs.history.cursor == Replicate() and specs.tick == Replicate()
    assert ops.chip_specs(plane, sw.N).v_core == Shard(-1)
    assert tsor.partition_specs(ss) == specs
    with pytest.raises(ValueError, match="fleet SorState"):
        tsor.partition_specs(ctrl.init_sor(None, device="cpu"))
    # leaf for leaf against the reference's PartitionSpecs
    jss = JCtrl(JPolicy(), sor=jsor.SorConfig(
        rails=jsor.ALL_RAIL_OBSERVABLES, **sw.SOR_KNOBS)).init_sor(sw.N)
    jspec = jsor.partition_specs(jss)
    for path in (("history", "v"), ("history", "obs"), ("history", "age_s"),
                 ("history", "polled"), ("history", "valid"),
                 ("history", "cursor"), ("history", "count"),
                 ("estimate", "intercept"), ("estimate", "confidence"),
                 ("tick",)):
        got, want = specs, jspec
        for k in path:
            got, want = getattr(got, k), getattr(want, k)
        sharded = len(want) > 0 and want[-1] == "chips"
        assert got == (Shard(-1) if sharded else Replicate()), path


def test_shard_fleet_state_takes_the_chip_groups_only(mesh1):
    plane, _, ss = sw.round_world()
    params = {"w": torch.ones(4)}
    out = tstep.shard_fleet_state({"params": params, "plane": plane,
                                   "sor": ss}, mesh1)
    assert out["params"]["w"] is params["w"]     # model groups pass through
    assert out["plane"].v_core is not plane.v_core
    assert torch.equal(out["plane"].v_core, plane.v_core)
    assert torch.equal(out["sor"].history.v, ss.history.v)
    assert out["sor"].tick == ss.tick
    fs = FleetSpec.sample(8, seed=0)
    blk = ops.shard_chip_tree(fs, mesh1, 8)
    np.testing.assert_array_equal(blk.v_io_nominal, fs.v_io_nominal)


# -- the sharded control round --------------------------------------------------------

def test_sharded_round_forced_single_rank_bit_equal(mesh1):
    """The reference's pin: on a one-rank mesh the sharded round is the
    unsharded round bit for bit, and its two collectives are the
    confidence's sum and min."""
    plane, ctrl, ss = sw.round_world()
    p0, s0 = sw.unsharded_rounds(plane, ctrl, ss)
    rnd = sharded_control_round(ctrl, mesh1)
    p1 = ops.shard_chip_tree(plane, mesh1, sw.N)
    s1 = ops.shard_chip_tree(ss, mesh1, sw.N)
    errs = sw.frame_errors()
    for i in range(sw.ROUNDS):
        p1, s1, conf_sum, conf_min = rnd(p1, sw.frame_at(p1, errs[i]), s1)
    a, b = sw.state_arrays(p0, s0), sw.state_arrays(p1, s1)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert float(conf_sum) == float(s0.estimate.confidence.sum())
    assert float(conf_min) == float(s0.estimate.confidence.min())


def test_sharded_round_blocks_equal_the_unsharded_round_per_slice(worlds):
    ranks, _, _ = worlds
    for r, res in enumerate(ranks):
        lo, hi = res["block"]
        assert (lo, hi) == (r * sw.N // sw.RANKS, (r + 1) * sw.N // sw.RANKS)
        plane, ctrl, ss = sw.round_world()
        p, s = sw.unsharded_rounds(_slice_tree(plane, slice(lo, hi)), ctrl,
                                   _slice_tree(ss, slice(lo, hi)),
                                   slice(lo, hi))
        want = sw.state_arrays(p, s)
        for f in FIELDS:
            np.testing.assert_array_equal(res["round"][f], want[f],
                                          err_msg=f"rank {r} {f}")
        assert res["round"]["tick"] == sw.ROUNDS


def test_sharded_round_equals_the_global_round_and_its_summary(worlds):
    """In this world the blocks joined equal the unsharded round on all 16
    chips bit for bit (its sums fall alike at 4 and 16 lanes), and every
    rank reads the same fleet-wide confidence sum and min (the sum within
    1e-6: the ranks' partial sums are added in another order)."""
    ranks, _, _ = worlds
    plane, ctrl, ss = sw.round_world()
    p0, s0 = sw.unsharded_rounds(plane, ctrl, ss)
    want = sw.state_arrays(p0, s0)
    got = _cat(ranks, "round")
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert all(r["round_conf"] == ranks[0]["round_conf"] for r in ranks)
    # the sum adds the ranks' partial sums: another order than one sum
    conf_sum, conf_min = ranks[0]["round_conf"][-1]
    np.testing.assert_allclose(conf_sum, float(s0.estimate.confidence.sum()),
                               rtol=1e-6)
    assert conf_min == float(s0.estimate.confidence.min())


def test_sharded_round_against_the_reference(worlds):
    """Against the reference's sharded round on 4 forced devices and its
    unsharded round per slice (which the reference's sharded run equals:
    sharding adds nothing on either side), at ROUND_TOL."""
    ranks, ref, _ = worlds
    got = _cat(ranks, "round")
    _close_to_reference(got, ref["round"], "4-device")
    parts = [_ref_rounds(slice(*r["block"])) for r in ranks]
    per_slice = {f: np.concatenate([p[f] for p in parts], -1)
                 for f in FIELDS}
    _close_to_reference(got, per_slice, "per slice")
    for f in FIELDS:
        np.testing.assert_allclose(ref["round"][f], per_slice[f], rtol=0,
                                   atol=5e-4, err_msg=f)
    assert [c for c in ranks[0]["round_conf"]] == [
        tuple(c) for c in ref["round"]["conf"]]


def test_sharded_round_rejects_unshardable_controllers(mesh1):
    cfg = sw.sor_config()
    with pytest.raises(ValueError, match="sor"):
        sharded_control_round(InGraphRailController(PhaseAware()), mesh1)
    with pytest.raises(ValueError, match="cross.chip"):
        sharded_control_round(
            InGraphRailController(WorstChipGate(inner=MultiRailClosedLoop()),
                                  sor=cfg), mesh1)
    with pytest.raises(ValueError, match="axes"):
        sharded_control_round(InGraphRailController(MultiRailClosedLoop(),
                                                    sor=cfg), mesh1, "data")


# -- sharded_fleet_reduce ---------------------------------------------------------

def test_sharded_fleet_reduce_over_four_ranks(worlds):
    from repro.kernels import ops as jops
    ranks, _, _ = worlds
    want = [np.asarray(a) for a in jops.fleet_reduce(
        jnp.asarray(sw.reduce_input()))]
    for r in ranks:
        for got, first in zip(r["reduce"], ranks[0]["reduce"]):
            np.testing.assert_array_equal(got, first)   # every rank alike
        np.testing.assert_array_equal(r["reduce"][0], want[0])
        np.testing.assert_array_equal(r["reduce"][1], want[1])
        np.testing.assert_allclose(r["reduce"][2], want[2], rtol=1e-6,
                                   atol=1e-6)


def test_sharded_fleet_reduce_single_rank(mesh1):
    x = torch.from_numpy(sw.reduce_input())
    want = ops.fleet_reduce(x)
    got = ops.sharded_fleet_reduce(x, mesh=mesh1)           # guard: plain
    forced = ops.sharded_fleet_reduce(x, mesh=mesh1, use_shard_map=True)
    for a, b, c in zip(want, got, forced):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="mesh"):
        ops.sharded_fleet_reduce(x, mesh=None, use_shard_map=True)
    with pytest.raises(ValueError, match="axes"):
        ops.sharded_fleet_reduce(x, mesh=mesh1, axis_name="nope",
                                 use_shard_map=True)


# -- the sharded fleet step ---------------------------------------------------------

def _unsharded_step():
    step, state = sw.fleet_step(FleetSpec.sample(sw.N, seed=sw.STEP_FLEET_SEED))
    return sw.run_fleet_step(step, state)


def test_sharded_fleet_step_equals_the_unsharded_step(worlds):
    """Each rank's plane and SOR state are the unsharded step's slice, its
    draws hash the global chip indices, and the gathered tail gives every
    `fleet/*` metric of the unsharded step bit for bit."""
    ranks, _, _ = worlds
    state, metrics = _unsharded_step()
    want = sw.state_arrays(state["plane"], state["sor"])
    got = _cat(ranks, "step")
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for r in ranks:
        lo, hi = r["block"]
        for k, v in metrics.items():
            g = r["step_metrics"][k]
            if k.startswith("fleet/") or v.ndim == 0:
                np.testing.assert_array_equal(g, v, err_msg=k)
            else:
                np.testing.assert_array_equal(g, v[..., lo:hi], err_msg=k)
        np.testing.assert_array_equal(r["step_w"],
                                      state["params"]["w"].detach().numpy())


def test_sharded_fleet_step_against_the_reference(worlds):
    ranks, ref, _ = worlds
    got = _cat(ranks, "step")
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref["step"][f], rtol=STEP_RTOL,
                                   atol=1e-12, err_msg=f)
    rm = ref["step"]["metrics"]
    for r in ranks:
        lo, hi = r["block"]
        for k, v in r["step_metrics"].items():
            want = rm[k] if rm[k].ndim == v.ndim == 0 or k.startswith(
                "fleet/") else rm[k][..., lo:hi]
            np.testing.assert_allclose(v, want, rtol=STEP_RTOL, atol=1e-12,
                                       err_msg=k)
        np.testing.assert_allclose(r["step_w"], ref["step"]["w"],
                                   rtol=STEP_RTOL)


def test_fleet_step_shard_control_forced_single_rank_bit_equal(mesh1):
    """FleetStepConfig.shard_control=True on a one-rank mesh: the sharded
    round and the gathered tail reproduce the unsharded step bit for bit."""
    fs = FleetSpec.sample(4, seed=7)
    runs = []
    for kw in (dict(), dict(mesh=mesh1, shard_control=True)):
        step, state = sw.fleet_step(fs, **kw)
        runs.append(sw.run_fleet_step(step, state))
    (su, mu), (ss_, ms) = runs
    a = sw.state_arrays(su["plane"], su["sor"])
    b = sw.state_arrays(ss_["plane"], ss_["sor"])
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert mu.keys() == ms.keys()
    for k in mu:
        np.testing.assert_array_equal(mu[k], ms[k], err_msg=k)


def test_fleet_step_validation_errors(mesh1):
    fs = FleetSpec.sample(4, seed=7)
    args = (lambda p, b: (p["w"].sum(), {}), None, lambda s: 1e-3, None)
    with pytest.raises(ValueError, match="needs a mesh"):
        tstep.make_fleet_train_step(
            *args, tstep.StepConfig(policy=MultiRailClosedLoop()),
            tstep.FleetStepConfig(spec=fs, shard_control=True,
                                  sor=sw.sor_config()))
    with pytest.raises(ValueError, match="FleetStepConfig.sor"):
        tstep.make_fleet_train_step(
            *args, tstep.StepConfig(policy=MultiRailClosedLoop()),
            tstep.FleetStepConfig(spec=fs, mesh=mesh1, shard_control=True))
    with pytest.raises(ValueError, match="cross.chip"):
        tstep.make_fleet_train_step(
            *args, tstep.StepConfig(policy=WorstChipGate(
                inner=MultiRailClosedLoop())),
            tstep.FleetStepConfig(spec=fs, mesh=mesh1, shard_control=True,
                                  sor=sw.sor_config()))


# -- checkpoints and the trainer ------------------------------------------------------

def test_sharded_checkpoint_gathers_and_restores_in_both_packages(worlds):
    """The world's 4 blocks, gathered on save and written by rank 0, restore
    whole bit for bit in the port and in the reference; grown to 24 chips
    (`remap_sor`) and re-sliced, each rank holds its block of the remap."""
    from repro.checkpoint.ckpt import CheckpointManager as JManager
    from repro.core import sor as jsor
    from repro.core.control_plane import InGraphRailController as JCtrl
    from repro.core.hwspec import FleetSpec as JFleet
    from repro.core.policy import MultiRailClosedLoop as JPolicy
    from repro.core.power_plane import PowerPlaneState as JPlane
    ranks, _, out = worlds
    ck = os.path.join(out, "world", "ckpt_round")
    assert os.listdir(ck) == ["step_00000001"]
    got = _cat(ranks, "round")
    plane, ctrl, _ = sw.round_world()
    _, restored = CheckpointManager(ck).restore(
        {"plane": plane, "sor": ctrl.init_sor(sw.N, device="cpu")})
    mine = sw.state_arrays(restored["plane"], restored["sor"])
    jctrl = JCtrl(JPolicy(), sor=jsor.SorConfig(
        rails=jsor.ALL_RAIL_OBSERVABLES, **sw.SOR_KNOBS))
    _, jrest = JManager(ck).restore(
        {"plane": JPlane.from_fleet(JFleet.sample(
            sw.N, seed=sw.ROUND_FLEET_SEED)), "sor": jctrl.init_sor(sw.N)})
    for f in FIELDS:
        np.testing.assert_array_equal(mine[f], got[f], err_msg=f)
    np.testing.assert_array_equal(np.asarray(jrest["sor"].history.v),
                                  got["history_v"])
    np.testing.assert_array_equal(
        np.asarray(jrest["sor"].estimate.confidence), got["confidence"])
    np.testing.assert_array_equal(np.asarray(jrest["plane"].v_io),
                                  got["v_io"])
    assert int(jrest["sor"].tick) == restored["sor"].tick == sw.ROUNDS
    grown = remap_sor(restored["sor"], 24)
    assert torch.all(grown.estimate.confidence[..., sw.N:] == 0)
    for r, res in enumerate(ranks):
        sl = slice(r * 6, (r + 1) * 6)
        np.testing.assert_array_equal(res["grown_block"]["history_v"],
                                      grown.history.v[..., sl].numpy())
        np.testing.assert_array_equal(
            res["grown_block"]["confidence"],
            grown.estimate.confidence[..., sl].numpy())
    shrunk = remap_sor(restored["sor"], 8)
    np.testing.assert_array_equal(shrunk.history.v.numpy(),
                                  got["history_v"][..., :8])


def test_trainer_mesh_recovers_from_a_failure_like_the_unsharded_trainer(
        worlds, tmp_path):
    """`Trainer(mesh=)` over 4 ranks: checkpoints gathered on save, one
    injected failure, the restore re-sliced; the blocks equal the
    unsharded trainer's final state and every rank logs its losses."""
    ranks, _, out = worlds
    trainer, state = sw.trainer_run(str(tmp_path / "ckpt"))
    assert trainer.restarts == 1
    want = sw.state_arrays(state["plane"], state["sor"])
    got = _cat(ranks, "trainer")
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    losses = [r.loss for r in trainer.log.records]
    for r in ranks:
        assert r["trainer_restarts"] == 1
        assert r["trainer_losses"] == losses
    assert sorted(os.listdir(os.path.join(out, "world", "ckpt_trainer"))) \
        == sorted(os.listdir(tmp_path / "ckpt"))


# -- routed serving over the mesh ------------------------------------------------------

def test_sharded_serve_equals_the_unsharded_engine(worlds):
    """The round-robin router over 4 ranks: every rank's ledger and counters
    equal the unsharded engine's, the plane's blocks its slices bit for
    bit, the SOR estimate within SERVE_SOR_ATOL (the CPU's window sums at 4
    lanes against 16; module docstring), `summary()` gathered."""
    ranks, _, _ = worlds
    eng, ledger = sw.routed_run("roundrobin")
    want = sw.serve_arrays(eng, ledger)
    for r in ranks:
        got = r["serve_roundrobin"]
        assert got["discrete"] == want["discrete"]
        assert got["fleet_energy_j"] == want["fleet_energy_j"]
        assert got["energy_j"] == want["energy_j"]
        assert got["summary"]["n_chips"] == sw.N
        for k in ("v_core_min", "v_io_min", "fleet_energy_j",
                  "decode_sheds"):
            assert got["summary"][k] == want["summary"][k], k
    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        np.testing.assert_array_equal(
            np.concatenate([r["serve_roundrobin"]["plane_" + f]
                            for r in ranks], -1), want["plane_" + f],
            err_msg=f)
    np.testing.assert_array_equal(
        np.concatenate([r["serve_roundrobin"]["sor_confidence"]
                        for r in ranks], -1), want["sor_confidence"])
    np.testing.assert_allclose(
        np.concatenate([r["serve_roundrobin"]["sor_v_frontier"]
                        for r in ranks], -1), want["sor_v_frontier"],
        rtol=0, atol=SERVE_SOR_ATOL)


@pytest.mark.parametrize("router", ["roundrobin", "headroom"])
def test_sharded_serve_against_the_reference(worlds, router):
    """Against the reference's engine over a 4-device chips mesh, by its
    multi-device contract: the ranks agree; request ids, placement times,
    tokens and defers exact; the defer ledger, tokens, unplaced and
    unfinished exact; fleet energy within SERVE_ENERGY_RTOL[router]."""
    ranks, ref, _ = worlds
    want = ref["serve_" + router]
    assert want["sharded"]
    got = ranks[0]["serve_" + router]
    for r in ranks:
        assert r["serve_" + router]["discrete"] == got["discrete"]
    a, b = got["discrete"], want["discrete"]
    assert [(x[0], x[1], x[4], x[5]) for x in a["records"]] == \
           [(x[0], x[1], x[4], x[5]) for x in b["records"]]
    for key in ("defers_by_reason", "unplaced", "unfinished",
                "prefill_tokens", "decode_tokens"):
        assert a[key] == b[key], key
    assert sum(x[4] for x in a["records"]) == a["decode_tokens"]
    np.testing.assert_allclose(got["fleet_energy_j"], want["fleet_energy_j"],
                               rtol=SERVE_ENERGY_RTOL[router])


def test_engine_mesh_validation_errors(mesh1):
    """The reference's `test_mesh_validation_errors`, and a cross-chip
    policy refused by the sharded round the engine builds."""
    from repro_torch.serve.router import HeadroomRouter
    import test_torch_inputs as ti
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("minicpm_2b", tiny=True)
    params = registry.build(cfg).init(torch.Generator().manual_seed(0))
    fs = FleetSpec.sample(4, seed=ti.ROUTED_SEED)

    def engine(**kw):
        return ServeEngine(cfg, params, max_len=16, batch_size=1,
                           device="cpu", **kw)

    with pytest.raises(ValueError, match="needs a mesh"):
        engine(fleet=fs, router=HeadroomRouter(capacity=2),
               shard_control=True)
    with pytest.raises(ValueError, match="fleet"):
        engine(mesh=mesh1, shard_control=True)
    with pytest.raises(ValueError, match="sor"):
        engine(policy=MultiRailClosedLoop(), fleet=fs,
               router=HeadroomRouter(capacity=2), mesh=mesh1,
               shard_control=True)
    with pytest.raises(ValueError, match="cross.chip"):
        engine(controller=InGraphRailController(
            WorstChipGate(inner=MultiRailClosedLoop()), sor=sw.sor_config()),
            fleet=fs, router=HeadroomRouter(capacity=2), mesh=mesh1,
            shard_control=True)
    eng = engine(policy=MultiRailClosedLoop(), fleet=fs, mesh=mesh1)
    assert not eng.shard_control and eng._sharded_round is None


def test_serve_forced_single_rank_bit_equal(mesh1):
    """The reference's single-device pin on the whole traced run: with
    shard_control=True on a one-rank mesh the ledger and the plane equal
    the unsharded engine's bit for bit, and the sharded engine then
    refuses what needs the whole plane."""
    runs = [sw.routed_run("headroom"),
            sw.routed_run("headroom", mesh=mesh1, shard_control=True)]
    (e0, l0), (e1, l1) = runs
    assert e1.shard_control and e1._sharded_round is not None
    a, b = sw.serve_arrays(e0, l0), sw.serve_arrays(e1, l1)
    assert a["discrete"] == b["discrete"]
    assert a["fleet_energy_j"] == b["fleet_energy_j"]
    for f in ("plane_v_core", "plane_v_hbm", "plane_v_io", "plane_energy_j",
              "sor_v_frontier", "sor_confidence"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    with pytest.raises(ValueError, match="whole plane"):
        e1.generate(np.zeros((2, 4), np.int32), 2)
    with pytest.raises(ValueError, match="fused"):
        e1.serve_trace([], fused=False)
