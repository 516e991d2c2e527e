"""The port's training path against the reference's on the reference's own
weights (carried over by `params_from_jax`) and the same `SyntheticLM`
batches: `forward_train` loss and gradients (tiny MiniCPM and a padded-head
variant, remat "none" and "full"), the fleet train step with in-graph SOR
learning over several steps (loss, params, AdamW state, plane, SOR
estimate, every `fleet/*` metric), the scalar step with PhaseAware and with
two microbatches, and `Trainer.run` with straggler injection, checkpoints,
resume and node-failure recovery.

The fleet step's random draws (`fleet_draws` / `jax.random`) differ between
the packages; with `telemetry_noise=0` and `straggler_prob=0` they have no
effect, so the parity runs there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import sor as jsor
from repro.core.hwspec import FleetSpec as JFleetSpec
from repro.core.policy import MultiRailClosedLoop as JMultiRail
from repro.core.policy import PhaseAware as JPhaseAware
from repro.core.power_plane import StepProfile as JProfile
from repro.core.telemetry import ALL_RAIL_OBSERVABLES as JRAILS
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import SyntheticLM as JSynth
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.optim.schedule import wsd as jwsd
from repro.train import step as jstep
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config as tget
from repro_torch.core import sor as tsor
from repro_torch.core.hwspec import FleetSpec as TFleetSpec
from repro_torch.core.policy import MultiRailClosedLoop as TMultiRail
from repro_torch.core.policy import PhaseAware as TPhaseAware
from repro_torch.core.power_plane import StepProfile as TProfile
from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES as TRAILS
from repro_torch.data.pipeline import DataConfig as TData
from repro_torch.data.pipeline import SyntheticLM as TSynth
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import wsd as twsd
from repro_torch.train import step as tstep
from repro_torch.train import trainer as ttrainer
from torch_threads import one_torch_thread  # noqa: F401

# loss: f32, the same math with sums in another order
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
# gradients and one-step states: f32, sums in another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# a few steps without a learned envelope: AdamW's normalized step
# (m / sqrt(v)) turns a last-bit gradient difference into up to ~1e-3 of
# lr where |g| is tiny, so params are held to lr-scaled absolute error
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
# twenty-odd scalar steps (peak lr 1e-3): the few-step PARAM_TOL no longer
# holds, because an element whose gradient sits at rounding level can take
# a sign-flipped normalized step. Measured between the packages: 4.3e-5
# after 20 uninterrupted steps (9 elements past PARAM_TOL), 1.0e-4 (0.1 of
# the peak lr) after the 31 steps of the fail_prob=0.15, seed=3 recovery
# run; 5.9e-7 after 3 steps. Held at 2x the largest:
LONG_PARAM_TOL = dict(rtol=1e-4, atol=2e-4)
# the plane and metrics without a learned envelope: f32 elementwise
PLANE_TOL = dict(rtol=1e-5, atol=1e-7)
# Trajectories through SOR refits. The refit at tick 2 solves from two
# samples (voltage spread ~0.04 V); its uncentred f32 solve loses ~3 of 7
# digits (denom = sw*sxx - sx*sx cancels), so the two packages' sums in
# another order give slopes ~2 % apart (measured: v_frontier 2.8e-3 V) from
# identical inputs. Blended at confidence 0.21 into the envelope floor,
# that moves the rails by up to 2.3e-4 V (measured), which then feeds the
# margin-coupled observables (0.2 % on hbm_error_rate) and the next fits;
# at 8 samples the fits still differ by 4.7e-4 in slope (of ~9 dex/V)
# and 5.2e-4 in intercept (measured), since their inputs now differ. Params
# drift by up to 3.6e-5 (measured, peak lr 1e-3). Held at ~2x the
# measured gaps:
TRAJ_PLANE_TOL = dict(rtol=0.0, atol=5e-4)       # volts
TRAJ_METRIC_TOL = dict(rtol=5e-3, atol=1e-9)
TRAJ_PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
TRAJ_SOR_TOL = dict(rtol=1e-4, atol=1e-3)        # dex, dex/V, volts

VARIANTS = {
    "minicpm_tiny": lambda get: get("minicpm_2b", tiny=True),
    # MHA padded by the head plan: 6 heads -> 8 q / 8 kv slots at tp=4
    "minicpm_pad": lambda get: dataclasses.replace(
        get("minicpm_2b", tiny=True), n_heads=6, n_kv_heads=6, head_dim=32,
        tp=4),
}


def _pair(name, variants=VARIANTS):
    jcfg = dataclasses.replace(variants[name](jget), dtype="float32")
    tcfg = dataclasses.replace(variants[name](tget), dtype="float32")
    jparams = jreg.build(jcfg).init(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, treg.params_from_jax(tcfg, tree, "cpu")


def _batches(cfg, n, seq=32, batch=4):
    jd = JSynth(JData(cfg.vocab_size, seq, batch))
    td = TSynth(TData(cfg.vocab_size, seq, batch))
    out = []
    for s in range(n):
        jb, tb = jd.jax_batch(s), td.torch_batch(s, "cpu")
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        out.append((jb, tb))
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close_trees(ttree, jtree, tol, what):
    paths = tadamw.leaf_paths(ttree)
    assert len(paths) == len(jax.tree_util.tree_leaves(jtree)), what
    for path in paths:
        t, j = tadamw.get_path(ttree, path), np.asarray(_leaf(jtree, path))
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{what}"
                                          f"{path}")
        else:
            np.testing.assert_allclose(t.detach().numpy(), j, **tol,
                                       err_msg=f"{what}{path}")


def _close_plane(tp, jp, rails_tol=PLANE_TOL):
    for f in ("v_core", "v_hbm", "v_io"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), **rails_tol,
                                   err_msg=f)
    # energy integrates the rails' power: relative, like the metrics
    np.testing.assert_allclose(tp.energy_j.numpy(), np.asarray(jp.energy_j),
                               rtol=max(rails_tol["rtol"], 1e-4), err_msg="e")
    for f in ("comp_level", "step"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def _close_metrics(tm, jm, tol=PLANE_TOL):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]),
                                   **tol, err_msg=k)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_train_loss_and_grads_match_reference(name, remat):
    jcfg, tcfg, jparams, tparams = _pair(name)
    (jb, tb), = _batches(jcfg, 1)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jb, jcfg, remat=remat),
        has_aux=True)(jparams)
    leaves = [tadamw.get_path(tparams, p) for p in tadamw.leaf_paths(tparams)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tmet = treg.build(tcfg, remat=remat).loss_fn(tparams, tb)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(tmet["ce_loss"].item(), float(jmet["ce_loss"]),
                               **LOSS_TOL)
    for path, g in zip(tadamw.leaf_paths(tparams), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(_leaf(jgrads, path)),
                                   **GRAD_TOL, err_msg=str(path))


def test_forward_train_refuses_group_remat():
    """`remat="group"` is ported (`test_group_remat_matches_reference`);
    what `forward_train` refuses is a remat mode the reference does not
    have."""
    cfg = tget("minicpm_2b", tiny=True)
    with pytest.raises(NotImplementedError, match="remat"):
        treg.build(cfg, remat="selective").loss_fn({}, {"tokens": None})
    assert tlm.REMAT_MODES == ("none", "full", "group")


# tiny configs at 4 layers in groups of 2: the dense family (Mistral-Large,
# whose CONFIG sets remat_group=8) and the moe family (its aux loss summed
# across the groups' checkpoints)
GROUP_ARCHS = ("mistral_large_123b", "qwen3_moe_30b_a3b")


@pytest.mark.parametrize("arch", GROUP_ARCHS)
def test_group_remat_matches_reference(arch, monkeypatch):
    """`remat="group"` at 4 layers and remat_group=2 against the
    reference's "group" (its outer checkpoint alone): loss, metrics and
    every gradient; against the port's "full" and "none" bit for bit (the
    CPU recomputes each op as it first ran it). One checkpoint a group:
    2 for "group", 4 for "full", none for "none"."""
    variants = {arch: lambda get: dataclasses.replace(
        get(arch, tiny=True), n_layers=4, remat_group=2)}
    jcfg, tcfg, jparams, tparams = _pair(arch, variants)
    assert tcfg.remat_group_ == jcfg.remat_group_ == 2
    (jb, tb), = _batches(jcfg, 1, seq=24, batch=2)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.forward_train(p, jb, jcfg, remat="group"),
        has_aux=True))(jparams)
    calls = []
    real = tlm.checkpoint
    monkeypatch.setattr(tlm, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    paths = tadamw.leaf_paths(tparams)
    leaves = [tadamw.get_path(tparams, p) for p in paths]
    for leaf in leaves:
        leaf.requires_grad_(True)
    runs = {}
    for remat in ("group", "full", "none"):
        calls.clear()
        loss, met = treg.build(tcfg, remat=remat).loss_fn(tparams, tb)
        runs[remat] = (loss, met, torch.autograd.grad(loss, leaves))
        assert len(calls) == {"group": 2, "full": 4, "none": 0}[remat]
    loss, met, grads = runs["group"]
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for key in ("ce_loss", "moe_aux"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   **LOSS_TOL, err_msg=key)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(_leaf(jgrads, path)),
                                   **GRAD_TOL, err_msg=str(path))
    for remat in ("full", "none"):
        assert runs[remat][0].item() == loss.item()
        for g, h in zip(grads, runs[remat][2]):
            np.testing.assert_array_equal(h.numpy(), g.numpy())


NEW_ARCHS = ("grok1_314b", "internvl2_2b", "mistral_large_123b",
             "qwen3_moe_30b_a3b", "whisper_base")


@pytest.mark.parametrize("tiny", [False, True], ids=["CONFIG", "TINY"])
def test_configs_equal_the_reference(tiny):
    """Every architecture of the reference, CONFIG and TINY, field for
    field, with its head plan and remat group."""
    from repro.configs.base import ARCH_IDS as JARCH_IDS
    from repro_torch.configs import ARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert set(NEW_ARCHS) <= set(ARCH_IDS)
    for arch in ARCH_IDS:
        tcfg, jcfg = tget(arch, tiny=tiny), jget(arch, tiny=tiny)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), arch
        assert tcfg.remat_group_ == jcfg.remat_group_, arch
        tplan, jplan = tcfg.head_plan(), jcfg.head_plan()
        for f in ("n_q", "n_kv", "n_q_pad", "n_kv_pad", "group", "kv_src",
                  "q_src"):
            assert tuple(np.atleast_1d(getattr(tplan, f))) == \
                tuple(np.atleast_1d(getattr(jplan, f))), (arch, f)
    if not tiny:
        q3 = tget("qwen3_moe_30b_a3b").head_plan()
        assert (q3.n_q_pad, q3.n_kv_pad, q3.group) == (32, 16, 2)
        assert tget("mistral_large_123b").remat_group_ == 8


def test_softmax_cross_entropy_masks_labels_like_reference():
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(-1, 11, (3, 7)).astype(np.int32)
    for z in (0.0, 1e-4):
        np.testing.assert_allclose(
            tcommon.softmax_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels),
                                          z).item(),
            float(jcommon.softmax_cross_entropy(jnp.asarray(logits),
                                                jnp.asarray(labels), z)),
            rtol=1e-6)
    none = np.full_like(labels, -1)
    assert tcommon.softmax_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(none)).item() == 0.0


# -- the fleet SOR step ---------------------------------------------------------

N_CHIPS = 8
PROFILE = dict(flops_per_chip=2e12, hbm_bytes_per_chip=8e9,
               ici_bytes_per_chip=4e9, grad_bytes_per_chip=3e9)


def _sched(pkg_wsd):
    return lambda s: pkg_wsd(s, peak_lr=1e-3, warmup_steps=2,
                             stable_steps=50, decay_steps=50)


def _fleet_pair(name, sor=True, variants=VARIANTS, **fleet_kw):
    """(jax step, torch step, jax state, torch state, sor configs) of the
    fleet SOR configuration under test (every rail learned, refit every
    2 ticks) on `N_CHIPS` chips; `name` a key of `variants`."""
    jcfg, tcfg, jparams, tparams = _pair(name, variants)
    kw = dict(hbm_error_base=1e-4, link_ber_floor=1e-3, **fleet_kw)
    jscfg = jsor.SorConfig(ingest="frames", rails=JRAILS, refresh_every=2)
    tscfg = tsor.SorConfig(ingest="frames", rails=TRAILS, refresh_every=2)
    jfs, tfs = JFleetSpec.sample(N_CHIPS, seed=0), \
        TFleetSpec.sample(N_CHIPS, seed=0)
    jraw = jstep.make_fleet_train_step(
        jreg.build(jcfg, remat="none").loss_fn, jadamw.AdamWConfig(),
        _sched(jwsd), JProfile(**PROFILE),
        jstep.StepConfig(policy=JMultiRail()),
        jstep.FleetStepConfig(spec=jfs, sor=jscfg if sor else None, **kw))
    tfn = tstep.make_fleet_train_step(
        treg.build(tcfg, remat="none").loss_fn, tadamw.AdamWConfig(),
        _sched(twsd), TProfile(**PROFILE),
        tstep.StepConfig(policy=TMultiRail()),
        tstep.FleetStepConfig(spec=tfs, sor=tscfg if sor else None, **kw))
    jplane, jef = jtrainer.initial_plane_and_ef(jparams, fleet=jfs)
    tplane, tef = ttrainer.initial_plane_and_ef(tparams, fleet=tfs)
    jstate = {"params": jparams, "opt": jadamw.init_state(
        jparams, jadamw.AdamWConfig()), "plane": jplane, "ef": jef}
    tstate = {"params": tparams, "opt": tadamw.init_state(
        tparams, tadamw.AdamWConfig()), "plane": tplane, "ef": tef}
    if sor:
        jstate["sor"] = jsor.init_state(jscfg, N_CHIPS)
        tstate["sor"] = tsor.init_state(tscfg, N_CHIPS, device="cpu")
    return (jstep.jit_train_step(jraw, donate=False), tfn, jstate, tstate,
            jcfg, (jscfg, tscfg))


def _close_estimate(t_est, j_est, *, analog: bool, tol):
    np.testing.assert_array_equal(t_est.confidence.numpy() > 0,
                                  np.asarray(j_est.confidence) > 0)
    if analog:
        for f in ("intercept", "slope", "v_frontier", "confidence",
                  "n_eff"):
            np.testing.assert_allclose(getattr(t_est, f).numpy(),
                                       np.asarray(getattr(j_est, f)),
                                       **tol, err_msg=f)


def test_fleet_sor_step_matches_reference():
    """The fleet SOR configuration on 8 chips, 10 steps (SOR refits at
    every second): loss, params, AdamW state, plane (comp_level exact) and
    every metric at each step; the SOR estimate's usable lanes at every
    step and its analog values once the window holds 8 samples."""
    jfn, tfn, js, ts, jcfg, _ = _fleet_pair("minicpm_tiny")
    ops.reset_launch_counts()
    learned = False
    for (jb, tb), i in zip(_batches(jcfg, 10), range(10)):
        jp, jo, jpl, jef, jss, jm = jfn(js["params"], js["opt"], js["plane"],
                                        js["ef"], js["sor"], jb)
        tp, to, tpl, tef, tss, tm = tfn(ts["params"], ts["opt"], ts["plane"],
                                        ts["ef"], ts["sor"], tb)
        js.update(params=jp, opt=jo, plane=jpl, ef=jef, sor=jss)
        ts.update(params=tp, opt=to, plane=tpl, ef=tef, sor=tss)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **LOSS_TOL)
        _close_plane(tpl, jpl, TRAJ_PLANE_TOL)
        _close_metrics(tm, jm, TRAJ_METRIC_TOL)
        assert tss.tick == int(jss.tick) == i + 1
        _close_estimate(tss.estimate, jss.estimate, analog=i + 1 >= 8,
                        tol=TRAJ_SOR_TOL)
        learned = learned or bool((tss.estimate.confidence > 0).any())
    _close_trees(ts["params"], js["params"], TRAJ_PARAM_TOL, "params")
    _close_trees(ts["opt"]["m"], js["opt"]["m"], TRAJ_PARAM_TOL, "m")
    _close_trees(ts["opt"]["v"], js["opt"]["v"], TRAJ_PARAM_TOL, "v")
    assert learned, "no SOR lane learned a frontier in 8 steps"
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_fleet_step_without_sor_matches_reference():
    jfn, tfn, js, ts, jcfg, _ = _fleet_pair("minicpm_pad", sor=False)
    for jb, tb in _batches(jcfg, 2):
        jp, jo, jpl, jef, jm = jfn(js["params"], js["opt"], js["plane"],
                                   js["ef"], jb)
        tp, to, tpl, tef, tm = tfn(ts["params"], ts["opt"], ts["plane"],
                                   ts["ef"], tb)
        js.update(params=jp, opt=jo, plane=jpl, ef=jef)
        ts.update(params=tp, opt=to, plane=tpl, ef=tef)
        _close_plane(tpl, jpl)
        _close_metrics(tm, jm, PARAM_TOL)
    _close_trees(tp, jp, PARAM_TOL, "params")


@pytest.mark.parametrize("microbatches,policy", [(1, "phase"), (2, "phase"),
                                                 (2, None)])
def test_scalar_step_matches_reference(microbatches, policy):
    jcfg, tcfg, jparams, tparams = _pair("minicpm_tiny")
    prof = dict(flops_per_chip=6e9, hbm_bytes_per_chip=1.4e7,
                ici_bytes_per_chip=4e6, grad_bytes_per_chip=4e6)
    jraw = jstep.make_train_step(
        jreg.build(jcfg, remat="full").loss_fn, jadamw.AdamWConfig(),
        _sched(jwsd), JProfile(**prof),
        jstep.StepConfig(microbatches=microbatches,
                         policy=JPhaseAware() if policy else None))
    tfn = tstep.make_train_step(
        treg.build(tcfg, remat="full").loss_fn, tadamw.AdamWConfig(),
        _sched(twsd), TProfile(**prof),
        tstep.StepConfig(microbatches=microbatches,
                         policy=TPhaseAware() if policy else None))
    jfn = jstep.jit_train_step(jraw, donate=False)
    jplane, jef = jtrainer.initial_plane_and_ef(jparams)
    tplane, tef = ttrainer.initial_plane_and_ef(tparams)
    jo, to = jadamw.init_state(jparams, jadamw.AdamWConfig()), \
        tadamw.init_state(tparams, tadamw.AdamWConfig())
    for jb, tb in _batches(jcfg, 3):
        jparams, jo, jplane, jef, jm = jfn(jparams, jo, jplane, jef, jb)
        tparams, to, tplane, tef, tm = tfn(tparams, to, tplane, tef, tb)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **LOSS_TOL)
        _close_plane(tplane, jplane)
        _close_metrics(tm, jm, PARAM_TOL)
    _close_trees(tparams, jparams, PARAM_TOL, "params")


def test_unported_options_raise():
    cfg = tget("minicpm_2b", tiny=True)
    api = treg.build(cfg)
    args = (api.loss_fn, tadamw.AdamWConfig(), _sched(twsd),
            TProfile(**PROFILE))
    fs = TFleetSpec.sample(2, seed=0)
    # the sharded fleet step is ported (tests/test_torch_sharding.py); its
    # knobs validate as the reference's do
    for kw, msg in ((dict(shard_control=True), "needs a mesh"),
                    (dict(mesh=object(), shard_control=True),
                     "FleetStepConfig.sor")):
        with pytest.raises(ValueError, match=msg):
            tstep.make_fleet_train_step(*args, tstep.StepConfig(),
                                        tstep.FleetStepConfig(spec=fs, **kw))


def test_fleet_draws_are_device_side_and_well_distributed():
    step = torch.tensor(7, dtype=torch.int32)
    n1, u1 = tstep.fleet_draws(0, step, 20000)
    n2, u2 = tstep.fleet_draws(0, step, 20000)
    assert torch.equal(n1, n2) and torch.equal(u1, u2)   # deterministic
    n3, u3 = tstep.fleet_draws(0, step + 1, 20000)
    n4, _ = tstep.fleet_draws(1, step, 20000)
    assert not torch.equal(u1, u3) and not torch.equal(n1, n4)
    assert 0.0 <= u1.min() and u1.max() < 1.0
    # 20000 draws: standard errors 0.002 (uniform mean), 0.007 (normal)
    assert abs(u1.mean().item() - 0.5) < 0.01
    assert abs(n1.mean().item()) < 0.03 and abs(n1.std().item() - 1) < 0.03
    assert abs((u1 < 0.05).float().mean().item() - 0.05) < 0.01


# -- Trainer ---------------------------------------------------------------------

def test_trainer_run_matches_reference(tmp_path):
    """4 fleet SOR steps through both Trainers, host-rng straggler events
    included: per-step losses, the telemetry records and summary()."""
    jfn, tfn, js, ts, jcfg, (jscfg, tscfg) = _fleet_pair("minicpm_tiny")
    faults = dict(straggler_prob=0.5, straggler_factor=4.0, seed=3)
    jt = jtrainer.Trainer(
        jfn, JSynth(JData(jcfg.vocab_size, 32, 4)),
        jtrainer.TrainerConfig(total_steps=4, ckpt_every=100,
                               ckpt_dir=str(tmp_path), async_ckpt=False,
                               faults=jtrainer.FaultConfig(**faults),
                               fleet=JFleetSpec.sample(N_CHIPS, seed=0),
                               sor=jscfg), js)
    tt = ttrainer.Trainer(
        tfn, TSynth(TData(jcfg.vocab_size, 32, 4)),
        ttrainer.TrainerConfig(total_steps=4, ckpt_every=100,
                               ckpt_dir=str(tmp_path / "port"),
                               async_ckpt=False,
                               faults=ttrainer.FaultConfig(**faults),
                               sor=tscfg, device="cpu"), ts)
    jt.run()
    tt.run()
    jrec, trec = list(jt.log.records), list(tt.log.records)
    assert [r.step for r in trec] == [r.step for r in jrec] == [0, 1, 2, 3]
    np.testing.assert_allclose([r.loss for r in trec],
                               [r.loss for r in jrec], **LOSS_TOL)
    for a, b in zip(trec, jrec):
        assert a.comp_level == b.comp_level and a.n_chips == b.n_chips
        assert set(a.per_chip) == set(b.per_chip)
        assert set(a.extras) == set(b.extras) and set(a.fleet) == set(b.fleet)
        for k in a.fleet:
            np.testing.assert_allclose(a.fleet[k], b.fleet[k],
                                       **TRAJ_METRIC_TOL, err_msg=k)
    js_, ts_ = jt.summary(), tt.summary()
    assert set(ts_) == set(js_)
    assert ts_["straggler_events"] == js_["straggler_events"] > 0
    # both write the last step
    assert ts_["ckpt_writes"] == js_["ckpt_writes"] == 1
    for k in ("steps", "energy_j", "mean_power_w", "time_s",
              "fleet_energy_j", "restarts", "host_actuations", "n_chips"):
        np.testing.assert_allclose(ts_[k], js_[k], **TRAJ_METRIC_TOL,
                                   err_msg=k)
    for k in js_["fleet_last"]:
        np.testing.assert_allclose(ts_["fleet_last"][k], js_["fleet_last"][k],
                                   **TRAJ_METRIC_TOL, err_msg=k)
    assert set(ts_["sor"]) == set(js_["sor"])
    for k in js_["sor"]:
        np.testing.assert_allclose(ts_["sor"][k], js_["sor"][k],
                                   **TRAJ_SOR_TOL, err_msg=k)


def test_launcher_tiny_cpu_trains(capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", "minicpm_2b", "--tiny", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "minicpm-tiny" in out and "'steps': 3" in out


# -- checkpoints, resume and recovery --------------------------------------------

def _leaf_bits(tree):
    """Every leaf of a port state tree as bytes, in checkpoint order."""
    from repro_torch.checkpoint import ckpt as tckpt
    out = {}

    def take(path, x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            x = x.contiguous().view(torch.uint8) if x.dim() else \
                x.reshape(1).view(torch.uint8)
            out[tckpt._path_key(path)] = bytes(x.numpy())
        else:
            out[tckpt._path_key(path)] = x

    tckpt._map_with_path(take, tree)
    return out


def test_trainer_resumes_bit_for_bit(tmp_path):
    """The fleet SOR step through the port's Trainer: 3 steps, a checkpoint,
    then a Trainer on another state restores it and runs to 6; its losses
    and its final state (params, moments, plane, ef, SOR ring and tick)
    are those of 6 steps run straight, bit for bit."""
    fs = TFleetSpec.sample(N_CHIPS, seed=0)

    def trainer(steps, where, perturb=False):
        _, tfn, _, ts, jcfg, (_, tscfg) = _fleet_pair("minicpm_tiny")
        if perturb:
            with torch.no_grad():
                for p in tadamw.leaf_paths(ts["params"]):
                    tadamw.get_path(ts["params"], p).add_(0.5)
        return ttrainer.Trainer(
            tfn, TSynth(TData(jcfg.vocab_size, 32, 4)),
            ttrainer.TrainerConfig(total_steps=steps, ckpt_every=3,
                                   ckpt_dir=str(tmp_path / where),
                                   fleet=fs, sor=tscfg, device="cpu"), ts)

    straight = trainer(6, "a")
    straight.run()
    first = trainer(3, "b")
    first.run()
    assert first.ckpt_writes == 1 and first.ckpt.list_steps() == [3]
    resumed = trainer(6, "b", perturb=True)
    assert resumed.maybe_restore() and resumed.start_step == 3
    resumed.run()
    assert [r.step for r in resumed.log.records] == [3, 4, 5]
    assert [r.loss for r in resumed.log.records] == \
        [r.loss for r in straight.log.records][3:]
    assert resumed.state["sor"].tick == straight.state["sor"].tick == 6
    assert _leaf_bits(resumed.state) == _leaf_bits(straight.state)
    assert resumed.summary()["ckpt_writes"] == 1    # step 6
    assert trainer(6, "empty").maybe_restore() is False


def _scalar_pair(tmp_path, faults, ckpt_every, port_ckpt=True, steps=20):
    """The reference's and the port's Trainer over the scalar step (tiny
    MiniCPM, the same weights and batches) with the same FaultConfig."""
    jcfg, tcfg, jparams, tparams = _pair("minicpm_tiny")
    prof = dict(flops_per_chip=6e9, hbm_bytes_per_chip=1.4e7,
                ici_bytes_per_chip=4e6, grad_bytes_per_chip=4e6)
    jfn = jstep.jit_train_step(jstep.make_train_step(
        jreg.build(jcfg).loss_fn, jadamw.AdamWConfig(), _sched(jwsd),
        JProfile(**prof), jstep.StepConfig()), donate=False)
    tfn = tstep.make_train_step(
        treg.build(tcfg).loss_fn, tadamw.AdamWConfig(), _sched(twsd),
        TProfile(**prof), tstep.StepConfig())
    jplane, jef = jtrainer.initial_plane_and_ef(jparams)
    tplane, tef = ttrainer.initial_plane_and_ef(tparams)
    jt = jtrainer.Trainer(
        jfn, JSynth(JData(jcfg.vocab_size, 32, 4)),
        jtrainer.TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                               ckpt_dir=str(tmp_path / "ref"),
                               async_ckpt=False,
                               faults=jtrainer.FaultConfig(**faults)),
        {"params": jparams, "opt": jadamw.init_state(
            jparams, jadamw.AdamWConfig()), "plane": jplane, "ef": jef})
    tt = ttrainer.Trainer(
        tfn, TSynth(TData(jcfg.vocab_size, 32, 4)),
        ttrainer.TrainerConfig(
            total_steps=steps, ckpt_every=ckpt_every,
            ckpt_dir=str(tmp_path / "port") if port_ckpt else None,
            faults=ttrainer.FaultConfig(**faults), device="cpu"),
        {"params": tparams, "opt": tadamw.init_state(
            tparams, tadamw.AdamWConfig()), "plane": tplane, "ef": tef})
    return jt, tt


def _same_run(jt, tt):
    jrec, trec = list(jt.log.records), list(tt.log.records)
    assert [r.step for r in trec] == [r.step for r in jrec]
    np.testing.assert_allclose([r.loss for r in trec],
                               [r.loss for r in jrec], **LOSS_TOL)
    assert tt.restarts == jt.restarts
    assert tt.summary()["restarts"] == jt.summary()["restarts"]
    _close_trees(tt.state["params"], jt.state["params"], LONG_PARAM_TOL,
                 "params")


def test_trainer_recovers_from_failures_like_reference(tmp_path):
    """FaultConfig(fail_prob=0.15, seed=3) over 20 steps with a checkpoint
    every 5 (the reference's recovery test): the same restarts, the same
    logged steps (a failed span's steps again after the restore), losses
    within LOSS_TOL and params within LONG_PARAM_TOL; the same checkpoint
    writes."""
    jt, tt = _scalar_pair(tmp_path, dict(fail_prob=0.15, seed=3), 5)
    jt.run()
    tt.run()
    steps = [r.step for r in tt.log.records]
    assert tt.restarts >= 1 and len(steps) > len(set(steps)) and \
        steps[-1] == 19
    _same_run(jt, tt)
    assert tt.ckpt_writes == jt.ckpt_writes
    assert tt.ckpt.list_steps() == jt.ckpt.list_steps()


def test_trainer_failure_without_checkpoint_restarts_the_span(tmp_path):
    """With no checkpoint to go back to, both trainers restart the span at
    the step it began with the state as it stands (the reference's
    recovery without a checkpoint), so the log repeats those steps."""
    jt, tt = _scalar_pair(tmp_path, dict(fail_prob=0.2, seed=1), 100,
                          port_ckpt=False, steps=8)
    jt.run()
    tt.run()
    steps = [r.step for r in tt.log.records]
    assert tt.restarts >= 1 and steps.count(0) == tt.restarts + 1
    _same_run(jt, tt)
    assert tt.ckpt is None and tt.ckpt_writes == 0


def test_trainer_remaps_restored_plane_onto_new_fleet(tmp_path):
    """An elastic restart onto a fleet of another size: the trainer
    restores the old [3] plane and its SorState and remaps both onto its
    own FleetSpec."""
    from repro_torch.checkpoint import ckpt as tckpt
    from repro_torch.core.power_plane import PowerPlaneState as TPlane
    fs_old = TFleetSpec.sample(3, seed=1)
    plane_old = dataclasses.replace(TPlane.from_fleet(fs_old, "cpu"),
                                    v_io=torch.tensor([0.81, 0.82, 0.83]))
    scfg = tsor.SorConfig(ingest="frames", rails=TRAILS)
    sor_old = tsor.init_state(scfg, 3, device="cpu")
    sor_old = dataclasses.replace(sor_old, estimate=dataclasses.replace(
        sor_old.estimate, confidence=torch.full((3, 3), 0.5)), tick=4)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(5, {"plane": plane_old, "params": {"w": torch.zeros(2)},
                 "opt": {"step": torch.tensor(5, dtype=torch.int32)},
                 "ef": {}, "sor": sor_old}, fleet=fs_old)
    fs_new = TFleetSpec.sample(5, seed=2)
    tr = ttrainer.Trainer(
        None, None,
        ttrainer.TrainerConfig(total_steps=10, ckpt_dir=str(tmp_path),
                               fleet=fs_new, sor=scfg, device="cpu"),
        {"plane": TPlane.from_fleet(fs_new, "cpu"),
         "params": {"w": torch.zeros(2)},
         "opt": {"step": torch.tensor(0, dtype=torch.int32)}, "ef": {},
         "sor": tsor.init_state(scfg, 5, device="cpu")})
    assert tr.maybe_restore() and tr.start_step == 5
    plane = tr.state["plane"]
    assert plane.n_chips == 5
    np.testing.assert_allclose(plane.v_io[:3].numpy(), [0.81, 0.82, 0.83],
                               rtol=1e-6)
    np.testing.assert_array_equal(plane.v_io[3:].numpy(),
                                  fs_new.v_io_nominal[3:])
    sor = tr.state["sor"]
    assert sor.history.chip_shape == (5,) and sor.tick == 4
    assert (sor.estimate.confidence[:, :3] == 0.5).all()
    assert (sor.estimate.confidence[:, 3:] == 0).all()
