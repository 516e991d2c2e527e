"""The port's control plane against the reference on the same numpy inputs:
the sampled fleet, per-chip accounting, the FrameHistory ring, the SOR
learner, every policy's decision and whole control rounds."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import control_plane as jcp
from repro.core import policy as jpol
from repro.core import power_plane as jpp
from repro.core import sor as jsor
from repro.core import telemetry as jtel
from repro.core.hwspec import FleetSpec as JFleet
from repro_torch.core import control_plane as tcp
from repro_torch.core import policy as tpol
from repro_torch.core import power_plane as tpp
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from repro_torch.core.hwspec import FleetSpec as TFleet
from torch_threads import one_torch_thread  # noqa: F401

# elementwise f32 on the same inputs: a few ulps apart at most
F32 = dict(rtol=1e-6, atol=1e-7)
# the EWLS fit cancels digits (uncentred voltages), so the estimate agrees
# to ~1e-5 relative; usable masks and discrete levels must match exactly
SOR = dict(rtol=1e-4, atol=1e-5)
BOUND = 5e-3
CFG = dict(ingest="frames", rails=jtel.ALL_RAIL_OBSERVABLES, capacity=16,
           refresh_every=4)


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _planes(fleet_j, fleet_t, comp=None, dv=0.0):
    jp = jpp.PowerPlaneState.from_fleet(fleet_j)
    tp = tpp.PowerPlaneState.from_fleet(fleet_t, "cpu")
    if comp is not None:
        jp = dataclasses.replace(jp, comp_level=jnp.asarray(comp, jnp.int32))
        tp = dataclasses.replace(tp, comp_level=torch.tensor(comp,
                                                             dtype=torch.int32))
    if dv:
        jp = dataclasses.replace(jp, v_io=jp.v_io - dv)
        tp = dataclasses.replace(tp, v_io=tp.v_io - dv)
    return jp, tp


def _frame(v, obs):
    """Both packages' TelemetryFrame from numpy: rail voltages `v` [3, n]
    and observables `obs` [3, n] in (VDD_CORE, VDD_HBM, VDD_IO) order; NaN
    observables are unmeasured lanes."""
    n = v.shape[1]
    out = []
    for mod, arr in ((jtel, jnp.asarray), (ttel, torch.from_numpy)):
        out.append(mod.TelemetryFrame(
            grad_error=arr(obs[2].copy()), v_core=arr(v[0].copy()),
            v_hbm=arr(v[1].copy()), v_io=arr(v[2].copy()),
            age_s=arr(np.zeros(n, np.float32)),
            extras={"straggle_rate": arr(obs[0].copy()),
                    "hbm_error_rate": arr(obs[1].copy())}))
    return out


def _observables(v, onsets, rng, nan_frac=0.1):
    obs = (BOUND * 10.0 ** np.clip(30.0 * (onsets - v), -6.0, 3.0)
           * np.exp(0.05 * rng.standard_normal(v.shape))).astype(np.float32)
    obs[rng.uniform(size=v.shape) < nan_frac] = np.nan
    return obs


@pytest.mark.parametrize("n,seed", [(8, 0), (64, 0), (64, 3)])
def test_fleet_spec_arrays_equal(n, seed):
    a, b = JFleet.sample(n, seed=seed), TFleet.sample(n, seed=seed)
    for f in ("v_core_nominal", "v_hbm_nominal", "v_io_nominal",
              "leakage_scale", "error_sensitivity"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("fleet", [True, False])
def test_account_and_observe_matches_reference(fleet):
    prof = dict(flops_per_chip=3e12, hbm_bytes_per_chip=2e10,
                ici_bytes_per_chip=4e9, grad_bytes_per_chip=3e9)
    if fleet:
        jp, tp = _planes(JFleet.sample(16, seed=2), TFleet.sample(16, seed=2),
                         comp=[i % 3 for i in range(16)], dv=0.05)
        jr = jpp.account_fleet_and_observe(jpp.StepProfile(**prof), jp,
                                           JFleet.sample(16, seed=2))
        tr = tpp.account_fleet_and_observe(tpp.StepProfile(**prof), tp,
                                           TFleet.sample(16, seed=2))
    else:
        jr = jpp.account_and_observe(jpp.StepProfile(**prof),
                                     jpp.PowerPlaneState.nominal())
        tr = tpp.account_and_observe(tpp.StepProfile(**prof),
                                     tpp.PowerPlaneState.nominal(
                                         device="cpu"))
    (jp2, jf, jm), (tp2, tf, tm) = jr, tr
    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        np.testing.assert_allclose(npy(getattr(tp2, f)),
                                   npy(getattr(jp2, f)), **F32)
    np.testing.assert_array_equal(npy(tp2.step), npy(jp2.step))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(npy(tm[k]), npy(jm[k]), err_msg=k, **F32)
    for f in ("t_step_s", "power_w", "energy_step_j", "v_nom_io"):
        if getattr(jf, f) is None:
            assert getattr(tf, f) is None
        else:
            np.testing.assert_allclose(npy(getattr(tf, f)),
                                       npy(getattr(jf, f)), **F32)


def test_frame_history_push_and_masks_exact():
    n, rng = 8, np.random.default_rng(4)
    jh = jtel.FrameHistory.create(6, n, rails=jtel.ALL_RAIL_OBSERVABLES)
    th = ttel.FrameHistory.create(6, n, rails=ttel.ALL_RAIL_OBSERVABLES,
                                  device="cpu")
    for _ in range(14):    # wraps the ring twice
        v = rng.uniform(0.6, 1.0, (3, n)).astype(np.float32)
        v[0, rng.integers(n)] = np.nan          # an unpolled VDD_CORE lane
        jf, tf = _frame(v, _observables(v, 0.7, rng))
        jh, th = jh.push(jf), th.push(tf)
        for f in ("v", "obs", "age_s", "polled", "valid"):
            np.testing.assert_array_equal(npy(getattr(th, f)),
                                          npy(getattr(jh, f)), err_msg=f)
        assert (th.cursor, th.count) == (int(jh.cursor), int(jh.count))
    np.testing.assert_allclose(npy(th.recency_weights(0.92)),
                               npy(jh.recency_weights(0.92)), **F32)


def _sweep(n, steps, rng, onsets):
    """A sawtooth voltage sweep per rail and chip, 0.2 V deep around each
    onset, with frontier-shaped observables that stay inside the fit's
    clip range; VDD_HBM's observable is never reported on chip 0 (an
    unusable lane)."""
    frames = []
    for t in range(steps):
        v = (onsets + 0.15 - 0.02 * (t % 10)
             + 0.01 * rng.standard_normal((3, n))).astype(np.float32)
        obs = _observables(v, onsets, rng, nan_frac=0.05)
        obs[1, 0] = np.nan
        frames.append(_frame(v, obs))
    return frames


def test_sor_observe_matches_reference():
    """Usable masks every round; the analog estimate once the window holds
    8 samples — with fewer, the voltage spread is so small against the
    uncentred voltages that the solve loses most of its f32 digits in both
    packages alike."""
    n, rng = 8, np.random.default_rng(7)
    onsets = rng.uniform(0.62, 0.72, (3, n)).astype(np.float32)
    jcfg, tcfg = jsor.SorConfig(**CFG), tsor.SorConfig(**CFG)
    js = jsor.init_state(jcfg, n)
    ts = tsor.init_state(tcfg, n, device="cpu")
    for t, (jf, tf) in enumerate(_sweep(n, 24, rng, onsets), start=1):
        js = jsor.observe(js, jf, jcfg, fused=True)
        ts = tsor.observe(ts, tf, tcfg)
        assert ts.tick == int(js.tick) == t
        usable = npy(js.estimate.confidence) > 0
        np.testing.assert_array_equal(npy(ts.estimate.confidence) > 0,
                                      usable)
        if t < 8:
            continue
        for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
            np.testing.assert_allclose(npy(getattr(ts.estimate, f)),
                                       npy(getattr(js.estimate, f)),
                                       err_msg=f, **SOR)
    assert usable.sum() > n and not usable.all()
    assert tsor.summary(ts.estimate, tcfg).keys() == \
        jsor.summary(js.estimate, jcfg).keys()


def _envelopes(n, rng):
    """Both packages' {rail: SafeEnvelope} from one random estimate."""
    fields = dict(intercept=rng.uniform(10, 30, (3, n)),
                  slope=-rng.uniform(20, 40, (3, n)),
                  v_frontier=rng.uniform(0.6, 0.95, (3, n)),
                  confidence=np.where(rng.uniform(size=(3, n)) < 0.3, 0.0,
                                      rng.uniform(size=(3, n))),
                  n_eff=rng.uniform(0, 10, (3, n)))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    je = jsor.SorEstimate(**{k: jnp.asarray(v) for k, v in fields.items()})
    te = tsor.SorEstimate(**{k: torch.from_numpy(v)
                             for k, v in fields.items()})
    return (jsor.rail_envelopes(je, jsor.SorConfig(**CFG)),
            tsor.rail_envelopes(te, tsor.SorConfig(**CFG)))


def _same_request(treq, jreq):
    assert treq.reason == jreq.reason
    for f in ("v_core", "v_hbm", "v_io"):
        a, b = getattr(treq, f), getattr(jreq, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(
                np.broadcast_to(npy(a), np.shape(npy(b))) if np.ndim(npy(a))
                else npy(a), npy(b), err_msg=f, **F32)
    np.testing.assert_array_equal(npy(treq.comp_level),
                                  npy(jreq.comp_level))


@pytest.mark.parametrize("name", list(jpol.POLICIES))
@pytest.mark.parametrize("with_env", [False, True])
def test_policy_decide_matches_reference(name, with_env):
    n, rng = 8, np.random.default_rng(11)
    jp, tp = _planes(JFleet.sample(n, seed=1), TFleet.sample(n, seed=1),
                     comp=[i % 3 for i in range(n)], dv=0.04)
    v = np.stack([npy(jp.v_core), npy(jp.v_hbm), npy(jp.v_io)])
    jf, tf = _frame(v, _observables(v, 0.8, rng, nan_frac=0.2))
    jf = dataclasses.replace(jf, v_nom_io=jnp.full((n,), 0.95, jnp.float32),
                             age_s=jnp.asarray(rng.uniform(0, 0.2, n),
                                               jnp.float32))
    tf = dataclasses.replace(tf, v_nom_io=torch.full((n,), 0.95),
                             age_s=torch.from_numpy(npy(jf.age_s).copy()))
    jpolicy, tpolicy = jpol.POLICIES[name], tpol.POLICIES[name]
    if with_env:
        jenv, tenv = _envelopes(n, rng)
        jreq = jpolicy.decide_env(jp, jf, jenv)
        treq = tpolicy.decide_env(tp, tf, tenv)
        jarb = jcp.arbitrate(jp, jreq, envelopes=jenv)
        tarb = tcp.arbitrate(tp, treq, envelopes=tenv)
        assert tcp.pinned_rails(tp, treq, envelope=tenv).keys() == \
            jcp.pinned_rails(jp, jreq, envelope=jenv).keys()
        for rail, mask in jcp.pinned_rails(jp, jreq, envelope=jenv).items():
            np.testing.assert_array_equal(
                tcp.pinned_rails(tp, treq, envelope=tenv)[rail], mask)
        assert tcp.worst_chip_pinned(tp, treq, envelope=tenv) == \
            jcp.worst_chip_pinned(jp, jreq, envelope=jenv)
        np.testing.assert_allclose(npy(tcp.rail_floors(tp, tenv)),
                                   npy(jcp.rail_floors(jp, jenv)), **F32)
    else:
        jreq, treq = jpolicy.decide(jp, jf), tpolicy.decide(tp, tf)
        jarb, tarb = jcp.arbitrate(jp, jreq), tcp.arbitrate(tp, treq)
    _same_request(treq, jreq)
    for f in ("v_core", "v_hbm", "v_io"):
        np.testing.assert_allclose(npy(getattr(tarb, f)),
                                   npy(getattr(jarb, f)), **F32)
    np.testing.assert_array_equal(npy(tarb.comp_level), npy(jarb.comp_level))


@pytest.mark.parametrize("make", [
    lambda pol: pol.MultiRailClosedLoop(),
    lambda pol: pol.WorstChipGate(pol.ClosedLoop()),
], ids=["multi-rail", "worst-chip-closed-loop"])
def test_control_round_matches_reference(make):
    """Whole learned control rounds (observe + refit on cadence + envelopes
    + decide + arbitrate) on frames measured at the reference plane's own
    voltages: rails allclose, compression levels exact, every round. A
    rail held at a learned floor carries the fit's agreement (SOR
    tolerance), not the elementwise one."""
    n, rng = 8, np.random.default_rng(5)
    fleet_j, fleet_t = JFleet.sample(n, seed=0), TFleet.sample(n, seed=0)
    jc = jcp.InGraphRailController(make(jpol), sor=jsor.SorConfig(**CFG))
    tc = tcp.InGraphRailController(make(tpol), sor=tsor.SorConfig(**CFG))
    jp, tp = _planes(fleet_j, fleet_t)
    js, ts = jc.init_sor(n), tc.init_sor(n, device="cpu")
    onsets = rng.uniform(0.66, 0.74, (3, n)).astype(np.float32)
    learned = False
    for _ in range(20):
        v = np.stack([npy(jp.v_core), npy(jp.v_hbm), npy(jp.v_io)])
        jf, tf = _frame(v, _observables(v, onsets, rng, nan_frac=0.05))
        jp, js, _, _ = jc.control_round(jp, jf, js)
        tp, ts, _, _ = tc.control_round(tp, tf, ts)
        for f in ("v_core", "v_hbm", "v_io"):
            np.testing.assert_allclose(npy(getattr(tp, f)),
                                       npy(getattr(jp, f)), err_msg=f, **SOR)
        np.testing.assert_array_equal(npy(tp.comp_level), npy(jp.comp_level))
        np.testing.assert_array_equal(npy(ts.estimate.confidence) > 0,
                                      npy(js.estimate.confidence) > 0)
        learned |= bool((npy(js.estimate.confidence) > 0).any())
    assert learned
