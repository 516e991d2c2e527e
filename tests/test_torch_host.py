"""The host (software-path) control plane of the port against the reference
on the same numpy inputs: the copied PMBus simulator (codecs, PowerManager,
settling detection, the multi-segment fleet bus with polling), the host
controllers on scalar and fleet planes, the split SOR fit (K7's plain
version, then the solve), host-path `ServeEngine.generate` and the trainer's
host path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jget
from repro.core import codecs as jcodecs
from repro.core import control_plane as jcp
from repro.core import policy as jpol
from repro.core import power_plane as jpp
from repro.core import settling as jset
from repro.core import sor as jsor
from repro.core import telemetry as jtel
from repro.core.fleet import FleetPowerManager as JFleetPM
from repro.core.hwspec import FleetSpec as JFleet
from repro.core.power_manager import PowerManager as JPM
from repro.models import registry as jreg
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import codecs as tcodecs
from repro_torch.core import control_plane as tcp
from repro_torch.core import policy as tpol
from repro_torch.core import power_plane as tpp
from repro_torch.core import settling as tset
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from repro_torch.core.fleet import FleetPowerManager as TFleetPM
from repro_torch.core.hwspec import FleetSpec as TFleet
from repro_torch.core.power_manager import PowerManager as TPM
from repro_torch.models import registry as treg
from repro_torch.serve.engine import ServeEngine as TEngine

# The simulator is the same Python on the same inputs, and the host
# controllers' decisions are elementwise f32 on equal observations, so
# achieved rails (LINEAR16-quantized), bus times and counters match exactly
# wherever no lane learns a frontier.
# The split EWLS fit sums the window in another order (XLA vs torch) and
# its uncentred solve cancels digits, so learned estimates agree to ~1e-5
# relative (the reference's own split fit drifts by up to 3.5e-5 on this
# jax); compared once a window holds >= 8 samples. A window whose voltages
# span little cancels more: see test_split_fit_on_the_frontier_worlds_last_
# window.
SOR = dict(rtol=1e-4, atol=1e-5)
# Learning closed loops: each package's envelope feeds its own next
# decision, so a last-bit difference in a fitted floor can move a setpoint
# across a LINEAR16 step (2^-12 V = 0.244 mV), and the trajectories part by
# a few steps: achieved rails within 4 steps (3 measured), learned floors
# within 0.5 mV (0.18 mV measured)
RAIL_ATOL = 4 * 2.0 ** -12
FLOOR_ATOL = 5e-4
# the trainer's host path: see test_trainer_host_path_matches_reference
TRAIN_HOST_RTOL = 1e-6
BOUND = 5e-3


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- codecs ----------------------------------------------------------------------

def test_linear16_grid_equal():
    volts = np.linspace(0.0, 16.5, 4001)
    for exp in (-12, -9, -13):
        words = [tcodecs.linear16_encode(float(v), exp) for v in volts]
        assert words == [jcodecs.linear16_encode(float(v), exp)
                         for v in volts]
        assert [tcodecs.linear16_decode(w, exp) for w in words] == \
            [jcodecs.linear16_decode(w, exp) for w in words]
    assert tcodecs.linear16_resolution() == jcodecs.linear16_resolution() \
        == 2.0 ** -12


@settings(max_examples=200, deadline=None)
@given(st.floats(min_value=-1e6, max_value=1e6, allow_nan=False))
def test_linear11_draws_equal(value):
    def both(fn, *args):
        out = []
        for mod in (tcodecs, jcodecs):
            try:
                out.append(("ok", getattr(mod, fn)(*args)))
            except ValueError:
                out.append(("raises", None))
        return out

    t, j = both("linear11_encode", value)
    assert t == j
    if t[0] == "ok":
        assert tcodecs.linear11_decode(t[1]) == \
            jcodecs.linear11_decode(j[1])


@settings(max_examples=200, deadline=None)
@given(st.floats(min_value=0.0, max_value=20.0, allow_nan=False),
       st.integers(min_value=-15, max_value=-1))
def test_linear16_draws_equal(volts, exp):
    w = tcodecs.linear16_encode(volts, exp)
    assert w == jcodecs.linear16_encode(volts, exp)
    assert tcodecs.linear16_decode(w, exp) == jcodecs.linear16_decode(w, exp)


# -- PowerManager and settling ---------------------------------------------------

@pytest.mark.parametrize("path", ["hw", "sw"])
@pytest.mark.parametrize("clock_hz", [100_000, 400_000])
def test_power_manager_transition_equal(path, clock_hz):
    pms = [mod(path=path, clock_hz=clock_hz, seed=3) for mod in (TPM, JPM)]
    for pm in pms:
        pm.set_voltage(0, 0.9)
    assert pms[0].get_voltage(0) == pms[1].get_voltage(0)
    # a window long enough for the slowest path to sample the settled rail
    tr = [pm.measure_transition(0, 0.5, duration_s=20e-3) for pm in pms]
    np.testing.assert_array_equal(tr[0].times, tr[1].times)
    np.testing.assert_array_equal(tr[0].volts, tr[1].volts)
    assert tr[0].command_time_s == tr[1].command_time_s
    a, b = (t.end_to_end_latency_s() for t in tr)
    assert a == b or (np.isnan(a) and np.isnan(b))
    assert pms[0].stats() == pms[1].stats()


@pytest.mark.parametrize("seed", range(4))
def test_settling_time_matches_reference(seed):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(1e-4, 3e-4, 120))
    tau = rng.uniform(2e-4, 8e-4)
    v = 0.5 + 0.5 * np.exp(-(t - t[0]) / tau) \
        + 1e-3 * rng.standard_normal(t.size)
    for n, band in ((8, 1.0), (4, 0.5), (16, 2.0)):
        got = tset.settling_time(t, v, n=n, band_pct=band)
        want = jset.settling_time(t, v, n=n, band_pct=band)
        assert (got.settled, got.t_s_index) == (want.settled, want.t_s_index)
        assert got.settling_time_s == want.settling_time_s or \
            (np.isnan(got.settling_time_s) and np.isnan(want.settling_time_s))
        # f32 mean of the last n samples: numpy's and XLA's summation order
        np.testing.assert_allclose(got.v_avg, want.v_avg, rtol=1e-6)
        np.testing.assert_allclose(got.band_v, want.band_v, rtol=1e-6)
        dev = tset.settling_time_torch(torch.from_numpy(t),
                                       torch.from_numpy(v.astype(np.float32)),
                                       n=n, band_pct=band)
        ref = jset.settling_time_jax(jnp.asarray(t, jnp.float32),
                                     jnp.asarray(v, jnp.float32), n=n,
                                     band_pct=band)
        np.testing.assert_allclose(float(dev), float(ref), rtol=1e-6)


def test_settling_time_never_settles():
    t = np.arange(40) * 1e-4
    v = np.where(np.arange(40) % 2, 1.0, 0.5)
    got = tset.settling_time(t, v, n=8)
    assert not got.settled and got.t_s_index == -1
    assert np.isnan(float(tset.settling_time_torch(
        torch.from_numpy(t), torch.from_numpy(v.astype(np.float32)))))


# -- the fleet bus ---------------------------------------------------------------

def _fleet_frames_equal(tf, jf):
    for f in ("v_core", "v_hbm", "v_io", "age_s"):
        a, b = getattr(tf, f), getattr(jf, f)
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(npy(a), np.asarray(b), err_msg=f)
    assert tf.provenance.value == jf.provenance.value


def test_fleet_setpoints_and_polling_equal():
    n, rng = 8, np.random.default_rng(5)
    fleets = [mod(n, seed=2) for mod in (TFleetPM, JFleetPM)]
    for f in fleets:
        f.start_polling(interval_s=1e-3)
    for r in range(6):
        sp = [{0: float(rng.uniform(0.62, 0.95)),
               2: float(rng.uniform(0.66, 1.0))} for _ in range(n)]
        if r == 3:
            sp[1][1] = 5.0                # outside the envelope: refused
        outs = [f.apply_setpoints(sp, settle_band_frac=0.005)
                for f in fleets]
        assert outs[0][0] == outs[1][0]
        assert dataclasses.asdict(outs[0][1]) == dataclasses.asdict(outs[1][1])
        for f in fleets:
            f.idle(2.5e-3)
        _fleet_frames_equal(fleets[0].poll_frame(), fleets[1].poll_frame())
        assert fleets[0].stats() == fleets[1].stats()
    ge = {"VDD_IO": 1e-3, "VDD_CORE": 2e-3}
    tf, jf = (f.poll_frame(grad_error=ge) for f in fleets)
    assert tf.grad_error == jf.grad_error and tf.extras == jf.extras
    np.testing.assert_array_equal(fleets[0].readback(), fleets[1].readback())


def test_poll_frame_marks_unpolled_lanes_nan():
    f = TFleetPM(3, seed=0)
    fr = f.poll_frame()
    assert torch.isnan(fr.v_io).all() and torch.isnan(fr.age_s).all()
    assert fr.provenance is ttel.Provenance.POLLED


# -- host controllers ------------------------------------------------------------

def _err(v, onset):
    """The reference tests' frontier world: an observable at the bound at
    `onset` volts, 30 dex/V steep, in f32 from the plane's voltage."""
    v = np.asarray(v, np.float32)
    return (BOUND * 10.0 ** np.clip(30.0 * (onset - v), -6.0, 3.0)).astype(
        np.float32)


def _controllers(mode, n_chips):
    """Both packages' HostRailController for `mode`."""
    out = []
    for pol, sor, tel in ((tpol, tsor, ttel), (jpol, jsor, jtel)):
        sor_cfg = None
        if mode.get("sor"):
            sor_cfg = sor.SorConfig(ingest="polled",
                                    rails=tel.ALL_RAIL_OBSERVABLES,
                                    refresh_every=4)
        policy = pol.MultiRailClosedLoop() if mode.get("multirail") \
            else pol.PhaseAware()
        mod = tcp if pol is tpol else jcp
        out.append(mod.HostRailController(
            policy, n_chips=n_chips, decide_from=mode["decide_from"],
            sor=sor_cfg, seed=1))
    return out


def _planes(n_chips):
    if n_chips == 1:
        return (tpp.PowerPlaneState.nominal(device="cpu"),
                jpp.PowerPlaneState.nominal())
    return (tpp.PowerPlaneState.from_fleet(TFleet.sample(n_chips, seed=0),
                                           "cpu"),
            jpp.PowerPlaneState.from_fleet(JFleet.sample(n_chips, seed=0)))


MODES = {
    "telemetry": dict(decide_from="telemetry"),
    "poll": dict(decide_from="poll"),
    "poll_sor": dict(decide_from="poll", sor=True, multirail=True),
    "telemetry_sor": dict(decide_from="telemetry", sor=True, multirail=True),
}


@pytest.mark.parametrize("n_chips", [1, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_host_rail_controller_matches_reference(mode, n_chips):
    """Achieved rails, stats() and the SOR summary, round by round. The
    serve-like world reports only the VDD_IO observable, and its error never
    changes with the voltage here, so no lane learns: everything is
    exact."""
    tc, jc = _controllers(MODES[mode], n_chips)
    if MODES[mode]["decide_from"] == "poll" or MODES[mode].get("sor"):
        tc.enable_polling()
        jc.enable_polling()
    tp, jp = _planes(n_chips)
    for _ in range(9):
        tc.fleet.idle(2e-3)
        jc.fleet.idle(2e-3)
        tele = np.full(max(n_chips, 1), 1e-4, np.float32)
        tm = {"grad_error": torch.from_numpy(tele) if n_chips > 1
              else float(tele[0]), "t_comp_s": 2e-3, "t_mem_s": 1e-3,
              "t_coll_s": 5e-4}
        jm = {**tm, "grad_error": jnp.asarray(tele) if n_chips > 1
              else float(tele[0])}
        tp, jp = tc.control_step(tp, tm), jc.control_step(jp, jm)
        for f in ("v_core", "v_hbm", "v_io"):
            a, b = npy(getattr(tp, f)), np.asarray(getattr(jp, f))
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(npy(tp.comp_level),
                                      np.asarray(jp.comp_level))
        assert dataclasses.asdict(tc.stats()) == \
            dataclasses.asdict(jc.stats())
    if MODES[mode].get("sor"):
        ts, js = tc.sor_summary(), jc.sor_summary()
        assert ts == js and ts["chips_learned"] == 0
        assert tc.sor_state.tick == int(jc.sor_state.tick) == 9
    assert tc.readback() == jc.readback()
    # one read of the plane per round to actuate, one more to fill the
    # polled frame's unsampled lanes
    per_round = 2 if MODES[mode]["decide_from"] == "poll" else 1
    assert tc.plane_reads == 9 * per_round


def test_host_deadband_and_poll_relax_match_reference():
    """A learning fleet world with the deadband scheduler and poll
    back-pressure: skipped writes, relaxed polls and rails against the
    reference."""
    n = 4
    ctrl = []
    for pol, sor, tel, mod in ((tpol, tsor, ttel, tcp),
                               (jpol, jsor, jtel, jcp)):
        ctrl.append(mod.HostRailController(
            pol.ClosedLoop(v_io_floor=0.70), n_chips=n,
            settle_band_frac=0.001, decide_from="poll",
            sor=sor.SorConfig(capacity=24, refresh_every=2, decay=0.96,
                              guard_v=0.004, max_extension_v=0.12),
            deadband_v=0.02, poll_relax=2.0))
    tc, jc = ctrl
    for c in ctrl:
        c.enable_polling(interval_s=1e-3)
    tp, jp = _planes(n)
    onsets = np.linspace(0.76, 0.80, n).astype(np.float32)
    for _ in range(40):
        tc.fleet.idle(5e-3)
        jc.fleet.idle(5e-3)
        te, je = _err(npy(tp.v_io), onsets), _err(np.asarray(jp.v_io), onsets)
        tp = tc.control_step(tp, {"grad_error": torch.from_numpy(te)})
        jp = jc.control_step(jp, {"grad_error": jnp.asarray(je)})
    ts, js = tc.stats(), jc.stats()
    assert ts.skipped_actuations > 0 and ts.relaxed_polls > 0
    assert ts.decisions == js.decisions == 40
    assert ts.poll_decisions == js.poll_decisions
    # the learned floors steer both loops: counts within a few lanes
    for f in ("skipped_actuations", "relaxed_polls", "actuations", "polls"):
        a, b = getattr(ts, f), getattr(js, f)
        assert abs(a - b) <= max(3, 0.1 * b), (f, a, b)
    np.testing.assert_allclose(npy(tp.v_io), np.asarray(jp.v_io),
                               atol=RAIL_ATOL)
    s_t, s_j = tc.sor_summary(), jc.sor_summary()
    assert s_t["chips_learned"] == s_j["chips_learned"] == n
    np.testing.assert_allclose(s_t["floor_mean_v"], s_j["floor_mean_v"],
                               atol=FLOOR_ATOL)


def _learn(mod, pol, sor, tel, pp, multirail, n_chips, arr, fleet):
    cfg = sor.SorConfig(capacity=24, refresh_every=2, decay=0.96,
                        guard_v=0.004, max_extension_v=0.12,
                        **({"rails": tel.ALL_RAIL_OBSERVABLES}
                           if multirail else {}))
    policy = (pol.MultiRailClosedLoop(floors={"VDD_CORE": 0.70,
                                              "VDD_HBM": 1.00,
                                              "VDD_IO": 0.70})
              if multirail else pol.ClosedLoop(v_io_floor=0.70))
    hc = mod.HostRailController(policy, n_chips=n_chips,
                                settle_band_frac=0.001, decide_from="poll",
                                sor=cfg)
    hc.enable_polling(interval_s=1e-3)
    if n_chips == 1:
        plane = (pp.PowerPlaneState.nominal(device="cpu") if mod is tcp
                 else pp.PowerPlaneState.nominal())
    else:
        plane = (pp.PowerPlaneState.from_fleet(fleet, "cpu") if mod is tcp
                 else pp.PowerPlaneState.from_fleet(fleet))
    for _ in range(40):
        hc.fleet.idle(5e-3)
        tele = {"grad_error": arr(np.asarray(_err(npy(plane.v_io), 0.78)))}
        if multirail:
            tele["straggle_rate"] = arr(np.asarray(
                _err(npy(plane.v_core), 0.72)))
        plane = hc.control_step(plane, tele)
    return hc, plane


@pytest.mark.parametrize("multirail", [False, True])
@pytest.mark.parametrize("n_chips", [1, 8])
def test_host_controller_learns_like_reference(multirail, n_chips):
    """The learning worlds of tests/test_sor.py::
    test_host_controller_learns_from_polls (one rail) and
    tests/test_sor_multirail.py::test_host_polled_ingest_multirail (three
    rails), on a scalar and an 8-chip plane: the same lanes learn, the same
    floor bands hold, the floors agree within FLOOR_ATOL and the rails
    within RAIL_ATOL."""
    t_hc, t_plane = _learn(tcp, tpol, tsor, ttel, tpp, multirail, n_chips,
                           torch.from_numpy, TFleet.sample(n_chips, seed=0))
    j_hc, j_plane = _learn(jcp, jpol, jsor, jtel, jpp, multirail, n_chips,
                           jnp.asarray, JFleet.sample(n_chips, seed=0))
    ts, js = t_hc.sor_summary(), j_hc.sor_summary()
    assert ts.keys() == js.keys()
    if multirail:
        for rail, band in (("VDD_IO", (0.775, 0.80)),
                           ("VDD_CORE", (0.715, 0.74))):
            assert ts[f"{rail}/chips_learned"] == \
                js[f"{rail}/chips_learned"] == n_chips
            for s in (ts, js):
                assert band[0] < s[f"{rail}/floor_mean_v"] < band[1]
            np.testing.assert_allclose(ts[f"{rail}/floor_mean_v"],
                                       js[f"{rail}/floor_mean_v"],
                                       atol=FLOOR_ATOL)
        assert ts["VDD_HBM/chips_learned"] == js["VDD_HBM/chips_learned"] \
            == 0
        assert float(t_hc.last_envelope["VDD_HBM"].floor(1.00).max()) == 1.00
    else:
        assert ts["chips_learned"] == js["chips_learned"] == n_chips
        for s in (ts, js):
            assert 0.775 < s["floor_mean_v"] < 0.80
        np.testing.assert_allclose(ts["floor_mean_v"], js["floor_mean_v"],
                                   atol=FLOOR_ATOL)
        assert float(t_hc.last_envelope["VDD_IO"].floor(0.70).min()) > 0.70
    np.testing.assert_allclose(npy(t_plane.v_io), np.asarray(j_plane.v_io),
                               atol=RAIL_ATOL)


def test_host_decision_controller_and_as_controller():
    pol = tpol.PhaseAware()
    hd = tcp.as_controller(pol, host=True)
    assert isinstance(hd, tcp.HostDecisionController)
    assert isinstance(tcp.as_controller(pol), tcp.InGraphRailController)
    tp = tpp.PowerPlaneState.nominal(device="cpu")
    jp = jpp.PowerPlaneState.nominal()
    jd = jcp.as_controller(jpol.PhaseAware(), host=True)
    m = {"t_comp_s": 2e-3, "t_mem_s": 1e-3, "t_coll_s": 5e-4}
    tp, jp = hd.control_step(tp, m), jd.control_step(jp, m)
    for f in ("v_core", "v_hbm", "v_io"):
        np.testing.assert_array_equal(npy(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)))
    assert dataclasses.asdict(hd.stats()) == dataclasses.asdict(jd.stats())
    assert dataclasses.asdict(tcp.InGraphRailController(pol).stats()) == \
        dataclasses.asdict(tcp.ControlPlaneStats())


def test_host_power_controller_applies_like_reference():
    t, j = tcp.HostPowerController(), jcp.HostPowerController()
    tp = dataclasses.replace(tpp.PowerPlaneState.nominal(device="cpu"),
                             v_io=torch.tensor(0.8123, dtype=torch.float32))
    jp = dataclasses.replace(jpp.PowerPlaneState.nominal(),
                             v_io=jnp.float32(0.8123))
    tp, jp = t.apply(tp), j.apply(jp)
    assert float(tp.v_io) == float(jp.v_io)
    assert t.actuation_seconds == j.actuation_seconds > 0


def test_host_controller_refusals():
    with pytest.raises(ValueError, match="decide_from"):
        tcp.HostRailController(tpol.PhaseAware(), decide_from="oracle")
    with pytest.raises(ValueError, match="needs a policy"):
        tcp.HostRailController(None, sor=tsor.SorConfig())
    with pytest.raises(ValueError, match="poll_relax"):
        tcp.HostRailController(tpol.PhaseAware(), poll_relax=0.5)
    hc = tcp.HostRailController(tpol.PhaseAware(), n_chips=2)
    with pytest.raises(ValueError, match="board"):
        hc.actuate(tpp.PowerPlaneState.from_fleet(TFleet.sample(3, seed=0),
                                                  "cpu"))


# -- the split fit ---------------------------------------------------------------

def _histories(n, steps, seed):
    """Both packages' three-rail FrameHistory after `steps` pushes of a
    voltage sweep with frontier-shaped observables (some NaN lanes)."""
    rng = np.random.default_rng(seed)
    onsets = rng.uniform(0.62, 0.72, (3, n)).astype(np.float32)
    jh = jtel.FrameHistory.create(16, n, rails=jtel.ALL_RAIL_OBSERVABLES)
    th = ttel.FrameHistory.create(16, n, rails=ttel.ALL_RAIL_OBSERVABLES,
                                  device="cpu")
    for t in range(steps):
        v = (onsets + 0.15 - 0.02 * (t % 10)
             + 0.01 * rng.standard_normal((3, n))).astype(np.float32)
        obs = (BOUND * 10.0 ** np.clip(30.0 * (onsets - v), -6.0, 3.0)
               * np.exp(0.05 * rng.standard_normal(v.shape))).astype(
                   np.float32)
        obs[rng.uniform(size=v.shape) < 0.05] = np.nan
        obs[1, ::2] = BOUND              # flat: these lanes never learn
        frames = []
        for mod, arr in ((jtel, jnp.asarray), (ttel, torch.from_numpy)):
            frames.append(mod.TelemetryFrame(
                grad_error=arr(obs[2].copy()), v_core=arr(v[0].copy()),
                v_hbm=arr(v[1].copy()), v_io=arr(v[2].copy()),
                age_s=arr(np.zeros(n, np.float32)),
                extras={"straggle_rate": arr(obs[0].copy()),
                        "hbm_error_rate": arr(obs[1].copy())}))
        jh, th = jh.push(frames[0]), th.push(frames[1])
    return jh, th


@pytest.mark.parametrize("n,steps", [(8, 8), (64, 16), (5, 23)])
def test_split_fit_matches_reference_and_fused(n, steps):
    jh, th = _histories(n, steps, seed=n + steps)
    kw = dict(rails=jtel.ALL_RAIL_OBSERVABLES, capacity=16)
    jcfg = jsor.SorConfig(**kw)
    tcfg = tsor.SorConfig(**{**kw, "rails": ttel.ALL_RAIL_OBSERVABLES})
    split = tsor.fit_history(th, tcfg, fused=False)
    fused = tsor.fit_history(th, tcfg, fused=True)
    want = jsor.fit_history(jh, jcfg, fused=False)
    usable = np.asarray(want.confidence) > 0
    assert usable.any() and not usable.all()
    np.testing.assert_array_equal(npy(split.confidence) > 0, usable)
    for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
        # on the CPU both paths sum with `ref.sor_accumulate_reference`
        # and solve in the same op order: bit-equal
        assert torch.equal(getattr(split, f), getattr(fused, f)), f
        np.testing.assert_allclose(npy(getattr(split, f)),
                                   np.asarray(getattr(want, f)), err_msg=f,
                                   **SOR)


def _solve_rtol(x, y, w):
    """Per-lane first-order bound on the relative change of the uncentred
    EWLS solve's slope and intercept when every window term moves by one
    rounding and each of the five sums by one rounding per row (another
    summation order, a multiply contracted into the add, a last-bit
    different log10), computed in f64 from the window [window, n]. A sum
    S of n terms t then moves by at most (n + 2) u sum|t|; `denom = sw*sxx
    - sx*sx` and `num = sw*sxy - sx*sy` cancel, so their relative changes
    are those of the products times (sw*sxx + sx^2)/|denom| and (sw
    sum|wxy| + sx sum|wy|)/|num|; the intercept `(sy - slope*sx)/sw` adds
    (sum|wy| + |slope*sx| (1 + rel slope))/|sy - slope*sx|."""
    x, y, w = (np.asarray(a, np.float64) for a in (x, y, w))
    u = (x.shape[0] + 2) * 2.0 ** -24
    sw, sx, sy = w.sum(0), (w * x).sum(0), (w * y).sum(0)
    sxx, sxy = (w * x * x).sum(0), (w * x * y).sum(0)
    a_y, a_xy = np.abs(w * y).sum(0), np.abs(w * x * y).sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        denom, num = sw * sxx - sx * sx, sw * sxy - sx * sy
        slope = num / denom
        rel_slope = 2 * u * ((sw * sxx + sx * sx) / np.abs(denom)
                             + (sw * a_xy + sx * a_y) / np.abs(num))
        rel_icpt = (u * a_y + np.abs(slope * sx) * (rel_slope + u)) \
            / np.abs(sy - slope * sx) + u
    return rel_slope, rel_icpt, (sy - slope * sx) / sw, slope


def test_split_fit_on_the_frontier_worlds_last_window():
    """The last window of the three-rail frontier world on 8 chips
    (`test_host_controller_learns_like_reference[True-8]`), refitted by the
    split fit of both packages. Its voltages span ~36 mV around 0.72 V, so
    the uncentred solve cancels all but 1.2e-4..6e-4 of `sw*sxx`: the
    port's `Tensor.sum` blocks the rows, the reference's jitted sums run
    row by row with the multiply contracted into the add (FMA), and torch's
    log10 differs from XLA's in the last bit on some samples, so intercept
    and slope part by 3.4e-3 and 3.0e-3 relative while the frontier, where
    the line meets the bound inside the data, moves 1.4e-5 relative
    (`tests/sor_window_readings.py`). No f32 summation order comes much
    nearer the exact answer (the reference's own is 3.0e-3 off, K7's row
    order 1.4e-3); a centred two-pass solve would put every order within
    4e-7, but it is not the reference's algorithm. So the frontier,
    confidence and weight are held at SOR, and intercept and slope at
    `_solve_rtol`'s conditioning bound of this window (1.2e-2 to 6.5e-2 per
    lane), against the reference and against the exact f64 fit."""
    hc, _ = _learn(tcp, tpol, tsor, ttel, tpp, True, 8, torch.from_numpy,
                   TFleet.sample(8, seed=0))
    th, tcfg = hc.sor_state.history, hc.sor
    jcfg = jsor.SorConfig(capacity=24, refresh_every=2, decay=0.96,
                          guard_v=0.004, max_extension_v=0.12,
                          rails=jtel.ALL_RAIL_OBSERVABLES)
    jh = dataclasses.replace(
        jtel.FrameHistory.create(24, 8, rails=jtel.ALL_RAIL_OBSERVABLES),
        **{f: jnp.asarray(npy(getattr(th, f)))
           for f in ("v", "obs", "age_s", "polled", "valid")},
        cursor=jnp.int32(th.cursor), count=jnp.int32(th.count))
    split = tsor.fit_history(th, tcfg, fused=False)
    fused = tsor.fit_history(th, tcfg, fused=True)
    want = jsor.fit_history(jh, jcfg, fused=False)
    usable = np.asarray(want.confidence).reshape(-1) > 0
    assert usable.sum() == 16          # VDD_CORE and VDD_IO, every chip
    np.testing.assert_array_equal(npy(split.confidence).reshape(-1) > 0,
                                  usable)
    for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
        assert torch.equal(getattr(split, f), getattr(fused, f)), f
    for f in ("v_frontier", "confidence", "n_eff"):
        np.testing.assert_allclose(npy(getattr(split, f)),
                                   np.asarray(getattr(want, f)), err_msg=f,
                                   **SOR)
    x, y, w = (npy(a).reshape(th.capacity, -1)
               for a in tsor._fit_inputs(th, tcfg))
    rel_slope, rel_icpt, exact_icpt, exact_slope = _solve_rtol(x, y, w)
    assert rel_icpt[usable].max() < 0.1
    for f, rel, exact in (("slope", rel_slope, exact_slope),
                          ("intercept", rel_icpt, exact_icpt)):
        got = npy(getattr(split, f)).reshape(-1)[usable]
        ref = np.asarray(getattr(want, f)).reshape(-1)[usable]
        assert np.all(np.abs(got - ref) <= rel[usable] * np.abs(ref)), f
        assert np.all(np.abs(got - exact[usable])
                      <= rel[usable] * np.abs(exact[usable])), f


def test_merge_observables_matches_reference():
    raw = TFleetPM(2, seed=0).poll_frame()
    jraw = JFleetPM(2, seed=0).poll_frame()
    src = ttel.TelemetryFrame(grad_error=torch.tensor([1e-3, 2e-3]),
                              extras={"straggle_rate": torch.tensor([0.1,
                                                                     0.2])})
    jsrc = jtel.TelemetryFrame(grad_error=jnp.asarray([1e-3, 2e-3]),
                               extras={"straggle_rate": jnp.asarray([0.1,
                                                                     0.2])})
    tcfg = tsor.SorConfig(rails=ttel.ALL_RAIL_OBSERVABLES)
    jcfg = jsor.SorConfig(rails=jtel.ALL_RAIL_OBSERVABLES)
    got = tsor.merge_observables(raw, src, tcfg)
    want = jsor.merge_observables(jraw, jsrc, jcfg)
    np.testing.assert_array_equal(npy(got.grad_error),
                                  np.asarray(want.grad_error))
    assert set(got.extras) == set(want.extras)
    for k in want.extras:
        np.testing.assert_array_equal(npy(torch.as_tensor(got.extras[k])),
                                      np.asarray(want.extras[k]))
    assert np.isnan(got.extras["hbm_error_rate"])


# -- the slice through ServeEngine and Trainer -----------------------------------

B, TP, NEW, CHIPS = 2, 16, 10, 4


@pytest.mark.parametrize("sor", [False, True])
def test_generate_host_path_matches_reference(sor):
    """Tiny Qwen2.5 in f32 served with a 4-chip HostRailController deciding
    from its polls (with and without the polled three-rail learner)."""
    jcfg = dataclasses.replace(jget("qwen2p5_14b", tiny=True),
                               dtype="float32")
    tcfg = dataclasses.replace(tget("qwen2p5_14b", tiny=True),
                               dtype="float32")
    import jax
    params = jreg.build(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a), params)
    n_params = sum(a.size for a in jax.tree_util.tree_leaves(params))
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, TP)).astype(np.int32)
    engines = []
    for pkg in ("t", "j"):
        pol, cp, pp, sor_m, tel, fleet = (
            (tpol, tcp, tpp, tsor, ttel, TFleet) if pkg == "t"
            else (jpol, jcp, jpp, jsor, jtel, JFleet))
        hc = cp.HostRailController(
            pol.MultiRailClosedLoop(), n_chips=CHIPS, decide_from="poll",
            sor=sor_m.SorConfig(ingest="polled",
                                rails=tel.ALL_RAIL_OBSERVABLES,
                                refresh_every=4) if sor else None)
        hc.enable_polling()
        kw = dict(max_len=TP + NEW + 8, batch_size=B, controller=hc,
                  fleet=fleet.sample(CHIPS, seed=0),
                  prefill_profile=pp.StepProfile(2.0 * n_params * B * TP,
                                                 2.0 * n_params, 0.0),
                  decode_profile=pp.StepProfile(2.0 * n_params * B,
                                                2.0 * n_params, 0.0))
        if pkg == "t":
            engines.append(TEngine(tcfg, treg.params_from_jax(tcfg, tree,
                                                              "cpu"),
                                   device="cpu", **kw))
        else:
            engines.append(JEngine(jcfg, params, **kw))
    te, je = engines
    np.testing.assert_array_equal(te.generate(prompts, NEW),
                                  je.generate(prompts, NEW))
    for f in ("v_core", "v_hbm", "v_io"):
        np.testing.assert_array_equal(npy(getattr(te.plane, f)),
                                      np.asarray(getattr(je.plane, f)))
    tc, jc = te.controller, je.controller
    assert dataclasses.asdict(tc.stats()) == dataclasses.asdict(jc.stats())
    assert tc.stats().decisions == NEW
    ts, js = te.summary(), je.summary()
    assert ts.keys() == js.keys() and ("sor" in ts) == sor
    for k in ("v_core", "v_io", "v_core_min", "v_io_min", "comp_level_min",
              "n_chips", "decode_tokens"):
        assert ts[k] == js[k], k
    if sor:
        # the serve frames carry no error observable that moves with the
        # voltage (grad_error is 0), so nothing is learned, exactly
        assert ts["sor"] == js["sor"] and ts["sor"]["chips_learned"] == 0
        assert tc.sor_state.tick == NEW


def test_engine_refuses_sor_with_a_host_controller():
    cfg = tget("qwen2p5_14b", tiny=True)
    params = treg.build(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="pass sor= to the controller"):
        TEngine(cfg, params, max_len=16, batch_size=1, device="cpu",
                controller=tcp.HostRailController(tpol.PhaseAware()),
                sor=tsor.SorConfig(ingest="frames"))


def test_trainer_host_path_matches_reference(tmp_path):
    """tests/test_train_e2e.py::test_host_controller_pays_pmbus_latency on
    both packages: six steps of the tiny trainer with a
    HostRailController(PhaseAware()) between steps."""
    import jax

    from repro.data.pipeline import DataConfig as JData
    from repro.data.pipeline import SyntheticLM as JSynth
    from repro.optim import adamw as jadamw
    from repro.optim.schedule import wsd as jwsd
    from repro.train import step as jstep
    from repro.train import trainer as jtrainer
    from repro_torch.data.pipeline import DataConfig as TData
    from repro_torch.data.pipeline import SyntheticLM as TSynth
    from repro_torch.optim import adamw as tadamw
    from repro_torch.optim.schedule import wsd as twsd
    from repro_torch.train import step as tstep
    from repro_torch.train import trainer as ttrainer
    jcfg = dataclasses.replace(jget("minicpm_2b", tiny=True), dtype="float32")
    tcfg = dataclasses.replace(tget("minicpm_2b", tiny=True), dtype="float32")
    params = jreg.build(jcfg, remat="none").init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a), params)
    tparams = treg.params_from_jax(tcfg, tree, "cpu")
    prof = dict(flops_per_chip=6e9, hbm_bytes_per_chip=1.4e7,
                ici_bytes_per_chip=4e6)
    sched = dict(peak_lr=1e-3, warmup_steps=2, stable_steps=50,
                 decay_steps=50)
    jstep_fn = jstep.jit_train_step(jstep.make_train_step(
        jreg.build(jcfg, remat="none").loss_fn,
        jadamw.AdamWConfig(grad_clip_norm=1.0), lambda s: jwsd(s, **sched),
        jpp.StepProfile(**prof), jstep.StepConfig()), donate=False)
    tstep_fn = tstep.make_train_step(
        treg.build(tcfg, remat="none").loss_fn,
        tadamw.AdamWConfig(grad_clip_norm=1.0), lambda s: twsd(s, **sched),
        tpp.StepProfile(**prof), tstep.StepConfig())
    jplane, jef = jtrainer.initial_plane_and_ef(params)
    tplane, tef = ttrainer.initial_plane_and_ef(tparams)
    jhc, thc = jcp.HostRailController(jpol.PhaseAware()), \
        tcp.HostRailController(tpol.PhaseAware())
    jt = jtrainer.Trainer(
        jstep_fn, JSynth(JData(jcfg.vocab_size, 32, 4)),
        jtrainer.TrainerConfig(total_steps=6, ckpt_every=10,
                               ckpt_dir=str(tmp_path), async_ckpt=False,
                               controller=jhc),
        {"params": params, "opt": jadamw.init_state(
            params, jadamw.AdamWConfig(grad_clip_norm=1.0)),
         "plane": jplane, "ef": jef})
    tt = ttrainer.Trainer(
        tstep_fn, TSynth(TData(jcfg.vocab_size, 32, 4)),
        ttrainer.TrainerConfig(total_steps=6, controller=thc, device="cpu"),
        {"params": tparams, "opt": tadamw.init_state(
            tparams, tadamw.AdamWConfig(grad_clip_norm=1.0)),
         "plane": tplane, "ef": tef})
    jt.run()
    tt.run()
    ts, js = thc.stats(), jhc.stats()
    assert ts.decisions == js.decisions == 6
    assert ts.actuations == js.actuations >= 1
    # PhaseAware's targets follow the step's roofline times, which the two
    # packages compute to f32 ulps (tests/test_torch_control.py F32); each
    # write settles into a band around its target, so bus seconds and
    # achieved voltages inherit that ulp
    np.testing.assert_allclose(ts.actuation_seconds, js.actuation_seconds,
                               rtol=TRAIN_HOST_RTOL)
    assert js.actuation_seconds > 0
    tsum, jsum = tt.summary(), jt.summary()
    assert tsum["host_actuations"] == jsum["host_actuations"]
    assert tsum["host_skipped_actuations"] == jsum["host_skipped_actuations"]
    np.testing.assert_allclose(tsum["host_actuation_s"],
                               jsum["host_actuation_s"], rtol=TRAIN_HOST_RTOL)
    for f in ("v_core", "v_hbm", "v_io"):
        np.testing.assert_allclose(npy(getattr(tt.state["plane"], f)),
                                   np.asarray(getattr(jt.state["plane"], f)),
                                   rtol=TRAIN_HOST_RTOL, err_msg=f)
