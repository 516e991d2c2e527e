"""Routed serving on the CPU: `ServeEngine.serve_trace` in the port against
the reference engine, on the reference's routed world (its serve_router
benchmark: the 23-seeded fleet, the envelope-blind walk, the load-coupled
frontier observables; `test_torch_inputs.ROUTED_*`) at 16 chips and below.

The reference draws the observables' noise with jax.random; both packages
here read one numpy table made from a seed, indexed by tick, each through
its own observe function.

Where whole traces agree, they agree exactly: every discrete ledger field
(placement and completion times, chips, tokens, defers, migrations) and
the engine's counters. That holds for the round-robin router in the
learned world, for the headroom router in the static world (the walk
without learning: floors are the rails' static ones, so headroom is the
held voltage, equal bit for bit in both packages), in the pinned-drain
world, on the controller-less fleet with fast-forward, and for the host
controller on the loop path. It does not hold for the headroom router in
the learned world: the SOR refit from the same frames parts by up to
0.5 mV between the packages (ROADMAP "Known disagreements"), one occupancy
slot is worth 2.5 mV of score, and a near-tie flips a placement (the first
split is recorded by `test_learned_headroom_trace_parts_at_a_near_tie`).
There one tick is held instead: the same plane, SOR state, busy fraction
and tick through both packages' tick functions.

Tolerances: analog ledger values (energies) of the port's eager tick
against the reference's jitted tick within ANALOG_RTOL (the reference
holds its own jitted tick to its eager loop at 1e-5); against the
reference's eager loop, and the port's two paths against each other, bit
for bit. The tick's bundle rows: energies and step time within TICK_RTOL
(elementwise f32 on equal inputs), floors and headroom within FLOOR_ATOL
(one refit from equal windows), the over and pinned rows exact.
"""

import ast
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmarks import serve_batching as sb
from benchmarks import serve_router as sr
from benchmarks import serve_scale as ss
from repro.configs import get_config as jget
from repro.core import control_plane as jcp
from repro.core import policy as jpol
from repro.core import sor as jsor
from repro.core import telemetry as jtel
from repro.core.hwspec import FleetSpec as JFleet
from repro.core.power_plane import StepProfile as JProfile
from repro.core.power_plane import account_fleet_and_observe as j_account
from repro.models import registry as jreg
from repro.serve import router as jrouter
from repro.serve import traffic as jtraffic
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import control_plane as tcp
from repro_torch.core import policy as tpol
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from repro_torch.core.hwspec import FleetSpec as TFleet
from repro_torch.core.power_plane import BatchShares, PowerPlaneState
from repro_torch.core.power_plane import StepProfile as TProfile
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import registry as treg
from repro_torch.serve import router as trouter
from repro_torch.serve import traffic as ttraffic
from repro_torch.serve.engine import ServeEngine as TEngine
from test_torch_inputs import (ROUTED_BOUND, ROUTED_DECODE_PROFILE,
                               ROUTED_LOAD_SHIFT_V, ROUTED_LOG_SLOPE,
                               ROUTED_ONSETS, ROUTED_POLICY_FLOORS,
                               ROUTED_PROFILE, ROUTED_SEED, ROUTED_SOR,
                               ROUTED_WARMUP, ledger_discrete,
                               routed_engine, routed_noise,
                               routed_migration_knobs, routed_observe,
                               routed_onset_sources, routed_trace_knobs,
                               routed_warm_up)

ANALOG_RTOL = 1e-5
TICK_RTOL = 1e-6
FLOOR_ATOL = 5e-4
MAX_TICKS = 900

_PARAMS = {}


def _params(pkg):
    """Tiny MiniCPM weights for either package's engine (serve_trace runs
    no forward; the engine only needs them to exist)."""
    if pkg not in _PARAMS:
        if pkg == "jax":
            cfg = jget("minicpm_2b", tiny=True)
            _PARAMS[pkg] = (cfg, jreg.build(cfg).init(jax.random.PRNGKey(0)))
        else:
            cfg = tget("minicpm_2b", tiny=True)
            _PARAMS[pkg] = (cfg, treg.build(cfg).init(
                torch.Generator().manual_seed(0)))
    return _PARAMS[pkg]


def _router(pkg, kind, capacity, **kw):
    mod = jrouter if pkg == "jax" else trouter
    return (mod.HeadroomRouter(capacity=capacity, **kw)
            if kind == "headroom" else mod.RoundRobinRouter(capacity=capacity))


# -- the reference's side of the routed world ---------------------------------

def _j_observe(fs, noise):
    """The reference benchmark's observe with its noise read from the
    shared table (jnp, so it runs inside the reference's jitted tick)."""
    table = jnp.asarray(noise)
    v_on = {}
    for rail, src in routed_onset_sources(fs).items():
        base, spread = ROUTED_ONSETS[rail]
        v_on[rail] = base + spread * (jnp.asarray(src) - 1.0)

    def err(v, v_onset, nz):
        return ROUTED_BOUND * nz * 10.0 ** jnp.clip(
            ROUTED_LOG_SLOPE * (v_onset - v), -6.0, 3.0)

    def observe(plane, frame, tick, busy_frac):
        nz = table[tick + ROUTED_WARMUP]
        shift = ROUTED_LOAD_SHIFT_V * busy_frac
        return dataclasses.replace(
            frame,
            grad_error=err(plane.v_io, v_on["VDD_IO"] + shift, nz[0]),
            extras={**frame.extras,
                    "straggle_rate": err(plane.v_core, v_on["VDD_CORE"],
                                         nz[1]),
                    "hbm_error_rate": err(plane.v_hbm,
                                          v_on["VDD_HBM"] + shift, nz[2])})

    return observe


def _j_engine(n_chips, control, router, decode_profile=None, **kw):
    fs = JFleet.sample(n_chips, seed=ROUTED_SEED)
    walk = sr._EnvelopeBlindWalk(floors=dict(sr.POLICY_FLOORS),
                                 backoff=1.01, name="envelope-blind-walk")
    ctrl = (jcp.HostRailController(walk, n_chips=n_chips, sor=sr.SOR_CFG)
            if control == "host" else jcp.InGraphRailController(
                walk, sor=sr.SOR_CFG if control == "learned" else None))
    cfg, params = _params("jax")
    profile = JProfile(**ROUTED_PROFILE)
    return JEngine(cfg, params, max_len=24, batch_size=2,
                   prefill_profile=profile,
                   decode_profile=decode_profile or profile, fleet=fs,
                   controller=ctrl, router=router, **kw)


def _j_warm_up(eng, observe):
    idle = jnp.zeros((eng.n_chips,), jnp.float32)
    for w in range(ROUTED_WARMUP):
        eng.plane, frame, _ = j_account(eng.decode_profile, eng.plane,
                                        eng.fleet_spec)
        eng._control_tick(observe(eng.plane, frame, w - ROUTED_WARMUP,
                                  idle))


# -- the worlds ---------------------------------------------------------------

def _learned_trace(pkg, n_requests=24):
    mod = jtraffic if pkg == "jax" else ttraffic
    return mod.bursty_trace(n_requests, seed=ROUTED_SEED, quiet_rate_hz=8.0,
                            burst_rate_hz=40.0, decode_mean=48.0)


def _migration_trace(pkg):
    """The reference's forced-pin scenario at test scale: saturating load
    (`tests/test_serve_batching.py` migration test)."""
    mod = jtraffic if pkg == "jax" else ttraffic
    return mod.bursty_trace(96, seed=ROUTED_SEED, quiet_rate_hz=16.0,
                            burst_rate_hz=80.0, decode_mean=96.0)


def _run_routed(pkg, *, n_chips=16, control="learned", router="headroom",
                capacity=4, batch_cap=None, decode=False, trace=None,
                max_ticks=MAX_TICKS, **serve_kw):
    """One warmed routed run in either package: (engine, ledger)."""
    noise = routed_noise(n_chips, max_ticks)
    trace = (trace or _learned_trace)(pkg)
    if pkg == "jax":
        prof = sb.DECODE_PROFILE if decode else None
        eng = _j_engine(n_chips, control, _router(pkg, router, capacity),
                        decode_profile=prof, batch_cap=batch_cap)
        observe = _j_observe(eng.fleet_spec, noise)
        _j_warm_up(eng, observe)
    else:
        cfg, params = _params("torch")
        prof = TProfile(**ROUTED_DECODE_PROFILE) if decode else None
        eng = routed_engine(n_chips, "cpu", params=params, cfg=cfg,
                            router=_router(pkg, router, capacity),
                            decode_profile=prof, control=control,
                            batch_cap=batch_cap)
        observe = routed_observe(eng.fleet_spec, noise, "cpu")
        routed_warm_up(eng, observe)
    ledger = eng.serve_trace(trace, observe=observe, max_ticks=max_ticks,
                             error_bound=ROUTED_BOUND, **serve_kw)
    return eng, ledger


def _pin_hbm(pkg):
    """A policy asking for an impossible VDD_HBM, so arbitration pins every
    chip at the HBM floor (the reference's `_PinHbmPolicy`)."""
    if pkg == "jax":
        class PinHbm(jpol.Policy):
            name = "pin-hbm-floor"

            def decide(self, state, frame):
                return jpol.RailRequest(v_hbm=jnp.zeros_like(
                    jnp.asarray(state.v_hbm, jnp.float32)),
                    reason="pinned-at-floor")
    else:
        class PinHbm(tpol.Policy):
            name = "pin-hbm-floor"

            def decide(self, state, frame):
                return tpol.RailRequest(v_hbm=torch.zeros_like(state.v_hbm),
                                        reason="pinned-at-floor")
    return PinHbm()


def _half_pinned(pkg):
    """A policy that pins the even chips at the VDD_HBM floor and holds
    the odd ones at their nominal: pinned and unpinned chips side by side
    with headroom from held voltages alone, so a headroom router that
    does not drain pinned chips places on both and migration moves lanes
    off the pinned ones."""
    if pkg == "jax":
        class HalfPinned(jpol.Policy):
            name = "half-pinned"

            def decide(self, state, frame):
                even = jnp.arange(state.v_hbm.shape[0]) % 2 == 0
                return jpol.RailRequest(
                    v_hbm=jnp.where(even, 0.0, jnp.asarray(
                        frame.v_nom_hbm, jnp.float32)),
                    reason="pinned-at-floor")
    else:
        class HalfPinned(tpol.Policy):
            name = "half-pinned"

            def decide(self, state, frame):
                even = torch.arange(state.v_hbm.shape[0],
                                    device=state.device) % 2 == 0
                return tpol.RailRequest(
                    v_hbm=torch.where(even, 0.0, frame.v_nom_hbm),
                    reason="pinned-at-floor")
    return HalfPinned()


def _run_plain(pkg, *, n_chips, seed, router="headroom", capacity=2,
               policy=None, trace=None, batch_cap=None, decode=False,
               drain_pinned=True, **serve_kw):
    """A small world without observables: a `seed` FleetSpec, `policy`
    (None: no controller) and the reference tests' default profile (or,
    `decode=True`, the decode-shaped one)."""
    profile = ROUTED_DECODE_PROFILE if decode else ROUTED_PROFILE
    cfg, params = _params(pkg)
    rkw = {} if router != "headroom" else dict(drain_pinned=drain_pinned)
    if pkg == "jax":
        eng = JEngine(cfg, params, max_len=24, batch_size=2,
                      prefill_profile=JProfile(**ROUTED_PROFILE),
                      decode_profile=JProfile(**profile),
                      fleet=JFleet.sample(n_chips, seed=seed),
                      policy=policy, batch_cap=batch_cap,
                      router=_router(pkg, router, capacity, **rkw))
    else:
        eng = TEngine(cfg, params, max_len=24, batch_size=2,
                      prefill_profile=TProfile(**ROUTED_PROFILE),
                      decode_profile=TProfile(**profile),
                      fleet=TFleet.sample(n_chips, seed=seed),
                      policy=policy, batch_cap=batch_cap,
                      router=_router(pkg, router, capacity, **rkw),
                      device="cpu")
    return eng, eng.serve_trace(trace(pkg), **serve_kw)


def _steady_pair(pkg):
    """Two requests 5 s apart: an idle gap for fast-forward to skip."""
    mod = jtraffic if pkg == "jax" else ttraffic
    return [mod.Request(rid=0, t_arrival_s=0.0, prefill_tokens=4,
                        decode_tokens=8),
            mod.Request(rid=1, t_arrival_s=5.0, prefill_tokens=4,
                        decode_tokens=8)]


# id -> (runner, kwargs): the worlds whose whole traces agree exactly
WORLDS = {
    "learned-roundrobin-fused": (_run_routed, dict(router="roundrobin")),
    "learned-roundrobin-loop": (_run_routed, dict(router="roundrobin",
                                                  fused=False)),
    "learned-roundrobin-batch4": (_run_routed, dict(
        router="roundrobin", batch_cap=4, decode=True)),
    "static-headroom-fused": (_run_routed, dict(control="static")),
    "static-headroom-loop": (_run_routed, dict(control="static",
                                               fused=False)),
    "static-headroom-batch4": (_run_routed, dict(
        control="static", batch_cap=4, decode=True)),
    "static-headroom-batch1": (_run_routed, dict(
        control="static", capacity=1, batch_cap=1)),
    "half-pinned-migrate": (_run_plain, dict(
        n_chips=8, seed=ROUTED_SEED, policy="half", capacity=4,
        batch_cap=4, decode=True, drain_pinned=False,
        trace=_migration_trace, max_ticks=4000, migrate_after_ticks=6)),
    "host-roundrobin-loop": (_run_routed, dict(
        n_chips=8, control="host", router="roundrobin")),
    "pinned-drain-fused": (_run_plain, dict(
        n_chips=3, seed=9, policy="pin", max_ticks=40,
        trace=lambda pkg: (jtraffic if pkg == "jax" else ttraffic
                           ).bursty_trace(4, seed=2))),
    "pinned-drain-loop": (_run_plain, dict(
        n_chips=3, seed=9, policy="pin", max_ticks=40, fused=False,
        trace=lambda pkg: (jtraffic if pkg == "jax" else ttraffic
                           ).bursty_trace(4, seed=2))),
    "idle-fast-forward": (_run_plain, dict(
        n_chips=2, seed=5, max_ticks=6000, tick_s=1 / 64,
        fast_forward=True, trace=_steady_pair)),
}


def _run_world(pkg, world):
    runner, kw = WORLDS[world]
    kw = dict(kw)
    if kw.get("policy") in ("pin", "half"):
        kw["policy"] = (_pin_hbm if kw["policy"] == "pin"
                        else _half_pinned)(pkg)
    return runner(pkg, **kw)


def _analog(eng, ledger):
    return dict(fleet_energy_j=ledger.fleet_energy_j,
                stats_fleet_energy_j=eng.stats.fleet_energy_j,
                request_energy_j=[r.energy_j for r in ledger.records()],
                **{f: getattr(eng.plane, f) for f in ("v_core", "v_hbm",
                                                      "v_io", "energy_j")})


def _assert_analog(a, b, rtol):
    for k in a:
        got = np.asarray(a[k].numpy() if isinstance(a[k], torch.Tensor)
                         else a[k], np.float64)
        np.testing.assert_allclose(got, np.asarray(b[k], np.float64),
                                   rtol=rtol, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("world", list(WORLDS))
def test_trace_matches_reference(world):
    """The port's ledger equals the reference's on every discrete field;
    energies and the plane within ANALOG_RTOL of the reference's jitted
    tick, bit for bit against its eager loop."""
    je, jl = _run_world("jax", world)
    te, tl = _run_world("torch", world)
    assert te.last_trace["fused"] == je.last_trace["fused"]
    assert ledger_discrete(te, tl) == ledger_discrete(je, jl)
    js, ts = jl.summary(), tl.summary()
    assert js["completed"] == ts["completed"]
    assert te.last_trace == je.last_trace
    rtol = ANALOG_RTOL if je.last_trace["fused"] else 0.0
    _assert_analog(_analog(te, tl),
                   {k: (np.asarray(v) if isinstance(v, jax.Array) else v)
                    for k, v in _analog(je, jl).items()}, rtol)
    if "pinned-drain" in world:     # every chip pinned: nothing placed
        assert ts["completed"] == 0 and te.stats.sheds_by_rail["VDD_HBM"]
    else:
        assert ts["completed"] == len(tl) > 0
    if "migrate" in world:
        assert te.last_trace["migrations"] > 0


def test_learned_headroom_trace_parts_at_a_near_tie():
    """The headroom router in the learned world: the port's trace parts
    from the reference's at a near-tie. On this world the first split is
    request 4 at tick 23 (t = 0.3176 s, decode share 0.43): with chip 4's
    occupancy term the reference scores chip 4 above chip 11 by 0.45 mV,
    while the port's learned VDD_HBM floor on chip 4 sits 0.39 mV higher
    (the two fits part by up to 1.2 mV by then) and it picks chip 11.
    Both packages still finish every request, the requests before the
    split are placed alike, and the SLO summary stays within 2 % of the
    reference's."""
    je, jl = _run_routed("jax")
    te, tl = _run_routed("torch")
    jr, tr = jl.records(), tl.records()
    assert [(r.rid, r.t_arrival_s) for r in jr] == \
           [(r.rid, r.t_arrival_s) for r in tr]
    split = next((i for i, (a, b) in enumerate(zip(jr, tr))
                  if (a.t_placed_s, a.chip) != (b.t_placed_s, b.chip)),
                 None)
    js, ts = jl.summary(), tl.summary()
    assert js["completed"] == ts["completed"] == len(jr)
    if split is not None:
        # the requests before the split were placed identically
        assert all(a.chip == b.chip for a, b in zip(jr[:split],
                                                    tr[:split]))
    for k in ("tokens_per_joule", "p95_latency_s", "p99_latency_s",
              "fleet_energy_j"):
        assert ts[k] == pytest.approx(js[k], rel=0.02), k


def test_fused_ledger_equals_loop_ledger():
    """The port's own oracle: its fused path and its loop path give the
    same ledger, discrete fields and energies bit for bit, on both
    routers in the learned world (the reference holds its jitted tick to
    its loop on the discrete fields)."""
    for router in ("headroom", "roundrobin"):
        runs = {fused: _run_routed("torch", router=router, fused=fused)
                for fused in (True, False)}
        (ef, lf), (el, ll) = runs[True], runs[False]
        assert ledger_discrete(ef, lf) == ledger_discrete(el, ll)
        _assert_analog(_analog(ef, lf), _analog(el, ll), 0.0)


@pytest.mark.parametrize("router", ["headroom", "roundrobin"])
def test_batch_cap_one_bit_equal_to_unbatched(router):
    """batch_cap=1 builds the unbatched tick: the ledger and the plane are
    equal bit for bit to the engine without batch_cap."""
    runs = {cap: _run_routed("torch", n_chips=6, capacity=1, router=router,
                             batch_cap=cap, trace=lambda p: _learned_trace(
                                 p, 16)) for cap in (None, 1)}
    (en, ln), (e1, l1) = runs[None], runs[1]
    assert not e1._batched and e1.last_trace["batch_cap"] == 1
    assert ledger_discrete(en, ln) == ledger_discrete(e1, l1)
    _assert_analog(_analog(en, ln), _analog(e1, l1), 0.0)


def test_batched_backlog_drains_in_fewer_ticks():
    """Every request at t=0 on the decode-shaped profile: a cap-4 fleet
    finishes in fewer ticks than a cap-1 fleet (the reference's test)."""
    profile = TProfile(**ROUTED_DECODE_PROFILE)
    cfg, params = _params("torch")
    trace = [ttraffic.Request(rid=i, t_arrival_s=0.0, prefill_tokens=8,
                              decode_tokens=32) for i in range(16)]
    ticks = {}
    for cap in (1, 4):
        eng = TEngine(cfg, params, max_len=24, batch_size=2,
                      prefill_profile=profile, decode_profile=profile,
                      fleet=TFleet.sample(4, seed=ROUTED_SEED),
                      router=trouter.HeadroomRouter(capacity=cap),
                      batch_cap=cap, device="cpu")
        led = eng.serve_trace(trace, max_ticks=4000)
        assert led.summary()["completed"] == 16
        ticks[cap] = eng.last_trace["ticks"]
    assert ticks[4] < ticks[1]


def test_fast_forward_skips_idle_gaps_tick_identically():
    """Controller-less fleet: jumping an idle gap lands on the tick grid
    the walked run reaches (binary-exact tick 2^-6 s), with the same
    placements and completions; only the skipped ticks' energy is
    missing."""
    runs = {ff: _run_plain("torch", n_chips=2, seed=5, max_ticks=6000,
                           tick_s=1 / 64, fast_forward=ff,
                           trace=_steady_pair) for ff in (False, True)}
    (ew, lw), (ef, lf) = runs[False], runs[True]
    assert ew.last_trace["fast_forward_ticks"] == 0
    skipped = ef.last_trace["fast_forward_ticks"]
    assert skipped > 0
    assert ef.last_trace["ticks"] + skipped == ew.last_trace["ticks"]
    key = [(r.rid, r.t_placed_s, r.chip, r.t_done_s, r.tokens_out)
           for r in lw.records()]
    assert key == [(r.rid, r.t_placed_s, r.chip, r.t_done_s, r.tokens_out)
                   for r in lf.records()]
    for rf, rw in zip(lf.records(), lw.records()):
        assert rf.energy_j == pytest.approx(rw.energy_j, rel=1e-6)
    assert lf.fleet_energy_j < lw.fleet_energy_j


def test_migration_moves_lanes_and_keeps_the_lifecycle():
    """The forced-pin scenario in the learned world: migration fires,
    every migrated record ends on its last destination having paid its
    stall, and the whole trace completes."""
    eng, led = _run_routed("torch", n_chips=8, batch_cap=4, decode=True,
                           trace=_migration_trace, max_ticks=4000,
                           migrate_after_ticks=6)
    assert eng.last_trace["migrations"] > 0
    assert led.summary()["completed"] == 96
    last = {}
    for e in led.migration_events:
        assert e["src"] != e["dst"] and e["src_streak"] >= 6
        last[e["rid"]] = e
    recs = {r.rid: r for r in led.records()}
    for rid, e in last.items():
        assert recs[rid].chip == e["dst"] and recs[rid].stall_time_s > 0
    s = led.summary()
    assert s["migrations"] == len(led.migration_events)
    assert s["migration_stall_s"] == pytest.approx(
        sum(e["stall_s"] for e in led.migration_events))


# -- one tick, the same state through both packages ----------------------------

def _to_torch_sor(state):
    """The reference's SorState as the port's (host-int cursor, count and
    tick)."""
    h = state.history
    hist = ttel.FrameHistory(
        **{f: torch.from_numpy(np.array(getattr(h, f)))
           for f in ("v", "obs", "age_s", "polled", "valid")},
        cursor=int(h.cursor), count=int(h.count), capacity=h.capacity,
        rails=ttel.ALL_RAIL_OBSERVABLES)
    est = tsor.SorEstimate(*(torch.from_numpy(np.array(getattr(
        state.estimate, f))) for f in ("intercept", "slope", "v_frontier",
                                        "confidence", "n_eff")))
    return tsor.SorState(history=hist, estimate=est, tick=int(state.tick))


def _to_torch_plane(plane):
    return PowerPlaneState(**{
        f.name: torch.from_numpy(np.array(getattr(plane, f.name)))
        for f in dataclasses.fields(PowerPlaneState)})


@pytest.mark.parametrize("batch_cap", [None, 4])
@pytest.mark.parametrize("refit", [False, True], ids=["hold", "refit"])
def test_tick_matches_reference(refit, batch_cap):
    """The learned world after warm-up and a few routed ticks in the
    reference: its plane and SOR state go through both packages' tick
    functions with the same busy fraction and tick (on a refit round and
    off one). The bundle rows agree at the stated tolerances, the over
    and pinned rows exactly, and so do the planes after the tick."""
    n = 16
    noise = routed_noise(n, MAX_TICKS)
    prof = sb.DECODE_PROFILE if batch_cap else None
    je = _j_engine(n, "learned", jrouter.HeadroomRouter(capacity=4),
                   decode_profile=prof, batch_cap=batch_cap)
    jobs = _j_observe(je.fleet_spec, noise)
    _j_warm_up(je, jobs)
    # routed ticks so the plane carries load-shifted history; the next
    # control round refits when the SOR tick reaches a multiple of
    # refresh_every (48 warm-up rounds + 31 ticks: the 80th round)
    je.serve_trace(_learned_trace("jax"), observe=jobs,
                   max_ticks=31 if refit else 30, error_bound=ROUTED_BOUND)
    cfg, params = _params("torch")
    te = routed_engine(n, "cpu", params=params, cfg=cfg,
                       router=trouter.HeadroomRouter(capacity=4),
                       decode_profile=(TProfile(**ROUTED_DECODE_PROFILE)
                                       if batch_cap else None),
                       batch_cap=batch_cap)
    tobs = routed_observe(te.fleet_spec, noise, "cpu")
    tick_s = 0.0138
    jfn = je._build_serve_tick(jobs, tick_s, ROUTED_BOUND)
    tfn = te._build_serve_tick(tobs, tick_s, ROUTED_BOUND)
    state = je._sor_state
    tick = 40
    occ = np.random.default_rng(3).integers(0, 5, n)
    busy = (np.minimum(occ.astype(np.float64), 4) / 4).astype(np.float32)
    jp, js, jb, _, _ = jfn(je.plane, state, jnp.asarray(busy),
                           jnp.int32(tick))
    tp, ts, tb, _, _ = tfn(_to_torch_plane(je.plane), _to_torch_sor(state),
                           torch.from_numpy(busy), tick)
    assert (ts.tick % 4 == 0) == refit
    jb, tb = np.asarray(jb, np.float64), tb.numpy().astype(np.float64)
    assert jb.shape == tb.shape == ((15 if batch_cap else 13), n)
    np.testing.assert_allclose(tb[:3], jb[:3], rtol=TICK_RTOL, err_msg="e/t")
    np.testing.assert_array_equal(tb[3], jb[3], err_msg="over")
    np.testing.assert_allclose(tb[4:10], jb[4:10], rtol=0, atol=FLOOR_ATOL,
                               err_msg="floors, headroom")
    np.testing.assert_array_equal(tb[10:13], jb[10:13], err_msg="pinned")
    if batch_cap:
        np.testing.assert_array_equal(tb[13], jb[13], err_msg="b_eff")
        np.testing.assert_allclose(tb[14], jb[14], rtol=TICK_RTOL,
                                   err_msg="t_lane")
    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)),
                                   rtol=TICK_RTOL, atol=FLOOR_ATOL
                                   if f != "energy_j" else 0, err_msg=f)


class _HostReads(TorchDispatchMode):
    """Records the aten ops that, on a CUDA tensor, read the device from
    the host or copy host data over: a scalar taken off a tensor, a
    data-dependent shape, a tensor made from host data, a copy that names
    a device."""
    SYNCING = {"_local_scalar_dense", "item", "nonzero", "masked_select",
               "lift_fresh", "lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.SYNCING or (name == "_to_copy"
                                    and "device" in (kwargs or {})):
            self.bad.append(name)
        return func(*args, **(kwargs or {}))


def test_tick_reads_nothing_back():
    """The fused tick function takes no scalar off a tensor, no
    data-dependent shape and builds no tensor from host data: on the card
    its only device-to-host copy is its caller's bundle read (on the CPU
    the check is the aten ops it dispatches)."""
    cfg, params = _params("torch")
    for batch_cap in (None, 4):
        eng = routed_engine(8, "cpu", params=params, cfg=cfg,
                            router=trouter.HeadroomRouter(capacity=4),
                            batch_cap=batch_cap)
        observe = routed_observe(eng.fleet_spec, routed_noise(8, 16), "cpu")
        fn = eng._build_serve_tick(observe, 0.0138, ROUTED_BOUND)
        state = eng.controller.init_sor(8, device="cpu")
        # the per-rail bounds go to the device once per (config, device)
        tsor._rail_consts(eng.controller.sor, state.history.v.device)
        busy = torch.full((8,), 0.25)
        plane = eng.plane
        for tick in range(8):     # two refits on cadence
            rec = _HostReads()
            with rec:
                plane, state, bundle, _, _ = fn(plane, state, busy, tick)
            assert not rec.bad, (tick, rec.bad)
        assert bundle.shape == ((15 if batch_cap else 13), 8)


# -- validation (the reference's tests, on the port) ---------------------------

def _tiny_engine(**kw):
    cfg, params = _params("torch")
    profile = TProfile(**ROUTED_PROFILE)
    kw.setdefault("prefill_profile", profile)
    kw.setdefault("decode_profile", profile)
    return TEngine(cfg, params, max_len=24, batch_size=2, device="cpu", **kw)


def test_engine_validation_errors():
    fs = TFleet.sample(2, seed=5)
    with pytest.raises(ValueError, match="fleet="):
        _tiny_engine(router=trouter.HeadroomRouter(capacity=2))
    with pytest.raises(ValueError, match="router"):
        _tiny_engine(fleet=fs, batch_cap=2)
    with pytest.raises(ValueError, match=">= 1"):
        _tiny_engine(fleet=fs, router=trouter.HeadroomRouter(capacity=2),
                     batch_cap=0)
    with pytest.raises(ValueError, match="must equal the router"):
        _tiny_engine(fleet=fs, router=trouter.HeadroomRouter(capacity=3),
                     batch_cap=2)
    with pytest.raises(ValueError, match="batch_cap"):
        _tiny_engine(fleet=fs, router=trouter.HeadroomRouter(capacity=2),
                     batch_shares=BatchShares())
    with pytest.raises(ValueError, match="needs a mesh"):
        _tiny_engine(fleet=fs, shard_control=True)
    with pytest.raises(ValueError, match="sor"):
        _tiny_engine(fleet=fs, mesh=object(), shard_control=True,
                     policy=tpol.MultiRailClosedLoop())


def test_serve_trace_validation_errors():
    fs = TFleet.sample(2, seed=5)
    trace = ttraffic.bursty_trace(3, seed=2)
    with pytest.raises(ValueError, match="router="):
        _tiny_engine(fleet=fs).serve_trace(trace)
    eng = _tiny_engine(fleet=fs, router=trouter.HeadroomRouter(capacity=2),
                       batch_cap=2)
    with pytest.raises(ValueError, match="batch-cap=1 semantics oracle"):
        eng.serve_trace(trace, max_ticks=10, fused=False)
    with pytest.raises(ValueError, match=">= 1"):
        eng.serve_trace(trace, max_ticks=10, migrate_after_ticks=0)
    eng2 = _tiny_engine(fleet=fs, policy=tpol.MultiRailClosedLoop(),
                        router=trouter.HeadroomRouter(capacity=2))
    with pytest.raises(ValueError, match="migration rides the fused"):
        eng2.serve_trace(trace, max_ticks=10, fused=False,
                         migrate_after_ticks=3)
    with pytest.raises(ValueError, match="fast_forward"):
        eng2.serve_trace(trace, max_ticks=10, fused=False,
                         fast_forward=True)
    eng3 = _tiny_engine(fleet=fs, router=trouter.RoundRobinRouter(capacity=2))
    with pytest.raises(ValueError, match="migration planner"):
        eng3.serve_trace(trace, max_ticks=10, migrate_after_ticks=3)


def test_host_controller_runs_the_loop_path():
    """A HostRailController resolves to the loop path and refuses the
    fused one (the reference's test on the port)."""
    fs = TFleet.sample(2, seed=5)
    eng = _tiny_engine(controller=tcp.HostRailController(
        tpol.MultiRailClosedLoop(), n_chips=2), fleet=fs,
        router=trouter.HeadroomRouter(capacity=2))
    led = eng.serve_trace(ttraffic.bursty_trace(3, seed=2), max_ticks=200)
    assert eng.last_trace["fused"] is False
    assert led.summary()["completed"] == 3
    with pytest.raises(ValueError, match="fused=False"):
        eng.serve_trace(ttraffic.bursty_trace(3, seed=2), max_ticks=10,
                        fused=True)


def test_round_robin_reset_at_trace_start():
    """serve_trace resets the router: a cursor left by an earlier trace
    does not move the next trace's placements."""
    fs = TFleet.sample(3, seed=9)
    trace = ttraffic.bursty_trace(6, seed=8)

    def first_chip(cursor):
        eng = _tiny_engine(policy=tpol.MultiRailClosedLoop(), fleet=fs,
                           router=trouter.RoundRobinRouter(capacity=2))
        eng.router._cursor = cursor
        return eng.serve_trace(trace, max_ticks=400).records()[0].chip

    assert first_chip(0) == first_chip(2)


def test_summary_router_branch_matches_reference():
    """`summary()` of a routed engine carries the shed counters and the
    same keys and values as the reference's."""
    je, jl = _run_world("jax", "pinned-drain-fused")
    te, tl = _run_world("torch", "pinned-drain-fused")
    js, ts = je.summary(), te.summary()
    assert ts.keys() == js.keys()
    assert ts["decode_sheds"] == js["decode_sheds"] > 0
    for k, v in js.items():
        if isinstance(v, float):
            np.testing.assert_allclose(ts[k], v, rtol=ANALOG_RTOL,
                                       err_msg=k)
        else:
            assert ts[k] == v, k


def test_cpu_routed_run_launches_no_kernel():
    ops.reset_launch_counts()
    _run_routed("torch", n_chips=8, max_ticks=200,
                trace=lambda p: _learned_trace(p, 8))
    _run_routed("torch", n_chips=8, control="host", max_ticks=200,
                trace=lambda p: _learned_trace(p, 8))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_routed_world_constants_are_the_benchmarks():
    """test_torch_inputs' copy of the routed world is the reference
    benchmark's."""
    assert dataclasses.asdict(sr.PROFILE) == ROUTED_PROFILE
    assert dataclasses.asdict(sb.DECODE_PROFILE) == ROUTED_DECODE_PROFILE
    assert (sr.ERROR_BOUND, sr.LOG_SLOPE, sr.LOAD_SHIFT_V, sr.SEED,
            sr.CAPACITY, sr.WARMUP_ROUNDS) == (
        ROUTED_BOUND, ROUTED_LOG_SLOPE, ROUTED_LOAD_SHIFT_V, ROUTED_SEED,
        4, ROUTED_WARMUP)
    assert sr.POLICY_FLOORS == ROUTED_POLICY_FLOORS
    assert sr.ONSETS == ROUTED_ONSETS
    assert sr.SOR_CFG == jsor.SorConfig(rails=jtel.ALL_RAIL_OBSERVABLES,
                                        **ROUTED_SOR)
    for n in (64, 1024, 4096):
        kn = routed_trace_knobs(n)
        tt = ttraffic.bursty_trace(kn.pop("n_requests"), **kn)
        assert [dataclasses.astuple(r) for r in tt] == \
               [dataclasses.astuple(r) for r in ss._trace(n)]
    # serve_batching's forced-pin migration trace, at its own 16 chips
    kn = routed_migration_knobs(sb.MIG_CHIPS)
    tt = ttraffic.bursty_trace(kn.pop("n_requests"), **kn)
    scale = sb.MIG_CHIPS / sb.BASE_CHIPS * 4
    jt = jtraffic.bursty_trace(sb.MIG_REQUESTS, seed=sr.SEED,
                               quiet_rate_hz=8.0 * scale,
                               burst_rate_hz=40.0 * scale, decode_mean=96.0)
    assert [dataclasses.astuple(r) for r in tt] == \
           [dataclasses.astuple(r) for r in jt]


# -- the launcher ---------------------------------------------------------------

def _printed(out: str, key: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith(key + ": "))
    return ast.literal_eval(line[len(key) + 2:])


@pytest.mark.parametrize("flags", [
    ["--router", "headroom", "--batch-cap", "4"],
    ["--router", "headroom", "--migrate-after-ticks", "2"],
    ["--router", "roundrobin", "--tick-path", "loop"],
    ["--router", "headroom", "--fast-forward", "--trace-seed", "3"],
], ids=["headroom-batch4", "headroom-migrate", "roundrobin-loop",
        "headroom-fast-forward"])
def test_launcher_router_matches_reference(flags, capsys, monkeypatch):
    """`launch/serve.py --router ...` on the CPU prints the same trace
    record, SLO ledger summary and engine summary as the reference's
    launcher (the tiny configuration's parameter count sizes both
    profiles; the launcher world has no observables, so the trace is
    the same to the last bit)."""
    from repro.launch import serve as jlaunch
    argv = ["--arch", "qwen2p5_14b", "--tiny", "--fleet-chips", "8",
            "--trace-requests", "24", *flags]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jlaunch.main()
    ref = capsys.readouterr().out
    ops.reset_launch_counts()
    eng, ledger = tlaunch.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert out.splitlines()[0] == ref.splitlines()[0]
    for key in ("trace", "slo", "summary"):
        got, want = _printed(out, key), _printed(ref, key)
        assert got.keys() == want.keys(), key
        for k, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, rtol=ANALOG_RTOL,
                                           err_msg=f"{key}.{k}")
            else:
                assert got[k] == v, f"{key}.{k}"
    assert ledger.summary()["completed"] == 24


def test_launcher_refuses_bad_router_flags(capsys):
    """The reference launcher's argument checks, before any model is
    built."""
    for flags, msg in ((["--batch-cap", "2"], "--router"),
                       (["--fleet-chips", "4", "--router", "roundrobin",
                         "--migrate-after-ticks", "3"], "headroom"),
                       (["--batch-cap", "-1"], ">= 0"),
                       (["--migrate-after-ticks", "-1"], ">= 0")):
        with pytest.raises(SystemExit) as exc:
            tlaunch.main(["--arch", "qwen2p5_14b", "--tiny", "--device",
                          "cpu", *flags])
        assert exc.value.code == 2
        assert msg in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--fleet-chips"):
        tlaunch.main(["--arch", "qwen2p5_14b", "--tiny", "--device", "cpu",
                      "--router", "headroom"])
