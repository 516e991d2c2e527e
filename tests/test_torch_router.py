"""The routed-serving pieces of the port against the reference on the CPU:
traffic traces (bit for bit), the routers' placement and migration plans
(equal, cursor included), the SLO ledger (lifecycle, guards, summary),
`rail_headroom` and its packed form, the pinned masks, `fleet_summary`,
`PowerPlaneState.fleet/chip` and the batched lane-rate model.

Inputs are seeded numpy. Tolerances: placements, plans, masks, traces and
ledger fields exactly; the plane's f32 elementwise values (headroom,
floors, lane times at b > 1) within PLANE_RTOL of the reference's, the
lane time at b = 1 bitwise `step_time_s`.
"""

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
from repro.core.hwspec import FleetSpec
from repro.serve import router as jrouter
from repro.serve import traffic as jtraffic
from repro_torch.core import control_plane as tcp
from repro_torch.core import policy as tpol
from repro_torch.core import power_plane as tpp
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from repro_torch.core.hwspec import FleetSpec as TFleet
from repro_torch.serve import router as trouter
from repro_torch.serve import traffic as ttraffic
from test_torch_inputs import ROUTED_PROFILE, ROUTED_SEED

PLANE_RTOL = 1e-6
RAILS = ("VDD_CORE", "VDD_HBM", "VDD_IO")


def _rows(trace):
    return [dataclasses.astuple(r) for r in trace]


# -- traffic ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2, 11, 23])
@pytest.mark.parametrize("knobs", [
    {},
    dict(quiet_rate_hz=8.0, burst_rate_hz=40.0, decode_mean=48.0),
    dict(quiet_rate_hz=128.0, burst_rate_hz=640.0, decode_mean=96.0,
         token_sigma=0.8),
    dict(mean_quiet_s=0.5, mean_burst_s=3.0, prefill_mean=4.0),
], ids=["default", "serve_router", "saturating", "long-bursts"])
def test_bursty_trace_bit_equal(seed, knobs):
    j = jtraffic.bursty_trace(64, seed, **knobs)
    t = ttraffic.bursty_trace(64, seed, **knobs)
    assert _rows(t) == _rows(j)
    assert t.metadata == j.metadata and t.seed == j.seed
    assert t.duration_s == j.duration_s
    assert t.total_decode_tokens == j.total_decode_tokens
    assert [r.decode_fraction for r in t] == [r.decode_fraction for r in j]


@pytest.mark.parametrize("kw", [dict(), dict(rate_hz=3.0, t_start_s=0.25,
                                              prefill_tokens=1,
                                              decode_tokens=7)])
def test_steady_trace_bit_equal(kw):
    assert _rows(ttraffic.steady_trace(10, **kw)) == \
           _rows(jtraffic.steady_trace(10, **kw))


def test_trace_refusals():
    for fn, args, kw in ((ttraffic.bursty_trace, (0,), {}),
                         (ttraffic.bursty_trace, (4,), dict(
                             quiet_rate_hz=0.0)),
                         (ttraffic.steady_trace, (0,), {}),
                         (ttraffic.steady_trace, (3,), dict(rate_hz=-1.0))):
        with pytest.raises(ValueError):
            fn(*args, **kw)


# -- placement -----------------------------------------------------------------

def _random_world(rng, n, capacity):
    """The reference tests' randomized mix: occupancy, headroom rounded to
    the mV (ties on purpose), ~30 % pinned, 1 to 3n requests."""
    occ = rng.integers(0, capacity + 1, n)
    headroom = {rail: np.round(rng.uniform(-0.02, 0.3, n), 3)
                for rail in RAILS}
    pinned = rng.random(n) < 0.3
    reqs = [(i, int(rng.integers(1, 64)), int(rng.integers(1, 128)))
            for i in range(int(rng.integers(1, 3 * n)))]
    return occ, headroom, pinned, reqs


def _requests(mod, reqs):
    return [mod.Request(rid=i, t_arrival_s=0.0, prefill_tokens=p,
                        decode_tokens=d) for i, p, d in reqs]


@pytest.mark.parametrize("trial", range(8))
def test_headroom_router_equals_reference(trial):
    """place (each request alone), place_batch and plan_migration (with
    an exclude mask) give the reference's chips on randomized worlds, for
    drain_pinned on and off."""
    rng = np.random.default_rng(100 + trial)
    for _ in range(6):
        n = int(rng.integers(1, 12))
        cap = int(rng.integers(1, 5))
        occ, headroom, pinned, reqs = _random_world(rng, n, cap)
        exclude = rng.random(n) < 0.2
        for drain in (True, False):
            j = jrouter.HeadroomRouter(capacity=cap, drain_pinned=drain)
            t = trouter.HeadroomRouter(capacity=cap, drain_pinned=drain)
            jr, tr = _requests(jtraffic, reqs), _requests(ttraffic, reqs)
            for a, b in zip(jr, tr):
                assert t.place(b, occ, headroom, pinned) == \
                    j.place(a, occ, headroom, pinned)
            assert t.place_batch(tr, occ, headroom, pinned) == \
                j.place_batch(jr, occ, headroom, pinned)
            assert t.plan_migration(tr, occ, headroom, pinned=pinned,
                                    exclude=exclude) == \
                j.plan_migration(jr, occ, headroom, pinned=pinned,
                                 exclude=exclude)


@pytest.mark.parametrize("trial", range(6))
def test_round_robin_router_equals_reference(trial):
    """place and place_batch from a random cursor give the reference's
    chips and leave the cursor where the reference's is."""
    rng = np.random.default_rng(200 + trial)
    for _ in range(8):
        n = int(rng.integers(1, 12))
        cap = int(rng.integers(1, 5))
        occ, headroom, pinned, reqs = _random_world(rng, n, cap)
        cursor = int(rng.integers(0, n))
        for batch in (False, True):
            j = jrouter.RoundRobinRouter(capacity=cap)
            t = trouter.RoundRobinRouter(capacity=cap)
            j._cursor = t._cursor = cursor
            jr, tr = _requests(jtraffic, reqs), _requests(ttraffic, reqs)
            if batch:
                assert t.place_batch(tr, occ) == j.place_batch(jr, occ)
            else:
                o_j, o_t = list(occ), list(occ)
                for a, b in zip(jr, tr):
                    cj, ct = j.place(a, o_j), t.place(b, o_t)
                    assert ct == cj
                    if cj is None:
                        break
                    o_j[cj] += 1
                    o_t[ct] += 1
            assert t._cursor == j._cursor
        t.reset()
        assert t._cursor == 0


def test_router_unit_invariants():
    """The reference's router unit tests on the port: capacity and the
    pinned drain, the token-mix weighting, the cursor's wrap, an empty
    queue, no eligible chip, and the planner's rules (deepest headroom,
    never pinned even with drain off, best effort)."""
    req = ttraffic.Request(rid=0, t_arrival_s=0.0, prefill_tokens=8,
                           decode_tokens=32)
    r = trouter.HeadroomRouter(capacity=2)
    h = {"VDD_HBM": np.array([0.02, 0.50]),
         "VDD_CORE": np.array([0.02, 0.50])}
    assert r.place(req, [0, 0], h, pinned=np.array([False, True])) == 0
    assert r.place(req, [2, 0], h, pinned=np.array([False, False])) == 1
    assert r.place(req, [2, 0], h, pinned=np.array([False, True])) is None
    assert r.place_batch([], [0, 0], h) == []
    mix = trouter.HeadroomRouter(capacity=4, occupancy_weight_v=0.0)
    h2 = {"VDD_HBM": np.array([0.30, 0.01]),
          "VDD_CORE": np.array([0.01, 0.30])}
    decode = dataclasses.replace(req, prefill_tokens=1, decode_tokens=99)
    prefill = dataclasses.replace(req, prefill_tokens=99, decode_tokens=1)
    assert mix.place(decode, [0, 0], h2) == 0
    assert mix.place(prefill, [0, 0], h2) == 1
    rr = trouter.RoundRobinRouter(capacity=1)
    assert [rr.place(req, o) for o in ([0, 0, 0], [1, 0, 0], [1, 1, 0],
                                       [1, 1, 1], [0, 1, 1])] == \
        [0, 1, 2, None, 0]
    plan = trouter.HeadroomRouter(capacity=4, drain_pinned=False)
    hh = {k: np.array([0.5, 0.1]) for k in RAILS}
    assert plan.plan_migration([req], np.array([0, 0]), hh,
                               pinned=np.array([True, False])) == [1]
    one = trouter.HeadroomRouter(capacity=1)
    hh = {k: np.array([0.1, 0.2]) for k in RAILS}
    assert one.plan_migration([req] * 3, np.array([1, 0]), hh) == \
        [1, None, None]
    assert not hasattr(trouter.RoundRobinRouter(capacity=2),
                       "plan_migration")
    for cls in (trouter.HeadroomRouter, trouter.RoundRobinRouter):
        with pytest.raises(ValueError, match="capacity"):
            cls(capacity=0)


# -- the SLO ledger --------------------------------------------------------------

def _drive_ledger(mod, traffic, rng):
    """The same seeded lifecycle on either package's ledger: admits,
    placements, defers by reason, migrations, charges, completions."""
    led = mod.RequestLedger()
    reqs = [traffic.Request(rid=i, t_arrival_s=float(i) * 0.1,
                        prefill_tokens=int(rng.integers(1, 32)),
                        decode_tokens=int(rng.integers(1, 64)))
            for i in range(24)]
    for r in reqs:
        led.admit(r)
    for r in reqs[:20]:
        if r.rid % 3 == 0:
            led.defer(r.rid, "capacity" if r.rid % 2 else "pinned-drain",
                      0.02)
        led.place(r.rid, r.t_arrival_s + 0.02 * (r.rid % 4), r.rid % 5)
        led.charge(r.rid, 0.5 + 0.01 * r.rid)
    for r in reqs[:20:4]:
        led.migrate(r.rid, 1.0, src=r.rid % 5, dst=(r.rid + 1) % 5,
                    stall_s=0.001 * r.decode_tokens, src_streak=6)
    for r in reqs[:16]:
        led.finish(r.rid, r.t_arrival_s + 0.3 + 0.01 * r.decode_tokens,
                   tokens_out=r.decode_tokens)
    led.tick_energy(123.25)
    led.tick_energy(0.5)
    return led


def test_ledger_equals_reference():
    j = _drive_ledger(jrouter, jtraffic, np.random.default_rng(5))
    t = _drive_ledger(trouter, ttraffic, np.random.default_rng(5))
    assert len(t) == len(j) == 24
    assert [dataclasses.astuple(r) for r in t.records()] == \
           [dataclasses.astuple(r) for r in j.records()]
    assert t.migration_events == j.migration_events
    assert t.defers_by_reason == j.defers_by_reason
    js, ts = j.summary(), t.summary()
    assert ts.keys() == js.keys()
    for k, v in js.items():
        assert ts[k] == v or (isinstance(v, float) and np.isnan(v)
                              and np.isnan(ts[k])), k
    assert t[3].chip == j[3].chip


@pytest.mark.parametrize("q", [0.0, 25.0, 50.0, 95.0, 99.0, 100.0])
def test_percentile_equals_reference(q):
    vals = list(np.random.default_rng(1).uniform(0, 3, 37))
    assert trouter.RequestLedger.percentile(vals, q) == \
        jrouter.RequestLedger.percentile(vals, q)
    assert trouter.RequestLedger.percentile(vals[:4], q) == \
        pytest.approx(float(np.percentile(vals[:4], q)))


def test_ledger_guards():
    """The lifecycle guards of the reference's ledger, with its messages;
    an empty ledger's percentiles are NaN."""
    led = trouter.RequestLedger()
    r = ttraffic.Request(rid=7, t_arrival_s=0.0, prefill_tokens=1,
                         decode_tokens=32)
    led.admit(r)
    with pytest.raises(ValueError, match="already admitted"):
        led.admit(r)
    with pytest.raises(ValueError, match="before placement"):
        led.finish(7, 1.0, tokens_out=4)
    with pytest.raises(ValueError, match="before placement"):
        led.migrate(7, 1.0, src=0, dst=1)
    led.place(7, 0.5, chip=2)
    with pytest.raises(ValueError, match="already placed"):
        led.place(7, 0.6, chip=1)
    with pytest.raises(ValueError, match="not the claimed source"):
        led.migrate(7, 1.0, src=0, dst=1)
    with pytest.raises(ValueError, match="source == destination"):
        led.migrate(7, 1.0, src=2, dst=2)
    led.finish(7, 2.0, tokens_out=32)
    with pytest.raises(ValueError, match="after completion"):
        led.migrate(7, 3.0, src=2, dst=1)
    with pytest.raises(ValueError, match="q must be"):
        trouter.RequestLedger.percentile([1.0], 101.0)
    s = trouter.RequestLedger().summary()
    assert s["completed"] == 0 and np.isnan(s["p99_latency_s"])


# -- headroom, pinning and the plane ----------------------------------------------

def _planes(n, seed):
    """The same `seed` FleetSpec fleet plane in both packages, its rails
    moved to seeded voltages around the rails' static floors."""
    rng = np.random.default_rng(seed)
    fs = FleetSpec.sample(n, seed=seed)
    v = {f: (lo + rng.uniform(-0.01, 0.1, n)).astype(np.float32)
         for f, lo in (("v_core", 0.60), ("v_hbm", 0.90), ("v_io", 0.65))}
    jp = dataclasses.replace(jpp.PowerPlaneState.from_fleet(fs),
                             **{f: jnp.asarray(a) for f, a in v.items()})
    tp = dataclasses.replace(
        tpp.PowerPlaneState.from_fleet(TFleet.sample(n, seed=seed), "cpu"),
        **{f: torch.from_numpy(a.copy()) for f, a in v.items()})
    return jp, tp


def _envelopes(n, seed):
    """Learned envelopes for the three rails from a seeded estimate (some
    lanes at zero confidence): both packages' {rail: SafeEnvelope}."""
    rng = np.random.default_rng(seed)
    est = [rng.normal(0, 1, (3, n)).astype(np.float32),
           rng.normal(30, 5, (3, n)).astype(np.float32),
           (np.array([0.6, 0.9, 0.65])[:, None]
            + rng.uniform(-0.03, 0.05, (3, n))).astype(np.float32),
           np.where(rng.random((3, n)) < 0.3, 0.0,
                    rng.uniform(0, 1, (3, n))).astype(np.float32),
           rng.uniform(0, 32, (3, n)).astype(np.float32)]
    jcfg = jsor.SorConfig(rails=jtel.ALL_RAIL_OBSERVABLES, guard_v=0.004,
                          max_extension_v=0.12)
    tcfg = tsor.SorConfig(rails=ttel.ALL_RAIL_OBSERVABLES, guard_v=0.004,
                          max_extension_v=0.12)
    return (jsor.rail_envelopes(jsor.SorEstimate(*map(jnp.asarray, est)),
                                jcfg),
            tsor.rail_envelopes(tsor.SorEstimate(*map(torch.from_numpy,
                                                      est)), tcfg))


@pytest.mark.parametrize("learned", [False, True], ids=["static", "learned"])
@pytest.mark.parametrize("n", [1, 5, 64])
def test_rail_headroom_equals_reference(n, learned):
    jp, tp = _planes(n, seed=n)
    je, te = _envelopes(n, seed=n) if learned else (None, None)
    jh, th = jrouter.rail_headroom(jp, je), trouter.rail_headroom(tp, te)
    assert list(th) == list(jh) == list(RAILS)
    for rail in RAILS:
        assert th[rail].dtype == np.float64 and th[rail].shape == (n,)
        np.testing.assert_allclose(th[rail], jh[rail], rtol=PLANE_RTOL,
                                   atol=1e-7, err_msg=rail)
    rows = (torch.stack([getattr(tp, f) for f in ("v_core", "v_hbm",
                                                  "v_io")])
            - tcp.rail_floors(tp, te)).numpy()
    packed = trouter.headroom_from_packed(rows)
    for rail in RAILS:
        np.testing.assert_array_equal(packed[rail], th[rail])


def _requests_for(n, seed):
    """A RailRequest on VDD_HBM and VDD_IO (VDD_CORE left alone): some
    chips want their floor or below, the rest above it."""
    rng = np.random.default_rng(seed)
    want = {f: (lo + rng.choice([-0.05, 0.0, 0.2], n)).astype(np.float32)
            for f, lo in (("v_hbm", 0.90), ("v_io", 0.65))}
    return (jpol.RailRequest(**{f: jnp.asarray(a) for f, a in want.items()},
                             reason="test"),
            tpol.RailRequest(**{f: torch.from_numpy(a.copy())
                                for f, a in want.items()}, reason="test"))


@pytest.mark.parametrize("learned", [False, True], ids=["static", "learned"])
def test_pinned_masks_equal_reference(learned):
    n = 24
    jp, tp = _planes(n, seed=3)
    # hold some chips at the static floors so the masks have both values
    for f, lo in (("v_hbm", 0.90), ("v_io", 0.65)):
        v = np.asarray(getattr(jp, f)).copy()
        v[::3] = np.float32(lo)
        jp = dataclasses.replace(jp, **{f: jnp.asarray(v)})
        tp = dataclasses.replace(tp, **{f: torch.from_numpy(v.copy())})
    je, te = _envelopes(n, seed=4) if learned else (None, None)
    jreq, treq = _requests_for(n, seed=5)
    want = np.asarray(jcp.pinned_lane_masks(jp, jreq, envelope=je))
    got = tcp.pinned_lane_masks(tp, treq, envelope=te)
    assert got.dtype == torch.bool and got.device == tp.device
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[0].any()                     # VDD_CORE left alone
    assert got[1:].any()
    np.testing.assert_array_equal(
        tcp.pinned_chip_mask(tp, treq, envelope=te),
        jcp.pinned_chip_mask(jp, jreq, envelope=je))
    np.testing.assert_array_equal(tcp.pinned_lane_masks(tp, None).numpy(),
                                  np.zeros((3, n), bool))
    assert not tcp.pinned_chip_mask(tp, None).any()


def test_fleet_summary_and_plane_constructors_equal_reference():
    fs = FleetSpec.sample(6, seed=ROUTED_SEED)
    tfs = TFleet.sample(6, seed=ROUTED_SEED)
    for jplane, tplane in ((jpp.PowerPlaneState.fleet(5),
                            tpp.PowerPlaneState.fleet(5, device="cpu")),
                           (jpp.PowerPlaneState.fleet(6, fs),
                            tpp.PowerPlaneState.fleet(6, tfs, "cpu"))):
        for f in dataclasses.fields(tpp.PowerPlaneState):
            a, b = getattr(tplane, f.name), np.asarray(getattr(jplane,
                                                               f.name))
            assert a.dtype == {"float32": torch.float32,
                               "int32": torch.int32}[str(b.dtype)]
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
        js, ts = jpp.fleet_summary(jplane), tpp.fleet_summary(tplane)
        assert ts.keys() == js.keys()
        for k in js:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                          err_msg=k)
        for i in (0, 4):
            jc, tc = jplane.chip(i), tplane.chip(i)
            assert not tc.is_fleet and tc.n_chips == 1
            for f in dataclasses.fields(tpp.PowerPlaneState):
                np.testing.assert_array_equal(
                    getattr(tc, f.name).numpy(),
                    np.asarray(getattr(jc, f.name)))
    with pytest.raises(ValueError, match="FleetSpec has 6"):
        tpp.PowerPlaneState.fleet(5, tfs, "cpu")
    with pytest.raises(ValueError, match="batched"):
        tpp.fleet_summary(tpp.PowerPlaneState.nominal(device="cpu"))
    scalar = tpp.PowerPlaneState.nominal(device="cpu")
    assert scalar.chip(0) is scalar
    with pytest.raises(IndexError):
        scalar.chip(1)


# -- the batched lane-rate model ---------------------------------------------------

def _terms(n=6):
    fs = FleetSpec.sample(n, seed=ROUTED_SEED)
    jplane = jpp.PowerPlaneState.from_fleet(fs)
    tplane = tpp.PowerPlaneState.from_fleet(TFleet.sample(n,
                                                          seed=ROUTED_SEED),
                                            "cpu")
    jprof, tprof = (jpp.StepProfile(**ROUTED_PROFILE),
                    tpp.StepProfile(**ROUTED_PROFILE))
    tvar = tpp.fleet_variation(TFleet.sample(n, seed=ROUTED_SEED), "cpu")
    return (jpp.step_terms(jprof, jplane, variation=fs.variation()),
            tpp.step_terms(tprof, tplane, variation=tvar),
            tpp.step_time_s(tprof, tplane, variation=tvar))


def test_lane_time_b1_bitwise_equals_step_time():
    """At b = 1 every scale factor is exactly 1.0f: the lane time is
    `step_time_s` on the same terms, bit for bit (lanes as ones, as
    zeros (clamped to 1) and as the Python number 1)."""
    _, tterms, t_step = _terms()
    for lanes in (torch.ones(6), torch.zeros(6), 1):
        lane = tpp.batched_lane_time_s(*tterms, lanes)
        assert torch.equal(lane, t_step)


@pytest.mark.parametrize("shares", [tpp.BatchShares(),
                                    tpp.BatchShares(0.1, 0.5, 0.0)],
                         ids=["default", "custom"])
def test_lane_time_equals_reference(shares):
    jterms, tterms, _ = _terms()
    lanes = np.array([1, 2, 3, 4, 8, 0], np.float32)
    jshares = jpp.BatchShares(**dataclasses.asdict(shares))
    want = np.asarray(jpp.batched_lane_time_s(*jterms, jnp.asarray(lanes),
                                              jshares))
    got = tpp.batched_lane_time_s(*tterms, torch.from_numpy(lanes), shares)
    np.testing.assert_allclose(got.numpy(), want, rtol=PLANE_RTOL)


def test_lane_time_monotone_and_shared_terms_free():
    tc, tm, tl = (torch.tensor(x) for x in (0.001, 0.010, 0.006))
    prev = None
    for b in (1, 2, 4, 8, 16):
        t = float(tpp.batched_lane_time_s(tc, tm, tl, b))
        if prev is not None:
            assert t > prev[1] and b / t > prev[0] / prev[1]
        prev = (b, t)
    free = tpp.BatchShares(flops=1.0, hbm=1.0, ici=1.0)
    assert float(tpp.batched_lane_time_s(tc, tm, tl, 1, free)) == \
        float(tpp.batched_lane_time_s(tc, tm, tl, 16, free)) == \
        pytest.approx(0.010)
