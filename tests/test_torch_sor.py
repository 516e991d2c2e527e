"""The SOR refit of the port (`core/sor.update_estimate`, K1's fused refit
`ops.sor_refit` and K7 on the ring, `ops.sor_accumulate_ring`) against
the composed tensor sequence it replaces and against the JAX reference, on
the CPU, over seeded history-ring states (`test_torch_inputs.ring_state`);
and a numpy model of the kernels' arithmetic in `csrc/sor_fit.cu` (the
ring's window inputs with the kernel's index arithmetic, row-order sums
without FMA, the solve, the blend)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sor as jsor
from repro.core import telemetry as jtel
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from repro_torch.kernels import fleet_telemetry as tft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_inputs import (RING_CASES, VIEW_OPS, OpNames, check_refit,
                               check_sums, ring_state)

F32 = np.float32
FIELDS = ("intercept", "slope", "v_frontier", "confidence", "n_eff")


def _configs(st):
    kw = dict(rails=jtel.ALL_RAIL_OBSERVABLES, **st["cfg"])
    return (jsor.SorConfig(**kw),
            tsor.SorConfig(**{**kw, "rails": ttel.ALL_RAIL_OBSERVABLES}))


def _histories(st):
    """Both packages' FrameHistory holding the ring state `st`."""
    cap, _, n = st["v"].shape
    bufs = {f: st[f] for f in ("v", "obs", "age_s", "polled", "valid")}
    jh = dataclasses.replace(
        jtel.FrameHistory.create(cap, n, rails=jtel.ALL_RAIL_OBSERVABLES),
        **{f: jnp.asarray(a) for f, a in bufs.items()},
        cursor=jnp.int32(st["cursor"]), count=jnp.int32(st["count"]))
    th = ttel.FrameHistory(**{f: torch.from_numpy(a.copy())
                              for f, a in bufs.items()},
                           cursor=st["cursor"], count=st["count"],
                           capacity=cap, rails=ttel.ALL_RAIL_OBSERVABLES)
    return jh, th


def _estimates(st):
    return (jsor.SorEstimate(*(jnp.asarray(a) for a in st["old"])),
            tsor.SorEstimate(*(torch.from_numpy(a.copy())
                               for a in st["old"])))


def _composed_update(old, hist, cfg):
    """The refit on cadence as the port composed it before K1's refit:
    `_fit_inputs`, K1's plain version on the flattened window with per-lane
    bounds and guards, then the blend as tensor code."""
    x, y, w = (a.reshape(hist.capacity, -1).contiguous()
               for a in tsor._fit_inputs(hist, cfg))
    lanes = hist.v.shape[1:]

    def full(a):
        return torch.from_numpy(a).reshape(-1, 1).expand(
            lanes).reshape(-1).contiguous()

    fit = tft.sor_fit_plain(x, y, w, full(tsor._rail_bounds(cfg)),
                            full(tsor._rail_guards(cfg)),
                            min_slope=cfg.min_slope,
                            min_spread_v=cfg.min_spread_v,
                            conf_samples=cfg.conf_samples)[:5]
    fit = tsor.SorEstimate(*(a.reshape(lanes) for a in fit))
    gain = torch.where(old.confidence > 0.0,
                       float(np.float32(cfg.update_gain)), 1.0)
    new_ok, old_ok = fit.confidence > 0.0, old.confidence > 0.0
    return tsor.SorEstimate(*(
        torch.where(new_ok, o + gain * (f - o), torch.where(old_ok, o, f))
        for o, f in ((getattr(old, k), getattr(fit, k)) for k in FIELDS)))


@pytest.mark.parametrize("case", RING_CASES)
def test_refit_plain_equals_the_composed_sequence(case):
    st = ring_state(case, 8)
    _, cfg = _configs(st)
    _, th = _histories(st)
    _, old = _estimates(st)
    got = tsor.update_estimate(old, th, cfg, fused=True)
    want = _composed_update(old, th, cfg)
    assert bool((want.confidence > 0).any())
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", RING_CASES)
def test_refit_matches_reference(case, fused):
    """Both refit paths against the reference's `update_estimate` on the
    same ring and old estimate."""
    st = ring_state(case, 8)
    jcfg, tcfg = _configs(st)
    jh, th = _histories(st)
    jold, told = _estimates(st)
    got = tsor.update_estimate(told, th, tcfg, fused=fused)
    want = jsor.update_estimate(jold, jh, jcfg, fused=fused)
    usable = np.asarray(want.confidence) > 0
    assert usable.any() and not usable.all()
    check_refit([getattr(got, f) for f in FIELDS],
                   [getattr(want, f) for f in FIELDS])


# -- a numpy model of the kernels' arithmetic --------------------------------

def model_inputs(st):
    """x, y, w [capacity, n] as `Ring::prepare` forms them: lane i = rail *
    n_chips + chip, age indexed by i % n_chips, rank (cursor - 1 - slot)
    wrapped once, the staleness division a multiply by the f32
    reciprocal."""
    cap, n_rails, n_chips = st["v"].shape
    n = n_rails * n_chips
    v, obs = st["v"].reshape(cap, n), st["obs"].reshape(cap, n)
    ok = st["valid"].reshape(cap, n)
    chip = np.arange(n) % n_chips
    decay, half = F32(0.92), st["cfg"]["age_halflife_s"]
    x, y, w = (np.zeros((cap, n), F32) for _ in range(3))
    with np.errstate(invalid="ignore"):
        for r in range(cap):
            rank = st["cursor"] - 1 - r
            rank += cap if rank < 0 else 0
            w[r] = np.power(decay, F32(rank)) * ok[r].astype(F32)
            if half is not None:
                inv = F32(1.0) / F32(half)
                w[r] = w[r] * np.power(F32(0.5), st["age_s"][r, chip] * inv)
            x[r] = np.where(ok[r], v[r], F32(0.0))
            y[r] = np.where(ok[r], np.clip(np.log10(
                np.maximum(obs[r], F32(1e-8))), F32(-8.0), F32(2.0)),
                F32(0.0))
    return x, y, w


def model_sums(x, y, w):
    """The five sums in row (slot) order, each product and add rounded on
    its own: `tile_sums`."""
    s = [np.zeros(x.shape[1], F32) for _ in range(5)]
    for xr, yr, wr in zip(x, y, w):
        wx = wr * xr
        for q, term in enumerate((wr, wx, wr * yr, wx * xr, wx * yr)):
            s[q] = s[q] + term
    return s


def model_refit(sums, old, bound_lanes, gain):
    """`ewls_solve` then the blend of `sor_refit_kernel`, in f32."""
    sw, sx, sy, sxx, sxy = sums
    eps = F32(1e-9)
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = sw * sxx - sx * sx
        slope = (sw * sxy - sx * sy) / np.maximum(denom, eps)
        sw_safe = np.maximum(sw, eps)
        intercept = (sy - slope * sx) / sw_safe
        mean_x = sx / sw_safe
        var_x = np.maximum(sxx / sw_safe - mean_x * mean_x, F32(0.0))
        usable = ((slope < F32(-0.5)) & (var_x > F32(2e-3) * F32(2e-3))
                  & (denom > eps))
        front = np.clip(np.where(usable, (bound_lanes - intercept) / slope,
                                 F32(0.0)), F32(0.0), F32(2.0))
        conf = np.where(usable, F32(1.0) - np.exp(
            -sw * (F32(1.0) / F32(8.0))), F32(0.0)).astype(F32)
    fit = (np.where(usable, intercept, F32(0.0)),
           np.where(usable, slope, F32(0.0)), front, conf, sw)
    new_ok, old_ok = conf > 0, old[3] > 0
    g = np.where(old_ok, F32(gain), F32(1.0))
    return [np.where(new_ok, o + g * (f - o), np.where(old_ok, o, f))
            for o, f in zip(old, fit)]


def _lane_bounds(cfg, n_chips):
    return np.repeat(tsor._rail_bounds(cfg), n_chips)


@pytest.mark.parametrize("case", RING_CASES)
def test_kernel_model_inputs_match_plain(case):
    """The kernel's index arithmetic (slot rank, lane to chip, the staleness
    weight) forms the window of `ref.sor_fit_inputs`: x exactly, y and w
    to a few ulps (numpy's and torch's log10 and pow round apart)."""
    st = ring_state(case, 8)
    _, cfg = _configs(st)
    _, th = _histories(st)
    got = model_inputs(st)
    want = [a.reshape(th.capacity, -1).numpy()
            for a in tsor._fit_inputs(th, cfg)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2] > 0, want[2] > 0)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("capacity", [16, 32])
@pytest.mark.parametrize("case", ["mid", "partial", "nan_lanes", "aged"])
def test_kernel_model_sums_in_slot_order(case, capacity):
    """The model's row-order sums on the plain version's window against the
    plain sums, at the serve path's 3 x 64 lanes: bit for bit at 16 slots,
    where `Tensor.sum` on the CPU takes the rows of a 192-lane window in
    order; past 16 it blocks them, and the orders agree to SUM_TOL."""
    st = ring_state(case, 64, capacity=capacity)
    _, cfg = _configs(st)
    _, th = _histories(st)
    x, y, w = (a.reshape(capacity, -1) for a in tsor._fit_inputs(th, cfg))
    got = model_sums(x.numpy(), y.numpy(), w.numpy())
    want = [a.numpy() for a in tref.sor_accumulate_reference(x, y, w)]
    if capacity <= 16:
        for q, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b, err_msg=str(q))
    check_sums(got, want)


@pytest.mark.parametrize("case", RING_CASES)
def test_kernel_model_matches_plain_and_reference(case):
    """The whole model of K1's refit against the plain refit and the JAX
    reference's `update_estimate`."""
    st = ring_state(case, 8)
    jcfg, tcfg = _configs(st)
    jh, th = _histories(st)
    jold, told = _estimates(st)
    n_chips = st["v"].shape[2]
    got = model_refit(model_sums(*model_inputs(st)),
                      [a.reshape(-1) for a in st["old"]],
                      _lane_bounds(tcfg, n_chips), st["cfg"]["update_gain"])
    plain = tsor.update_estimate(told, th, tcfg, fused=True)
    want = jsor.update_estimate(jold, jh, jcfg, fused=True)
    check_refit(got, [getattr(plain, f).reshape(-1) for f in FIELDS])
    check_refit(got, [np.asarray(getattr(want, f)).reshape(-1)
                         for f in FIELDS])


# -- what a refit runs ----------------------------------------------------------

def test_fused_refit_is_one_kernel_call_and_views(monkeypatch):
    """`update_estimate(fused=True)` hands the ring's buffers, the old
    estimate and the cached per-rail bounds to `ops.sor_refit` and does
    nothing else but take views: no input preparation, no blend, no copy
    from the host (on the card: one launch, no stream sync)."""
    st = ring_state("old_conf", 8)
    _, cfg = _configs(st)
    _, th = _histories(st)
    _, old = _estimates(st)
    want = tsor.update_estimate(old, th, cfg, fused=True)   # primes the bounds
    out = [getattr(want, f).reshape(3, -1) for f in FIELDS]
    calls = []

    def sor_refit(*args, **kwargs):
        calls.append((args, kwargs))
        return out

    monkeypatch.setattr(tsor.ops, "sor_refit", sor_refit)
    with OpNames() as rec:
        got = tsor.update_estimate(old, th, cfg, fused=True)
    assert len(calls) == 1
    assert set(rec.names) <= VIEW_OPS, rec.names
    (v, obs, valid, age_s, old_fields, bound), kw = calls[0]
    assert v.data_ptr() == th.v.data_ptr() and v.shape == (32, 3, 8)
    assert valid.dtype == torch.bool and age_s.shape == (32, 8)
    assert bound is tsor._rail_consts(cfg, th.v.device)[0]
    assert kw["cursor"] == th.cursor and kw["update_gain"] == 1.0
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f))


def test_split_refit_reads_the_ring_in_k7(monkeypatch):
    """`fit_history(fused=False)` hands the ring to `ops.sor_accumulate_ring`
    (K7): no tensor op forms the window (no arange, remainder, log10), and
    nothing is copied from the host; the solve follows as tensor code."""
    st = ring_state("aged", 8)
    _, cfg = _configs(st)
    _, th = _histories(st)
    sums = tops.sor_accumulate_ring(*tsor._ring(th), cursor=th.cursor,
                                    decay=cfg.decay,
                                    age_halflife_s=cfg.age_halflife_s)
    want = tsor.fit_history(th, cfg, fused=False)        # primes the bounds
    calls = []

    def sor_accumulate_ring(*args, **kwargs):
        calls.append(kwargs)
        return sums

    monkeypatch.setattr(tsor.ops, "sor_accumulate_ring", sor_accumulate_ring)
    with OpNames() as rec:
        got = tsor.fit_history(th, cfg, fused=False)
    assert calls == [dict(cursor=th.cursor, decay=cfg.decay,
                          age_halflife_s=cfg.age_halflife_s)]
    assert not set(rec.names) & {"arange", "remainder", "log10", "full",
                                 "_to_copy", "copy_", "lift_fresh"}, rec.names
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f))


def test_rail_bounds_are_built_once_per_config_and_device():
    cfg = tsor.SorConfig(rails=ttel.ALL_RAIL_OBSERVABLES)
    a = tsor._rail_consts(cfg, torch.device("cpu"))
    assert a is tsor._rail_consts(cfg, torch.device("cpu"))
    np.testing.assert_array_equal(a[0].numpy(), tsor._rail_bounds(cfg))
    np.testing.assert_array_equal(a[1].numpy(), tsor._rail_guards(cfg))


def test_ring_wrappers_reject_other_devices():
    st = ring_state("mid", 4)
    v, obs, age = (torch.from_numpy(st[k]).to("meta")
                   for k in ("v", "obs", "age_s"))
    valid = torch.from_numpy(st["valid"]).to("meta")
    kw = dict(cursor=st["cursor"], decay=0.92, age_halflife_s=None)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tft.sor_accumulate_ring(v, obs, valid, age, **kw)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tft.sor_refit(v, obs, valid, age, [v[0]] * 5, v[0, :, 0],
                      update_gain=1.0, min_slope=0.5, min_spread_v=2e-3,
                      conf_samples=8.0, **kw)
