"""Readings behind the split-fit tolerances of tests/test_torch_host.py on
the last window of the three-rail frontier world (8 chips, the window of
`test_split_fit_on_the_frontier_worlds_last_window`): which summation
order each implementation uses, and how far each order's uncentred and
centred solve lands from the exact (f64) fit and from the reference's split
fit. Prints one JSON object. Runs on the CPU:

    PYTHONPATH=src:tests python tests/sor_window_readings.py
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import torch

import test_torch_host as T
from repro.kernels import ops as jops
from repro.kernels import ref as jref

F32 = np.float32


def row_order(x, y, w, fma: bool):
    """The five sums row by row (K1's and K7's order); with `fma` the
    multiply is contracted into the add (one rounding, exact in f64)."""
    s = [np.zeros(x.shape[1], F32) for _ in range(5)]
    for a, b, c in zip(x, y, w):
        wx = c * a
        terms = ((c, None), (c, a), (c, b), (wx, a), (wx, b))
        for i, (p, q) in enumerate(terms):
            if q is None:
                s[i] = s[i] + p
            elif fma:
                s[i] = (p.astype(np.float64) * q + s[i]).astype(F32)
            else:
                s[i] = s[i] + p * q
    return s


def uncentred(s, bound):
    sw, sx, sy, sxx, sxy = s
    slope = (sw * sxy - sx * sy) / (sw * sxx - sx * sx)
    icpt = (sy - slope * sx) / sw
    return icpt, slope, (bound - icpt) / slope


def centred(x, y, w, s):
    """Two passes: the weighted means from the sums, then the centred sums
    in row order (not the reference's algorithm)."""
    mx, my = s[1] / s[0], s[2] / s[0]
    sxx, sxy = np.zeros_like(mx), np.zeros_like(mx)
    for a, b, c in zip(x, y, w):
        wdx = c * (a - mx)
        sxx, sxy = sxx + wdx * (a - mx), sxy + wdx * (b - my)
    slope = sxy / sxx
    return my - slope * mx, slope


def main():
    np.seterr(divide="ignore", invalid="ignore")   # unusable lanes
    hc, _ = T._learn(T.tcp, T.tpol, T.tsor, T.ttel, T.tpp, True, 8,
                     torch.from_numpy, T.TFleet.sample(8, seed=0))
    h, cfg = hc.sor_state.history, hc.sor
    x, y, w = (a.reshape(h.capacity, -1).numpy()
               for a in T.tsor._fit_inputs(h, cfg))
    usable = (hc.sor_state.estimate.confidence > 0).reshape(-1).numpy()
    bound = np.repeat(T.tsor._rail_bounds(cfg), 8).astype(F32)
    tx, ty, tw = (torch.from_numpy(a) for a in (x, y, w))
    jx, jy, jw = (jnp.asarray(a) for a in (x, y, w))
    orders = {
        "torch Tensor.sum (the port's plain version)": [
            a.numpy() for a in (tw.sum(0), (tw * tx).sum(0),
                                (tw * ty).sum(0), (tw * tx * tx).sum(0),
                                (tw * tx * ty).sum(0))],
        "row order (K1, K7)": row_order(x, y, w, fma=False),
        "row order with FMA": row_order(x, y, w, fma=True),
        "reference oracle, op by op": [
            np.asarray(a) for a in jref.sor_accumulate_reference(jx, jy, jw)],
        "reference ops.sor_accumulate, jitted (its split fit)": [
            np.asarray(a) for a in jops.sor_accumulate(jx, jy, jw)],
    }
    x64, y64, w64 = (a.astype(np.float64) for a in (x, y, w))
    exact = [w64.sum(0), (w64 * x64).sum(0), (w64 * y64).sum(0),
             (w64 * x64 * x64).sum(0), (w64 * x64 * y64).sum(0)]
    ex_icpt, ex_slope, ex_front = uncentred(exact, bound.astype(np.float64))
    ref_key = "reference ops.sor_accumulate, jitted (its split fit)"
    ref_fit = uncentred(orders[ref_key], bound)

    def rel(a, b):
        return float(np.max(np.abs(a - b)[usable] / np.abs(b)[usable]))

    out = {"window": list(x.shape), "usable_lanes": int(usable.sum()),
           "denom_over_sw_sxx": [
               float(np.min(((exact[0] * exact[3] - exact[1] ** 2)
                             / (exact[0] * exact[3]))[usable])),
               float(np.max(((exact[0] * exact[3] - exact[1] ** 2)
                             / (exact[0] * exact[3]))[usable]))],
           "orders": {}}
    for name, s in orders.items():
        icpt, slope, front = uncentred(s, bound)
        c_icpt, c_slope = centred(x, y, w, s)
        out["orders"][name] = dict(
            sums_equal_row_order=[bool(np.array_equal(a, b)) for a, b
                                  in zip(s, orders["row order (K1, K7)"])],
            sums_equal_reference_split=[
                bool(np.array_equal(a, b))
                for a, b in zip(s, orders[ref_key])],
            uncentred_vs_exact=dict(intercept=rel(icpt, ex_icpt),
                                    slope=rel(slope, ex_slope),
                                    frontier_v=float(np.max(np.abs(
                                        front - ex_front)[usable]))),
            uncentred_vs_reference_split=dict(
                intercept=rel(icpt, ref_fit[0]),
                slope=rel(slope, ref_fit[1]),
                frontier_v=float(np.max(np.abs(
                    front - ref_fit[2])[usable]))),
            centred_vs_exact=dict(intercept=rel(c_icpt, ex_icpt),
                                  slope=rel(c_slope, ex_slope)))
    rel_slope, rel_icpt, _, _ = T._solve_rtol(x, y, w)
    out["solve_rtol_bound"] = dict(
        slope=[float(rel_slope[usable].min()),
               float(rel_slope[usable].max())],
        intercept=[float(rel_icpt[usable].min()),
                   float(rel_icpt[usable].max())])
    # the whole split fit of both packages on this history (each computes
    # its own inputs: torch's and XLA's log10 differ in the last bit)
    jh = dataclasses.replace(
        T.jtel.FrameHistory.create(24, 8, rails=T.jtel.ALL_RAIL_OBSERVABLES),
        **{f: jnp.asarray(getattr(h, f).numpy())
           for f in ("v", "obs", "age_s", "polled", "valid")},
        cursor=jnp.int32(h.cursor), count=jnp.int32(h.count))
    jcfg = T.jsor.SorConfig(capacity=24, refresh_every=2, decay=0.96,
                            guard_v=0.004, max_extension_v=0.12,
                            rails=T.jtel.ALL_RAIL_OBSERVABLES)
    got = T.tsor.fit_history(h, cfg, fused=False)
    want = T.jsor.fit_history(jh, jcfg, fused=False)
    jy = np.asarray(T.jsor._fit_inputs(jh, jcfg)[1]).reshape(h.capacity, -1)
    out["fit_history_port_vs_reference"] = dict(
        y_inputs_equal=bool(np.array_equal(y, jy)),
        y_max_abs_diff=float(np.abs(y - jy).max()),
        **{f: rel(getattr(got, f).reshape(-1).numpy(),
                  np.asarray(getattr(want, f)).reshape(-1))
           for f in ("intercept", "slope", "v_frontier")})
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
