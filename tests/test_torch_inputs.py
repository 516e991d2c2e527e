"""Seeded numpy inputs and the SOR-fit and fleet-tail comparisons shared by
the port's test files (tests/test_torch_kernels.py, test_torch_rwkv6.py,
test_torch_zamba2.py, test_torch_ecollectives.py, test_torch_sor.py,
test_torch_fleet_stats.py on the CPU; test_torch_kernels_cuda.py and
chip_smoke.py on the card). It holds no tests and imports no
JAX."""

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

SOR_KW = dict(min_slope=0.5, min_spread_v=2e-3, conf_samples=8.0)
# SOR fit: the uncentred EWLS solve cancels digits (denom = sw*sxx - sx^2),
# so analog outputs agree to ~1e-5 relative, not bitwise; masks exactly
SOR_TOL = dict(rtol=1e-4, atol=1e-6)


def qkv(B, T, S, Hq, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Hq, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32))


def rwkv_inputs(B, T, H, Dh, seed, state=True):
    """r, k, v ~ N(0, 1); w = -exp(N(-1, 1)), the log-decay (decays spread
    over (0, 1), most near exp(-exp(-1)) = 0.69); u ~ N(0, 0.5); an
    N(0, 1) initial state, or None."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, Dh)).astype(np.float32)
               for _ in range(3))
    w = -np.exp(rng.normal(-1.0, 1.0, (B, T, H, Dh))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, Dh))).astype(np.float32)
    s0 = (rng.standard_normal((B, H, Dh, Dh)).astype(np.float32)
          if state else None)
    return r, k, v, w, u, s0


def mamba2_inputs(Bt, T, H, G, N, seed, state=True, P=64):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)) (step sizes in (0, ~4));
    A = -exp(N(0, 1)) (decays exp(dt * A) spread over (0, 1)); D ~ N(0, 1);
    an N(0, 1) initial state [Bt,H,N,P], or None."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, T, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((Bt, T, H)), 0.0).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    B, C = (rng.standard_normal((Bt, T, G, N)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    s0 = (rng.standard_normal((Bt, H, N, P)).astype(np.float32)
          if state else None)
    return x, dt, A, B, C, D, s0


def rwkv_adversarial_w(w, seed):
    """w with head 0 at -3 every step (sum |w| 192 over a 64-step chunk)
    and head 1 at -40 on ~30 % of steps, -1e-3 on the rest (decays near 1
    between them): past the ~88 at which the factorised form's e^{-W}
    overflows f32. The other heads keep their draws."""
    rng = np.random.default_rng(seed)
    w = w.copy()
    w[:, :, 0] = -3.0
    w[:, :, 1] = np.where(rng.random(w.shape[:2] + w.shape[3:]) < 0.3,
                          -40.0, -1e-3).astype(np.float32)
    return w


def mamba2_adversarial_decay(dt, A):
    """dt and A with dt * A = -64 every step on head 0 (each step's decay
    e^-64; a cumulative sum reaches -16384 over 256 steps) and A = -1e-3
    on head 1 (decays near 1). The other heads keep their draws."""
    dt, A = dt.copy(), A.copy()
    A[0], A[1] = -16.0, -1e-3
    dt[..., 0] = 4.0
    return dt, A


def bf16_round(a):
    """f32 -> the nearest bf16 (ties to even), returned as f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def bf16_split(a, n: int):
    """f32 a as n bf16 terms, largest first, each the rounding of what the
    earlier ones left (the scan kernels' `split_bf16`)."""
    terms = []
    a = np.asarray(a, np.float32)
    for _ in range(n):
        t = bf16_round(a)
        terms.append(t)
        a = (a - t).astype(np.float32)
    return terms


def codec_input(n: int, seed: int, block: int = 256):
    """n N(0, 1) values f32, each block scaled by 10^U(-6, 1) (the spread of
    gradient magnitudes across a model's leaves), with one all-zero block
    where n allows (its scale is 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    nb = -(-n // block)
    mag = 10.0 ** rng.uniform(-6.0, 1.0, nb)
    x = (x * np.repeat(mag, block)[:n]).astype(np.float32)
    if nb > 2:
        x[block:2 * block] = 0.0
    return x


def codec_ties(block: int = 256):
    """One block whose absmax is 127, so its scale is exactly 1 and every
    x / scale below is an exact .5 tie (rounded half to even)."""
    ties = np.arange(-126.5, 126.0, 1.0, dtype=np.float32)
    x = np.resize(ties, block).astype(np.float32)
    x[0] = 127.0
    return x


def ef_inputs(case: str, seed: int = 0, n: int = 0):
    """(g, r) f32 for one leaf of the fused ef pass: g from `codec_input`, r
    ~ 1e-2 N(0, 1). 'ragged' (1000 elements, a tail past the last full
    block, or n); 'zeros' an all-zero block of g + r; 'nan' a NaN in g;
    'ties' g on a grid of quarters and r zero, so a block's magnitudes
    repeat at the top-k threshold (every tie is kept)."""
    rng = np.random.default_rng(seed)
    n = n or {"ragged": 1000, "zeros": 1024, "nan": 768, "ties": 512}[case]
    g = codec_input(n, seed=seed + 1)
    r = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    if case == "zeros":
        g[256:512], r[256:512] = 0.0, 0.0
    if case == "nan":
        g[300] = np.nan
    if case == "ties":
        g = np.round(rng.standard_normal(n) * 4).astype(np.float32) / 4
        r[:] = 0.0
    return g, r


def sor_inputs(window: int, n: int, seed: int):
    """A window with a real log-linear frontier (slope -30 dex/V) on two
    lanes in three and a flat observable on the rest; recency weights with
    some invalid (zero-weight) samples."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.6, 0.95, (window, n)).astype(np.float32)
    steep = (np.arange(n) % 3 != 2).astype(np.float32)
    y = (-3.0 - 30.0 * steep * (x - 0.7)
         + 0.05 * rng.standard_normal((window, n))).astype(np.float32)
    rank = np.arange(window)[::-1, None].astype(np.float32)
    w = (0.92 ** rank * (rng.uniform(size=(window, n)) > 0.1)).astype(
        np.float32)
    bound = np.full((n,), np.log10(5e-3), np.float32)
    guard = np.full((n,), 0.01, np.float32)
    return x, y, w, bound, guard


def accumulate_inputs(window: int, n: int, seed: int):
    """`sor_inputs`' (x, y, w) with two whole rows at zero weight, as the
    unfilled slots of a history ring carry."""
    x, y, w, _, _ = sor_inputs(window, n, seed)
    w[[0, window // 2]] = 0.0
    return x, y, w


# the five EWLS sums in another order: within 1e-6 of the largest |sum| of
# each output (f32 sums of 32 terms of O(1) magnitude)
SUM_TOL = 1e-6


def check_sums(got, want):
    names = ("sw", "sx", "sy", "sxx", "sxy")
    assert len(got) == len(want) == 5
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, name
        scale = max(float(np.abs(b).max()), 1.0)
        assert float(np.abs(a - b).max()) <= SUM_TOL * scale, name


def check_refit(got, want):
    """The five new estimate fields of a refit (intercept, slope,
    v_frontier, confidence, n_eff): confidence > 0 masks exactly, each
    field at SOR_TOL."""
    got, want = [np.asarray(a) for a in got], [np.asarray(a) for a in want]
    np.testing.assert_array_equal(got[3] > 0, want[3] > 0)
    for name, a, b in zip(("intercept", "slope", "v_frontier", "confidence",
                           "n_eff"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **SOR_TOL)


def check_sor(got, want):
    """Usable masks exactly, the six analog outputs at SOR_TOL."""
    names = ("intercept", "slope", "v_frontier", "confidence", "n_eff",
             "floor")
    np.testing.assert_array_equal(np.asarray(got[3]) > 0,
                                  np.asarray(want[3]) > 0)
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=name, **SOR_TOL)


# the fleet step's reduction tail (`fleet_stats`): the chip counts it is
# held at (the step's 64 and its neighbours, both sides of the kernel's
# rank-counting limit of 128, one past a CTA's one-pass 8192), and its input
# cases: 'ties' puts the p95's ranks in runs of equal values, 'nan_*' a NaN
# in that field, 'no_conf' the step without the SOR
FLEET_SIZES = (1, 2, 63, 64, 65, 128, 129, 1000, 4096, 20000)
FLEET_CASES = ("plain", "ties", "nan_t_chip", "nan_err", "nan_v_io",
               "no_conf")
# the tail's means are sums in another order than torch's: f32 sums of up
# to 20000 positive terms
FLEET_SUM_RTOL = 1e-5


def fleet_inputs(n: int, case: str = "plain", seed: int = 0):
    """(power_w, t_chip_s, grad_error, energy_step_j, v_io, straggle, conf)
    of an n-chip fleet step, numpy: [n] f32 fields, ~5 % stragglers
    ([n] bool, their step 1.5x), conf [3, n] f32 with a third of its lanes
    unlearned (0; None for 'no_conf'). 'ties': t_chip_s at two levels (a
    synchronous fleet's step times) and grad_error on a grid of 1e-3."""
    rng = np.random.default_rng(seed + n)
    power = rng.uniform(150.0, 250.0, n).astype(np.float32)
    straggle = rng.uniform(size=n) < 0.05
    t_chip = (rng.uniform(0.45, 0.55, n)
              * np.where(straggle, 1.5, 1.0)).astype(np.float32)
    err = (1e-3 * np.exp(rng.standard_normal(n))).astype(np.float32)
    v_io = rng.uniform(0.6, 0.8, n).astype(np.float32)
    conf = rng.uniform(size=(3, n)).astype(np.float32)
    conf[rng.uniform(size=(3, n)) < 1 / 3] = 0.0
    if case == "ties":
        t_chip = np.where(straggle, 0.75, 0.5).astype(np.float32)
        err = (np.round(rng.uniform(0.0, 4.0, n)) * 1e-3).astype(np.float32)
    energy = (power * t_chip).astype(np.float32)
    nan_at = {"nan_t_chip": (t_chip, n // 2), "nan_err": (err, n // 3),
              "nan_v_io": (v_io, n - 1)}
    if case in nan_at:
        field, i = nan_at[case]
        field[i] = np.nan
    return (power, t_chip, err, energy, v_io, straggle,
            None if case == "no_conf" else conf)


def check_fleet_stats(got, want, rtol: float) -> float:
    """The fleet tail's {key: 0-d value}: the same keys in the same order;
    every mean (a sum in another order) within `rtol`, every other value
    (max, min, the p95s, the straggler fraction) equal; NaN where the other
    has NaN. Returns the largest |difference| of the means."""
    assert list(got) == list(want), (list(got), list(want))
    gap = 0.0
    for key in want:
        a, b = (np.float32(np.asarray(v[key])) for v in (got, want))
        if key.endswith("_mean"):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=key)
            if not np.isnan(b):
                gap = max(gap, float(abs(a - b)))
        else:
            assert (a == b) or (np.isnan(a) and np.isnan(b)), (key, a, b)
    return gap


# the SOR history ring states a refit is held at: the cursor at 0, mid-ring
# and just wrapped; a partly filled ring; whole NaN lanes; staleness
# weighting; a half update gain; an old estimate with confidence
RING_CASES = ("cursor0", "mid", "wrapped", "partial", "nan_lanes", "aged",
              "gain_half", "old_conf")
RING_BOUND = 5e-3       # SorConfig's default error bound
RING_RAILS = 3          # ALL_RAIL_OBSERVABLES


def ring_state(case: str, n_chips: int, capacity: int = 32, seed: int = 0):
    """A three-rail history ring as `FrameHistory.push` leaves it, made from
    a numpy seed: a voltage sweep of ~0.27 V around each (rail, chip)
    lane's frontier, log-linear observables (30 dex/V) with 5 % lost
    samples (NaN, invalid), VDD_HBM flat on every other chip (never
    learns); the sweep is wide enough that the uncentred f32 solve keeps
    the packages' sum orders within SOR_TOL of each other (ROADMAP.md,
    "Known disagreements"). `case` (RING_CASES) sets the push count (so
    the cursor), whole
    NaN lanes, ages, the update gain and the old estimate. Returns a dict:
    v, obs, valid [capacity, 3, n_chips], age_s, polled [capacity,
    n_chips], cursor, count, old (five [3, n_chips] f32: intercept, slope,
    v_frontier, confidence, n_eff) and the SorConfig keywords
    (`capacity`, `age_halflife_s`, `update_gain`)."""
    rng = np.random.default_rng(seed + 1000 * n_chips + 7 * capacity
                                + RING_CASES.index(case))
    count = {"cursor0": 2 * capacity, "mid": capacity + capacity // 2,
             "wrapped": capacity + 1, "partial": 12}.get(
                 case, capacity + capacity // 3)
    shape = (RING_RAILS, n_chips)
    onsets = rng.uniform(0.62, 0.72, shape).astype(np.float32)
    v = np.zeros((capacity,) + shape, np.float32)
    obs = np.zeros_like(v)
    age = np.zeros((capacity, n_chips), np.float32)
    aged = case == "aged"
    for t in range(count):
        slot = t % capacity
        v[slot] = (onsets + 0.2 - 0.03 * (t % 10)
                   + 0.01 * rng.standard_normal(shape)).astype(np.float32)
        o = (RING_BOUND * 10.0 ** np.clip(30.0 * (onsets - v[slot]), -6.0,
                                          3.0)
             * np.exp(0.05 * rng.standard_normal(shape)))
        o[rng.uniform(size=shape) < 0.05] = np.nan
        o[1, ::2] = RING_BOUND
        obs[slot] = o.astype(np.float32)
        if aged:
            a = rng.uniform(0.0, 0.1, n_chips).astype(np.float32)
            a[rng.uniform(size=n_chips) < 0.1] = np.inf    # unknown age
            age[slot] = a
    if case == "nan_lanes":
        obs[:, 0, 1::5] = np.nan
        obs[:, 2, 3::7] = np.nan
    valid = np.isfinite(v) & np.isfinite(obs)
    valid[count:] = False
    old = [np.zeros(shape, np.float32) for _ in range(5)]
    if case in ("gain_half", "old_conf"):    # an earlier fit of the lanes
        learned = rng.uniform(size=shape) < 0.6
        jitter = 1.0 + 0.02 * rng.standard_normal((5,) + shape)
        old = [np.where(learned, a * j, 0.0).astype(np.float32)
               for a, j in zip((np.log10(RING_BOUND) + 30.0 * onsets,
                                np.full(shape, -30.0), onsets,
                                rng.uniform(0.3, 0.95, shape),
                                rng.uniform(4.0, 9.0, shape)), jitter)]
    return dict(v=v, obs=obs, valid=valid, age_s=age,
                polled=np.zeros((capacity, n_chips), np.float32),
                cursor=count % capacity, count=count, old=old,
                cfg=dict(capacity=capacity,
                         age_halflife_s=0.05 if aged else None,
                         update_gain=0.5 if case == "gain_half" else 1.0))


class OpNames(TorchDispatchMode):
    """Records the name of every aten op dispatched inside it (`view`,
    `empty`, `log10`, ...)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


# the aten ops that only take a view of a tensor
VIEW_OPS = {"view", "_unsafe_view", "alias", "unbind", "select", "expand",
            "slice", "unsqueeze"}


# ---------------------------------------------------------------------------
# The routed-serving world: the reference's serve_router benchmark world
# (benchmarks/serve_router.py, serve_scale.py, serve_batching.py), its
# constants copied so that this file imports no JAX. The benchmark draws
# each tick's observable noise with jax.random; the port cannot reproduce
# those draws, so both packages read one numpy table made from a seed
# (`routed_noise`) and index it by tick: rows [0, ROUTED_WARMUP) are the
# warm-up rounds (ticks -ROUTED_WARMUP .. -1), row ROUTED_WARMUP + t the
# trace's tick t.
# ---------------------------------------------------------------------------

ROUTED_PROFILE = dict(flops_per_chip=2e12, hbm_bytes_per_chip=8e9,
                      ici_bytes_per_chip=4e9, grad_bytes_per_chip=3e9)
# serve_batching's decode-shaped profile: FLOPs at the decode ratio
ROUTED_DECODE_PROFILE = dict(ROUTED_PROFILE, flops_per_chip=8e10)
ROUTED_BOUND = 5e-3
ROUTED_LOG_SLOPE = 30.0     # decades of error per volt below the onset
ROUTED_LOAD_SHIFT_V = 0.025
ROUTED_SEED = 23
ROUTED_CAPACITY = 4
ROUTED_POLICY_FLOORS = {"VDD_CORE": 0.652, "VDD_HBM": 0.995,
                        "VDD_IO": 0.725}
ROUTED_ONSETS = {"VDD_CORE": (0.635, 0.05), "VDD_HBM": (0.935, 0.05),
                 "VDD_IO": (0.665, 0.05)}
ROUTED_WARMUP = 48
ROUTED_SOR = dict(capacity=32, refresh_every=4, decay=0.96,
                  error_bound=ROUTED_BOUND, guard_v=0.004,
                  max_extension_v=0.12, ingest="frames")
# the noise table's rows per tick, in this order
ROUTED_NOISE_RAILS = ("VDD_IO", "VDD_CORE", "VDD_HBM")


def routed_trace_knobs(n_chips: int, base_chips: int = 64) -> dict:
    """serve_scale's weak-scaled load: int(1.5 n) requests, seed 23, quiet
    and burst rates 8 and 40 Hz times n / base_chips, decode mean 48."""
    scale = n_chips / base_chips
    return dict(n_requests=int(1.5 * n_chips), seed=ROUTED_SEED,
                quiet_rate_hz=8.0 * scale, burst_rate_hz=40.0 * scale,
                decode_mean=48.0)


def routed_migration_knobs(n_chips: int, base_chips: int = 64) -> dict:
    """serve_batching's forced-pin migration scenario weak-scaled from its
    16 chips: 6 requests a chip, quiet and burst rates 4 x 8 and 4 x 40 Hz
    times n / base_chips (saturating), decode mean 96."""
    scale = 4.0 * n_chips / base_chips
    return dict(n_requests=6 * n_chips, seed=ROUTED_SEED,
                quiet_rate_hz=8.0 * scale, burst_rate_hz=40.0 * scale,
                decode_mean=96.0)


def routed_noise(n_chips: int, ticks: int, seed: int = ROUTED_SEED,
                 warmup: int = ROUTED_WARMUP) -> np.ndarray:
    """The observables' multiplicative noise, 1 + 0.05 N(0, 1), as f32
    `[warmup + ticks, 3, n_chips]` (rows per tick in ROUTED_NOISE_RAILS
    order)."""
    z = np.random.default_rng(seed).standard_normal(
        (warmup + ticks, len(ROUTED_NOISE_RAILS), n_chips))
    return (1.0 + 0.05 * z).astype(np.float32)


def routed_onset_sources(fs) -> dict:
    """{rail: [n_chips] float64}: the FleetSpec arrays each rail's onset
    rides (VDD_CORE the leakage spread, VDD_HBM and VDD_IO the error
    sensitivity); onset = base + spread * (f32(src) - 1), in f32."""
    return {rail: np.asarray(fs.leakage_scale if rail == "VDD_CORE"
                             else fs.error_sensitivity)
            for rail in ROUTED_ONSETS}


ROUTED_CONTROLS = ("learned", "static", "host")


def routed_engine(n_chips: int, device, *, params, cfg, router,
                  decode_profile=None, control: str = "learned", **kw):
    """The port's engine in the routed world: the 23-seeded FleetSpec and
    the envelope-blind walk over POLICY_FLOORS with backoff 1.01, which
    learns through the in-graph SOR round (`control="learned"`), runs
    without learning (`"static"`: the floors stay the rails' static ones),
    or runs in a HostRailController deciding from the frames and learning
    with the split fit (`"host"`); the benchmark's prefill profile and
    `decode_profile` (default the same)."""
    if control not in ROUTED_CONTROLS:
        raise ValueError(f"control must be one of {ROUTED_CONTROLS}")
    from repro_torch.core import sor
    from repro_torch.core.control_plane import (HostRailController,
                                                InGraphRailController)
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES
    from repro_torch.serve.engine import ServeEngine
    fs = FleetSpec.sample(n_chips, seed=ROUTED_SEED)
    walk = envelope_blind_walk()
    cfg_sor = sor.SorConfig(rails=ALL_RAIL_OBSERVABLES, **ROUTED_SOR)
    ctrl = (HostRailController(walk, n_chips=n_chips, sor=cfg_sor)
            if control == "host" else InGraphRailController(
                walk, sor=cfg_sor if control == "learned" else None))
    profile = StepProfile(**ROUTED_PROFILE)
    return ServeEngine(cfg, params, max_len=24, batch_size=2,
                       prefill_profile=profile,
                       decode_profile=decode_profile or profile,
                       fleet=fs, controller=ctrl, router=router,
                       device=device, **kw)


def envelope_blind_walk():
    """The port's MultiRailClosedLoop walking to ROUTED_POLICY_FLOORS with
    backoff 1.01 that ignores the envelopes when it decides (arbitration
    still clamps per chip, so weak chips pin at their learned floors)."""
    from repro_torch.core.policy import MultiRailClosedLoop

    class EnvelopeBlindWalk(MultiRailClosedLoop):
        def decide_env(self, state, frame, envelope=None):
            return super().decide_env(state, frame, None)

    return EnvelopeBlindWalk(floors=dict(ROUTED_POLICY_FLOORS),
                             backoff=1.01, name="envelope-blind-walk")


def routed_observe(fs, noise: np.ndarray, device):
    """The port's measured error world for `serve_trace`: per-rail
    frontier errors at onsets that move up with the chip's load
    (busy_frac) on VDD_HBM and VDD_IO, the noise read from `noise`
    (`routed_noise`), which goes to the device once here."""
    import dataclasses

    import torch
    table = torch.from_numpy(noise).to(device)
    v_on = {}
    for rail, src in routed_onset_sources(fs).items():
        base, spread = ROUTED_ONSETS[rail]
        s = torch.from_numpy(src.astype(np.float32)).to(device)
        v_on[rail] = base + spread * (s - 1.0)
    rows = {rail: i for i, rail in enumerate(ROUTED_NOISE_RAILS)}

    def err(v, v_onset, nz):
        return ROUTED_BOUND * nz * 10.0 ** torch.clamp(
            ROUTED_LOG_SLOPE * (v_onset - v), -6.0, 3.0)

    def observe(plane, frame, tick, busy_frac):
        nz = table[tick + ROUTED_WARMUP]
        shift = ROUTED_LOAD_SHIFT_V * busy_frac
        return dataclasses.replace(
            frame,
            grad_error=err(plane.v_io, v_on["VDD_IO"] + shift,
                           nz[rows["VDD_IO"]]),
            extras={**frame.extras,
                    "straggle_rate": err(plane.v_core, v_on["VDD_CORE"],
                                         nz[rows["VDD_CORE"]]),
                    "hbm_error_rate": err(plane.v_hbm,
                                          v_on["VDD_HBM"] + shift,
                                          nz[rows["VDD_HBM"]])})

    return observe


def routed_warm_up(eng, observe, rounds: int = ROUTED_WARMUP) -> None:
    """The benchmark's warm-up: `rounds` accounted control rounds on the
    idle fleet (busy_frac 0, noise rows 0 .. rounds - 1) before the trace,
    so placement reads learned margins."""
    import torch

    from repro_torch.core.power_plane import (account_fleet_and_observe,
                                              fleet_variation)
    idle = torch.zeros(eng.n_chips, dtype=torch.float32, device=eng.device)
    variation = fleet_variation(eng.fleet_spec, eng.device)
    for w in range(rounds):
        eng.plane, frame, _ = account_fleet_and_observe(
            eng.decode_profile, eng.plane, eng.fleet_spec,
            variation=variation)
        eng._control_tick(observe(eng.plane, frame, w - rounds, idle))


def ledger_discrete(eng, ledger) -> dict:
    """Every discrete quantity of a routed run, the fields the fused path
    must equal the loop path on (the reference's `_discrete`, plus the
    migration records)."""
    out = {
        "records": [(r.rid, r.t_placed_s, r.chip, r.t_done_s, r.tokens_out,
                     r.defers, r.defer_time_s, r.migrations)
                    for r in ledger.records()],
        "defers_by_reason": dict(ledger.defers_by_reason),
        "migration_events": list(ledger.migration_events),
        "decode_sheds": eng.stats.decode_sheds,
        "sheds_by_rail": dict(eng.stats.sheds_by_rail),
        "sheds_by_reason": dict(eng.stats.sheds_by_reason),
        "prefill_tokens": eng.stats.prefill_tokens,
        "decode_tokens": eng.stats.decode_tokens,
    }
    out.update({k: eng.last_trace[k] for k in (
        "ticks", "max_occupancy", "degraded_chip_ticks", "unplaced",
        "unfinished")})
    return out
