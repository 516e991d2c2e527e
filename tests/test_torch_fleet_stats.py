"""The fleet train step's reduction tail in one launch (`fleet_stats`, K6's
fold) on the CPU, where the wrapper runs its plain version: `ops.fleet_stats`
against the reference package's tail (`src/repro/train/step.py`) on the
same numpy inputs; a numpy model of the card kernel's p95 (f32 ranks, the
two values by rank counting on the floats' bit keys, torch's lerp with its
products fused) against torch.quantile bit for bit, ties and NaN included;
and the inputs the wrapper refuses. The kernel against its plain version is
in tests/test_torch_kernels_cuda.py."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import fleet_telemetry as tft
from repro_torch.kernels import ops as tops
from test_torch_inputs import FLEET_CASES, check_fleet_stats, fleet_inputs
from torch_threads import one_torch_thread  # noqa: F401

CPU_SIZES = (1, 2, 63, 64, 65, 1000)
# the plain version against the reference: the same max and min; sums (the
# means) in torch's order and XLA's; jnp.percentile interpolates as
# (1 - w) a + w b, torch as a + w (b - a); the straggler count is exact, but
# XLA divides it by n as a multiply by the f32 reciprocal and torch's CPU
# mean divides, an ulp apart at some n (63)
SUM_RTOL = 1e-6
P95_RTOL = 1e-6
STRAGGLER_ULPS = 1


def reference_tail(power, t_chip, err, energy, v_io, straggle, conf):
    """The reference's tail, `src/repro/train/step.py` (unsharded), on its
    oracles."""
    n = power.shape[0]
    mx, mn, sm = jref.fleet_reduce_reference(
        jnp.stack([power, t_chip, err, energy, v_io], axis=1))
    out = {}
    for i, name in enumerate(("power_w", "t_chip_s", "grad_error",
                              "energy_step_j")):
        out[f"fleet/{name}_worst"] = mx[i]
        out[f"fleet/{name}_mean"] = sm[i] / n
    out["fleet/v_io_min"] = mn[4]
    out["fleet/v_io_mean"] = sm[4] / n
    out["fleet/t_fleet_s"] = mx[1]
    out["fleet/t_chip_p95_s"] = jref.fleet_percentile_reference(t_chip, 95.0)
    out["fleet/grad_error_p95"] = jref.fleet_percentile_reference(err, 95.0)
    out["fleet/straggler_frac"] = jnp.mean(straggle.astype(jnp.float32))
    if conf is not None:
        out["fleet/sor_conf_mean"] = jnp.mean(conf)
        out["fleet/sor_conf_min"] = jnp.min(conf)
    return out


@pytest.mark.parametrize("case", FLEET_CASES)
@pytest.mark.parametrize("n", CPU_SIZES)
def test_fleet_stats_matches_reference_tail(n, case):
    inputs = fleet_inputs(n, case)
    tops.reset_launch_counts()
    got = tops.fleet_stats(*(None if a is None else torch.from_numpy(a)
                             for a in inputs))
    want = reference_tail(*(None if a is None else jnp.asarray(a)
                            for a in inputs))
    assert list(got) == list(want)
    assert list(got) == list(tft.STATS_KEYS[:len(got)])
    for key in want:
        a, b = got[key].numpy(), np.asarray(want[key])
        assert a.shape == () and a.dtype == np.float32, key
        if key.endswith("_mean"):
            np.testing.assert_allclose(a, b, rtol=SUM_RTOL, atol=0,
                                       equal_nan=True, err_msg=key)
        elif key.endswith("_p95_s") or key.endswith("_p95"):
            np.testing.assert_allclose(a, b, rtol=P95_RTOL, atol=0,
                                       equal_nan=True, err_msg=key)
        elif key == "fleet/straggler_frac":
            assert round(float(a) * n) == round(float(b) * n) \
                == int(inputs[5].sum())
            np.testing.assert_array_max_ulp(a, b, maxulp=STRAGGLER_ULPS)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)
    nan_field = {"nan_t_chip": "t_chip_s", "nan_err": "grad_error",
                 "nan_v_io": "v_io"}.get(case)
    if nan_field is not None:
        assert any(np.isnan(got[k].item()) for k in got if nan_field in k)
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}


def test_check_fleet_stats_catches_a_mean_and_a_p95_ulp():
    """The card's comparison (`check_fleet_stats`) passes the plain version
    against itself and fails a mean off by more than its tolerance and a
    p95 off by one ulp."""
    got = tft.fleet_stats_plain(*(None if a is None else torch.from_numpy(a)
                                  for a in fleet_inputs(64, "ties")))
    assert check_fleet_stats(got, dict(got), rtol=1e-5) == 0.0
    bad = dict(got)
    bad["fleet/power_w_mean"] = got["fleet/power_w_mean"] * (1 + 1e-4)
    with pytest.raises(AssertionError):
        check_fleet_stats(bad, got, rtol=1e-5)
    bad = dict(got)
    bad["fleet/t_chip_p95_s"] = torch.nextafter(got["fleet/t_chip_p95_s"],
                                                torch.tensor(np.inf))
    with pytest.raises(AssertionError):
        check_fleet_stats(bad, got, rtol=1e-5)


# -- a numpy model of the kernel's p95 ----------------------------------------

def _round_f32(x: Fraction) -> np.float32:
    """x rounded once to f32 (to nearest, ties to even)."""
    r = np.float32(float(x))
    near = (np.nextafter(r, np.float32(-np.inf)), r,
            np.nextafter(r, np.float32(np.inf)))
    return min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                    int(np.array(c).view(np.uint32)) & 1))


def _fma_f32(a, b, c) -> np.float32:
    """a * b + c rounded once to f32."""
    if not np.isfinite([a, b, c]).all():
        return np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    return _round_f32(Fraction(float(a)) * Fraction(float(b))
                      + Fraction(float(c)))


def _to_key(x):
    b = x.view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _from_key(k) -> np.float32:
    k = np.uint32(k)
    bits = k & np.uint32(0x7fffffff) if k & np.uint32(0x80000000) else ~k
    return np.array(bits, np.uint32).view(np.float32)[()]


def kernel_p95(x, q: float = 0.95, fused: bool = True) -> np.float32:
    """The p95 as `csrc/fleet_reduce.cu`'s `quantile` computes it: ranks =
    f32(q) * (n - 1) in f32, lo its truncation, w = ranks - lo, hi = lo + (w
    > 0); the key of x_i holds the ranks #{x_j < x_i} up to #{x_j <= x_i};
    torch.lerp with each product fused into its add (`fused=False`: each
    product rounded on its own); NaN if any x is."""
    n = x.size
    ranks = np.float32(np.float32(q) * np.float32(n - 1))
    lo = int(ranks)
    w = np.float32(ranks - np.float32(lo))
    hi = lo + int(w > 0)
    if np.isnan(x).any():
        return np.float32(np.nan)
    k = _to_key(x)
    lt = (k[None, :] < k[:, None]).sum(1)
    le = (k[None, :] <= k[:, None]).sum(1)
    a = _from_key(k[(lt <= lo) & (lo < le)][0])
    b = _from_key(k[(lt <= hi) & (hi < le)][0])
    with np.errstate(invalid="ignore"):      # inf - inf
        d = np.float32(b - a)
    if not fused:
        if w < 0.5:
            return np.float32(a + np.float32(w * d))
        return np.float32(b - np.float32(d * (np.float32(1.0) - w)))
    if w < 0.5:
        return _fma_f32(w, d, a)
    return _fma_f32(-d, np.float32(1.0) - w, b)


@pytest.mark.parametrize("case", ["plain", "ties", "nan_t_chip", "nan_err"])
@pytest.mark.parametrize("n", CPU_SIZES)
def test_kernel_p95_model_equals_torch_quantile(n, case):
    _, t_chip, err, *_ = fleet_inputs(n, case)
    for x in (t_chip, err):
        got = kernel_p95(x)
        want = torch.quantile(torch.from_numpy(x), 0.95).numpy()
        if np.isnan(want):
            assert np.isnan(got)
        else:
            assert got.view(np.uint32) == want.view(np.uint32), (got, want)


def test_kernel_p95_model_equals_torch_quantile_on_random_fields():
    """3000 random fields (n 1 to 299, magnitudes 1e-3 to 1e3): the fused
    lerp equals torch.quantile in every one; the separately rounded lerp
    differs in some, so these cases tell the two forms apart."""
    rng = np.random.default_rng(0)
    separate_differs = 0
    for _ in range(3000):
        n = int(rng.integers(1, 300))
        x = (rng.standard_normal(n) * 10 ** rng.uniform(-3, 3)).astype(
            np.float32)
        want = torch.quantile(torch.from_numpy(x), 0.95).numpy().view(
            np.uint32)
        assert kernel_p95(x).view(np.uint32) == want, x
        separate_differs += int(kernel_p95(x, fused=False).view(np.uint32)
                                != want)
    assert separate_differs > 0


def test_kernel_p95_model_equals_torch_quantile_on_signed_zeros_and_inf():
    """Runs of -0 and +0 (equal as floats, apart as keys) and infinities at
    the p95's ranks."""
    cases = [np.array([0.0, -0.0] * 20 + [1.0], np.float32),
             np.array([-0.0] * 38 + [0.0, 2.0, 3.0], np.float32),
             np.array([1.0] * 30 + [np.inf] * 3, np.float32),
             np.array([-np.inf] * 40 + [5.0], np.float32)]
    for x in cases:
        got = kernel_p95(x)
        want = torch.quantile(torch.from_numpy(x), 0.95).numpy()
        assert (got.view(np.uint32) == want.view(np.uint32)
                or (np.isnan(got) and np.isnan(want))), (x, got, want)


# -- what the wrapper refuses -----------------------------------------------

def _bad(kind):
    args = [torch.from_numpy(a) for a in fleet_inputs(8)]
    if kind == "noncontiguous":
        args[2] = torch.zeros(16)[::2]
    elif kind == "float64":
        args[0] = args[0].double()
    elif kind == "length":
        args[4] = torch.zeros(9)
    elif kind == "straggle_dtype":
        args[5] = args[5].to(torch.uint8)
    elif kind == "conf_dtype":
        args[6] = args[6].double()
    elif kind == "conf_empty":
        args[6] = torch.zeros(0)
    elif kind == "empty":
        args = [a[:0] for a in args[:6]] + [args[6]]
    elif kind == "other_device":
        args[1] = args[1].to("meta")
    return args


@pytest.mark.parametrize("kind", ["noncontiguous", "float64", "length",
                                  "straggle_dtype", "conf_dtype",
                                  "conf_empty", "empty", "other_device"])
def test_fleet_stats_refuses(kind):
    with pytest.raises(ValueError):
        tops.fleet_stats(*_bad(kind))
