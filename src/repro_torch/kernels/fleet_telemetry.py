"""Fused safe-operating-region fit (K1), the EWLS accumulation of the split
fit (K7) and the fleet telemetry reduction (K6): wrappers around the CUDA
kernels `csrc/sor_fit.cu` (K1 and K7) and `csrc/fleet_reduce.cu`, each
beside its plain PyTorch version.

K6 replaces the TPU kernel `repro/kernels/fleet_telemetry.py::fleet_reduce`
and has two entry points on one fold routine: `fleet_reduce` (the TPU
kernel's interface, `[n_chips, n_fields]` -> max, min, sum) and
`fleet_stats` (the fleet train step's whole reduction tail in one launch:
every `fleet/*` metric from the step's fields as they stand, the p95s exact
order statistics interpolated as `torch.quantile` does). Both are bound by
latency at the step's 64 chips: one CTA a job, every job at once.

K1 replaces the TPU kernel `repro/kernels/fleet_telemetry.py::sor_fit`
(`_sor_fit_kernel`), K7 its `sor_accumulate` (`_sor_kernel`). Each has two
entry points: the TPU kernel's own interface on a `[window, n]` window
(`sor_fit`, `sor_accumulate`), and one that reads the SOR history ring as
it stands and forms the window's inputs itself (`sor_refit`: the whole
refit on cadence, blend included, in one launch; `sor_accumulate_ring`:
the split fit's sums). On the card they are bound by latency: the serve
and host paths' window is ~74 KB. A CTA stages 32 lanes x 32 rows with
every load of a pass issued at once, and one warp sums each lane's
products in row order, so K7's sums equal K1's bit for bit; see the
source's header note.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref


def sor_fit_plain(x, y, w, log10_bound, guard, *, min_slope: float,
                  min_spread_v: float, conf_samples: float):
    """The plain PyTorch version: `ref.sor_fit_reference`."""
    return ref.sor_fit_reference(x, y, w, log10_bound, guard,
                                 min_slope=min_slope,
                                 min_spread_v=min_spread_v,
                                 conf_samples=conf_samples)


def sor_fit(x, y, w, log10_bound, guard, *, min_slope: float,
            min_spread_v: float, conf_samples: float):
    """x/y/w [window, n] f32, log10_bound/guard [n] f32 -> (intercept,
    slope, v_frontier, confidence, n_eff, floor), each [n] f32."""
    if x.device.type == "cpu":
        return sor_fit_plain(x, y, w, log10_bound, guard,
                             min_slope=min_slope, min_spread_v=min_spread_v,
                             conf_samples=conf_samples)
    if x.device.type != "cuda":
        raise ValueError(f"sor_fit runs on cpu or cuda, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [window, n], got {tuple(x.shape)}")
    window, n = x.shape
    for name, a, shape in (("y", y, (window, n)), ("w", w, (window, n)),
                           ("log10_bound", log10_bound, (n,)),
                           ("guard", guard, (n,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    args = (x, y, w, log10_bound, guard)
    for a in args:
        if a.device != x.device or a.dtype != torch.float32 or \
                not a.is_contiguous():
            raise ValueError("sor_fit takes contiguous float32 tensors on "
                             "one CUDA device")
    outs = tuple(torch.empty(n, dtype=torch.float32, device=x.device)
                 for _ in range(6))
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sor_fit_launch(*(a.data_ptr() for a in args),
                                *(o.data_ptr() for o in outs), window, n,
                                min_slope, min_spread_v, conf_samples,
                                stream)
    _build.check(rc, "sor_fit")
    sor_fit.launches += 1
    return outs


sor_fit.launches = 0


def sor_accumulate_plain(x, y, w):
    """The plain PyTorch version: `ref.sor_accumulate_reference`."""
    return ref.sor_accumulate_reference(x, y, w)


def sor_accumulate(x, y, w):
    """K7. x/y/w [window, n] f32 -> the five EWLS sums (Σw, Σwx, Σwy, Σwx²,
    Σwxy), each [n] f32."""
    if x.device.type == "cpu":
        return sor_accumulate_plain(x, y, w)
    if x.device.type != "cuda":
        raise ValueError(f"sor_accumulate runs on cpu or cuda, got "
                         f"{x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [window, n], got {tuple(x.shape)}")
    window, n = x.shape
    for name, a in (("y", y), ("w", w)):
        if tuple(a.shape) != (window, n):
            raise ValueError(f"{name} must be {(window, n)}, got "
                             f"{tuple(a.shape)}")
    for a in (x, y, w):
        if a.device != x.device or a.dtype != torch.float32 or \
                not a.is_contiguous():
            raise ValueError("sor_accumulate takes contiguous float32 "
                             "tensors on one CUDA device")
    outs = tuple(torch.empty(n, dtype=torch.float32, device=x.device)
                 for _ in range(5))
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sor_accumulate_launch(x.data_ptr(), y.data_ptr(),
                                       w.data_ptr(),
                                       *(o.data_ptr() for o in outs),
                                       window, n, stream)
    _build.check(rc, "sor_accumulate")
    sor_accumulate.launches += 1
    return outs


sor_accumulate.launches = 0


def _check_ring(name: str, v, obs, valid, age_s, cursor: int) -> tuple:
    """Refuse a ring the kernels do not take; returns (capacity, n_rails,
    n_chips)."""
    if v.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {v.device}")
    if v.dim() != 3 or v.numel() == 0:
        raise ValueError(f"{name}: v must be a non-empty [capacity, n_rails, "
                         f"n_chips], got {tuple(v.shape)}")
    cap, n_rails, n_chips = v.shape
    for arg, a, shape, dtype in (
            ("v", v, (cap, n_rails, n_chips), torch.float32),
            ("obs", obs, (cap, n_rails, n_chips), torch.float32),
            ("valid", valid, (cap, n_rails, n_chips), torch.bool),
            ("age_s", age_s, (cap, n_chips), torch.float32)):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got "
                             f"{tuple(a.shape)}")
        if a.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {a.dtype}")
        if a.device != v.device or not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors on one CUDA "
                             f"device")
    if not 0 <= cursor < cap:
        raise ValueError(f"{name}: cursor must be in [0, {cap}), got "
                         f"{cursor}")
    return cap, n_rails, n_chips


def _weighting_args(cursor: int, decay: float, age_halflife_s) -> tuple:
    """(cursor, aged, decay, 1 / halflife) as the kernels take them: the
    reciprocal in f32, as torch divides by a Python scalar on the card."""
    inv = 0.0 if age_halflife_s is None else float(
        np.float32(1.0) / np.float32(age_halflife_s))
    return int(cursor), int(age_halflife_s is not None), decay, inv


def sor_accumulate_ring_plain(v, obs, valid, age_s, *, cursor: int,
                              decay: float, age_halflife_s):
    """The plain PyTorch version: `ref.sor_fit_inputs`, then
    `ref.sor_accumulate_reference`."""
    return ref.sor_accumulate_reference(*ref.sor_fit_inputs(
        v, obs, valid, age_s, cursor=cursor, decay=decay,
        age_halflife_s=age_halflife_s))


def sor_accumulate_ring(v, obs, valid, age_s, *, cursor: int, decay: float,
                        age_halflife_s):
    """K7 on the history ring as it stands: v, obs [capacity, n_rails,
    n_chips] f32, valid the same in bool, age_s [capacity, n_chips] f32,
    `cursor` the next write slot -> the five EWLS sums of the window that
    `ref.sor_fit_inputs` forms, each [n_rails, n_chips] f32. Counts on
    `sor_accumulate.launches`: the same kernel."""
    if v.device.type == "cpu":
        return sor_accumulate_ring_plain(v, obs, valid, age_s, cursor=cursor,
                                         decay=decay,
                                         age_halflife_s=age_halflife_s)
    cap, n_rails, n_chips = _check_ring("sor_accumulate_ring", v, obs, valid,
                                        age_s, cursor)
    outs = tuple(torch.empty((n_rails, n_chips), dtype=torch.float32,
                             device=v.device) for _ in range(5))
    lib = _build.load()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.sor_accumulate_ring_launch(
            v.data_ptr(), obs.data_ptr(), valid.data_ptr(), age_s.data_ptr(),
            *(o.data_ptr() for o in outs), cap, n_rails, n_chips,
            *_weighting_args(cursor, decay, age_halflife_s), stream)
    _build.check(rc, "sor_accumulate_ring")
    sor_accumulate.launches += 1
    return outs


def sor_refit_plain(v, obs, valid, age_s, old, log10_bound, *, cursor: int,
                    decay: float, age_halflife_s, update_gain: float,
                    min_slope: float, min_spread_v: float,
                    conf_samples: float):
    """The plain PyTorch version: `ref.sor_refit_reference`, the composed
    sequence (the window's inputs, the sums, the solve, the blend)."""
    return ref.sor_refit_reference(
        v, obs, valid, age_s, old, log10_bound, cursor=cursor, decay=decay,
        age_halflife_s=age_halflife_s, update_gain=update_gain,
        min_slope=min_slope, min_spread_v=min_spread_v,
        conf_samples=conf_samples)


def sor_refit(v, obs, valid, age_s, old, log10_bound, *, cursor: int,
              decay: float, age_halflife_s, update_gain: float,
              min_slope: float, min_spread_v: float, conf_samples: float):
    """K1's refit on cadence in one launch. The history ring as it stands
    (v, obs [capacity, n_rails, n_chips] f32, valid the same in bool, age_s
    [capacity, n_chips] f32, `cursor` the next write slot), the old
    estimate `old` (intercept, slope, v_frontier, confidence, n_eff), each
    [n_rails, n_chips] f32, and log10_bound [n_rails] f32 -> the five new
    estimate fields, each [n_rails, n_chips] f32 (rows of one [5, n_rails,
    n_chips] allocation)."""
    if v.device.type == "cpu":
        return sor_refit_plain(v, obs, valid, age_s, old, log10_bound,
                               cursor=cursor, decay=decay,
                               age_halflife_s=age_halflife_s,
                               update_gain=update_gain, min_slope=min_slope,
                               min_spread_v=min_spread_v,
                               conf_samples=conf_samples)
    cap, n_rails, n_chips = _check_ring("sor_refit", v, obs, valid, age_s,
                                        cursor)
    old = tuple(old)
    if len(old) != 5:
        raise ValueError(f"sor_refit: old must be the five estimate fields, "
                         f"got {len(old)}")
    for arg, a, shape in (*((f"old[{k}]", o, (n_rails, n_chips))
                            for k, o in enumerate(old)),
                          ("log10_bound", log10_bound, (n_rails,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"sor_refit: {arg} must be {shape}, got "
                             f"{tuple(a.shape)}")
        if a.dtype != torch.float32 or a.device != v.device or \
                not a.is_contiguous():
            raise ValueError("sor_refit takes contiguous float32 tensors on "
                             "one CUDA device")
    out = torch.empty((5, n_rails, n_chips), dtype=torch.float32,
                      device=v.device)
    lib = _build.load()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.sor_refit_launch(
            v.data_ptr(), obs.data_ptr(), valid.data_ptr(), age_s.data_ptr(),
            *(o.data_ptr() for o in old), log10_bound.data_ptr(),
            out.data_ptr(), cap, n_rails, n_chips,
            *_weighting_args(cursor, decay, age_halflife_s), update_gain,
            min_slope, min_spread_v, conf_samples, stream)
    _build.check(rc, "sor_refit")
    sor_refit.launches += 1
    return tuple(out.unbind(0))


sor_refit.launches = 0


def fleet_reduce_plain(x):
    """The plain PyTorch version: `ref.fleet_reduce_reference`."""
    return ref.fleet_reduce_reference(x)


def fleet_reduce(x):
    """K6. x [n_chips, n_fields] f32 -> (max, min, sum) over the chips,
    each [n_fields] f32; a field with a NaN lane gives NaN, as the
    reference's `jnp.max`/`jnp.min` do. Replaces the TPU kernel
    `repro/kernels/fleet_telemetry.py::fleet_reduce` (`_kernel`); launch-
    bound at the fleet step's [64, 5], so one block; see
    `csrc/fleet_reduce.cu`."""
    if x.device.type == "cpu":
        return fleet_reduce_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"fleet_reduce runs on cpu or cuda, got {x.device}")
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"x must be [n_chips >= 1, n_fields], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fleet_reduce takes a contiguous float32 tensor")
    n_chips, n_fields = x.shape
    outs = tuple(torch.empty(n_fields, dtype=torch.float32, device=x.device)
                 for _ in range(3))
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fleet_reduce_launch(x.data_ptr(),
                                     *(o.data_ptr() for o in outs), n_chips,
                                     n_fields, stream)
    _build.check(rc, "fleet_reduce")
    fleet_reduce.launches += 1
    return outs


fleet_reduce.launches = 0


# the fleet train step's `fleet/*` metrics, in the order of `fleet_stats`'
# output buffer (`csrc/fleet_reduce.cu`, enum Slot); the last two only with
# the SOR confidence
STATS_FIELDS = ("power_w", "t_chip_s", "grad_error", "energy_step_j",
                "v_io")
STATS_KEYS = tuple(f"fleet/{k}" for k in (
    "power_w_worst", "power_w_mean", "t_chip_s_worst", "t_chip_s_mean",
    "grad_error_worst", "grad_error_mean", "energy_step_j_worst",
    "energy_step_j_mean", "v_io_min", "v_io_mean", "t_fleet_s",
    "t_chip_p95_s", "grad_error_p95", "straggler_frac", "sor_conf_mean",
    "sor_conf_min"))
P95 = 95.0
QUANTILE_MAX = 2**24     # torch.quantile's largest input


def fleet_stats_plain(power_w, t_chip_s, grad_error, energy_step_j, v_io,
                      straggle, conf=None):
    """The plain PyTorch version: the fleet train step's reduction tail as
    a sequence of tensor ops (the five fields stacked, `fleet_reduce_plain`,
    the means, two `torch.quantile`s, the straggler and confidence
    means)."""
    n = power_w.shape[0]
    stacked = torch.stack([power_w, t_chip_s, grad_error, energy_step_j,
                           v_io], dim=1).contiguous()
    mx, mn, sm = fleet_reduce_plain(stacked)
    out = {}
    # for these the worst chip is the max; for a voltage rail it is the
    # MIN (thinnest margin), so v_io gets min/mean instead
    for i, name in enumerate(STATS_FIELDS[:4]):
        out[f"fleet/{name}_worst"] = mx[i]
        out[f"fleet/{name}_mean"] = sm[i] / n
    out["fleet/v_io_min"] = mn[4]
    out["fleet/v_io_mean"] = sm[4] / n
    # a synchronous fleet steps at its slowest chip
    out["fleet/t_fleet_s"] = mx[1]
    out["fleet/t_chip_p95_s"] = ref.fleet_percentile_reference(t_chip_s, P95)
    out["fleet/grad_error_p95"] = ref.fleet_percentile_reference(grad_error,
                                                                 P95)
    out["fleet/straggler_frac"] = straggle.float().mean()
    if conf is not None:
        # learned-region telemetry: how much of the fleet trusts a fit
        out["fleet/sor_conf_mean"] = conf.mean()
        out["fleet/sor_conf_min"] = conf.min()
    return out


def _check_stats(fields, straggle, conf) -> int:
    """Refuse inputs the kernel does not take; returns n."""
    dev = fields[0].device
    n = fields[0].shape[0] if fields[0].dim() == 1 else 0
    if not 1 <= n <= QUANTILE_MAX:
        raise ValueError(f"fleet_stats: power_w must be [n] with 1 <= n <= "
                         f"{QUANTILE_MAX}, got {tuple(fields[0].shape)}")
    args = [(name, a, torch.float32, (n,))
            for name, a in zip(STATS_FIELDS, fields)]
    args.append(("straggle", straggle, torch.bool, (n,)))
    if conf is not None:
        args.append(("conf", conf, torch.float32, None))
    for name, a, dtype, shape in args:
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"fleet_stats: {name} must be {shape}, got "
                             f"{tuple(a.shape)}")
        if a.dtype != dtype:
            raise ValueError(f"fleet_stats: {name} must be {dtype}, got "
                             f"{a.dtype}")
        if a.device != dev or not a.is_contiguous():
            raise ValueError("fleet_stats takes contiguous tensors on one "
                             "device")
    if conf is not None and conf.numel() == 0:
        raise ValueError("fleet_stats: conf is empty")
    return n


def fleet_stats(power_w, t_chip_s, grad_error, energy_step_j, v_io,
                straggle, conf=None):
    """The fleet train step's reduction tail in one launch: five [n] f32
    fields, the straggle mask ([n] bool) and, with the SOR, its confidence
    (f32, any shape) -> {`fleet/*` key: 0-d f32}, the keys of
    `STATS_KEYS` (the last two only with `conf`). On the card the values
    are views of one output buffer; max, min, the p95s and the straggler
    fraction equal the plain version's bit for bit, the sums' order is the
    kernel's own. Counts on `fleet_stats.launches`."""
    fields = (power_w, t_chip_s, grad_error, energy_step_j, v_io)
    n = _check_stats(fields, straggle, conf)
    if power_w.device.type == "cpu":
        return fleet_stats_plain(*fields, straggle, conf)
    if power_w.device.type != "cuda":
        raise ValueError(f"fleet_stats runs on cpu or cuda, got "
                         f"{power_w.device}")
    keys = STATS_KEYS if conf is not None else STATS_KEYS[:-2]
    out = torch.empty(len(keys), dtype=torch.float32, device=power_w.device)
    lib = _build.load()
    with torch.cuda.device(power_w.device):
        stream = torch.cuda.current_stream(power_w.device).cuda_stream
        rc = lib.fleet_stats_launch(
            *(a.data_ptr() for a in fields), straggle.data_ptr(),
            None if conf is None else conf.data_ptr(), out.data_ptr(), n,
            0 if conf is None else conf.numel(), P95 / 100.0, stream)
    _build.check(rc, "fleet_stats")
    fleet_stats.launches += 1
    return dict(zip(keys, out.unbind(0)))


fleet_stats.launches = 0
