"""Fused safe-operating-region fit (K1), the EWLS accumulation of the split
fit (K7) and the fleet telemetry reduction (K6): wrappers around the CUDA
kernels `csrc/sor_fit.cu` (K1 and K7) and `csrc/fleet_reduce.cu`, each
beside its plain PyTorch version.

K1 replaces the TPU kernel `repro/kernels/fleet_telemetry.py::sor_fit`
(`_sor_fit_kernel`), K7 its `sor_accumulate` (`_sor_kernel`). On the card
both are bound by launch latency: the `[window, n]` window of the serve and
host paths is ~74 KB. Each runs one thread per lane over the window rows
(coalesced row loads, sums in registers); K1 carries the solve and the
envelope floor out of the same pass, K7 returns the five sums, computed by
the same device function, so they equal K1's bit for bit; see the source's
header note.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

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
