"""Fused safe-operating-region fit (K1): wrapper around the CUDA kernel
`csrc/sor_fit.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/fleet_telemetry.py::sor_fit`
(`_sor_fit_kernel`). On the card it is bound by launch latency: the
`[window, n]` window of the serve path is ~74 KB. The kernel runs one thread
per lane over the window rows (coalesced row loads, sums in registers) and
carries the solve and the envelope floor out of the same pass; see the
source's header note.

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
