#!/usr/bin/env python3
"""Time K8 (`repro_torch.kernels.mamba2_ssd`) and K9
(`repro_torch.kernels.rwkv6_scan`) of one checkout at the serve paths'
shapes: the prefill (B 4, T 256, 64 heads x 64, bf16, zero initial state;
K8 one group, state 64) and the decode step (T 1, the carried state).
Device ms a call (CUDA events, queue held, L2 flushed, as `chip_smoke.py`'s
`kernels` phase), beside the harness's floor (`floor_ms`: a one-element
fill timed alike), and the host us a wrapper call takes (`*_host_us`:
`chip_smoke.host_us`, 100 calls enqueued without a sync, the least of
`HOST_REPS` runs: the host is shared, and five runs left ±20 us between
two runs of one checkout). Where the wrapper takes `state_out`, the decode step is also run in
place (`*_decode_in_place_*`, as the models run it). `--profile` adds each launch's device ms at the prefill
(torch.profiler, L2 warm: a prefill is several launches); `--serve` adds
`chip_smoke.py`'s full RWKV6-7B and Zamba2-1.2B `generate` with its
decode-step breakdown (device busy ms, the scans' ms and the copy kernels
a step).

    python3 scripts/scan_compare.py [--root CHECKOUT] [--profile] [--serve]

`--root` (default: this repository) is the checkout whose `src/` is
imported and whose kernels are built into its own `build/kernels/`. To set
two versions side by side, unpack one with `git archive` into a directory
that `.gitignore` lists and run both in one command, in turns (A, B, B, A).
Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
HOST_REPS = 20
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (this repository's timing helpers)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_compare: needs a CUDA card", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import mamba2_ssd as m2
    from repro_torch.kernels import rwkv6_scan as r6
    for mod in (m2, r6):
        assert Path(mod.__file__).resolve().is_relative_to(root), mod.__file__

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    # bf16 matrix products first, ~0.3 s of them, as decode_compare.py
    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    for _ in range(200):
        a @ a
    torch.cuda.synchronize()
    del a
    gen = torch.Generator(device=dev).manual_seed(22)
    tiny = torch.zeros(1, device=dev)
    out = {"root": str(root), "gpu": chip_smoke.nvidia_smi(),
           "floor_ms": chip_smoke.time_ms(lambda: tiny.zero_(), 100, flush)}
    B, T, H = chip_smoke.RWKV["batch"], chip_smoke.RWKV["prompt"], 64
    for name, kernel, make in (
            ("mamba2_ssd", m2.mamba2_ssd,
             lambda t, s: chip_smoke.mamba2_args(B, t, H, 1, 64,
                                                 torch.bfloat16, s, gen,
                                                 dev)),
            ("rwkv6_scan", r6.rwkv6_scan,
             lambda t, s: chip_smoke.rwkv6_args(B, t, H, torch.bfloat16, s,
                                                gen, dev))):
        for case, t, state, iters in (("prefill", T, False, 50),
                                      ("decode", 1, True, 100)):
            xs, s0 = make(t, state)
            out[f"{name}_{case}_ms"] = chip_smoke.time_ms(
                lambda: kernel(*xs, init_state=s0), iters, flush)
            out[f"{name}_{case}_host_us"] = chip_smoke.host_us(
                lambda: kernel(*xs, init_state=s0), reps=HOST_REPS)
            if case == "decode" and \
                    "state_out" in inspect.signature(kernel).parameters:
                buf = s0.clone()
                out[f"{name}_decode_in_place_ms"] = chip_smoke.time_ms(
                    lambda: kernel(*xs, init_state=buf, state_out=buf),
                    iters, flush, setup=lambda: buf.copy_(s0))
                out[f"{name}_decode_in_place_host_us"] = chip_smoke.host_us(
                    lambda: kernel(*xs, init_state=buf, state_out=buf),
                    reps=HOST_REPS)
            if args.profile and case == "prefill":
                out[f"{name}_prefill_launch_ms"] = launch_ms(
                    lambda: kernel(*xs, init_state=s0))
    if args.serve:
        for spec in (chip_smoke.RWKV, chip_smoke.ZAMBA):
            cfg, params, init_s = chip_smoke.init_main(dev, spec)
            run = chip_smoke.run_main(dev, spec, cfg, params, init_s)
            del params
            torch.cuda.empty_cache()
            out[run["arch"]] = dict(
                prefill_ms=run["prefill_ms"],
                decode_ms_per_token=run["decode_ms_per_token"],
                **{k: v for k, v in run["profile"].items()
                   if k != "top_kernels"})
    print(json.dumps(out), flush=True)
    return 0


def launch_ms(call) -> list:
    """The device ms of each kernel one `call` launches, in order (a
    warm-up call first; torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [(e.name[:40], getattr(e, "device_time", 0.0) / 1e3)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


if __name__ == "__main__":
    sys.exit(main())
