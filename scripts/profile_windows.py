#!/usr/bin/env python3
"""Count the torch.profiler windows that lose their device events, and
what `chip_smoke.device_activity` reads over many calls.

Two calls at the fleet train step's shape (64 chips, the SOR confidence
[3, 64]; `tests/test_torch_inputs.fleet_inputs`): one `ops.fleet_stats`
launch, and the composed tail it replaced
(`chip_smoke.fleet_tail_composed`: the stack, K6, the divides, two
torch.quantile, the means). For each:

- `raw`, `raw_padded`: `--windows` profiler windows of one call each (a
  warm-up call first, the window closed after a synchronisation, no
  witness kernel; `raw_padded` with `chip_smoke.PROFILE_PAD_S` of host
  time at both ends, as `device_activity` pads them): how many recorded
  every device event the call makes (the most seen), how many fewer, and
  how many none at all;
- `marked`, `marked_padded`: `--windows` windows of three one-element
  marker kernels around the call (an int32 negation first, an int16
  negation, the call, an int16 bitwise not): how many windows recorded
  each marker, and the median lag (us) from each recorded marker's launch
  on the host to its start on the card, both on the profiler's clock;
- `witnessed`: `--calls` readings of `chip_smoke.device_activity` (its
  lead kernels first, the call between two witness kernels, a window that
  lost a witness taken again): each distinct reading of kernels / copies
  / syncs and how many windows were taken again in all.

`--after-checks` first runs `chip_smoke.py`'s kernel checks that come
before K6's in its `kernels` phase (K1, K7, K1's refit, K2, K3, K4/K5),
so the windows are taken in a process with that history.

    python3 scripts/profile_windows.py [--windows 900] [--calls 300]
        [--after-checks]

Prints one JSON line a call; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke  # noqa: E402  (the port's measurement helpers)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=900)
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--after-checks", action="store_true")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_windows: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    _build.build()
    _build.load()
    if args.after_checks:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
        for check in (chip_smoke.check_sor_fit,
                      chip_smoke.check_sor_accumulate,
                      chip_smoke.check_sor_refit, chip_smoke.check_flash,
                      chip_smoke.check_decode, chip_smoke.check_flash_bwd):
            check(dev, flush)
        del flush
    fields = chip_smoke.fleet_tail_args(chip_smoke.TRAIN["chips"], "plain",
                                        dev)
    calls = {"fleet_stats": lambda: ops.fleet_stats(*fields),
             "composed": lambda: chip_smoke.fleet_tail_composed(ops,
                                                                *fields)}

    def raw_window(fn, pad) -> int:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        return sum(e.device_type == DeviceType.CUDA for e in prof.events())

    def raw(fn, pad) -> dict:
        seen = Counter(raw_window(fn, pad) for _ in range(args.windows))
        full = max(seen)
        return dict(windows=args.windows, pad_s=pad, device_events=full,
                    full=seen[full], none=seen[0],
                    fewer=args.windows - seen[full] - (seen[0] if full
                                                       else 0))

    lead = torch.zeros(1, dtype=torch.int32, device=dev)
    mark = torch.zeros(1, dtype=torch.int16, device=dev)
    # marker: (its op on the host, what its kernel's name holds)
    markers = {"lead": ("aten::neg_", "(int)"),
               "open": ("aten::neg_", "(short)"),
               "close": ("aten::bitwise_not_", "bitwise_not")}

    def marked_window(fn, pad) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            lead.neg_()
            mark.neg_()
            fn()
            mark.bitwise_not_()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        host = sorted((e.time_range.start, e.name) for e in events
                      if e.device_type != DeviceType.CUDA
                      and e.name in ("aten::neg_", "aten::bitwise_not_"))
        host = {"lead": host[0][0], "open": host[1][0],
                "close": host[2][0]} if len(host) == 3 else {}
        out = {}
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            for m, (_, part) in markers.items():
                if part in e.name and ("neg_kernel" in e.name) == (
                        m != "close") and m in host:
                    out[m] = e.time_range.start - host[m]
        return out

    def marked(fn, pad) -> dict:
        seen = [marked_window(fn, pad) for _ in range(args.windows)]
        out = dict(windows=args.windows, pad_s=pad)
        for m in markers:
            lags = sorted(w[m] for w in seen if m in w)
            out[m] = dict(recorded=len(lags),
                          median_lag_us=lags[len(lags) // 2] if lags
                          else None)
        return out

    head = {"gpu": chip_smoke.nvidia_smi(), "torch": torch.__version__,
            "after_checks": args.after_checks}
    for name, fn in calls.items():
        out = dict(head, call=name, raw=raw(fn, 0.0),
                   raw_padded=raw(fn, chip_smoke.PROFILE_PAD_S),
                   marked=marked(fn, 0.0),
                   marked_padded=marked(fn, chip_smoke.PROFILE_PAD_S))
        readings, retaken = Counter(), 0
        for _ in range(args.calls):
            a = chip_smoke.device_activity(fn)
            readings[f"{a['kernels']}/{a['copies']}/{a['syncs']}"] += 1
            retaken += a["retaken"]
        out["witnessed"] = dict(calls=args.calls, retaken=retaken,
                                readings=dict(readings))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
