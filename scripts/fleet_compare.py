#!/usr/bin/env python3
"""Time K6 (`repro_torch.kernels.fleet_telemetry.fleet_reduce`) and the
fleet train step's reduction tail of one checkout at the step's shape: 64
chips, five fields, the SOR confidence [3, 64]
(`tests/test_torch_inputs.fleet_inputs`).

- `fleet_reduce_*`: K6 alone on `[64, 5]`;
- `tail_*`: the tail as the checkout's `train/step.py` runs it: one
  `ops.fleet_stats` launch where the checkout has it, else the composed
  sequence (`chip_smoke.fleet_tail_composed`: the stack, K6, the divides,
  two torch.quantile, the means) on the checkout's `ops`;
- for each: device ms a call (CUDA events, queue held, L2 flushed, as
  `chip_smoke.py`'s `kernels` phase; 10 calls of a multi-launch tail),
  host us a call (`chip_smoke.host_us`, the least of `HOST_REPS` runs of
  100) and what one call puts on the card (`chip_smoke.device_activity`:
  kernels, copies, their device us, host syncs);
- `floor_ms`: the harness's floor, a one-element fill timed alike.

    python3 scripts/fleet_compare.py [--root CHECKOUT]

`--root` (default: this repository) is the checkout whose `src/` is
imported and whose kernels are built into its own `build/kernels/`; the
inputs and the timing helpers come from this repository. To set two
versions side by side, unpack one with `git archive` into a directory that
`.gitignore` lists and run both in one command, in turns (A, B, B, A).
Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
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
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fleet_compare: needs a CUDA card", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import ops
    assert Path(ops.__file__).resolve().is_relative_to(root), ops.__file__

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    n = chip_smoke.TRAIN["chips"]
    fields = chip_smoke.fleet_tail_args(n, "plain", dev)
    x = torch.stack(fields[:5], dim=1).contiguous()
    if hasattr(ops, "fleet_stats"):
        tail_path = "fleet_stats"

        def tail():
            return ops.fleet_stats(*fields)
    else:
        tail_path = "composed"

        def tail():
            return chip_smoke.fleet_tail_composed(ops, *fields)

    out = {"root": str(root), "gpu": chip_smoke.nvidia_smi(),
           "floor_ms": chip_smoke.floor_ms(flush), "tail_path": tail_path,
           "n_chips": n}
    for key, fn, iters in (("fleet_reduce", lambda: ops.fleet_reduce(x), 100),
                           ("tail", tail, 100 if tail_path == "fleet_stats"
                            else 10)):
        out[f"{key}_ms"] = chip_smoke.time_ms(fn, iters, flush)
        out[f"{key}_host_us"] = chip_smoke.host_us(fn, reps=HOST_REPS)
        out[f"{key}_activity"] = chip_smoke.device_activity(fn)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
