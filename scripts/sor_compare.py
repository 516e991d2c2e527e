#!/usr/bin/env python3
"""Time K1 and K7 (`repro_torch.kernels.fleet_telemetry`) and the SOR refit
on cadence (`repro_torch.core.sor.update_estimate`) of one checkout at the
serve and host paths' shape: window 32, 3 rails x 64 chips = 192 lanes,
the main path's `SorConfig` (decay 0.92, no staleness weighting, gain 1).

- `sor_fit_ms`, `sor_accumulate_ms`: K1 and K7 alone on a `[32, 192]`
  window (`chip_smoke.sor_inputs`), device ms a call (CUDA events, queue
  held, L2 flushed, as `chip_smoke.py`'s `kernels` phase);
- `refit_*` (fused, the in-graph paths') and `split_refit_*` (the host
  path's): `update_estimate` on a history ring (`tests/test_torch_inputs.
  ring_state`, case "mid"): device ms a refit timed alike (a refit that
  waits on the host shows that wait too), host us a call
  (`chip_smoke.host_us`, the least of `HOST_REPS` runs of 100), and what
  one refit puts on the card (`chip_smoke.device_activity`: kernels,
  copies, their device us, host syncs);
- `floor_ms`: the harness's floor, a one-element fill timed alike.

    python3 scripts/sor_compare.py [--root CHECKOUT]

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
sys.path.insert(0, str(HERE / "tests"))
import chip_smoke  # noqa: E402  (this repository's timing helpers)
from test_torch_inputs import ring_state  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sor_compare: needs a CUDA card", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import sor
    from repro_torch.core import telemetry as tel
    from repro_torch.kernels import fleet_telemetry as ft
    for mod in (sor, ft):
        assert Path(mod.__file__).resolve().is_relative_to(root), mod.__file__

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    out = {"root": str(root), "gpu": chip_smoke.nvidia_smi(),
           "floor_ms": chip_smoke.floor_ms(flush)}
    x, y, w, bound, guard = chip_smoke.sor_inputs(32, 192, seed=192, dev=dev)
    out["sor_fit_ms"] = chip_smoke.time_ms(
        lambda: ft.sor_fit(x, y, w, bound, guard, **chip_smoke.SOR_KW), 100,
        flush)
    out["sor_accumulate_ms"] = chip_smoke.time_ms(
        lambda: ft.sor_accumulate(x, y, w), 100, flush)

    st = ring_state("mid", chip_smoke.MAIN["chips"])
    hist = tel.FrameHistory(
        **{f: torch.from_numpy(st[f]).to(dev)
           for f in ("v", "obs", "age_s", "polled", "valid")},
        cursor=st["cursor"], count=st["count"],
        capacity=st["cfg"]["capacity"], rails=tel.ALL_RAIL_OBSERVABLES)
    cfg = sor.SorConfig(rails=tel.ALL_RAIL_OBSERVABLES, **st["cfg"])
    old = sor.SorEstimate.init(chip_smoke.MAIN["chips"], n_rails=3,
                               device=dev)
    for key, fused in (("refit", True), ("split_refit", False)):
        def refit():
            return sor.update_estimate(old, hist, cfg, fused=fused)
        out[f"{key}_ms"] = chip_smoke.time_ms(refit, 100, flush)
        out[f"{key}_host_us"] = chip_smoke.host_us(refit, reps=HOST_REPS)
        out[f"{key}_activity"] = chip_smoke.device_activity(refit)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
