"""Quickstart: the VolTune control plane in 60 lines (port of
`examples/quickstart.py`).

Programs a rail voltage through the PMBus-simulated PowerManager, watches
the transition settle (paper Fig 7), and reads back telemetry — then shows
the same opcode interface driving the TPU logical rails, whose plane lives
on `--device`.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core import PowerManager, settling_time
from repro_torch.core.control_plane import HostRailController
from repro_torch.core.power_manager import Opcode
from repro_torch.core.power_plane import PowerPlaneState
from repro_torch.core.rails import KC705_RAIL_MAP
from repro_torch.models.common import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)

    # --- 1. KC705: set VCCBRAM to 0.9 V (the paper's §IV-E example) -------
    pm = PowerManager(KC705_RAIL_MAP, path="hw", clock_hz=400_000)
    lane = KC705_RAIL_MAP.by_name("VCCBRAM").lane
    res = pm.set_voltage(lane, 0.9)
    print(f"set_voltage(VCCBRAM, 0.9V): ok={res.ok}, "
          f"{len(res.completions)} PMBus transactions, "
          f"command time {res.elapsed_s*1e3:.2f} ms")

    # --- 2. watch the transition settle (Fig 7 methodology) ---------------
    tr = pm.measure_transition(KC705_RAIL_MAP.by_name("MGTAVCC").lane, 0.85,
                               duration_s=5e-3)
    det = settling_time(tr.times, tr.volts, n=8, band_pct=1.0)
    print(f"MGTAVCC 1.0->0.85V: settled={det.settled}, "
          f"end-to-end latency {tr.end_to_end_latency_s()*1e3:.2f} ms "
          f"(sampling interval {pm.measurement_interval_s()*1e3:.1f} ms)")

    # --- 3. raw opcode interface (Table III) -------------------------------
    r = pm.execute(Opcode.GET_VOLTAGE, lane)
    print(f"opcode 0x5 GET_VOLTAGE(VCCBRAM) -> {r.value:.4f} V "
          f"in {r.elapsed_s*1e3:.2f} ms")

    # --- 4. the same stack driving TPU logical rails -----------------------
    hc = HostRailController()   # SW-path analogue of the unified control plane
    want = dataclasses.replace(
        PowerPlaneState.nominal(device=device),
        v_io=torch.tensor(0.80, dtype=torch.float32,
                          device=device))   # undervolt ICI SerDes
    achieved = hc.actuate(want)
    print(f"TPU VDD_IO 0.95->0.80V via PMBus: achieved "
          f"{float(achieved.v_io):.3f} V, "
          f"actuation cost {hc.actuation_seconds*1e3:.2f} ms "
          f"({hc.pm.bus.transaction_count} transactions)")
    print("readback:", {k: round(v, 3) for k, v in hc.readback().items()})


if __name__ == "__main__":
    main()
