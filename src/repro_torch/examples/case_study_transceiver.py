"""The paper's §VI case study, end to end: runtime voltage sweeps on the GTX
transceiver rail, identifying the three operating regimes and the
reliability-constrained energy optimum (port of
`examples/case_study_transceiver.py`).

The link model is host numpy (`core/transceiver.py`), so the output is
the same on either device; `--device` is checked as every example checks
it (without a card only `cpu` runs).

Run:  PYTHONPATH=src python -m repro_torch.examples.case_study_transceiver \
          [--device cpu]
"""

from __future__ import annotations

import argparse
import math

from repro_torch.core.transceiver import SPEEDS_GBPS, GtxLinkModel
from repro_torch.models.common import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    resolve_device(ap.parse_args(argv).device)

    m = GtxLinkModel()

    print("=== Fig 12: 10 Gbps reliability under voltage tuning ===")
    sweep = m.sweep(10.0, mode="both")
    onset = next(r for r in sweep if r.ber > 0)
    collapse = next(r for r in sweep if r.bytes_received < 0.9 * r.bytes_sent)
    print(f"  near-zero-BER plateau: 1.000 -> {onset.v_rx+0.001:.3f} V")
    print(f"  bounded-BER band: BER rises to 1e-6 by "
          f"{next(r.v_rx for r in sweep if r.ber >= 1e-6):.3f} V")
    print(f"  instability: throughput collapses at {collapse.v_rx:.3f} V "
          f"(received {100*collapse.bytes_received/collapse.bytes_sent:.0f}%)")

    print("\n=== Fig 13: TX-only vs RX-only sensitivity ===")
    for mode in ("tx", "rx"):
        sw = m.sweep(10.0, mode=mode)
        o = next((r for r in sw if r.ber > 0), None)
        v = (o.v_tx if mode == "tx" else o.v_rx) if o else None
        print(f"  {mode}-swept: BER onset at {v} V"
              + (" (RX-dominant degradation)" if mode == "rx" else ""))

    print("\n=== Fig 14: link-speed impact ===")
    for speed in SPEEDS_GBPS:
        sw = m.sweep(speed, mode="both")
        o = next((r.v_rx for r in sw if r.ber > 0), None)
        print(f"  {speed:>4} Gbps: BER onset {o:.3f} V "
              f"(headroom {1.0-o:.3f} V)")

    print("\n=== Fig 16: BER-aware power savings at 10 Gbps ===")
    p_nom = sweep[0].tx_power_w
    nz = next(r for r in sweep if r.ber > 0)
    b6 = next(r for r in sweep if r.ber >= 1e-6)
    print(f"  nominal:            {p_nom:.4f} W @ 1.000 V")
    print(f"  near-zero boundary: {nz.tx_power_w:.4f} W @ {nz.v_rx:.3f} V "
          f"-> {100*(1-nz.tx_power_w/p_nom):.1f}% saving  (paper: 28.4%)")
    print(f"  BER<=1e-6 boundary: {b6.tx_power_w:.4f} W @ {b6.v_rx:.3f} V "
          f"-> {100*(1-b6.tx_power_w/p_nom):.1f}% saving  (paper: 29.3%)")
    print(f"  (log10 BER at that point: {math.log10(b6.ber):.1f})")
    print("\nMost of the practical saving comes before the near-zero-BER "
          "boundary; the bounded-BER band adds ~1% more — matching the paper.")


if __name__ == "__main__":
    main()
