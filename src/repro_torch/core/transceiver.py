"""GTX transceiver link model for the representative case study (paper §VI).

Models the KC705 back-to-back GTX link as a function of the MGTAVCC analog
supply voltage applied per side (TX / RX) and the line rate. All curve
anchors are taken from the paper's measurements:

  RX-side BER onset voltages (Fig 12/14):  10.0 Gbps: 0.869 V,
      7.5 Gbps: 0.787 V, 5.0 Gbps: 0.745 V, 2.5 Gbps: 0.744 V.
  BER ramp at 10 Gbps (Fig 12c): 1e-10..1e-9 near 0.869-0.868 V,
      ~1e-7 near 0.866 V, ~1e-6 near 0.864 V.
  Throughput collapse (Fig 12a/14a): ~0.80 V @10 G, ~0.72 V @5 G
      (7.5/2.5 G collapse below the 0.70 V sweep floor, as observed).
  TX-only sensitivity (Fig 13): BER onset ~0.82 V @10 G, no received-size
      collapse down to 0.70 V.
  Latency (Fig 15): baselines ~100/130/200/410 ns for 10/7.5/5/2.5 Gbps,
      excursion onsets ~0.86/0.76/0.745/0.74 V.
  Rail power (Tables XI/XII, Fig 16): TX 0.20 W -> 0.1432 W at the
      near-zero-BER boundary (28.4% saving), 0.1415 W at BER<=1e-6 (29.3%).

The voltage->power shape is a Fritsch-Carlson monotone cubic (PCHIP) through
the paper's anchor points, shared across speeds/sides except the 2.5 Gbps RX
rail whose measured reduction is shallower (paper §VI-G: ~25-30%).

Copied from `repro/core/transceiver.py` (numpy only): the anchor tables,
`Pchip` and `_det_uniform`'s hash of rounded keys are kept exactly, so a
sweep equals the reference's field for field.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SPEEDS_GBPS = (2.5, 5.0, 7.5, 10.0)
PAYLOAD_BYTES_DEFAULT = 10 * 10**9  # 10 GByte count-up stream (paper §VI-B)
NOMINAL_V = 1.0

# Reference clocks (paper Table X): 125 MHz except 117.188 MHz for 7.5 Gbps.
REFCLK_MHZ = {2.5: 125.000, 5.0: 125.000, 7.5: 117.188, 10.0: 125.000}

RX_BER_ONSET_V = {10.0: 0.869, 7.5: 0.787, 5.0: 0.745, 2.5: 0.744}
TX_BER_ONSET_V = {10.0: 0.820, 7.5: 0.745, 5.0: 0.708, 2.5: 0.706}
RX_COLLAPSE_V = {10.0: 0.800, 7.5: 0.695, 5.0: 0.720, 2.5: 0.688}
LATENCY_BASE_NS = {10.0: 100.0, 7.5: 130.0, 5.0: 200.0, 2.5: 410.0}
LATENCY_EXCURSION_ONSET_V = {10.0: 0.860, 7.5: 0.760, 5.0: 0.745, 2.5: 0.740}

TX_POWER_1V0_W = {10.0: 0.200, 7.5: 0.180, 5.0: 0.140, 2.5: 0.120}
RX_POWER_1V0_W = {10.0: 0.170, 7.5: 0.155, 5.0: 0.120, 2.5: 0.095}

# Shared normalized power-vs-voltage shape (anchored to Fig 16 / Table XII).
_POWER_SHAPE_ANCHORS = (
    (0.700, 0.400), (0.800, 0.648), (0.864, 0.7075), (0.866, 0.7100),
    (0.869, 0.7160), (0.900, 0.785), (1.000, 1.000),
)
# 2.5 Gbps RX: shallower reduction (~25-30% at 0.8 V; paper §VI-G).
_POWER_SHAPE_ANCHORS_25RX = (
    (0.700, 0.520), (0.800, 0.720), (0.869, 0.800), (0.900, 0.840), (1.000, 1.000),
)

BER_FLOOR_LOG10 = -12.0  # "effectively zero" — below detection for 8e10 bits


class Pchip:
    """Fritsch-Carlson monotone piecewise-cubic Hermite interpolator."""

    def __init__(self, x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if x.ndim != 1 or x.shape != y.shape or x.shape[0] < 2:
            raise ValueError("need matching 1-D arrays with >= 2 points")
        if np.any(np.diff(x) <= 0):
            raise ValueError("x must be strictly increasing")
        h = np.diff(x)
        delta = np.diff(y) / h
        m = np.empty_like(x)
        m[0], m[-1] = delta[0], delta[-1]
        for i in range(1, len(x) - 1):
            if delta[i - 1] * delta[i] <= 0:
                m[i] = 0.0
            else:
                w1 = 2 * h[i] + h[i - 1]
                w2 = h[i] + 2 * h[i - 1]
                m[i] = (w1 + w2) / (w1 / delta[i - 1] + w2 / delta[i])
        self.x, self.y, self.m, self.h = x, y, m, h

    def __call__(self, xq):
        xq = np.asarray(xq, np.float64)
        scalar = xq.ndim == 0
        xq = np.atleast_1d(xq)
        # clamp to the fitted domain (model is only defined on the sweep range)
        xq = np.clip(xq, self.x[0], self.x[-1])
        i = np.clip(np.searchsorted(self.x, xq, side="right") - 1, 0, len(self.x) - 2)
        t = (xq - self.x[i]) / self.h[i]
        h00 = (1 + 2 * t) * (1 - t) ** 2
        h10 = t * (1 - t) ** 2
        h01 = t * t * (3 - 2 * t)
        h11 = t * t * (t - 1)
        out = (h00 * self.y[i] + h10 * self.h[i] * self.m[i]
               + h01 * self.y[i + 1] + h11 * self.h[i] * self.m[i + 1])
        return float(out[0]) if scalar else out


_POWER_SHAPE = Pchip(*zip(*_POWER_SHAPE_ANCHORS))
_POWER_SHAPE_25RX = Pchip(*zip(*_POWER_SHAPE_ANCHORS_25RX))


def _det_uniform(seed: int, *keys: float) -> float:
    """Deterministic pseudo-uniform in (0,1) from a seed + float keys."""
    h = hash((seed,) + tuple(round(k * 1e6) for k in keys)) & 0xFFFFFFFF
    return (h + 0.5) / 4294967296.0


@dataclasses.dataclass
class LinkTestResult:
    """One voltage point of the sweep (paper §VI-B workload)."""
    speed_gbps: float
    v_tx: float
    v_rx: float
    bytes_sent: int
    bytes_received: int
    bit_errors: float
    ber: float                # measured BER (0.0 when below detection)
    ber_true: float           # model ground truth (for validation tests)
    latency_ns: float
    tx_power_w: float
    rx_power_w: float
    link_up: bool


class GtxLinkModel:
    """Voltage-sensitive serial-link behavioural model (see module docstring)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    # -- reliability ---------------------------------------------------------
    def _log10_ber_side(self, v: float, onset: float, collapse: float,
                        hard_floor: bool) -> float:
        """log10(BER) contributed by one side at supply voltage v.

        Piecewise: detection floor above `onset`; a steep ramp
        -9.5 -> -6.0 over the 5 mV transition band (paper Fig 12c); then a
        gradual rise toward -3 at the collapse voltage."""
        if v >= onset:
            return BER_FLOOR_LOG10
        d = onset - v
        if d <= 0.005:  # the 5 mV transition band (Fig 12c anchor offsets)
            ramp = ((0.000, -9.5), (0.001, -9.0), (0.003, -7.0), (0.005, -6.0))
            for (d0, y0), (d1, y1) in zip(ramp, ramp[1:]):
                if d <= d1:
                    return y0 + (d - d0) / (d1 - d0) * (y1 - y0)
        lo = -6.0
        span = max(1e-4, onset - 0.005 - collapse)
        frac = min(1.0, (d - 0.005) / span)
        return lo + frac * 3.0 if hard_floor else lo + frac * 1.5

    def log10_ber(self, v_tx: float, v_rx: float, speed_gbps: float) -> float:
        rx = self._log10_ber_side(v_rx, RX_BER_ONSET_V[speed_gbps],
                                  RX_COLLAPSE_V[speed_gbps], hard_floor=True)
        tx = self._log10_ber_side(v_tx, TX_BER_ONSET_V[speed_gbps],
                                  RX_COLLAPSE_V[speed_gbps] - 0.05, hard_floor=False)
        # independent error sources: BER ~ ber_tx + ber_rx
        return math.log10(10.0 ** rx + 10.0 ** tx)

    def received_fraction(self, v_rx: float, speed_gbps: float) -> float:
        """Received-data-size model: full payload above the collapse voltage,
        sharp noisy drop below it (paper Fig 12a: 'the received data size
        drops sharply'). Only the RX side collapses (Fig 13a)."""
        collapse = RX_COLLAPSE_V[speed_gbps]
        if v_rx >= collapse:
            return 1.0
        depth = (collapse - v_rx) / 0.008
        frac = math.exp(-depth)
        jitter = 0.2 + 0.8 * _det_uniform(self.seed, v_rx, speed_gbps, 1.0)
        return max(0.0, min(1.0, frac * jitter))

    # -- performance -----------------------------------------------------------
    def latency_ns(self, v_tx: float, v_rx: float, speed_gbps: float) -> float:
        base = LATENCY_BASE_NS[speed_gbps]
        onset = LATENCY_EXCURSION_ONSET_V[speed_gbps]
        v_eff = min(v_rx, v_tx + 0.05)  # RX-dominant (paper §VI-D)
        if v_eff >= onset:
            return base
        # Below the excursion onset: frequent large spikes (paper Fig 15).
        depth = (onset - v_eff) / max(1e-6, onset - 0.70)
        p_spike = min(0.9, 0.15 + 0.8 * depth)
        u = _det_uniform(self.seed, v_tx, v_rx, speed_gbps)
        if u < p_spike:
            mag = 10.0 ** (1.0 + 2.0 * _det_uniform(self.seed + 1, v_tx, v_rx, speed_gbps))
            return base + mag * 100.0  # spikes up to ~100x baseline
        return base

    # -- power ------------------------------------------------------------------
    def rail_power_w(self, side: str, v: float, speed_gbps: float) -> float:
        if side not in ("tx", "rx"):
            raise ValueError(f"side must be tx|rx, got {side}")
        base = (TX_POWER_1V0_W if side == "tx" else RX_POWER_1V0_W)[speed_gbps]
        shape = _POWER_SHAPE_25RX if (side == "rx" and speed_gbps == 2.5) else _POWER_SHAPE
        return base * shape(v)

    def current_a(self, side: str, v: float, speed_gbps: float) -> float:
        """Rail current for READ_IOUT telemetry."""
        return self.rail_power_w(side, v, speed_gbps) / max(v, 1e-6)

    # -- the full link test -------------------------------------------------------
    def run_link_test(self, v_tx: float, v_rx: float, speed_gbps: float,
                      payload_bytes: int = PAYLOAD_BYTES_DEFAULT) -> LinkTestResult:
        """Simulate one test point: TX sends `payload_bytes` of count-up data,
        RX checks correctness (paper §VI-B)."""
        if speed_gbps not in SPEEDS_GBPS:
            raise ValueError(f"speed {speed_gbps} not in {SPEEDS_GBPS}")
        frac = self.received_fraction(v_rx, speed_gbps)
        bytes_received = int(payload_bytes * frac)
        bits_received = bytes_received * 8
        ber_true = 10.0 ** self.log10_ber(v_tx, v_rx, speed_gbps)
        expected_errors = ber_true * bits_received
        # Detection floor: with < ~0.5 expected errors the counter reads zero.
        if expected_errors < 0.5:
            bit_errors = 0.0
        else:
            # deterministic Poisson-ish jitter around the expectation
            jitter = 0.7 + 0.6 * _det_uniform(self.seed, v_tx, v_rx, speed_gbps, 2.0)
            bit_errors = expected_errors * jitter
        ber_meas = bit_errors / bits_received if bits_received else 1.0
        return LinkTestResult(
            speed_gbps=speed_gbps, v_tx=v_tx, v_rx=v_rx,
            bytes_sent=int(payload_bytes), bytes_received=bytes_received,
            bit_errors=bit_errors, ber=ber_meas, ber_true=ber_true,
            latency_ns=self.latency_ns(v_tx, v_rx, speed_gbps),
            tx_power_w=self.rail_power_w("tx", v_tx, speed_gbps),
            rx_power_w=self.rail_power_w("rx", v_rx, speed_gbps),
            link_up=frac > 0.5,
        )

    # -- sweep helper (the §VI-B procedure) ----------------------------------------
    def sweep(self, speed_gbps: float, mode: str = "both",
              v_start: float = 1.0, v_stop: float = 0.70, step: float = 0.001,
              payload_bytes: int = PAYLOAD_BYTES_DEFAULT) -> list[LinkTestResult]:
        """Voltage sweep 1.0 -> 0.7 V at 1 mV steps (paper Table X).

        mode: 'both' (TX=RX swept), 'tx' (RX fixed 1.0 V), 'rx' (TX fixed 1.0 V).
        """
        if mode not in ("both", "tx", "rx"):
            raise ValueError(f"bad mode {mode}")
        out = []
        n = int(round((v_start - v_stop) / step)) + 1
        for i in range(n):
            v = round(v_start - i * step, 6)
            v_tx = v if mode in ("both", "tx") else NOMINAL_V
            v_rx = v if mode in ("both", "rx") else NOMINAL_V
            out.append(self.run_link_test(v_tx, v_rx, speed_gbps, payload_bytes))
        return out
