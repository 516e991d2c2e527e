"""UCD9248 regulator-channel model (paper Fig 6 + §V-B dynamics). Copied
from `repro/core/regulator.py`.

The UCD9248 does not apply VOUT_COMMAND directly to the DAC: the programmed
value passes through calibration offset, limit clamping, and scaling before
driving the DAC reference (paper Fig 6), and the rail then slews toward the
new reference with finite regulator response ("voltage adjustment must be
treated as a regulator-level operation with finite response and settling
time, not as an instantaneous rail change").

Dynamics model: slew-rate-limited first-order response,

    dv/dt = clip((v_ref - v) / tau, -slew, +slew)

which has a closed-form piecewise solution (linear ramp while the error
exceeds slew*tau, exponential tail inside). The (slew, tau) defaults are
calibrated so that the full HW-path/400 kHz voltage-update sequence
(PAGE + 4 threshold writes + VOUT_COMMAND, paper §IV-E) plus settling for a
1.0 V -> 0.5 V step completes end-to-end in 2.3 ms (paper Fig 7a), with
transition time monotone in the step size |dV| (paper Fig 7b).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import codecs

# Calibrated dynamics (see module docstring + EXPERIMENTS.md validation).
DEFAULT_SLEW_V_PER_S = 350.0      # 0.35 V/ms slew limit
DEFAULT_TAU_S = 0.17e-3           # first-order tail time constant
DEFAULT_ADC_NOISE_V = 0.3e-3      # telemetry readback noise sigma (V)


@dataclasses.dataclass
class _Segment:
    """One commanded transition: closed-form v(t) for t >= t0."""
    t0: float
    v_start: float
    v_target: float
    slew: float
    tau: float

    def voltage_at(self, t: float) -> float:
        dt = max(0.0, t - self.t0)
        err0 = self.v_target - self.v_start
        sgn = 1.0 if err0 >= 0 else -1.0
        knee = self.slew * self.tau  # error magnitude where ramp -> exponential
        if abs(err0) > knee:
            t_lin = (abs(err0) - knee) / self.slew
            if dt <= t_lin:
                return self.v_start + sgn * self.slew * dt
            # exponential tail from error = knee
            return self.v_target - sgn * knee * math.exp(-(dt - t_lin) / self.tau)
        # small step: pure first-order response
        return self.v_target - err0 * math.exp(-dt / self.tau)

    def time_to_band(self, band_v: float) -> float:
        """Time after t0 until |v - v_target| <= band_v (stays inside after)."""
        err0 = abs(self.v_target - self.v_start)
        if err0 <= band_v:
            return 0.0
        knee = self.slew * self.tau
        if err0 > knee:
            t_lin = (err0 - knee) / self.slew
            if band_v >= knee:
                return (err0 - band_v) / self.slew
            return t_lin + self.tau * math.log(knee / band_v)
        return self.tau * math.log(err0 / band_v)


class RegulatorChannel:
    """One output channel (= one PAGE) of a UCD9248-like regulator."""

    def __init__(
        self,
        nominal_v: float,
        v_min: float,
        v_max: float,
        *,
        cal_offset_v: float = 0.0,
        dac_gain: float = 1.0,
        slew_v_per_s: float = DEFAULT_SLEW_V_PER_S,
        tau_s: float = DEFAULT_TAU_S,
        adc_noise_v: float = DEFAULT_ADC_NOISE_V,
        seed: int = 0,
    ):
        self.nominal_v = nominal_v
        self.v_min = v_min
        self.v_max = v_max
        self.cal_offset_v = cal_offset_v
        self.dac_gain = dac_gain
        self.slew = slew_v_per_s
        self.tau = tau_s
        self.adc_noise_v = adc_noise_v
        self._seed = seed
        self._segment = _Segment(0.0, nominal_v, nominal_v, self.slew, self.tau)
        # Protection/monitoring registers (written via PMBus; paper §IV-E).
        self.uv_warn_limit_v = nominal_v * 0.9
        self.uv_fault_limit_v = nominal_v * 0.85
        self.power_good_on_v = nominal_v * 0.92
        self.power_good_off_v = nominal_v * 0.88
        self.fault_latched = False

    # -- Fig 6 control path ------------------------------------------------
    def _reference_from_command(self, commanded_v: float) -> float:
        """VOUT_COMMAND -> cal offset -> limit clamp -> scale -> DAC ref."""
        v = commanded_v + self.cal_offset_v
        v = min(max(v, self.v_min), self.v_max)
        return v * self.dac_gain

    def command_voltage(self, commanded_v: float, t_now: float) -> float:
        """Apply a VOUT_COMMAND at simulated time `t_now` (end of the PMBus
        transaction). Returns the post-clamp DAC reference actually used."""
        v_now = self.voltage_at(t_now)
        ref = self._reference_from_command(commanded_v)
        self._segment = _Segment(t_now, v_now, ref, self.slew, self.tau)
        return ref

    # -- observation --------------------------------------------------------
    def voltage_at(self, t: float) -> float:
        return self._segment.voltage_at(t)

    def telemetry_voltage(self, t: float) -> float:
        """ADC-sampled readback: true rail voltage + deterministic noise,
        quantized to LINEAR16 resolution (what READ_VOUT returns)."""
        v = self.voltage_at(t)
        # Deterministic noise: hash of (seed, quantized time) -> ~N(0, sigma).
        h = hash((self._seed, round(t * 1e7))) & 0xFFFFFFFF
        u1 = ((h & 0xFFFF) + 0.5) / 65536.0
        u2 = (((h >> 16) & 0xFFFF) + 0.5) / 65536.0
        gauss = math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)
        v_noisy = v + gauss * self.adc_noise_v
        word = codecs.linear16_encode(max(0.0, v_noisy))
        return codecs.linear16_decode(word)

    def update_faults(self, t: float) -> None:
        if self.voltage_at(t) < self.uv_fault_limit_v:
            self.fault_latched = True

    def power_good(self, t: float) -> bool:
        v = self.voltage_at(t)
        return v >= self.power_good_off_v

    def settle_time_to_band(self, band_v: float) -> float:
        """Analytic time (s) from the last command until the rail is inside
        +/- band_v of its target. Used for calibration tests; the benchmarks
        measure the same thing from sampled telemetry via §V-D detection."""
        return self._segment.time_to_band(band_v)

    @property
    def target_v(self) -> float:
        return self._segment.v_target
