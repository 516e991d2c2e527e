"""PMBus fixed-point payload codecs (paper §IV-B). Copied from
`repro/core/codecs.py`.

VolTune encodes voltage programming/readback payloads in LINEAR16 and some
telemetry (e.g. READ_IOUT) in LINEAR11, matching the UCD9248 configuration on
KC705 [paper Table I, §IV-B]. These are exact bit-level implementations of the
PMBus Part II formats:

  LINEAR16:  value = mantissa * 2**exponent
             mantissa: unsigned 16-bit word; exponent: signed 5-bit from
             VOUT_MODE (UCD9248 uses -12 => ~0.2441 mV resolution).
  LINEAR11:  one 16-bit word: [15:11] signed 5-bit exponent N,
             [10:0] signed 11-bit mantissa Y; value = Y * 2**N.
"""

from __future__ import annotations

# UCD9248 VOUT_MODE exponent used on KC705 (2^-12 V per LSB).
VOUT_MODE_EXPONENT = -12


def _twos_complement(value: int, bits: int) -> int:
    """Interpret the low `bits` of `value` as a signed two's-complement int."""
    mask = (1 << bits) - 1
    value &= mask
    if value & (1 << (bits - 1)):
        value -= 1 << bits
    return value


def _to_twos_complement(value: int, bits: int) -> int:
    """Encode a signed int into `bits`-wide two's complement (raises on overflow)."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if not lo <= value <= hi:
        raise ValueError(f"{value} does not fit in {bits}-bit two's complement")
    return value & ((1 << bits) - 1)


# ---------------------------------------------------------------------------
# LINEAR16 (voltage programming / readback: VOUT_COMMAND, READ_VOUT, limits)
# ---------------------------------------------------------------------------

def linear16_encode(volts: float, exponent: int = VOUT_MODE_EXPONENT) -> int:
    """Encode a voltage into a LINEAR16 mantissa word for the given VOUT_MODE
    exponent. Clamps to the representable [0, 0xFFFF * 2**exp] range, which is
    what the UCD9248 limit stage does before the DAC (paper Fig 6)."""
    if exponent > 0:
        lsb = float(1 << exponent)
    else:
        lsb = 1.0 / float(1 << (-exponent))
    mantissa = int(round(volts / lsb))
    return max(0, min(0xFFFF, mantissa))


def linear16_decode(mantissa: int, exponent: int = VOUT_MODE_EXPONENT) -> float:
    """Decode a LINEAR16 mantissa word into volts."""
    if not 0 <= mantissa <= 0xFFFF:
        raise ValueError(f"LINEAR16 mantissa out of range: {mantissa}")
    if exponent > 0:
        return float(mantissa << exponent)
    return mantissa / float(1 << (-exponent))


def linear16_resolution(exponent: int = VOUT_MODE_EXPONENT) -> float:
    """Volts per LSB — the regulator resolution limit (paper §I: 'fine-grained
    voltage adjustment within regulator resolution limits')."""
    return linear16_decode(1, exponent)


# ---------------------------------------------------------------------------
# LINEAR11 (telemetry: READ_IOUT and friends)
# ---------------------------------------------------------------------------

def linear11_encode(value: float, exponent: int | None = None) -> int:
    """Encode a real value into a LINEAR11 word.

    If `exponent` is None, picks the smallest exponent that fits the value in
    the 11-bit signed mantissa with maximum precision (the strategy PMBus
    devices use for telemetry).
    """
    if exponent is None:
        exponent = -16
        while exponent < 15:
            mant = round(value / (2.0 ** exponent))
            if -1024 <= mant <= 1023:
                break
            exponent += 1
        else:
            raise ValueError(f"value {value} not representable in LINEAR11")
    mantissa = int(round(value / (2.0 ** exponent)))
    if not -1024 <= mantissa <= 1023:
        raise ValueError(f"mantissa {mantissa} out of 11-bit range (exp={exponent})")
    return (_to_twos_complement(exponent, 5) << 11) | _to_twos_complement(mantissa, 11)


def linear11_decode(word: int) -> float:
    """Decode a LINEAR11 word into a real value."""
    if not 0 <= word <= 0xFFFF:
        raise ValueError(f"LINEAR11 word out of range: {word}")
    exponent = _twos_complement(word >> 11, 5)
    mantissa = _twos_complement(word & 0x7FF, 11)
    return mantissa * (2.0 ** exponent)


def word_to_bytes_le(word: int) -> tuple[int, int]:
    """PMBus words are transmitted low byte first (SMBus convention)."""
    return (word & 0xFF, (word >> 8) & 0xFF)


def bytes_le_to_word(lo: int, hi: int) -> int:
    return ((hi & 0xFF) << 8) | (lo & 0xFF)
