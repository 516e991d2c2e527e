"""PMBus transaction engine + UCD9248 device model (paper §IV). Copied
from `repro/core/pmbus.py`.

Wire-level timing model (paper §IV-A, Fig 4): PMBus is an I2C-compatible
two-wire bus. Every byte costs 9 SCL periods (8 data bits + ACK on the 9th
clock pulse); START, repeated-START and STOP each cost one period. The
engine supports the exact transaction primitives of Fig 4:

    Write Byte : S  addr+W  cmd  data                 P   -> 29 clocks
    Write Word : S  addr+W  cmd  lo  hi               P   -> 38 clocks
    Read Byte  : S  addr+W  cmd  Sr  addr+R  data     P   -> 39 clocks
    Read Word  : S  addr+W  cmd  Sr  addr+R  lo  hi   P   -> 48 clocks

and the two PMBus clock rates used by VolTune, 100 kHz and 400 kHz
(paper §IV-B). Transactions execute atomically and serially (paper §IV-F):
the engine refuses to start a transaction before the previous one completed.

The UCD9248 model implements exactly the Table I command subset with PAGE
multiplexing across output channels, LINEAR16 voltage registers, and
READ_VOUT/READ_IOUT telemetry backed by `RegulatorChannel` dynamics.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Callable

from repro_torch.core import codecs
from repro_torch.core.rails import Rail, RailMap
from repro_torch.core.regulator import RegulatorChannel


# ---------------------------------------------------------------------------
# PMBus command bytes (paper Table I)
# ---------------------------------------------------------------------------

class Cmd(enum.IntEnum):
    PAGE = 0x00
    CLEAR_FAULTS = 0x03
    VOUT_COMMAND = 0x21
    VOUT_UV_WARN_LIMIT = 0x43
    VOUT_UV_FAULT_LIMIT = 0x44
    POWER_GOOD_ON = 0x5E
    POWER_GOOD_OFF = 0x5F
    READ_VOUT = 0x8B
    READ_IOUT = 0x8C


class Primitive(enum.Enum):
    WRITE_BYTE = "write_byte"
    WRITE_WORD = "write_word"
    READ_BYTE = "read_byte"
    READ_WORD = "read_word"
    SEND_BYTE = "send_byte"  # command only, no payload (CLEAR_FAULTS)


# SCL periods per primitive: 9 per byte + START/STOP/repeated-START framing.
_CLOCKS = {
    Primitive.SEND_BYTE: 2 + 2 * 9,    # S addr cmd P
    Primitive.WRITE_BYTE: 2 + 3 * 9,   # S addr cmd data P            = 29
    Primitive.WRITE_WORD: 2 + 4 * 9,   # S addr cmd lo hi P           = 38
    Primitive.READ_BYTE: 3 + 4 * 9,    # S addr cmd Sr addr data P    = 39
    Primitive.READ_WORD: 3 + 5 * 9,    # S addr cmd Sr addr lo hi P   = 48
}

SUPPORTED_CLOCK_HZ = (100_000, 400_000)


def primitive_clocks(p: Primitive) -> int:
    return _CLOCKS[p]


def transaction_seconds(p: Primitive, clock_hz: int) -> float:
    if clock_hz not in SUPPORTED_CLOCK_HZ:
        raise ValueError(f"unsupported PMBus clock {clock_hz}; VolTune uses {SUPPORTED_CLOCK_HZ}")
    return _CLOCKS[p] / float(clock_hz)


@dataclasses.dataclass
class Transaction:
    primitive: Primitive
    address: int
    command: int
    payload: tuple[int, ...] = ()


@dataclasses.dataclass
class Completion:
    """Structured status returned to the PowerManager (paper §IV-B: 'protocol
    failures ... reported through structured status signals')."""
    ok: bool
    data: tuple[int, ...] = ()
    nack: bool = False
    error: str | None = None
    t_start: float = 0.0
    t_end: float = 0.0


class SimClock:
    """Monotonic simulated time in seconds shared by bus + regulators."""

    def __init__(self) -> None:
        self._t = 0.0

    @property
    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("time cannot go backwards")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        """Advance to absolute time `t` (no-op if already past it)."""
        if t > self._t:
            self._t = t
        return self._t

    def age(self, t: float) -> float:
        """Seconds elapsed since timestamp `t` (clamped at 0 — a sample from
        a segment clock that ran ahead of fleet time is 'fresh', not from
        the future). Used to stamp staleness onto POLLED telemetry frames."""
        return max(0.0, self._t - t)


@dataclasses.dataclass(order=True)
class Event:
    """One scheduled callback on a simulated timeline. Ordering is
    (time, seq) so simultaneous events fire in scheduling order."""
    t: float
    seq: int
    fn: Callable[[float], None] = dataclasses.field(compare=False)


class EventQueue:
    """Discrete-event scheduler over simulated time.

    The fleet bus model (fleet.py) uses this to let N per-board bus segments
    make progress concurrently in simulated time: work on each segment is
    scheduled as events on the shared fleet timeline and drained in global
    time order, instead of serializing the whole world through one PmBus."""

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = 0
        self.processed = 0

    def __len__(self) -> int:
        return len(self._heap)

    def schedule(self, t: float, fn: Callable[[float], None]) -> Event:
        ev = Event(t, self._seq, fn)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def next_time(self) -> float | None:
        return self._heap[0].t if self._heap else None

    def schedule_periodic(self, t0: float,
                          fn: Callable[[float], float | None]) -> Event:
        """Self-rescheduling event: `fn(t_fire)` returns the *absolute* time
        of its next firing, or None to stop. The callback choosing its own
        next time (rather than a fixed period) is what lets periodic
        telemetry polling degrade gracefully under back-pressure instead of
        accumulating an unbounded backlog of overdue polls (fleet.py)."""
        def wrapper(t_fire: float) -> None:
            nxt = fn(t_fire)
            if nxt is None:
                return
            if nxt <= t_fire:
                raise ValueError(
                    f"periodic event must advance: next={nxt} <= t={t_fire}")
            self.schedule(nxt, wrapper)
        return self.schedule(t0, wrapper)

    def run_until(self, t: float) -> int:
        """Pop and run every event with fire time <= t, in (time, seq) order.
        Returns the number of events processed. Events may schedule further
        events; those are honored in the same drain if they land <= t."""
        n = 0
        while self._heap and self._heap[0].t <= t:
            ev = heapq.heappop(self._heap)
            ev.fn(ev.t)
            n += 1
        self.processed += n
        return n

    def run_all(self) -> int:
        n = 0
        while self._heap:
            ev = heapq.heappop(self._heap)
            ev.fn(ev.t)
            n += 1
        self.processed += n
        return n


# ---------------------------------------------------------------------------
# UCD9248 device model
# ---------------------------------------------------------------------------

class Ucd9248:
    """A multi-rail digital PWM controller at one PMBus address.

    PAGE selects the output channel for subsequent commands (paper §IV-A:
    'Rail selection is performed using the PAGE mechanism').
    `loads` optionally maps page -> current(volts, t) for READ_IOUT telemetry.
    """

    def __init__(
        self,
        address: int,
        channels: dict[int, RegulatorChannel],
        loads: dict[int, Callable[[float, float], float]] | None = None,
    ):
        self.address = address
        self.channels = channels
        self.loads = loads or {}
        self.page = 0

    def _chan(self) -> RegulatorChannel | None:
        return self.channels.get(self.page)

    def handle(self, txn: Transaction, t_end: float) -> Completion:
        cmd, p = txn.command, txn.primitive
        ch = self._chan()

        if cmd == Cmd.PAGE:
            if p == Primitive.WRITE_BYTE:
                if txn.payload[0] not in self.channels:
                    return Completion(False, nack=True, error=f"bad PAGE {txn.payload[0]}")
                self.page = txn.payload[0]
                return Completion(True)
            if p == Primitive.READ_BYTE:
                return Completion(True, data=(self.page,))

        if ch is None:
            return Completion(False, nack=True, error=f"no channel at page {self.page}")

        if cmd == Cmd.CLEAR_FAULTS and p == Primitive.SEND_BYTE:
            ch.fault_latched = False
            return Completion(True)

        if cmd == Cmd.VOUT_COMMAND:
            if p == Primitive.WRITE_WORD:
                volts = codecs.linear16_decode(codecs.bytes_le_to_word(*txn.payload))
                ch.command_voltage(volts, t_end)
                return Completion(True)
            if p == Primitive.READ_WORD:
                word = codecs.linear16_encode(ch.target_v)
                return Completion(True, data=codecs.word_to_bytes_le(word))

        _limit_attrs = {
            Cmd.VOUT_UV_WARN_LIMIT: "uv_warn_limit_v",
            Cmd.VOUT_UV_FAULT_LIMIT: "uv_fault_limit_v",
            Cmd.POWER_GOOD_ON: "power_good_on_v",
            Cmd.POWER_GOOD_OFF: "power_good_off_v",
        }
        if cmd in _limit_attrs:
            attr = _limit_attrs[Cmd(cmd)]
            if p == Primitive.WRITE_WORD:
                volts = codecs.linear16_decode(codecs.bytes_le_to_word(*txn.payload))
                setattr(ch, attr, volts)
                return Completion(True)
            if p == Primitive.READ_WORD:
                word = codecs.linear16_encode(getattr(ch, attr))
                return Completion(True, data=codecs.word_to_bytes_le(word))

        if cmd == Cmd.READ_VOUT and p == Primitive.READ_WORD:
            v = ch.telemetry_voltage(t_end)
            ch.update_faults(t_end)
            return Completion(True, data=codecs.word_to_bytes_le(codecs.linear16_encode(v)))

        if cmd == Cmd.READ_IOUT and p == Primitive.READ_WORD:
            load = self.loads.get(self.page)
            v = ch.voltage_at(t_end)
            amps = load(v, t_end) if load is not None else 0.0
            return Completion(True, data=codecs.word_to_bytes_le(codecs.linear11_encode(amps)))

        return Completion(False, nack=True,
                          error=f"unsupported cmd 0x{cmd:02X} primitive {p.value}")


# ---------------------------------------------------------------------------
# The bus
# ---------------------------------------------------------------------------

class PmBus:
    """Serialized PMBus master. One transaction in flight at a time
    (paper §IV-F: 'A new PMBus request is not issued until the previous
    request completes')."""

    def __init__(self, clock: SimClock, clock_hz: int = 400_000):
        if clock_hz not in SUPPORTED_CLOCK_HZ:
            raise ValueError(f"unsupported PMBus clock {clock_hz}")
        self.clock = clock
        self.clock_hz = clock_hz
        self.devices: dict[int, Ucd9248] = {}
        self._busy = False
        self.transaction_count = 0
        self.busy_seconds = 0.0

    def attach(self, dev: Ucd9248) -> None:
        if dev.address in self.devices:
            raise ValueError(f"duplicate PMBus address {dev.address}")
        self.devices[dev.address] = dev

    def execute(self, txn: Transaction) -> Completion:
        if self._busy:
            raise RuntimeError("PMBus transaction overlap — serialization violated")
        self._busy = True
        try:
            t_start = self.clock.now
            dt = transaction_seconds(txn.primitive, self.clock_hz)
            t_end = self.clock.advance(dt)
            self.transaction_count += 1
            self.busy_seconds += dt
            dev = self.devices.get(txn.address)
            if dev is None:
                # Address NACK: full addressing cost was still paid on the wire.
                return Completion(False, nack=True, error=f"address NACK 0x{txn.address:02X}",
                                  t_start=t_start, t_end=t_end)
            comp = dev.handle(txn, t_end)
            comp.t_start, comp.t_end = t_start, t_end
            return comp
        finally:
            self._busy = False


# ---------------------------------------------------------------------------
# Board assembly
# ---------------------------------------------------------------------------

def build_board(
    rail_map: RailMap,
    clock: SimClock | None = None,
    clock_hz: int = 400_000,
    loads: dict[str, Callable[[float, float], float]] | None = None,
    seed: int = 0,
) -> tuple[SimClock, PmBus, dict[int, RegulatorChannel]]:
    """Instantiate regulators + bus for a rail map (KC705 or TPU logical).

    Returns (clock, bus, channels_by_lane). `loads` maps rail *name* ->
    current(volts, t) for READ_IOUT telemetry.
    """
    clock = clock or SimClock()
    bus = PmBus(clock, clock_hz)
    channels_by_lane: dict[int, RegulatorChannel] = {}
    loads = loads or {}
    for address in rail_map.devices():
        pages = rail_map.pages_for_device(address)
        chans: dict[int, RegulatorChannel] = {}
        page_loads: dict[int, Callable[[float, float], float]] = {}
        for page, rail in pages.items():
            ch = RegulatorChannel(rail.nominal_v, rail.v_min, rail.v_max,
                                  seed=seed * 131 + rail.lane)
            chans[page] = ch
            channels_by_lane[rail.lane] = ch
            if rail.name in loads:
                page_loads[page] = loads[rail.name]
        bus.attach(Ucd9248(address, chans, page_loads))
    return clock, bus, channels_by_lane
