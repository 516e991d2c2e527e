"""A MessagePack codec for the checkpoint manifest's subset of values:
nil, bool, int, float, str, list (and tuple) and dict (str keys).

The manifest is MessagePack so that a checkpoint written by the port
restores in the reference and the other way round. `packb` gives the bytes
that `msgpack.packb(obj)` gives with its defaults: ints in their smallest
form (unsigned forms for non-negative values), Python floats as float64,
str as fixstr/str8/str16/str32, lists and tuples as arrays, dicts as maps in
their insertion order. `unpackb` reads every format of the spec but the
extension types (`raw=False`: strings come back as str, bin as bytes,
arrays as lists).
"""

from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, fix=(0xA0, 31), codes=(0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, fix=(0x90, 15), codes=(None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, fix=(0x80, 15), codes=(None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < top:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} too big to pack")
    else:
        for code, fmt, bottom in ((0xD0, ">b", -(1 << 7)),
                                  (0xD1, ">h", -(1 << 15)),
                                  (0xD2, ">i", -(1 << 31)),
                                  (0xD3, ">q", -(1 << 63))):
            if x >= bottom:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} too small to pack")


def _pack_len(n: int, out: bytearray, fix, codes) -> None:
    """The header of a str, array or map of length n: its fix form (base
    code, largest length), else the 8-, 16- or 32-bit length form
    (`codes`, None where the type has no such form)."""
    if n <= fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too long to pack")


# -- decoding -------------------------------------------------------------------

_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}
_STR_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY_LEN = {0xDC: ">H", 0xDD: ">I"}
_MAP_LEN = {0xDE: ">H", 0xDF: ">I"}


def unpackb(data: bytes):
    obj, at = _unpack(memoryview(data), 0)
    if at != len(data):
        raise ValueError(f"{len(data) - at} extra bytes after the object")
    return obj


def _take(buf, at: int, fmt: str):
    n = struct.calcsize(fmt)
    if at + n > len(buf):
        raise ValueError("truncated MessagePack data")
    return struct.unpack_from(fmt, buf, at)[0], at + n


def _bytes(buf, at: int, n: int):
    if at + n > len(buf):
        raise ValueError("truncated MessagePack data")
    return bytes(buf[at:at + n]), at + n


def _unpack(buf, at: int):
    if at >= len(buf):
        raise ValueError("truncated MessagePack data")
    code = buf[at]
    at += 1
    if code < 0x80:
        return code, at
    if code >= 0xE0:
        return code - 0x100, at
    if 0xA0 <= code <= 0xBF:
        raw, at = _bytes(buf, at, code & 0x1F)
        return raw.decode("utf-8"), at
    if 0x90 <= code <= 0x9F:
        return _unpack_array(buf, at, code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _unpack_map(buf, at, code & 0x0F)
    if code == 0xC0:
        return None, at
    if code in (0xC2, 0xC3):
        return code == 0xC3, at
    if code in _FIXED:
        return _take(buf, at, _FIXED[code])
    if code in _STR_LEN:
        n, at = _take(buf, at, _STR_LEN[code])
        raw, at = _bytes(buf, at, n)
        return raw.decode("utf-8"), at
    if code in _BIN_LEN:
        n, at = _take(buf, at, _BIN_LEN[code])
        return _bytes(buf, at, n)
    if code in _ARRAY_LEN:
        n, at = _take(buf, at, _ARRAY_LEN[code])
        return _unpack_array(buf, at, n)
    if code in _MAP_LEN:
        n, at = _take(buf, at, _MAP_LEN[code])
        return _unpack_map(buf, at, n)
    raise ValueError(f"unsupported MessagePack type byte 0x{code:02x}")


def _unpack_array(buf, at: int, n: int):
    out = []
    for _ in range(n):
        x, at = _unpack(buf, at)
        out.append(x)
    return out, at


def _unpack_map(buf, at: int, n: int):
    out = {}
    for _ in range(n):
        k, at = _unpack(buf, at)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"map key of type {type(k).__name__!r}: only "
                             f"str and bytes keys are read")
        out[k], at = _unpack(buf, at)
    return out, at
