"""Deterministic binary codec for protocol structures ("mcode").

The reference serializes with protobuf (``server/messages/MochiProtocol.proto``
+ Netty varint framing, ``MochiClientInitializer.java:14-26``).  Protobuf's
encoding is not canonical across implementations, which matters once messages
are *signed* (the capability the reference declared but never built —
``MochiProtocol.proto:123``).  mcode is a small, canonical-by-construction
structural encoding: one byte tag per value, varint lengths, map keys sorted
bytewise.  The same encoder produces both wire bytes and signing bytes, so
there is no separate canonicalization step to get wrong.

Supported values: None, bool, non-negative int (< 2**64), signed int, bytes,
str (utf-8), list/tuple, dict (str keys, emitted sorted).  The format is
deliberately trivial to re-implement in C++ for the native wire path.
"""

from __future__ import annotations

from typing import Any

# Type tags
T_NONE = 0x00
T_FALSE = 0x01
T_TRUE = 0x02
T_UINT = 0x03
T_NINT = 0x04  # negative int, stores (-1 - n)
T_BYTES = 0x05
T_STR = 0x06
T_LIST = 0x07
T_DICT = 0x08

_MAX_DEPTH = 32
_MAX_LEN = 64 * 1024 * 1024  # 64 MiB guard for lengths/counts


def _write_varint(buf: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _encode_into(buf: bytearray, value: Any, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("mcode: structure too deep")
    if value is None:
        buf.append(T_NONE)
    elif value is True:
        buf.append(T_TRUE)
    elif value is False:
        buf.append(T_FALSE)
    elif isinstance(value, int):
        if value >= 0:
            if value >= 1 << 64:
                raise TypeError(f"mcode int out of range: {value}")
            buf.append(T_UINT)
            _write_varint(buf, value)
        else:
            if -1 - value >= 1 << 64:
                raise TypeError(f"mcode int out of range: {value}")
            buf.append(T_NINT)
            _write_varint(buf, -1 - value)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        buf.append(T_BYTES)
        b = bytes(value)
        _write_varint(buf, len(b))
        buf += b
    elif isinstance(value, str):
        buf.append(T_STR)
        b = value.encode("utf-8")
        _write_varint(buf, len(b))
        buf += b
    elif isinstance(value, (list, tuple)):
        buf.append(T_LIST)
        _write_varint(buf, len(value))
        for item in value:
            _encode_into(buf, item, depth + 1)
    elif isinstance(value, dict):
        buf.append(T_DICT)
        _write_varint(buf, len(value))
        for key in sorted(value):
            if not isinstance(key, str):
                raise TypeError(f"mcode dict keys must be str, got {type(key)}")
            _encode_into(buf, key, depth + 1)
            _encode_into(buf, value[key], depth + 1)
    else:
        raise TypeError(f"mcode cannot encode {type(value)}")


def _encode_py(value: Any) -> bytes:
    """Canonically encode a structural value to bytes (pure Python)."""
    buf = bytearray()
    _encode_into(buf, value, 0)
    return bytes(buf)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_varint(self) -> int:
        shift = 0
        result = 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError("mcode: truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                if result >= 1 << 64:
                    raise ValueError("mcode: varint out of 64-bit range")
                # Canonical-only: a multi-byte varint ending in 0x00 carries
                # no bits in its last byte => non-minimal.  The encoder only
                # emits minimal forms; accepting others would let two
                # distinct frames decode to the same value (and shift the
                # envelope's signed-prefix slice).
                if shift > 0 and b == 0:
                    raise ValueError("mcode: non-canonical varint")
                return result
            shift += 7
            if shift > 63:
                raise ValueError("mcode: varint too long")

    def read_bytes(self, n: int) -> bytes:
        if n > _MAX_LEN:
            raise ValueError("mcode: length guard exceeded")
        if self.pos + n > len(self.data):
            raise ValueError("mcode: truncated value")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_value(self, depth: int = 0) -> Any:
        if depth > _MAX_DEPTH:
            raise ValueError("mcode: structure too deep")
        if self.pos >= len(self.data):
            raise ValueError("mcode: truncated input")
        tag = self.data[self.pos]
        self.pos += 1
        if tag == T_NONE:
            return None
        if tag == T_TRUE:
            return True
        if tag == T_FALSE:
            return False
        if tag == T_UINT:
            return self.read_varint()
        if tag == T_NINT:
            return -1 - self.read_varint()
        if tag == T_BYTES:
            return self.read_bytes(self.read_varint())
        if tag == T_STR:
            return self.read_bytes(self.read_varint()).decode("utf-8")
        if tag == T_LIST:
            n = self.read_varint()
            if n > _MAX_LEN:
                raise ValueError("mcode: list guard exceeded")
            return [self.read_value(depth + 1) for _ in range(n)]
        if tag == T_DICT:
            n = self.read_varint()
            if n > _MAX_LEN:
                raise ValueError("mcode: dict guard exceeded")
            out = {}
            for _ in range(n):
                key = self.read_value(depth + 1)
                if not isinstance(key, str):
                    raise ValueError("mcode: dict key must be str")
                out[key] = self.read_value(depth + 1)
            return out
        raise ValueError(f"mcode: unknown tag {tag:#x}")


def _decode_py(data: bytes) -> Any:
    """Decode bytes produced by :func:`encode`; rejects trailing garbage."""
    reader = _Reader(bytes(data))
    value = reader.read_value()
    if reader.pos != len(reader.data):
        raise ValueError("mcode: trailing bytes after value")
    return value


def _decode_env_py(data: bytes) -> "tuple[list, int]":
    """Decode a wire envelope (top-level 8- or 9-element list) and report
    the stream offset just past element 6.  The signed prefix of an
    envelope is a contiguous slice of its wire encoding (see
    ``messages.Envelope``), so receivers authenticate by slicing instead of
    re-encoding the payload.  The optional 9th element is the
    trace-context field (UNauthenticated, advisory — see
    ``messages.decode_envelope``); 8-element frames stay byte-identical to
    the untraced form.  Tolerance is one-directional: readers older than the
    trace field reject the 9-element form, so traced envelopes require an upgraded
    fleet (docs/OPERATIONS.md §4j)."""
    reader = _Reader(bytes(data))
    if not reader.data or reader.data[0] != T_LIST:
        raise ValueError("mcode: envelope must be a list")
    reader.pos = 1
    n = reader.read_varint()
    if n not in (8, 9):
        raise ValueError(f"mcode: envelope needs 8 or 9 elements, got {n}")
    values = []
    off6 = 0
    for i in range(n):
        values.append(reader.read_value(1))
        if i == 5:
            off6 = reader.pos
    if reader.pos != len(reader.data):
        raise ValueError("mcode: trailing bytes after value")
    return values, off6


# The reference package binds a native codec here when one is built; the
# port has no native/ yet, so the pure-Python codec (the readable spec of
# the format, byte-identical on the wire) is the one in use.
encode, decode, decode_env = _encode_py, _decode_py, _decode_env_py
