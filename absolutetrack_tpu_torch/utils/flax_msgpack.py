"""A small msgpack codec for flax's checkpoint format, so that the port
reads and writes the JAX package's param files without flax or msgpack.

It covers what ``flax.serialization.to_bytes`` writes for a param tree:
maps, str, bin, arrays, ints, floats, nil and bool, and the ndarray
extension (code 1), whose payload is itself the msgpack array
``[shape, dtype name, raw C-order bytes]``. Each value takes the shortest
header that the msgpack-python packer picks, so the bytes written equal
flax's for the same tree. Flax's chunked form of arrays of 2**30 bytes or
more (``__msgpack_chunked_array__``) is refused with an error.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
CHUNKED_MARKER = "__msgpack_chunked_array__"


def _sized(out: bytearray, n: int, fix: int | None, fix_limit: int, codes) -> None:
    """A header for a length ``n``: ``fix | n`` below ``fix_limit``, else
    the 8/16/32-bit code (``codes``; an entry is None where msgpack has no
    such header)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: integer {n} is too large")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: integer {n} is too small")


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _sized(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, (bytes, bytearray)):
        _sized(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _sized(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, dict):
        _sized(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in x.items():
            _pack(out, key)
            _pack(out, value)
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.fields is not None:
            raise ValueError(f"msgpack: arrays of dtype {x.dtype} are not supported")
        payload = packb([list(x.shape), x.dtype.name, x.tobytes("C")])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            _sized(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"msgpack: cannot pack {type(x).__name__}")


def packb(x) -> bytes:
    """``x`` (dicts, lists, str, bytes, int, float, None, bool, ndarrays) as msgpack."""
    out = bytearray()
    _pack(out, x)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: data ends inside a value")
        view = self.data[self.pos : self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return [self.value() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sizes:
            data = self.take(self.unpack(sizes[b]))
            return bytes(data) if b < 0xC7 else str(data, "utf-8")
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        ext_sizes = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in ext_sizes:
            return self.ext(ext_sizes[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if CHUNKED_MARKER in out:
            raise ValueError(
                "msgpack: a chunked array (flax splits leaves of 2**30 bytes or more) is not supported"
            )
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported extension type {code}")
        shape, dtype, raw = unpackb(payload)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes):
    """One msgpack value from ``data`` (all of it), ndarray extensions as numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the value")
    return out
