"""Host-side bit-granular serialization for headers and metadata.

Counterpart of the reference BitMemoryReader/Writer
(BitMemory.h:28-435).  Used only for *small* control structures (archive
headers, block section tables, model descriptors); bulk payloads are written
as raw byte blobs produced by device kernels.  Big-endian bit order within a
byte (MSB first), matching the reference's convention.
"""
from __future__ import annotations

import numpy as np

from ..config import DsrcException


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0        # bit accumulator (MSB-aligned within _nbits)
        self._nbits = 0

    def put_bit(self, b: int) -> None:
        self.put_bits(b & 1, 1)

    def put_bits(self, value: int, nbits: int) -> None:
        if nbits < 0 or (nbits < 64 and value >> nbits):
            raise DsrcException(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def put_byte(self, v: int) -> None:
        self.put_bits(v, 8)

    def put_uint16(self, v: int) -> None:
        self.put_bits(v, 16)

    def put_uint32(self, v: int) -> None:
        self.put_bits(v, 32)

    def put_uint64(self, v: int) -> None:
        self.put_bits(v, 64)

    def put_varint(self, v: int) -> None:
        """LEB128-style varint (7 bits per byte, MSB = continuation)."""
        if v < 0:
            raise DsrcException("varint must be non-negative")
        self.flush()
        while True:
            b = v & 0x7F
            v >>= 7
            self._bytes.append(b | (0x80 if v else 0))
            if not v:
                break

    def put_svarint(self, v: int) -> None:
        """Zigzag-coded signed varint."""
        self.put_varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def put_bytes(self, data) -> None:
        self.flush()
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self._bytes.extend(data)

    def flush(self) -> None:
        """Pad to a byte boundary with zero bits."""
        if self._nbits:
            self.put_bits(0, 8 - self._nbits)

    @property
    def byte_position(self) -> int:
        return len(self._bytes)

    def getvalue(self) -> bytes:
        self.flush()
        return bytes(self._bytes)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self._data = data
        self._pos = pos
        self._acc = 0
        self._nbits = 0

    def get_bit(self) -> int:
        return self.get_bits(1)

    def get_bits(self, nbits: int) -> int:
        while self._nbits < nbits:
            if self._pos >= len(self._data):
                raise DsrcException("bit stream underflow")
            self._acc = (self._acc << 8) | self._data[self._pos]
            self._pos += 1
            self._nbits += 8
        self._nbits -= nbits
        v = (self._acc >> self._nbits) & ((1 << nbits) - 1)
        self._acc &= (1 << self._nbits) - 1
        return v

    def get_byte(self) -> int:
        return self.get_bits(8)

    def get_uint16(self) -> int:
        return self.get_bits(16)

    def get_uint32(self) -> int:
        return self.get_bits(32)

    def get_uint64(self) -> int:
        return self.get_bits(64)

    def get_varint(self) -> int:
        self.align()
        v = 0
        shift = 0
        while True:
            if self._pos >= len(self._data):
                raise DsrcException("varint underflow")
            b = self._data[self._pos]
            self._pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def get_svarint(self) -> int:
        u = self.get_varint()
        return (u >> 1) ^ -(u & 1)

    def get_bytes(self, n: int) -> bytes:
        self.align()
        if self._pos + n > len(self._data):
            raise DsrcException("byte stream underflow")
        out = self._data[self._pos:self._pos + n]
        self._pos += n
        return out

    def align(self) -> None:
        self._acc = 0
        self._nbits = 0

    @property
    def byte_position(self) -> int:
        return self._pos
