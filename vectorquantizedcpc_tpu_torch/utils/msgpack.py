"""A decoder of the msgpack bytes that ``flax.serialization.to_bytes`` writes.

The port's counterpart of ``flax.serialization.msgpack_restore``, which the
JAX package reaches through ``training/checkpoint.py:restore_checkpoint``.
Pure Python over the standard library, numpy and torch: the card's machine
has neither flax nor msgpack.

The subset is what flax writes with ``use_bin_type=True``: maps, arrays,
str, bin, ints of every width, float32 and float64, nil and bools, and
flax's ext types

- 1, an ndarray: a packed ``(shape, dtype name, C-order bytes)``;
- 2, a native complex: a packed ``(real, imag)``;
- 3, a numpy scalar: an ndarray of shape ``()``, unwrapped.

A map ``{"__msgpack_chunked_array__": True, "shape", "chunks"}``, which flax
writes for a leaf over ``MAX_CHUNK_SIZE`` bytes, becomes the array again.
Arrays come back as numpy arrays over the input's buffer (no copy, and no
loop over bytes in Python), except bfloat16 ones, which numpy lacks: those
become ``torch.bfloat16`` tensors. Anything else raises ``ValueError``
naming the byte offset.
"""

import struct
from typing import Any, Union

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # marker -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """One pass over ``data``; ``bin_view`` keeps bin payloads as memoryview
    slices (the arrays' bytes) instead of copying them into ``bytes``."""

    def __init__(self, data: memoryview, base: int, bin_view: bool):
        self.data, self.pos, self.base, self.bin_view = data, 0, base, bin_view

    def fail(self, msg: str, at: int) -> ValueError:
        return ValueError(f"msgpack: {msg} at byte {self.base + at}")

    def take(self, n: int) -> memoryview:
        start, end = self.pos, self.pos + n
        if end > len(self.data):
            raise self.fail(f"truncated input: {n} bytes wanted, {len(self.data) - start} left",
                            start)
        self.pos = end
        return self.data[start:end]

    def unpack(self, fmt: str, size: int) -> Union[int, float]:
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, size: int) -> int:
        return self.unpack(_LENGTH[size], size)

    def value(self) -> Any:
        at = self.pos
        m = self.take(1)[0]
        if m <= 0x7F:
            return m
        if m >= 0xE0:
            return m - 0x100
        if 0x80 <= m <= 0x8F:
            return self.map(m & 0x0F, at)
        if 0x90 <= m <= 0x9F:
            return [self.value() for _ in range(m & 0x0F)]
        if 0xA0 <= m <= 0xBF:
            return self.str(m & 0x1F, at)
        if m == 0xC0:
            return None
        if m in (0xC2, 0xC3):
            return m == 0xC3
        if m in _FIXED:
            return self.unpack(*_FIXED[m])
        if m in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            payload = self.take(self.length(1 << (m - 0xC4)))
            return payload if self.bin_view else bytes(payload)
        if m in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            return self.str(self.length(1 << (m - 0xD9)), at)
        if m in (0xDC, 0xDD):  # array 16 / 32
            return [self.value() for _ in range(self.length(2 if m == 0xDC else 4))]
        if m in (0xDE, 0xDF):  # map 16 / 32
            return self.map(self.length(2 if m == 0xDE else 4), at)
        if m in _FIXEXT:
            return self.ext(_FIXEXT[m], at)
        if m in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            return self.ext(self.length(1 << (m - 0xC7)), at)
        raise self.fail(f"marker 0x{m:02x} is outside the subset flax writes", at)

    def str(self, n: int, at: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise self.fail(f"invalid utf-8 in a str ({e.reason})", at) from None

    def map(self, n: int, at: int) -> Any:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if isinstance(key, (list, dict)):
                raise self.fail("a map key that is a map or an array", key_at)
            out[key] = self.value()
        if out.get(CHUNKED) is True:
            return _unchunk(out, self, at)
        return out

    def ext(self, n: int, at: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        start = self.pos
        payload = self.take(n)
        inner = _Reader(payload, self.base + start, bin_view=True)
        if code == _EXT_COMPLEX:
            parts = inner.whole()
            if not (isinstance(parts, list) and len(parts) == 2):
                raise self.fail("a complex ext that is not (real, imag)", at)
            return complex(parts[0], parts[1])
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = inner.ndarray(at)
            return arr if code == _EXT_NDARRAY else arr[()]
        raise self.fail(f"ext type {code} is outside the subset flax writes", at)

    def whole(self) -> Any:
        value = self.value()
        if self.pos != len(self.data):
            raise self.fail(f"{len(self.data) - self.pos} bytes after the value", self.pos)
        return value

    def ndarray(self, at: int) -> Union[np.ndarray, torch.Tensor]:
        spec = self.whole()
        if not (isinstance(spec, list) and len(spec) == 3 and isinstance(spec[0], list)
                and isinstance(spec[1], str) and isinstance(spec[2], memoryview)):
            raise self.fail("an ndarray ext that is not (shape, dtype, bytes)", at)
        shape, name, buf = tuple(spec[0]), spec[1], spec[2]
        try:
            dtype = np.dtype("int16" if name == "bfloat16" else name)
        except TypeError:
            raise self.fail(f"unknown dtype {name!r}", at) from None
        if dtype.hasobject or len(buf) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise self.fail(f"{len(buf)} bytes do not hold a {name} array of shape {shape}", at)
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        if name == "bfloat16":
            return torch.from_numpy(arr.copy()).view(torch.bfloat16)
        return arr


def _unchunk(d: dict, reader: _Reader, at: int) -> Union[np.ndarray, torch.Tensor]:
    """flax's chunked leaf: ``shape`` and ``chunks`` are {"0": ..., ...} dicts."""
    try:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    except (KeyError, TypeError):
        raise reader.fail("a chunked array without its shape or chunks", at) from None
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(data: Union[bytes, bytearray, memoryview]) -> Any:
    """The value ``data`` holds, as ``flax.serialization.msgpack_restore``
    gives it: dicts, lists, Python scalars, numpy arrays and scalars,
    bf16 tensors."""
    view = memoryview(data).cast("B")
    if len(view) == 0:
        raise ValueError("msgpack: empty input at byte 0")
    return _Reader(view, 0, bin_view=False).whole()

