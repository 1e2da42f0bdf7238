"""Read the JAX package's checkpoint files with ``pickle`` and numpy only.

The JAX package writes a checkpoint as a pickle of
``{key: flax.serialization.to_bytes(tree)}`` (keys ``params``,
``batch_stats`` and ``opt_state``; ``pbnet_tpu/tools/log.py:52-66``).  Each
value is msgpack in the subset flax writes:

* maps, arrays, str, bin, ints, floats, nil and bool;
* ext type 1 (an ndarray) and ext type 3 (a numpy scalar), whose payload is
  itself msgpack ``[shape, dtype name, raw C-order bytes]``.

Lists and tuples come back as maps keyed ``"0"``, ``"1"``, ... (flax's state
dict of a tuple), NamedTuples as maps of their fields: optax's Adam state is
``{"count", "mu", "nu"}``, a chain ``{"0": ..., "1": ...}``.

Refused with an error: a pickle that holds anything but a dict of str to
bytes (the unpickler resolves no class or function at all), ext type 2 (a
Python complex) or any other ext type, a dtype numpy does not know
(bfloat16 where ``ml_dtypes`` is not loaded), and leaves flax splits into
chunks (over 2**30 bytes; no PBNet leaf comes near that).
"""

from __future__ import annotations

import pickle
import struct

import numpy as np


class _DictOfBytesUnpickler(pickle.Unpickler):
    """Builds only what pickle's own opcodes make; resolves no global."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"checkpoint pickle refers to {module}.{name}: refused")


def load_payload(f) -> dict[str, bytes]:
    """The ``{key: msgpack bytes}`` mapping of an open JAX checkpoint file."""
    payload = _DictOfBytesUnpickler(f).load()
    if not (isinstance(payload, dict)
            and all(type(k) is str and type(v) is bytes for k, v in payload.items())):
        raise pickle.UnpicklingError("checkpoint pickle is not a dict of str to bytes")
    return payload


_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # ext type 2 (complex) is refused


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack("BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack("BHI"[b - 0xC7]))
        if b == 0xCA:
            return self.unpack("f")
        if b == 0xCB:
            return self.unpack("d")
        if 0xCC <= b <= 0xCF:
            return self.unpack("BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack("bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack("BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack("HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("HI"[b - 0xDE]))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("msgpack: chunked array leaf (over 2**30 bytes) is not supported")
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} is not supported")
        shape, dtype, raw = _Reader(data).whole()
        if isinstance(dtype, bytes):
            dtype = dtype.decode("ascii")
        try:
            dt = np.dtype(dtype)
        except TypeError as e:
            raise ValueError(f"msgpack: array dtype {dtype!r} is not supported") from e
        arr = np.frombuffer(raw, dtype=dt).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]

    def whole(self):
        v = self.value()
        if self.pos != len(self.buf):
            raise ValueError("msgpack: trailing bytes")
        return v


def msgpack_restore(data: bytes):
    """The tree of one ``flax.serialization.to_bytes`` value: nested dicts of
    numpy arrays (and Python scalars where flax wrote them)."""
    return _Reader(data).whole()


def read_checkpoint(path) -> dict:
    """``{key: tree}`` of a JAX-package checkpoint file."""
    with open(path, "rb") as f:
        payload = load_payload(f)
    return {k: msgpack_restore(v) for k, v in payload.items()}
