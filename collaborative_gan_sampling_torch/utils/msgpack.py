"""A small MessagePack codec for the subset that Flax checkpoints use.

``flax.serialization.msgpack_serialize`` writes a state dict with the
``msgpack`` package (``use_bin_type=True``, ``strict_types=True``) after a
tree map that sorts every dict's keys. The port must read and write those
files where ``msgpack`` is not installed, so it keeps its own encoder and
decoder of exactly what such a file holds:

* maps with str keys (Flax writes a tuple as a map keyed ``'0'``, ``'1'``,
  ...), arrays, str, nil, bool, int, float and bin;
* ext type 1, an ndarray: the payload is itself MessagePack, the array
  ``[shape, dtype name, C-order bytes]``;
* ext type 3, a numpy scalar: the same payload with shape ``[]``.

``packb`` gives the bytes that ``msgpack_serialize`` gives for the same
tree, byte for byte. ``unpackb`` raises ``ValueError`` on anything else,
including the chunked form that Flax uses for arrays over 2^30 bytes.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


# -- encoding ---------------------------------------------------------------

def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack("b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < top:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if x >= low:
                return bytes([code]) + struct.pack(fmt, x)
    raise ValueError(f"integer {x} does not fit MessagePack's 64 bits")


def _head(n: int, fix: int | None, fix_max: int,
          codes: tuple[int, int, int]) -> bytes:
    """The header of a str, bin, array or map of n items."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"a MessagePack item of {n} entries is too long")


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _head(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + bytes([code]) + payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    return _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")],
                 sort_keys=False)


def _pack(obj: Any, sort_keys: bool) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if type(obj) is int:
        return _int(obj)
    if type(obj) is float:
        return b"\xcb" + struct.pack(">d", obj)
    if type(obj) is str:
        raw = obj.encode("utf-8")
        return _head(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + raw
    if type(obj) is bytes:
        return _head(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + obj
    if type(obj) is list:
        return (_head(len(obj), 0x90, 16, (None, 0xDC, 0xDD))
                + b"".join(_pack(v, sort_keys) for v in obj))
    if type(obj) is dict:
        keys = sorted(obj) if sort_keys else list(obj)
        out = [_head(len(keys), 0x80, 16, (None, 0xDE, 0xDF))]
        for k in keys:
            if type(k) is not str:
                raise ValueError(f"map key {k!r} is not a str")
            out.append(_pack(k, sort_keys))
            out.append(_pack(obj[k], sort_keys))
        return b"".join(out)
    if isinstance(obj, np.ndarray):
        return _ext(EXT_NDARRAY, _ndarray_payload(obj))
    if isinstance(obj, np.generic):
        return _ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    raise ValueError(f"cannot serialize {type(obj).__name__}")


def packb(tree: Any) -> bytes:
    """MessagePack bytes of a state-dict tree, as Flax writes it: every
    dict's keys sorted, numpy arrays and scalars as ext types 1 and 3."""
    return _pack(tree, sort_keys=True)


# -- decoding ---------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {  # code: struct format of the value that follows
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {  # code: (kind, struct format of the length)
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray_from(payload: bytes) -> np.ndarray:
    shape, name, buf = _unpack_one(_Reader(payload))
    if isinstance(name, bytes):
        name = name.decode()
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"array dtype {name!r} is not supported") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _unpack_one(r: _Reader) -> Any:
    code = r.take(1)[0]
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code == 0xC0:
        return None
    elif code == 0xC2:
        return False
    elif code == 0xC3:
        return True
    elif code in _FIXED:
        return r.unpack(_FIXED[code])
    elif code in _LEN:
        kind, fmt = _LEN[code]
        n = r.unpack(fmt)
    elif code in _FIXEXT:
        kind, n = "ext", _FIXEXT[code]
    else:
        raise ValueError(f"MessagePack type 0x{code:02x} is not supported")
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return r.take(n)
    if kind == "array":
        return [_unpack_one(r) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            k = _unpack_one(r)
            out[k] = _unpack_one(r)
        if CHUNKED_KEY in out:
            raise ValueError("chunked arrays (over 2^30 bytes) are not "
                             "supported")
        return out
    ext = r.take(1)[0]
    payload = r.take(n)
    if ext == EXT_NDARRAY:
        return _ndarray_from(payload)
    if ext == EXT_NPSCALAR:
        return _ndarray_from(payload)[()]
    raise ValueError(f"MessagePack ext type {ext} is not supported")


def unpackb(data: bytes) -> Any:
    """The tree that ``packb`` (or ``flax.serialization.msgpack_serialize``)
    wrote: dicts, lists, python scalars, numpy arrays and scalars."""
    r = _Reader(data)
    out = _unpack_one(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the MessagePack object")
    return out
