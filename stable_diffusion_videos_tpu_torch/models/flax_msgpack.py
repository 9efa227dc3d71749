"""The subset of MessagePack that ``flax.serialization.to_bytes`` writes,
read and written with the standard library, numpy and torch.

A flax parameter file is one msgpack map: str keys, nested maps, and array
leaves as ext type 1 (ext type 3 for a numpy scalar) whose payload is itself
a msgpack array ``(shape, dtype name, raw C-order bytes)``
(``flax/serialization.py`` ``_ndarray_to_bytes``).  Beside maps, arrays,
str, bin, nil, bool, ints and float32/64 nothing else occurs.  flax splits a
leaf above 2**30 bytes into ``{"__msgpack_chunked_array__": True, "shape":
{"0": ...}, "chunks": {"0": flat, ...}}``; ``read`` joins such chunks back
into one tensor and ``write`` splits the same way.

Array leaves come back as CPU tensors that are views of one buffer holding
the file (a copy-on-write ``mmap`` for ``read``), so a 3.4 GB UNet is never
held twice on the host; ``bfloat16``, which numpy lacks, is read and written
as its raw 16-bit words.  A numpy scalar (ext 3) comes back as a numpy
scalar, or as a 0-d tensor when its dtype is bfloat16.
"""

from __future__ import annotations

import io
import mmap
import struct
import warnings
from pathlib import Path

import numpy as np
import torch

#: flax's ``MAX_CHUNK_SIZE``: leaves above this many bytes are chunked
CHUNK_BYTES = 2 ** 30
_EXT_NDARRAY, _EXT_SCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

#: type byte -> (length format, kind) of the sized forms
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.view = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.view[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.view, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def obj(self, raw: bool = False):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        if b in _FIXEXT_LEN:
            return self.ext(_FIXEXT_LEN[b])
        if b not in _SIZED:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                             "subset flax writes")
        fmt, kind = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.str(n, raw)
        if kind == "array":
            return [self.obj(raw) for _ in range(n)]
        if kind == "map":
            return self.map(n, raw)
        return self.ext(n)

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        if out.get(_CHUNKED) is True:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_SCALAR):
            raise ValueError(f"msgpack ext type {code} is not an array")
        # the payload: (shape, dtype name, raw bytes), names as bytes
        head = self.unpack(">B")
        if head != 0x93:
            raise ValueError("an array's ext payload is not a 3-array")
        shape = tuple(self.obj(raw=True))
        name = self.obj(raw=True).decode("ascii")
        fmt, kind = _SIZED.get(self.unpack(">B"), (None, None))
        if kind != "bin":
            raise ValueError("an array's data is not a msgpack bin")
        nbytes = self.unpack(fmt)
        t = _tensor(self.buf, self.pos, nbytes, name, shape)
        self.pos += nbytes
        if self.pos != end:
            raise ValueError("an array's ext payload has trailing bytes")
        if code == _EXT_SCALAR and t.dtype != torch.bfloat16:
            return t.numpy()[()]
        return t


def _tensor(buf, offset: int, nbytes: int, name: str,
            shape: tuple) -> torch.Tensor:
    """A CPU tensor viewing ``nbytes`` of ``buf`` at ``offset``."""
    dtype = (torch.bfloat16 if name == "bfloat16"
             else torch.from_numpy(np.zeros(0, np.dtype(name))).dtype)
    count = int(np.prod(shape)) if shape else 1
    if count * dtype.itemsize != nbytes:
        raise ValueError(f"an array of {shape} {name} holds {nbytes} bytes")
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():
        # a bytes object is read-only; the views are never written
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.frombuffer(buf, dtype=dtype, count=count, offset=offset)
    return t.reshape(shape)


def _unchunk(d: dict) -> torch.Tensor:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat([torch.as_tensor(c).reshape(-1)
                      for c in chunks]).reshape(shape)


def loads(data) -> dict:
    """Bytes (or any buffer) of a flax msgpack file -> its tree."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.view):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def read(path) -> dict:
    """A flax msgpack file -> its tree, the array leaves views of one
    copy-on-write mapping of the file."""
    with open(path, "rb") as f:
        if Path(path).stat().st_size == 0:
            raise ValueError(f"{path} is empty")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return loads(buf)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

# (fixed form's code, the lengths it holds, [(code, length format, limit)])
_STR = (0xA0, 32, [(0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16),
                   (0xDB, ">I", 1 << 32)])
_BIN = (None, 0, [(0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                  (0xC6, ">I", 1 << 32)])
_ARRAY = (0x90, 16, [(0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)])
_MAP = (0x80, 16, [(0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)])
_EXT = (None, 0, [(0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                  (0xC9, ">I", 1 << 32)])
_FIXEXT = {n: code for code, n in _FIXEXT_LEN.items()}


def _sized(kind: tuple, n: int) -> bytes:
    """The header of a str, bin, array, map or ext of length ``n``: the
    shortest form msgpack allows."""
    fixed, fixed_limit, forms = kind
    if fixed is not None and n < fixed_limit:
        return bytes([fixed | n])
    for code, fmt, limit in forms:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                             (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
        if -limit <= v:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"int {v} does not fit msgpack")


def _raw(x) -> tuple:
    """An array leaf -> (shape, dtype name, its C-order bytes as a uint8
    numpy array), bfloat16 as its 16-bit words."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu").contiguous()
        name = str(t.dtype).split(".")[1]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return tuple(t.shape), name, t.numpy().reshape(-1).view(np.uint8)
    a = np.asarray(x)  # reshape(-1) copies a non-contiguous array, C order
    return a.shape, a.dtype.name, a.reshape(-1).view(np.uint8)


def _write_array(f, x, code: int) -> None:
    shape, name, data = _raw(x)
    inner = (bytes([0x93]) + _sized(_ARRAY, len(shape))
             + b"".join(_int(int(d)) for d in shape)
             + _sized(_STR, len(name)) + name.encode("ascii")
             + _sized(_BIN, data.size))
    n = len(inner) + data.size
    f.write((bytes([_FIXEXT[n]]) if n in _FIXEXT else _sized(_EXT, n))
            + struct.pack(">b", code) + inner)
    f.write(memoryview(data))


def _chunk(x) -> dict:
    """A leaf above ``CHUNK_BYTES`` -> flax's chunked form."""
    flat = x.reshape(-1)
    step = max(1, CHUNK_BYTES // (flat.itemsize if isinstance(
        flat, np.ndarray) else flat.element_size()))
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + step] for i, j in
                       enumerate(range(0, len(flat), step))}}


def _write(f, obj) -> None:
    if isinstance(obj, dict):
        f.write(_sized(_MAP, len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _write(f, k)
            _write(f, v)
    elif isinstance(obj, (list, tuple)):
        f.write(_sized(_ARRAY, len(obj)))
        for v in obj:
            _write(f, v)
    elif obj is None:
        f.write(b"\xc0")
    elif isinstance(obj, bool):
        f.write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        f.write(_int(obj))
    elif isinstance(obj, float):
        f.write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        f.write(_sized(_STR, len(data)) + data)
    elif isinstance(obj, bytes):
        f.write(_sized(_BIN, len(obj)) + obj)
    elif isinstance(obj, np.generic):
        _write_array(f, np.asarray(obj), _EXT_SCALAR)
    elif torch.is_tensor(obj) or isinstance(obj, np.ndarray):
        nbytes = (obj.nbytes if isinstance(obj, np.ndarray)
                  else obj.numel() * obj.element_size())
        if nbytes > CHUNK_BYTES:
            _write(f, _chunk(obj))
        else:
            _write_array(f, obj, _EXT_NDARRAY)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as flax msgpack")


def write(path, tree: dict) -> None:
    """Write ``tree`` (nested str-keyed dicts of tensors or numpy arrays)
    to ``path`` as ``flax.serialization.to_bytes`` does, one leaf at a
    time."""
    with open(path, "wb") as f:
        _write(f, tree)


def dumps(tree: dict) -> bytes:
    """``tree`` -> the bytes ``write`` puts in a file."""
    buf = io.BytesIO()
    _write(buf, tree)
    return buf.getvalue()
