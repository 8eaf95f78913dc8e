"""The JAX package's file format: flax's msgpack, without flax or msgpack.

``eadgan_tpu/train/checkpoint.py`` writes every file with
``flax.serialization.to_bytes``: the tree's state dict packed by
``msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)``
(``use_bin_type`` on, doubles for floats).  This module is that codec for
the subset flax emits, so a machine with neither package reads and
writes the same bytes:

* maps with str keys, lists, str, bin, nil, bool, int (the smallest
  msgpack form), float (float64);
* an ndarray (numpy, or a CPU torch tensor) is ext type 1 whose payload
  is the msgpack triple ``(shape, dtype name, C-order bytes)``; a numpy
  scalar is ext type 3 with the same payload; a complex is ext type 2,
  the pair ``(real, imag)`` (flax ``serialization.py``:
  ``_ndarray_to_bytes``, ``_MsgpackExtType``);
* an array above :data:`MAX_CHUNK_SIZE` bytes that is a map value (or
  the whole tree) goes as flax's chunked map
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  and is joined back on reading;
* ``bfloat16`` decodes to a ``torch.bfloat16`` tensor (numpy has no such
  type), and a ``torch.bfloat16`` tensor encodes under that name.

:func:`packb` keeps the tree's key order, so a tree equal to the one
flax packed (its dicts in the order JAX leaves them: sorted, after any
jitted step) gives the same bytes.  :func:`unpackb` returns numpy arrays
that are views of the input buffer (read-only when it is ``bytes``).
"""

from __future__ import annotations

import struct
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "packb", "pack_into", "unpackb", "is_flax_msgpack"]

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# --- encoding -------------------------------------------------------------


def _uint(n: int, widths) -> bytes:
    """``n`` behind the first (limit, prefix, struct format) it fits."""
    for limit, prefix, fmt in widths:
        if n < limit:
            return prefix + struct.pack(fmt, n)
    raise ValueError(f"length {n} is beyond msgpack's 32-bit lengths")


_STR = ((256, b"\xd9", ">B"), (1 << 16, b"\xda", ">H"), (1 << 32, b"\xdb", ">I"))
_BIN = ((256, b"\xc4", ">B"), (1 << 16, b"\xc5", ">H"), (1 << 32, b"\xc6", ">I"))
_ARRAY = ((1 << 16, b"\xdc", ">H"), (1 << 32, b"\xdd", ">I"))
_MAP = ((1 << 16, b"\xde", ">H"), (1 << 32, b"\xdf", ">I"))
_FIXEXT = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
_EXT = ((256, b"\xc7", ">B"), (1 << 16, b"\xc8", ">H"), (1 << 32, b"\xc9", ">I"))


def _int(n: int) -> bytes:
    if 0 <= n < 128:
        return struct.pack(">B", n)
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for limit, head, fmt in ((1 << 8, b"\xcc", ">B"), (1 << 16, b"\xcd", ">H"),
                                 (1 << 32, b"\xce", ">I"), (1 << 64, b"\xcf", ">Q")):
            if n < limit:
                return head + struct.pack(fmt, n)
    else:
        for limit, head, fmt in ((1 << 7, b"\xd0", ">b"), (1 << 15, b"\xd1", ">h"),
                                 (1 << 31, b"\xd2", ">i"), (1 << 63, b"\xd3", ">q")):
            if -n <= limit:
                return head + struct.pack(fmt, n)
    raise OverflowError(f"int {n} is beyond msgpack's 64 bits")


def _str(s: str) -> List[bytes]:
    b = s.encode("utf-8")
    return [struct.pack(">B", 0xA0 | len(b)) if len(b) < 32 else _uint(len(b), _STR), b]


def _bin_head(n: int) -> bytes:
    return _uint(n, _BIN)


def _container_head(n: int, fix: int, widths) -> bytes:
    return struct.pack(">B", fix | n) if n < 16 else _uint(n, widths)


def _ext_head(code: int, n: int) -> bytes:
    head = _FIXEXT.get(n) or _uint(n, _EXT)
    return head + struct.pack(">b", code)


class _Array(NamedTuple):
    """An array leaf as the format sees it."""

    shape: Tuple[int, ...]
    name: str
    itemsize: int
    data: memoryview  # C-order bytes


def _as_array(x) -> _Array:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            flat = x.view(torch.int16).numpy()
            return _Array(tuple(x.shape), "bfloat16", 2, memoryview(flat).cast("B"))
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct or x.dtype.names:
        raise ValueError("object and structured dtypes have no flax msgpack form")
    shape = tuple(int(d) for d in x.shape)
    flat = np.ascontiguousarray(x).reshape(-1)  # 0-d arrays come back 1-d
    return _Array(shape, x.dtype.name, x.dtype.itemsize, memoryview(flat.view(np.uint8)))


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _pack_array(a: _Array, code: int, out: List) -> None:
    inner = [b"\x93", _container_head(len(a.shape), 0x90, _ARRAY)]
    inner += [_int(d) for d in a.shape]
    inner += _str(a.name)
    inner.append(_bin_head(len(a.data)))
    n = sum(len(p) for p in inner) + len(a.data)
    out.append(_ext_head(code, n))
    out.extend(inner)
    out.append(a.data)


def _chunked(a: _Array) -> dict:
    """flax's ``_chunk``: the flattened array in pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes."""
    per = max(1, int(MAX_CHUNK_SIZE / a.itemsize)) * a.itemsize
    pieces = [a.data[i : i + per] for i in range(0, len(a.data), per)]
    return {
        CHUNKED: True,
        "shape": {str(i): d for i, d in enumerate(a.shape)},
        "chunks": {
            str(i): _Array((len(p) // a.itemsize,), a.name, a.itemsize, p)
            for i, p in enumerate(pieces)
        },
    }


def _maybe_chunked(x):
    """A map value or the whole tree: an array above the chunk size goes
    chunked (flax chunks nothing else, e.g. not list items)."""
    if _is_array(x):
        a = _as_array(x)
        return _chunked(a) if len(a.data) > MAX_CHUNK_SIZE else a
    return x


def _pack(x, out: List) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif t is int:
        out.append(_int(x))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        out.extend(_str(x))
    elif t is bytes:
        out += [_bin_head(len(x)), x]
    elif t is dict:
        out.append(_container_head(len(x), 0x80, _MAP))
        for k, v in x.items():
            _pack(k, out)
            _pack(_maybe_chunked(v), out)
    elif t is list:
        out.append(_container_head(len(x), 0x90, _ARRAY))
        for v in x:
            _pack(v, out)
    elif t is _Array:
        _pack_array(x, EXT_NDARRAY, out)
    elif _is_array(x):
        _pack_array(_as_array(x), EXT_NDARRAY, out)
    elif isinstance(x, np.generic):
        _pack_array(_as_array(np.asarray(x)), EXT_NPSCALAR, out)
    elif t is complex:
        data = b"\x92\xcb" + struct.pack(">d", x.real) + b"\xcb" + struct.pack(">d", x.imag)
        out += [_ext_head(EXT_COMPLEX, len(data)), data]
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _pieces(tree) -> List:
    out: List = []
    _pack(_maybe_chunked(tree), out)
    return out


def packb(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for a
    state-dict tree (``to_bytes`` of an object whose state dict it is)."""
    return b"".join(_pieces(tree))


def pack_into(f, tree) -> int:
    """Write :func:`packb`'s bytes to the binary file ``f`` piece by piece
    (no joined copy of the arrays); returns the byte count."""
    n = 0
    for piece in _pieces(tree):
        f.write(piece)
        n += len(piece)
    return n


# --- decoding -------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = buf  # bytes-like, kept as the base of the arrays
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError(f"truncated flax msgpack data: {n} bytes wanted at {self.pos} "
                             f"of {len(self.mv)}")
        out = self.mv[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {  # head byte: (kind, struct format of the length or value)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xCA: ("num", ">f"), 0xCB: ("num", ">d"),
    0xCC: ("num", ">B"), 0xCD: ("num", ">H"), 0xCE: ("num", ">I"), 0xCF: ("num", ">Q"),
    0xD0: ("num", ">b"), 0xD1: ("num", ">h"), 0xD2: ("num", ">i"), 0xD3: ("num", ">q"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _head(r: _Reader):
    """The next object's (kind, length or value)."""
    b = r.unpack(">B")
    if b <= 0x7F:
        return "num", b
    if b >= 0xE0:
        return "num", b - 0x100
    if 0x80 <= b <= 0x8F:
        return "map", b & 0x0F
    if 0x90 <= b <= 0x9F:
        return "array", b & 0x0F
    if 0xA0 <= b <= 0xBF:
        return "str", b & 0x1F
    if b == 0xC0:
        return "nil", None
    if b in (0xC2, 0xC3):
        return "num", b == 0xC3
    if b in _FIXEXT_LEN:
        return "ext", _FIXEXT_LEN[b]
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        return kind, r.unpack(fmt)
    raise ValueError(f"byte 0x{b:02x} at {r.pos - 1} starts no msgpack object")


def _dtype(name: str):
    if name == "bfloat16":
        return None
    return np.dtype(name)


def _read_array(r: _Reader, n: int):
    """An ndarray payload ``(shape, dtype name, bytes)`` of ``n`` bytes as
    a view of the buffer."""
    end = r.pos + n
    kind, count = _head(r)
    if kind != "array" or count != 3:
        raise ValueError("an ndarray payload is not a msgpack triple")
    shape = _read(r)
    name = _read(r)
    kind, size = _head(r)
    if kind != "bin" or not isinstance(name, str):
        raise ValueError("an ndarray payload has no dtype name or no bytes")
    start = r.pos
    r.take(size)
    if r.pos != end:
        raise ValueError("an ndarray payload's length does not add up")
    dtype = _dtype(name)
    if not isinstance(shape, list) or size != int(np.prod(shape)) * (2 if dtype is None else dtype.itemsize):
        raise ValueError(f"an ndarray payload of {size} bytes is not a {name} array of shape {shape}")
    if dtype is None:  # bfloat16
        bits = np.frombuffer(r.buf, dtype=np.int16, count=size // 2, offset=start)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(r.buf, dtype=dtype, count=size // dtype.itemsize,
                         offset=start).reshape(shape)


def _read(r: _Reader):
    kind, n = _head(r)
    if kind == "num":
        return n
    if kind == "nil":
        return None
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_read(r) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            key = _read(r)
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"{type(key).__name__} is not allowed for map key")
            out[key] = _read(r)
        return out
    code = r.unpack(">b")  # ext
    if code == EXT_NDARRAY:
        return _read_array(r, n)
    if code == EXT_NPSCALAR:
        return _read_array(r, n)[()]
    if code == EXT_COMPLEX:
        end = r.pos + n
        pair = _read(r)
        if r.pos != end or not isinstance(pair, list) or len(pair) != 2:
            raise ValueError("a complex payload is not a pair")
        return complex(pair[0], pair[1])
    raise ValueError(f"ext type {code} is none of flax's (1 ndarray, 2 complex, 3 numpy scalar)")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d):
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps that are
    the tree or a map value (lists are not searched)."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if CHUNKED in v else _unchunk_tree(v)
    return d


def unpackb(buf) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives for these
    bytes (``bytes``, ``bytearray``, ``memoryview`` or ``mmap``)."""
    r = _Reader(buf)
    tree = _read(r)
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} bytes after the flax msgpack object")
    return _unchunk_tree(tree)


def is_flax_msgpack(head: bytes) -> bool:
    """Whether a file starting with ``head`` is a flax msgpack file: a
    map header (every file of the JAX package is a non-empty map; 0x80,
    the empty map, is also pickle's first byte)."""
    return len(head) > 0 and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
