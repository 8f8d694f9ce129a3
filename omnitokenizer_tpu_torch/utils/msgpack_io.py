"""The JAX package's msgpack checkpoints, read and written without flax or
the msgpack package: a reader and a writer of the msgpack spec with flax's
extensions (`flax.serialization`'s `msgpack_restore` and `to_bytes`; the
role of its `from_bytes`, rebuilding a target's structure and checking it,
falls to the strict key maps of `convert.py` that every loader feeds).

    tree = read_msgpack("step_00003000.msgpack")   # nested dicts of tensors
    write_msgpack("tok.msgpack", {"params": ..., "buffers": ...})

What flax writes, and how it comes back here:
- a dict comes back as a dict with str keys; a tuple or a list was written
  by flax as a dict keyed '0', '1', ... and comes back so (a namedtuple as
  a dict of its fields, a dataclass state as a dict of its fields);
- an array is msgpack ext type 1, the packed triple (shape, dtype name,
  C-order bytes), and comes back as a CPU torch.Tensor of that dtype;
  bfloat16 (dtype name 'bfloat16') as torch.bfloat16 with its bits kept;
- a numpy scalar is ext type 3 (the same triple, shape ()) and comes back
  as a 0-d tensor;
- an array above MAX_CHUNK_SIZE bytes was written as a dict
  {'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
  {'0': flat piece, ...}} and comes back as the whole array;
- None, bool, int, float and str leaves come back as Python values.

A path is read through a read-only mmap, so each array's bytes are copied
once, from the page cache into its tensor. Anything outside the spec or the
extensions above raises `MsgpackError` with the key path where it was found.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Any, Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE: bytes above which an array is chunked
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"

_DTYPES = {"float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
           "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
           "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class MsgpackError(ValueError):
    """A file that is not the JAX package's msgpack, with the key path."""


# -- reading ---------------------------------------------------------------------------------
class _Reader:
    """One pass over a msgpack buffer; `pos` is the next byte."""

    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def fail(self, path: Tuple[str, ...], what: str):
        raise MsgpackError(f"{'/'.join(path) or '<root>'}: {what} (at byte {self.pos})")

    def take(self, n: int, path) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail(path, f"truncated: {n} bytes wanted, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, path):
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(n, path))[0]

    def read(self, path: Tuple[str, ...] = ()) -> Any:
        b = self.unpack(">B", path)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F, path)
        if 0x90 <= b <= 0x9F:
            return [self.read(path + (str(i),)) for i in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, path)
        fixed = _FIXED.get(b)
        if fixed is not None:
            return self.unpack(fixed, path)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack(_LEN[b - 0xC4], path), path))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.text(self.unpack(_LEN[b - 0xD9], path), path)
        if b in (0xDC, 0xDD):  # array 16/32
            n = self.unpack(_LEN[b - 0xDB], path)
            return [self.read(path + (str(i),)) for i in range(n)]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.read_map(self.unpack(_LEN[b - 0xDD], path), path)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b", path)
            return self.ext(code, self.take(1 << (b - 0xD4), path), path)
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack(_LEN[b - 0xC7], path)
            code = self.unpack(">b", path)
            return self.ext(code, self.take(n, path), path)
        self.fail(path, f"byte 0x{b:02x} is no msgpack type")

    def text(self, n: int, path) -> str:
        try:
            return str(self.take(n, path), "utf-8")
        except UnicodeDecodeError as e:
            self.fail(path, f"a str that is not UTF-8 ({e})")

    def read_map(self, n: int, path) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _ in range(n):
            key = self.read(path)
            if not isinstance(key, str):
                self.fail(path, f"a map key of type {type(key).__name__}; flax writes str keys")
            out[key] = self.read(path + (key,))
        if CHUNKED in out:
            return _unchunk(out, path)
        return out

    def ext(self, code: int, data: memoryview, path) -> Any:
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            self.fail(path, f"msgpack ext type {code}; the JAX package writes arrays (1) and "
                            "numpy scalars (3) only")
        inner = _Reader(data)
        if inner.unpack(">B", path) != 0x93:
            self.fail(path, "an array extension that is not the triple (shape, dtype, bytes)")
        shape = inner.read(path)
        name = inner.read(path)
        if isinstance(name, bytes):
            name = name.decode("ascii")
        head = inner.unpack(">B", path)
        if head not in (0xC4, 0xC5, 0xC6):
            self.fail(path, "an array extension whose data is not msgpack bin")
        raw = inner.take(inner.unpack(_LEN[head - 0xC4], path), path)
        if not isinstance(shape, list) or not all(isinstance(d, int) and d >= 0 for d in shape):
            self.fail(path, f"an array shape {shape!r}")
        if name not in _DTYPES:
            self.fail(path, f"an array of dtype {name!r}, which the port does not read")
        dtype = _DTYPES[name]
        if len(raw) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            self.fail(path, f"{len(raw)} bytes for a {name} array of shape {tuple(shape)}")
        if code == EXT_NPSCALAR and shape:
            self.fail(path, f"a numpy scalar of shape {tuple(shape)}")
        return _tensor(raw, dtype, shape)


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = (">B", ">H", ">I")


def _tensor(raw: memoryview, dtype: torch.dtype, shape: Sequence[int]) -> torch.Tensor:
    """The one copy: the bytes into a fresh (aligned) tensor, viewed as dtype."""
    out = torch.empty(len(raw), dtype=torch.uint8)
    if len(raw):
        out.numpy()[:] = np.frombuffer(raw, np.uint8)
    return out.view(dtype).reshape(tuple(shape))


def _unchunk(d: Dict[str, Any], path) -> torch.Tensor:
    """flax's `_unchunk`: the pieces joined in key order, reshaped."""
    try:
        shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
        pieces = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return torch.cat([p.reshape(-1) for p in pieces]).reshape(shape)
    except (KeyError, TypeError, AttributeError, RuntimeError) as e:
        raise MsgpackError(f"{'/'.join(path) or '<root>'}: a malformed chunked array ({e!r})")


def msgpack_restore(data: Union[bytes, bytearray, memoryview]) -> Any:
    """flax.serialization.msgpack_restore: bytes -> the tree (see the module
    docstring for what each leaf becomes)."""
    with memoryview(data) as mv:
        reader = _Reader(mv.cast("B") if mv.format != "B" else mv)
        out = reader.read()
        if reader.pos != len(mv):
            raise MsgpackError(f"<root>: {len(mv) - reader.pos} bytes after the object")
        del reader
    return out


def read_msgpack(path: str) -> Any:
    """The tree of a msgpack file, read through a read-only mmap."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise MsgpackError(f"{path}: empty file")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        return msgpack_restore(mm)
    except MsgpackError as e:
        raise MsgpackError(f"{path}: {e}") from None
    finally:
        try:
            mm.close()
        except BufferError:  # a view still held by an exception's frames: closed when collected
            pass


# -- writing ---------------------------------------------------------------------------------
def _head(n: int, small: int, small_max: int, codes: Tuple[int, ...]) -> bytes:
    """A length-prefixed header: the fix form below small_max, else 8/16/32 bit."""
    if n <= small_max and small >= 0:
        return bytes([small | n])
    for code, fmt, top in zip(codes, ("B", "H", "I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code >= 0 and n <= top:
            return struct.pack(">B" + fmt, code, n)
    raise MsgpackError(f"a length of {n} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _int(x: int) -> bytes:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, "B"), (-0x80, -1, 0xD0, "b"),
                              (0, 0xFFFF, 0xCD, "H"), (-0x8000, -1, 0xD1, "h"),
                              (0, 0xFFFFFFFF, 0xCE, "I"), (-0x80000000, -1, 0xD2, "i"),
                              (0, 0xFFFFFFFFFFFFFFFF, 0xCF, "Q"),
                              (-0x8000000000000000, -1, 0xD3, "q")):
        if lo <= x <= hi:
            return struct.pack(">B" + fmt, code, x)
    raise MsgpackError(f"the int {x} does not fit msgpack")


def _array_bytes(x: Union[torch.Tensor, np.ndarray]) -> Tuple[str, List[int], memoryview]:
    """(dtype name, shape, C-order bytes) of an array, without a copy where
    it is contiguous already."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise MsgpackError(f"a tensor of dtype {t.dtype} has no msgpack name")
        flat = t.reshape(-1).view(torch.uint8) if t.numel() else torch.empty(0, dtype=torch.uint8)
        return _NAMES[t.dtype], list(t.shape), memoryview(flat.numpy())
    a = np.asarray(x)
    if not a.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.name not in _DTYPES:
        raise MsgpackError(f"an array of dtype {a.dtype} has no msgpack name")
    return a.dtype.name, list(a.shape), memoryview(a.reshape(-1).view(np.uint8))


def _ext(code: int, parts: List[Any], size: int) -> List[Any]:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(size)
    if fix is not None:
        return [bytes([fix]), struct.pack(">b", code)] + parts
    return [_head(size, -1, -1, (0xC7, 0xC8, 0xC9)), struct.pack(">b", code)] + parts


def _pack_array(code: int, x) -> List[Any]:
    """flax's _ndarray_to_bytes inside an ext: packb((shape, name, bytes))."""
    name, shape, raw = _array_bytes(x)
    head = (bytes([0x93]) + _head(len(shape), 0x90, 15, (-1, 0xDC, 0xDD))
            + b"".join(_int(d) for d in shape) + _str(name)
            + _head(len(raw), -1, -1, (0xC4, 0xC5, 0xC6)))
    return _ext(code, [head, raw], len(head) + len(raw))


def _chunk(x) -> Dict[str, Any]:
    """flax's _chunk: a flat array in pieces of MAX_CHUNK_SIZE bytes."""
    t = x.detach().cpu().contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)
    size = max(1, int(MAX_CHUNK_SIZE / (t.element_size() if isinstance(t, torch.Tensor)
                                        else t.dtype.itemsize)))
    flat = t.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(t.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, int(np.prod(t.shape, dtype=np.int64)), size))}}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _parts(x: Any, path: Tuple[str, ...] = ()) -> Iterator[Any]:
    """The msgpack of `x` as a stream of bytes and memoryviews (an array's
    data is not copied into one buffer)."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            yield from _parts(_chunk(x), path)
        else:
            yield from _pack_array(EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        yield from _pack_array(EXT_NPSCALAR, np.asarray(x))
    elif isinstance(x, (tuple, list, dict)):  # a sequence as flax's to_state_dict writes it
        items = x.items() if isinstance(x, dict) else ((str(i), v) for i, v in enumerate(x))
        yield _head(len(x), 0x80, 15, (-1, 0xDE, 0xDF))
        for k, v in items:
            yield _str(str(k))
            yield from _parts(v, path + (str(k),))
    elif x is None:
        yield b"\xc0"
    elif isinstance(x, bool):
        yield b"\xc3" if x else b"\xc2"
    elif isinstance(x, int):
        yield _int(x)
    elif isinstance(x, float):
        yield struct.pack(">Bd", 0xCB, x)
    elif isinstance(x, str):
        yield _str(x)
    else:
        raise MsgpackError(f"{'/'.join(path) or '<root>'}: a {type(x).__name__} has no "
                           "msgpack form")


def to_bytes(tree: Any) -> bytes:
    """flax.serialization.to_bytes of a tree of dicts, tuples and lists
    (written as dicts keyed '0', '1', ...), tensors, numpy arrays and
    scalars, and None, bool, int, float and str leaves: the bytes flax
    writes for the same tree."""
    return b"".join(_parts(tree))


def write_msgpack(path: str, tree: Any) -> None:
    """to_bytes(tree) into `path`, array by array (no whole-file copy in
    memory), through a temporary file that replaces `path` at the end."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for part in _parts(tree):
            f.write(part)
    os.replace(tmp, path)
