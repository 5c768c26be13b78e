"""The subset of msgpack that flax.serialization writes, without msgpack or
flax: maps, arrays, str, bin, nil, bools, ints, floats, and ext type 1
(an ndarray: the packed tuple (shape, dtype name, C-order bytes), flax
`_ndarray_to_bytes`). bfloat16 leaves are widened to float32 by the
reader; the writer takes them as torch bfloat16 tensors. Flax's chunked
form for arrays over its chunk size is refused.
"""
import struct

import numpy as np
import torch

_EXT_NDARRAY = 1
_CHUNKED_KEY = "__msgpack_chunked_array__"


def _ndarray(payload):
    shape, dtype_name, buf = unpackb(payload)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
    return np.frombuffer(buf, np.dtype(dtype_name)).reshape(shape).copy()


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sizes = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
                 0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
                 0xdc: ">H", 0xdd: ">I",                  # array
                 0xde: ">H", 0xdf: ">I",                  # map
                 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}      # ext
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in sizes:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self.unpack(sizes[b])
        if b <= 0xc6:
            return bytes(self.take(n))
        if b >= 0xd9 and b <= 0xdb:
            return str(self.take(n), "utf-8")
        if b in (0xdc, 0xdd):
            return [self.obj() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(n)
        return self.ext(n)

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if _CHUNKED_KEY in out:
            raise ValueError("flax chunked arrays are not supported")
        return out

    def ext(self, n):
        code = self.unpack(">b")
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _ndarray(payload)


def unpackb(data):
    """bytes → python tree; flax ndarray leaves become numpy arrays."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _pack_len(n, small, fmts, fix_base=None, fix_max=-1):
    if n <= fix_max:
        return struct.pack(">B", fix_base | n)
    for code, fmt, limit in zip(small, fmts, (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= limit:
            return struct.pack(">B", code) + struct.pack(fmt, n)
    raise ValueError("object too large for msgpack")


def _pack_int(n):
    """The shortest encoding, as msgpack-python writes it."""
    if 0 <= n <= 0x7f or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n > 0:
        for code, fmt, limit in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                                 (0xce, ">I", 0xffffffff),
                                 (0xcf, ">Q", 0xffffffffffffffff)):
            if n <= limit:
                return struct.pack(">B", code) + struct.pack(fmt, n)
    for code, fmt, bits in ((0xd0, ">b", 7), (0xd1, ">h", 15),
                            (0xd2, ">i", 31), (0xd3, ">q", 63)):
        if n >= -(1 << bits):
            return struct.pack(">B", code) + struct.pack(fmt, n)
    raise ValueError("integer too large for msgpack")


_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _pack_ndarray(shape, dtype_name, raw):
    payload = packb([list(shape), dtype_name, raw])
    head = struct.pack(">B", _FIXEXT[len(payload)]) \
        if len(payload) in _FIXEXT else _pack_len(
            len(payload), (0xc7, 0xc8, 0xc9), (">B", ">H", ">I"))
    return head + struct.pack(">b", _EXT_NDARRAY) + payload


def packb(obj):
    """python tree of dict / list / str / bytes / int / numpy arrays /
    torch bfloat16 tensors → the bytes flax.serialization.to_bytes writes
    for it (ndarrays as ext type 1, a bfloat16 leaf as dtype "bfloat16"
    and its raw 16-bit words)."""
    if isinstance(obj, dict):
        return _pack_len(len(obj), (None, 0xde, 0xdf), (None, ">H", ">I"),
                         0x80, 15) + b"".join(packb(k) + packb(v)
                                              for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return _pack_len(len(obj), (None, 0xdc, 0xdd), (None, ">H", ">I"),
                         0x90, 15) + b"".join(packb(v) for v in obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), (0xd9, 0xda, 0xdb), (">B", ">H", ">I"),
                         0xa0, 31) + raw
    if isinstance(obj, bytes):
        return _pack_len(len(obj), (0xc4, 0xc5, 0xc6),
                         (">B", ">H", ">I")) + obj
    if isinstance(obj, int) and not isinstance(obj, bool):
        return _pack_int(obj)
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return _pack_ndarray(arr.shape, arr.dtype.name, arr.tobytes())
    if isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16:
        t = obj.detach().cpu().contiguous()
        return _pack_ndarray(t.shape, "bfloat16",
                             t.view(torch.int16).numpy().tobytes())
    raise TypeError(f"cannot pack {type(obj)}")
