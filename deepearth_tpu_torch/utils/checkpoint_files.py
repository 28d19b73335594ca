"""Checkpoint file formats the port reads and writes without their packages.

* flax's ``msgpack_serialize`` layout (``params.msgpack`` of a converted
  DeepSeek checkpoint, ``scripts/convert_checkpoint.py``): a msgpack map of
  maps whose array leaves are msgpack ext type 1 holding the msgpack array
  ``(shape, dtype name, C-order bytes)``, numpy scalars ext type 3, and
  arrays over ``MAX_CHUNK_SIZE`` bytes split into flat chunks under
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``.
  :func:`write_msgpack_tree` writes the bytes flax writes for the same tree
  of numpy arrays (maps in sorted key order, the smallest msgpack
  encodings), streaming each array to the file; :func:`read_msgpack_tree`
  reads the layout back.
* ``.safetensors``: an 8-byte little-endian header length, a JSON header of
  ``{name: {"dtype", "shape", "data_offsets"}}``, then the raw bytes
  (:func:`read_safetensors`).

Neither ``msgpack``, ``flax`` nor ``safetensors`` is imported: the card's
machine has none of them. numpy has no bfloat16, so a bfloat16 leaf of a
msgpack tree reads as float32 (exactly: bfloat16 is float32's top half).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, BinaryIO, Dict, Mapping, Union

import numpy as np
import torch

# flax's limit per array leaf before it chunks (msgpack caps an object at
# 2^31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# --------------------------------------------------------------- msgpack ----

def _uint(n: int, fix_max: int, fix_tag: int, tags) -> bytes:
    """A length or count: the fix form below ``fix_max`` (when given), else
    the smallest of the 8-, 16- and 32-bit forms ``tags`` names (None where
    a form does not exist)."""
    if fix_max and n < fix_max:
        return bytes([fix_tag | n])
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"),
                             (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} is too long")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for tag, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                              (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                return bytes([tag]) + struct.pack(fmt, n)
    else:
        for tag, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                              (0xd2, ">i", -(1 << 31)),
                              (0xd3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} does not fit 64 bits")


def _pack_str(s: str) -> bytes:
    raw = s.encode()
    return _uint(len(raw), 32, 0xa0, (0xd9, 0xda, 0xdb)) + raw


def _bin_header(n: int) -> bytes:
    return _uint(n, 0, 0, (0xc4, 0xc5, 0xc6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    head = (bytes([fixed[n]]) if n in fixed
            else _uint(n, 0, 0, (0xc7, 0xc8, 0xc9)))
    return head + struct.pack(">b", code)


def _write_array(f: BinaryIO, x: np.ndarray) -> None:
    """An array leaf as flax packs it: ext type 1 around the msgpack array
    (shape, dtype name, C-order bytes)."""
    raw = memoryview(np.ascontiguousarray(x).reshape(-1).view(np.uint8))
    inner = (bytes([0x93]) + _uint(len(x.shape), 16, 0x90, (None, 0xdc, 0xdd))
             + b"".join(_pack_int(int(d)) for d in x.shape)
             + _pack_str(x.dtype.name) + _bin_header(raw.nbytes))
    f.write(_ext_header(_EXT_NDARRAY, len(inner) + raw.nbytes))
    f.write(inner)
    f.write(raw)


def _chunked(x: np.ndarray) -> Dict[str, Any]:
    """flax's chunked form of an array over MAX_CHUNK_SIZE bytes."""
    flat = x.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / flat.dtype.itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _write_value(f: BinaryIO, value, sort: bool) -> None:
    if isinstance(value, Mapping):
        keys = sorted(value) if sort else list(value)
        f.write(_uint(len(keys), 16, 0x80, (None, 0xde, 0xdf)))
        for key in keys:
            f.write(_pack_str(key))
            _write_value(f, value[key], sort)
    elif isinstance(value, np.ndarray):
        if value.nbytes > MAX_CHUNK_SIZE:
            _write_value(f, _chunked(value), sort=False)
        else:
            _write_array(f, value)
    elif isinstance(value, bool):  # the chunked form's marker
        f.write(b"\xc3" if value else b"\xc2")
    elif isinstance(value, int):  # its shape
        f.write(_pack_int(value))
    else:
        raise TypeError(f"msgpack: cannot write a {type(value).__name__}")


def write_msgpack_tree(path: Union[str, Path], tree: Mapping[str, Any]
                       ) -> None:
    """Write a nested mapping of numpy arrays as flax's
    ``msgpack_serialize`` writes it."""
    with open(path, "wb") as f:
        _write_value(f, tree, sort=True)


class _Reader:
    """A msgpack decoder over one buffer; bin payloads are views into it."""

    def __init__(self, data: Union[bytes, memoryview]):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.at:self.at + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated data")
        self.at += n
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.mapping(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return [self.value() for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return str(self.take(tag & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if tag in simple:
            return simple[tag]
        fixed = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
                 0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
        if tag in fixed:
            return self.number(fixed[tag])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xd9 <= tag <= 0xdb:
            return str(self.take(self.number(sizes[tag - 0xd9])), "utf-8")
        if 0xc4 <= tag <= 0xc6:
            return self.take(self.number(sizes[tag - 0xc4]))
        if tag in (0xdc, 0xdd):
            return [self.value()
                    for _ in range(self.number(">H" if tag == 0xdc else ">I"))]
        if tag in (0xde, 0xdf):
            return self.mapping(self.number(">H" if tag == 0xde else ">I"))
        if 0xd4 <= tag <= 0xd8:
            return self.ext(1 << (tag - 0xd4))
        if 0xc7 <= tag <= 0xc9:
            return self.ext(self.number(sizes[tag - 0xc7]))
        raise ValueError(f"msgpack: unknown tag 0x{tag:02x}")

    def mapping(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.number(">b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown ext type {code}")
        shape, name, raw = _Reader(payload).value()
        if name == "bfloat16":  # the top half of a float32
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(
                np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(name))
        arr = arr.reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_msgpack_tree(path: Union[str, Path]) -> Dict[str, Any]:
    """Read flax's ``msgpack_serialize`` layout: a nested dict of numpy
    arrays (read-only views into the file's bytes, chunked arrays joined;
    bfloat16 leaves as float32)."""
    return _unchunk(_Reader(Path(path).read_bytes()).value())


# ----------------------------------------------------------- safetensors ----

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, in its stored
    dtype."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]]
        if end > begin:
            t = torch.frombuffer(bytearray(data[base + begin:base + end]),
                                 dtype=dtype)
        else:
            t = torch.empty((0,), dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out

