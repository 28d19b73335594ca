"""ctypes loader for the native batch gather (``csrc/fast_gather.c``): the
port's counterpart of ``deepearth_tpu/data/native.py``, with its own copy of
the C source.

The source is compiled at first use with the host's C compiler into
``build/native/`` at the repository root (gitignored), under a name that
carries the source's hash, loaded with ctypes, and exposed as
:func:`gather_rows`. Without a C compiler it falls back to the JAX module's
numpy loop, so the pure-Python path always works. This is host code: the
card never touches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.logging import get_logger

logger = get_logger("Native")

SRC = Path(__file__).resolve().parent / "csrc" / "fast_gather.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _build_lib() -> Optional[Path]:
    """The library for the current source, compiled if missing; None when
    no C compiler builds it."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfastgather_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for cc in ("cc", "gcc", "clang"):
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, lib.name)
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-pthread", str(SRC),
                     "-o", out],
                    check=True, capture_output=True, timeout=60,
                )
            except (FileNotFoundError, subprocess.CalledProcessError,
                    subprocess.TimeoutExpired) as e:
                logger.debug(f"{cc} build failed: {e}")
                continue
            os.replace(out, lib)  # atomic: a concurrent build sees all or nothing
        logger.info(f"built native gather with {cc} -> {lib}")
        return lib
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build_lib()
        if path is None:
            logger.info("no C compiler; using numpy gather fallback")
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning(f"native gather unavailable: {e}")
            return None
        lib.gather_rows.argtypes = [
            ctypes.c_void_p,  # base
            ctypes.POINTER(ctypes.c_int64),  # offsets
            ctypes.c_int,  # n
            ctypes.c_int64,  # row_bytes
            ctypes.c_void_p,  # out
            ctypes.c_int,  # n_threads
        ]
        lib.gather_rows.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def gather_rows(
    mmap_arr: np.memmap,
    byte_offsets: np.ndarray,
    row_bytes: int,
    n_threads: int = 4,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Gather rows from a memory-mapped blob into one contiguous buffer.

    Args:
        mmap_arr: 1-D np.memmap over the blob (any dtype).
        byte_offsets: (N,) int64 byte offsets of each row start.
        row_bytes: bytes per row.

    Returns:
        (N, row_bytes) uint8 array (caller views/reshapes to the real dtype).
    """
    n = len(byte_offsets)
    if out is None:
        out = np.empty((n, row_bytes), dtype=np.uint8)
    if not out.flags["C_CONTIGUOUS"] or out.nbytes != n * row_bytes:
        raise ValueError("out must be C-contiguous and hold N * row_bytes")
    offs = np.ascontiguousarray(byte_offsets, dtype=np.int64)
    if n and (offs.min() < 0 or offs.max() + row_bytes > mmap_arr.nbytes):
        raise ValueError("a row lies outside the mapped blob")
    lib = _load()
    if lib is not None:
        base = mmap_arr.ctypes.data_as(ctypes.c_void_p)
        lib.gather_rows(
            base,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int(n),
            ctypes.c_int64(row_bytes),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(n_threads),
        )
        return out
    # numpy fallback
    raw = mmap_arr.view(np.uint8)
    for i, off in enumerate(offs):
        out[i] = raw[off : off + row_bytes]
    return out
