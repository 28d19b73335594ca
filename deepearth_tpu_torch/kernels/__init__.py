"""Hand-written CUDA kernels for Hopper (sm_90a) and their launch wrappers.

The sources in ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` into one shared library under ``build/kernels/`` at the
repository root, named by a hash of the sources, and loaded with ctypes. No
PyTorch header is compiled, so a build takes seconds.

Each wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on the current stream, raises if the launch reports an error, and
adds one to its entry of :data:`launch_counts`. Nothing here runs at import
time: the CPU tests import this module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launches per kernel since the last reset_launch_counts().
launch_counts = {"hash_encode_fwd": 0, "pairwise_attention_fwd": 0}

_lib: Optional[ctypes.CDLL] = None
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "hash_encode_fwd": [_P, _P, _P, _P, _I64, _I, _I, _I64, _I64, _I, _I, _P],
    "pairwise_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I64, _I64, _I64, _I64, _I64, _I64, _F, _I, _P],
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile the kernels if no library for the current sources exists.

    Returns the library's path. The compiler's report (registers, spills)
    is kept beside it as ``<library>.log``.
    """
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libdeepearth_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    Path(str(lib) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")
    launch_counts[name] += 1


def _no_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel yet; run it under "
            "torch.inference_mode() or torch.no_grad()")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def hash_encode_fwd(coords: torch.Tensor, tables: torch.Tensor,
                    resolutions: torch.Tensor, table_size: int,
                    linear: bool) -> torch.Tensor:
    """K2 forward: coords (N, D) fp32, tables (L, T, F) fp32, resolutions (L,)
    fp32, all on one CUDA device. Returns (N, L*F) fp32."""
    _no_grad("hash_encode_fwd", coords, tables)
    n, d = coords.shape
    n_levels, level_stride, f = tables.shape
    _require(coords.is_cuda and tables.device == coords.device
             and resolutions.device == coords.device,
             "hash_encode_fwd: inputs must lie on one CUDA device")
    _require(coords.dtype == tables.dtype == resolutions.dtype == torch.float32,
             "hash_encode_fwd: coords, tables and resolutions must be float32")
    _require(1 <= d <= 4, f"hash_encode_fwd: coords_dim {d} not in 1..4")
    _require(resolutions.shape == (n_levels,),
             "hash_encode_fwd: resolutions must be (L,)")
    _require(0 < table_size <= level_stride,
             "hash_encode_fwd: table_size must fit the tables")
    coords, tables, resolutions = (
        coords.contiguous(), tables.contiguous(), resolutions.contiguous())
    out = torch.empty((n, n_levels * f), device=coords.device,
                      dtype=torch.float32)
    rc = library().hash_encode_fwd(
        coords.data_ptr(), tables.data_ptr(), resolutions.data_ptr(),
        out.data_ptr(), n, d, n_levels, level_stride, table_size, f,
        int(linear), torch.cuda.current_stream(coords.device).cuda_stream)
    _check("hash_encode_fwd", rc)
    return out


_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _token_major_strides(x: torch.Tensor, name: str):
    _require(x.dim() == 3 and x.stride(2) == 1,
             f"pairwise_attention_fwd: {name} must be (N, B, D) with unit "
             "stride along D")
    _require(x.stride(0) % 2 == 0 and x.stride(1) % 2 == 0
             and x.data_ptr() % (2 * x.element_size()) == 0,
             f"pairwise_attention_fwd: {name} must be aligned to element pairs")
    return x.stride(0), x.stride(1)


def pairwise_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_heads: int, scale: float,
                           key_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K1 forward: q (Nq, B, D), k and v (Nk, B, D) on one CUDA device,
    float32 or bfloat16, unit stride along D; key_mask optional (B, Nk)
    bool, True = visible. Returns (Nq, B, D) in q's dtype."""
    _no_grad("pairwise_attention_fwd", q, k, v)
    nq, b, d = q.shape
    nk = k.shape[0]
    _require(q.is_cuda and k.device == q.device and v.device == q.device,
             "pairwise_attention_fwd: q, k, v must lie on one CUDA device")
    _require(q.dtype in _ATTN_DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             "pairwise_attention_fwd: q, k, v must share float32 or bfloat16")
    _require(k.shape == v.shape == (nk, b, d),
             "pairwise_attention_fwd: k and v must be (Nk, B, D) like q")
    _require(d % n_heads == 0 and (d // n_heads) % 2 == 0,
             "pairwise_attention_fwd: head dim must be even")
    _require(1 <= nk and nq * nk <= 64, "pairwise_attention_fwd: Nq*Nk > 64")
    strides = [s for x, name in ((q, "q"), (k, "k"), (v, "v"))
               for s in _token_major_strides(x, name)]
    mask_ptr = None
    if key_mask is not None:
        _require(key_mask.dtype == torch.bool and key_mask.shape == (b, nk)
                 and key_mask.device == q.device,
                 "pairwise_attention_fwd: key_mask must be (B, Nk) bool")
        key_mask = key_mask.contiguous()
        mask_ptr = key_mask.data_ptr()
    out = torch.empty((nq, b, d), device=q.device, dtype=q.dtype)
    rc = library().pairwise_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        nq, nk, b, n_heads, d // n_heads, *strides, float(scale),
        _ATTN_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check("pairwise_attention_fwd", rc)
    return out
