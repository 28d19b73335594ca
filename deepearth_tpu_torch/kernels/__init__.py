"""Hand-written CUDA kernels for Hopper (sm_90a) and their launch wrappers.

The sources in ``csrc/`` have a plain C interface. At first use each ``.cu``
is compiled with its own ``nvcc``, all at once, and the objects are linked
into one shared library under ``build/kernels/`` at the repository root,
named by a hash of the sources, and loaded with ctypes. No PyTorch header is
compiled, so a build takes seconds.

Each wrapper checks its inputs, allocates the output with ``torch.empty``
(``torch.zeros`` for the scatter-add), launches on the current stream,
raises if the launch reports an error, and adds one to its entry of
:data:`launch_counts`. The wrappers know nothing of autograd: the
``torch.autograd.Function`` of each kernel pair lives in ``ops/``. Nothing
here runs at import time: the CPU tests import this module on machines
without ``nvcc``.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launches per kernel since the last reset_launch_counts().
launch_counts = {"hash_encode_fwd": 0, "hash_encode_bwd": 0,
                 "pairwise_attention_fwd": 0, "pairwise_attention_bwd": 0,
                 "vmem_attention_fwd": 0, "vmem_attention_bwd": 0,
                 "flash_attention_fwd": 0, "flash_attention_bwd": 0}

_lib: Optional[ctypes.CDLL] = None
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "hash_encode_fwd": [_P, _P, _P, _P, _I64, _I, _I, _I64, _I64, _I, _I, _P],
    "hash_encode_bwd": [_P, _P, _P, _P, _I64, _I, _I, _I64, _I64, _I, _I, _P],
    "pairwise_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I64, _I64, _I64, _I64, _I64, _I64, _F, _I, _P],
    "pairwise_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I64, _I64, _I64, _I64, _I64, _I64, _F, _I,
                               _P],
    "attention_vmem_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           *[_I64] * 9, _F, _I, _P],
    "attention_vmem_bwd": [*[_P] * 10, *[_I] * 6, *[_I64] * 9, _F, _I, _P],
    "flash_attention_fwd": [*[_P] * 6, *[_I] * 6, *[_I64] * 9, _F, _I, _I,
                            _P],
    "flash_attention_bwd": [*[_P] * 11, *[_I] * 6, *[_I64] * 9, _F, _I, _I,
                            _P],
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        so = os.path.join(tmp, lib.name)
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", so,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{proc.stderr}")
        Path(str(lib) + ".log").write_text("\n".join(log))
        os.replace(so, lib)  # atomic: a concurrent build sees all or nothing
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


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _hash_inputs(name, coords, tables_shape, device, resolutions,
                 table_size):
    n, d = coords.shape
    n_levels, level_stride, f = tables_shape
    _require(coords.is_cuda and device == coords.device
             and resolutions.device == coords.device,
             f"{name}: inputs must lie on one CUDA device")
    _require(coords.dtype == resolutions.dtype == torch.float32,
             f"{name}: coords and resolutions must be float32")
    _require(1 <= d <= 4, f"{name}: coords_dim {d} not in 1..4")
    _require(resolutions.shape == (n_levels,),
             f"{name}: resolutions must be (L,)")
    _require(0 < table_size <= level_stride,
             f"{name}: table_size must fit the tables")
    return n, d, n_levels, level_stride, f


def hash_encode_fwd(coords: torch.Tensor, tables: torch.Tensor,
                    resolutions: torch.Tensor, table_size: int,
                    linear: bool) -> torch.Tensor:
    """K2 forward: coords (N, D) fp32, tables (L, T, F) fp32, resolutions (L,)
    fp32, all on one CUDA device. Returns (N, L*F) fp32."""
    n, d, n_levels, level_stride, f = _hash_inputs(
        "hash_encode_fwd", coords, tables.shape, tables.device, resolutions,
        table_size)
    _require(tables.dtype == torch.float32,
             "hash_encode_fwd: tables must be float32")
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


def hash_encode_bwd(coords: torch.Tensor, grad_out: torch.Tensor,
                    resolutions: torch.Tensor, tables_shape, table_size: int,
                    linear: bool) -> torch.Tensor:
    """K2 backward: the gradient of :func:`hash_encode_fwd` with respect to
    the tables. coords (N, D) fp32, grad_out (N, L*F) fp32, resolutions (L,)
    fp32 on one CUDA device; tables_shape (L, T, F). Returns (L, T, F) fp32,
    summed with atomics (the order of each sum differs from run to run)."""
    n, d, n_levels, level_stride, f = _hash_inputs(
        "hash_encode_bwd", coords, tuple(tables_shape), grad_out.device,
        resolutions, table_size)
    _require(grad_out.dtype == torch.float32
             and grad_out.shape == (n, n_levels * f),
             "hash_encode_bwd: grad_out must be (N, L*F) float32")
    coords, grad_out, resolutions = (
        coords.contiguous(), grad_out.contiguous(), resolutions.contiguous())
    grad_tables = torch.zeros((n_levels, level_stride, f),
                              device=coords.device, dtype=torch.float32)
    rc = library().hash_encode_bwd(
        coords.data_ptr(), grad_out.data_ptr(), resolutions.data_ptr(),
        grad_tables.data_ptr(), n, d, n_levels, level_stride, table_size, f,
        int(linear), torch.cuda.current_stream(coords.device).cuda_stream)
    _check("hash_encode_bwd", rc)
    return grad_tables


_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _token_major_strides(x: torch.Tensor, name: str):
    _require(x.dim() == 3 and x.stride(2) == 1,
             f"pairwise attention: {name} must be (N, B, D) with unit "
             "stride along D")
    _require(x.stride(0) % 2 == 0 and x.stride(1) % 2 == 0
             and x.data_ptr() % (2 * x.element_size()) == 0,
             f"pairwise attention: {name} must be aligned to element pairs")
    return x.stride(0), x.stride(1)


def _attention_inputs(q, k, v, n_heads, key_mask):
    """Checks shared by both directions; returns the strides of q, k, v and
    the key mask's pointer (or None)."""
    nq, b, d = q.shape
    nk = k.shape[0]
    _require(q.is_cuda and k.device == q.device and v.device == q.device,
             "pairwise attention: q, k, v must lie on one CUDA device")
    _require(q.dtype in _ATTN_DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             "pairwise attention: q, k, v must share float32 or bfloat16")
    _require(k.shape == v.shape == (nk, b, d),
             "pairwise attention: k and v must be (Nk, B, D) like q")
    _require(d % n_heads == 0 and (d // n_heads) % 2 == 0,
             "pairwise attention: head dim must be even")
    _require(1 <= nk and nq * nk <= 64, "pairwise attention: Nq*Nk > 64")
    strides = [s for x, name in ((q, "q"), (k, "k"), (v, "v"))
               for s in _token_major_strides(x, name)]
    mask_ptr = None
    if key_mask is not None:
        _require(key_mask.dtype == torch.bool and key_mask.shape == (b, nk)
                 and key_mask.device == q.device
                 and key_mask.is_contiguous(),
                 "pairwise attention: key_mask must be (B, Nk) bool")
        mask_ptr = key_mask.data_ptr()
    return strides, mask_ptr


def pairwise_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_heads: int, scale: float,
                           key_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K1 forward: q (Nq, B, D), k and v (Nk, B, D) on one CUDA device,
    float32 or bfloat16, unit stride along D; key_mask optional (B, Nk)
    bool, True = visible. Returns (Nq, B, D) in q's dtype."""
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    strides, mask_ptr = _attention_inputs(q, k, v, n_heads, key_mask)
    nq, b, d = q.shape
    out = torch.empty((nq, b, d), device=q.device, dtype=q.dtype)
    rc = library().pairwise_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        nq, k.shape[0], b, n_heads, d // n_heads, *strides, float(scale),
        _ATTN_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check("pairwise_attention_fwd", rc)
    return out


def pairwise_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, n_heads: int, scale: float,
                           key_mask: Optional[torch.Tensor] = None):
    """K1 backward: the forward's inputs plus dout (Nq, B, D), the gradient
    of its output, in q's dtype. Returns (dq, dk, dv), contiguous, in q's
    dtype."""
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    strides, mask_ptr = _attention_inputs(q, k, v, n_heads, key_mask)
    nq, b, d = q.shape
    nk = k.shape[0]
    _require(dout.shape == q.shape and dout.dtype == q.dtype
             and dout.device == q.device,
             "pairwise_attention_bwd: dout must be (Nq, B, D) like q")
    dout = dout.contiguous()
    dq = torch.empty((nq, b, d), device=q.device, dtype=q.dtype)
    dk = torch.empty((nk, b, d), device=q.device, dtype=q.dtype)
    dv = torch.empty((nk, b, d), device=q.device, dtype=q.dtype)
    rc = library().pairwise_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), mask_ptr,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), nq, nk, b, n_heads,
        d // n_heads, *strides, float(scale), _ATTN_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _check("pairwise_attention_bwd", rc)
    return dq, dk, dv


VMEM_MAX_SEQ, ATTN_MAX_DIM = 1024, 128


def _bhnd_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, key_mask: Optional[torch.Tensor]):
    """Checks shared by K3 and K4 (both directions). Returns (B, H, Nq, Nk,
    Dqk, Dv), the (B, H, N) strides of q, k and v, and the key mask, made
    contiguous, or None."""
    _require(q.is_cuda and k.device == q.device and v.device == q.device,
             f"{name}: q, k, v must lie on one CUDA device")
    _require(q.dtype in _ATTN_DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             f"{name}: q, k, v must share float32 or bfloat16")
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             f"{name}: q, k, v must be (B, H, N, D)")
    b, h, nq, dqk = q.shape
    nk, dv = k.shape[2], v.shape[3]
    _require(k.shape == (b, h, nk, dqk) and v.shape == (b, h, nk, dv),
             f"{name}: k must be (B, H, Nk, Dqk) and v (B, H, Nk, Dv)")
    _require(nk >= 1, f"{name}: Nk must be at least 1")
    _require(1 <= dqk <= ATTN_MAX_DIM and 1 <= dv <= ATTN_MAX_DIM,
             f"{name}: head dims {dqk}, {dv} must be at most "
             f"{ATTN_MAX_DIM}")
    _require(b <= 65535 and h <= 65535,
             f"{name}: B and H must be at most 65535")
    _require(all(x.stride(3) == 1 for x in (q, k, v)),
             f"{name}: q, k, v need unit stride along the head dim")
    if key_mask is not None:
        key_mask = key_mask.contiguous()
        _require(key_mask.dtype == torch.bool and key_mask.shape == (b, nk)
                 and key_mask.device == q.device,
                 f"{name}: key_mask must be (B, Nk) bool")
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    return (b, h, nq, nk, dqk, dv), strides, key_mask


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _like_output(name: str, x: torch.Tensor, q: torch.Tensor, shape,
                 dtype) -> torch.Tensor:
    _require(tuple(x.shape) == tuple(shape) and x.dtype == dtype
             and x.device == q.device,
             f"{name}: must be {tuple(shape)} {dtype} on q's device")
    return x.contiguous()


def vmem_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, key_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K3 forward: q (B, H, Nq, Dqk), k (B, H, Nk, Dqk), v (B, H, Nk, Dv) on
    one CUDA device, float32 or bfloat16, unit stride along the head dim
    (any strides along B, H, N); 1 <= Nk <= 1024, Nq <= 1024, Dqk and Dv <=
    128; key_mask optional (B, Nk) bool, True = visible. Returns
    (B, H, Nq, Dv), contiguous, in q's dtype."""
    (b, h, nq, nk, dqk, dv), strides, key_mask = _bhnd_inputs(
        "vmem attention", q, k, v, key_mask)
    _require(nk <= VMEM_MAX_SEQ and nq <= VMEM_MAX_SEQ,
             f"vmem attention: Nq {nq} and Nk {nk} must be at most "
             f"{VMEM_MAX_SEQ}")
    out = torch.empty((b, h, nq, dv), device=q.device, dtype=q.dtype)
    rc = library().attention_vmem_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), b, h, nq, nk, dqk, dv, *strides, float(scale),
        _ATTN_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check("vmem_attention_fwd", rc)
    return out


def vmem_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, scale: float,
                       key_mask: Optional[torch.Tensor] = None):
    """K3 backward: the forward's inputs plus dout (B, H, Nq, Dv), the
    gradient of its output, in q's dtype. Returns (dq, dk, dv), contiguous,
    in q's dtype."""
    (b, h, nq, nk, dqk, dv), strides, key_mask = _bhnd_inputs(
        "vmem attention", q, k, v, key_mask)
    _require(nk <= VMEM_MAX_SEQ and nq <= VMEM_MAX_SEQ,
             f"vmem attention: Nq {nq} and Nk {nk} must be at most "
             f"{VMEM_MAX_SEQ}")
    dout = _like_output("vmem_attention_bwd: dout", dout, q, (b, h, nq, dv),
                        q.dtype)
    grads = [torch.empty(shape, device=q.device, dtype=q.dtype) for shape in
             ((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv))]
    # per query row: the log-sum-exp and delta, written by the dq kernel for
    # the dk/dv kernel
    lse, delta = (torch.empty((b, h, nq), device=q.device,
                              dtype=torch.float32) for _ in range(2))
    rc = library().attention_vmem_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        dout.data_ptr(), *(g.data_ptr() for g in grads), lse.data_ptr(),
        delta.data_ptr(), b, h, nq, nk, dqk, dv, *strides, float(scale),
        _ATTN_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check("vmem_attention_bwd", rc)
    return tuple(grads)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, key_mask: Optional[torch.Tensor] = None,
                        causal: bool = False):
    """K4 forward: q (B, H, Nq, Dqk), k (B, H, Nk, Dqk), v (B, H, Nk, Dv) on
    one CUDA device, float32 or bfloat16, unit stride along the head dim;
    any N >= 1, Dqk and Dv <= 128; key_mask optional (B, Nk) bool; causal:
    key j visible to query i iff j <= i. Returns (out (B, H, Nq, Dv) in q's
    dtype, lse (B, H, Nq) float32), both contiguous; a row whose keys are
    all masked gives out 0 and lse +inf."""
    (b, h, nq, nk, dqk, dv), strides, key_mask = _bhnd_inputs(
        "flash attention", q, k, v, key_mask)
    out = torch.empty((b, h, nq, dv), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
    rc = library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), lse.data_ptr(), b, h, nq, nk, dqk, dv, *strides,
        float(scale), int(causal), _ATTN_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _check("flash_attention_fwd", rc)
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, scale: float,
                        key_mask: Optional[torch.Tensor] = None,
                        causal: bool = False):
    """K4 backward: the forward's inputs, its out and lse, and dout
    (B, H, Nq, Dv) in q's dtype. Returns (dq, dk, dv), contiguous, in q's
    dtype. One launch of the dq kernel and one of the dk/dv kernel, counted
    as one."""
    (b, h, nq, nk, dqk, dv), strides, key_mask = _bhnd_inputs(
        "flash attention", q, k, v, key_mask)
    out = _like_output("flash_attention_bwd: out", out, q, (b, h, nq, dv),
                       q.dtype)
    dout = _like_output("flash_attention_bwd: dout", dout, q, (b, h, nq, dv),
                        q.dtype)
    lse = _like_output("flash_attention_bwd: lse", lse, q, (b, h, nq),
                       torch.float32)
    grads = [torch.empty(shape, device=q.device, dtype=q.dtype) for shape in
             ((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv))]
    delta = torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
    rc = library().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        *(g.data_ptr() for g in grads), delta.data_ptr(), b, h, nq, nk, dqk,
        dv, *strides, float(scale), int(causal), _ATTN_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _check("flash_attention_bwd", rc)
    return tuple(grads)
