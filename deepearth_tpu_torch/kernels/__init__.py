"""Hand-written CUDA kernels for Hopper (sm_90a) and their launch wrappers:
K1 ``pairwise_attention_fwd`` / ``_bwd`` (each by one of two routes,
:func:`pairwise_fwd_tma_route`, :func:`pairwise_bwd_tma_route`), K2-fwd
``grid4d_encode_fwd`` (a Grid4D encoder's every table, masks, concatenation
and cast in one launch, where :func:`grid4d_encode_route` holds) and
``hash_encode_fwd`` (one table), K2-bwd ``hash_encode_bwd`` (by one of two
routes, :func:`hash_bwd_dense_route`),
K3 ``vmem_attention_fwd`` / ``_bwd`` (each by one of three routes,
:func:`vmem_fwd_tma_route`, :func:`vmem_bwd_tma_route`), K4
``flash_attention_fwd`` / ``_bwd`` (each by one of three routes,
:func:`flash_fwd_tma_route`, :func:`flash_bwd_tma_route`),
K5 ``grouped_matmul_fwd`` (three routes, :func:`gmm_fwd_tma_route`) and
``grouped_matmul_bwd`` (which launches
``grouped_matmul_split_dout`` and ``grouped_matmul_bwd_{dlhs,drhs}_tma``, or
``grouped_matmul_bwd_{dlhs,drhs}_mma``), K6 ``int8_bmm`` and K7
``int4_bmm`` (each by one of two routes, :func:`int8_bmm_tc_route`,
:func:`int4_bmm_tc_route`), and Gaussian splatting's K8 ``splat_bin`` and
K9 ``splat_composite_fwd`` / ``_bwd`` (``csrc/gaussian_splat.cu``).

The sources in ``csrc/`` have a plain C interface. At first use each ``.cu``
is compiled with its own ``nvcc``, all at once, and the objects are linked
into one shared library under ``build/kernels/`` at the repository root,
named by a hash of the sources, and loaded with ctypes. No PyTorch header is
compiled, so a build takes seconds.

Each wrapper checks its inputs, allocates the output with ``torch.empty``
(``torch.zeros`` for K2-bwd's scalar scatter-add), launches on the current
stream, raises if the launch reports an error, and adds one to its entry of
:data:`launch_counts`. The wrappers know nothing of autograd: the
``torch.autograd.Function`` of each kernel pair lives in ``ops/``. Nothing
here runs at import time: the CPU tests import this module on machines
without ``nvcc``.

``torch.export`` traces with fake tensors, which have no data for ctypes.
The kernels of the A-stack forward that ``api.DeepEarth`` serves, K1-fwd
and K2-fwd's Grid4D encode, are therefore registered as custom operators
(``torch.ops.deepearth.pairwise_attention_fwd`` and ``.grid4d_encode_fwd``,
each with a fake implementation): under an export trace their wrappers
call the operator, which the exported program keeps and which runs the
wrapper again when the program runs. Every other kernel launch raises a
``ValueError`` under an export trace (:func:`library`, :data:`EXPORT_TODO`).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launches per kernel since the last reset_launch_counts().
launch_counts = {"grid4d_encode_fwd": 0, "hash_encode_fwd": 0,
                 # K2-bwd by route: the dense gradient written whole with
                 # float2 reductions (no suffix, F = 2), scalar atomics into
                 # a zeroed gradient (_scalar)
                 "hash_encode_bwd": 0, "hash_encode_bwd_scalar": 0,
                 # K1 by route: 8 lanes a (row, head) on 16-byte register
                 # loads (no suffix), a warp a (row, head) (_warp)
                 "pairwise_attention_fwd": 0, "pairwise_attention_fwd_warp": 0,
                 "pairwise_attention_bwd": 0,
                 "pairwise_attention_bwd_warp": 0,
                 # K3, K4, K5-fwd and K5-bwd by route: wgmma over TMA tiles
                 # (no suffix), mma.sync (bf16 off TMA's grid), CUDA cores
                 # (fp32)
                 "vmem_attention_fwd": 0, "vmem_attention_fwd_mma": 0,
                 "vmem_attention_fwd_fp32": 0, "vmem_attention_bwd": 0,
                 "vmem_attention_bwd_mma": 0, "vmem_attention_bwd_fp32": 0,
                 "flash_attention_fwd": 0, "flash_attention_fwd_mma": 0,
                 "flash_attention_fwd_fp32": 0, "flash_attention_bwd": 0,
                 "flash_attention_bwd_mma": 0, "flash_attention_bwd_fp32": 0,
                 "grouped_matmul_fwd": 0, "grouped_matmul_fwd_mma": 0,
                 "grouped_matmul_fwd_fp32": 0, "grouped_matmul_split_dout": 0,
                 "grouped_matmul_bwd_dlhs": 0, "grouped_matmul_bwd_dlhs_mma": 0,
                 "grouped_matmul_bwd_dlhs_fp32": 0,
                 "grouped_matmul_bwd_drhs": 0, "grouped_matmul_bwd_drhs_mma": 0,
                 "grouped_matmul_bwd_drhs_fp32": 0,
                 # K6 and K7 by route: tensor cores in one cluster launch
                 # (no suffix), CUDA-core FMAs (shapes off its grid)
                 "int8_bmm": 0, "int8_bmm_fma": 0, "int4_bmm": 0,
                 "int4_bmm_fma": 0,
                 # K8 and K9: Gaussian splatting's binning and compositing
                 "splat_bin": 0, "splat_composite_fwd": 0,
                 "splat_composite_bwd": 0}

_lib: Optional[ctypes.CDLL] = None
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "grid4d_encode_fwd": [_P, _I64, _I64, _I64, _P, _P, _P, _I, _P, _I64, _I,
                          _P],
    "hash_encode_fwd": [_P, _P, _P, _P, _I64, _I, _I, _I64, _I64, _I, _I, _P],
    "hash_encode_bwd": [_P, _P, _P, _P, _I64, _I, _I, _I64, _I64, _I, _I, _P],
    "hash_encode_bwd_dense": [_P, _P, _P, _P, _I64, _I, _I, _I64, _I64, _I,
                              _P],
    "pairwise_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I64, _I64, _I64, _I64, _I64, _I64, _F, _I, _P],
    "pairwise_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I64, _I64, _I64, _I64, _I64, _I64, _F, _I,
                               _P],
    "attention_vmem_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           *[_I64] * 9, _F, _I, _P],
    "attention_vmem_fwd_tma": [*[_P] * 5, *[_I] * 6, *[_I64] * 9, _F, _P],
    "attention_vmem_bwd": [*[_P] * 10, *[_I] * 6, *[_I64] * 9, _F, _I, _P],
    "attention_vmem_bwd_tma": [*[_P] * 10, *[_I] * 6, *[_I64] * 9, _F, _P],
    "flash_attention_fwd": [*[_P] * 6, *[_I] * 6, *[_I64] * 9, _F, _I, _I,
                            _P],
    "flash_attention_fwd_tma": [*[_P] * 6, *[_I] * 6, *[_I64] * 9, _F, _I,
                                _P],
    "flash_attention_bwd": [*[_P] * 11, *[_I] * 6, *[_I64] * 9, _F, _I, _I,
                            _P],
    "flash_attention_bwd_tma": [*[_P] * 11, *[_I] * 6, *[_I64] * 9, _F, _I,
                                _P],
    "grouped_matmul_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "grouped_matmul_fwd_tma": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "grouped_matmul_bwd_dlhs": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "grouped_matmul_bwd_drhs": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "grouped_matmul_split_dout": [_P, _P, _P, _I64, _P],
    "grouped_matmul_bwd_dlhs_tma": [*[_P] * 5, *[_I] * 4, _P],
    "grouped_matmul_bwd_drhs_tma": [*[_P] * 5, *[_I] * 4, _P],
    "int8_bmm": [*[_P] * 5, *[_I] * 10, _P],
    "int4_bmm": [*[_P] * 5, *[_I] * 10, _P],
    "int4_bmm_tc": [*[_P] * 4, *[_I] * 9, _P],
    "int8_bmm_tc": [*[_P] * 4, *[_I] * 9, _P],
    "pairwise_attention_bwd_tma": [*[_P] * 8, *[_I] * 5, *[_I64] * 6, _F,
                                   _P],
    "pairwise_attention_fwd_tma": [*[_P] * 5, *[_I] * 5, *[_I64] * 6, _F,
                                   _P],
    "splat_bin": [_P, _P, _P, *[_I] * 6, _P, _P, _P, _P],
    "splat_composite_fwd": [*[_P] * 5, *[_I] * 8, _P, _P, _P],
    "splat_composite_bwd": [*[_P] * 7, *[_I] * 8, *[_P] * 5, _P],
}

EXPORT_TODO = ("ROADMAP.md Queue 1, item 21: only K1-fwd and K2-fwd's Grid4D "
               "encode are registered as custom operators")


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
        cus = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, src.stem + ".o") for src in cus]

        def compile_one(src, obj):
            # each in its own thread: the compilers run together, and each
            # report is read as it comes (a full pipe would stall nvcc)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return proc, time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(len(cus)) as pool:
            done = list(pool.map(compile_one, cus, objs))
        log, failed = [], []
        for src, (proc, seconds) in zip(cus, done):
            log.append(f"== {src.name} ({seconds:.1f} s)\n{proc.stdout}")
            if proc.returncode != 0:
                failed.append(src.name)
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
    """The loaded kernel library, built on first use. Every launch goes
    through it, so under an export trace it raises ``ValueError``: ctypes
    cannot launch on fake tensors, and only the kernels registered as
    operators (which divert before they launch) can be traced."""
    global _lib
    if torch.compiler.is_exporting():
        raise ValueError("torch.export reached a kernel launch, which it "
                         f"cannot trace: {EXPORT_TODO}")
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


def _hash_bwd_inputs(name, coords, grad_out, resolutions, tables_shape,
                     table_size):
    """Checks of K2-bwd's inputs (both routes); returns (N, D, L, T, F) and
    contiguous coords, grad_out and resolutions."""
    n, d, n_levels, level_stride, f = _hash_inputs(
        name, coords, tuple(tables_shape), grad_out.device, resolutions,
        table_size)
    _require(grad_out.dtype == torch.float32
             and grad_out.shape == (n, n_levels * f),
             f"{name}: grad_out must be (N, L*F) float32")
    return ((n, d, n_levels, level_stride, f), coords.contiguous(),
            grad_out.contiguous(), resolutions.contiguous())


def hash_bwd_dense_route(f: int) -> bool:
    """Whether K2-bwd takes its dense route (the whole gradient written by
    the kernel, one float2 reduction a corner, ``hash_encode_bwd_dense`` in
    ``csrc/hash_encode.cu``): F = 2, as in every Grid4D configuration. Else
    the scalar atomics into a zeroed gradient (``hash_encode_bwd_scalar``).
    A function of the shape alone."""
    return f == 2


def hash_encode_bwd_dense(coords: torch.Tensor, grad_out: torch.Tensor,
                          resolutions: torch.Tensor, tables_shape,
                          table_size: int, linear: bool) -> torch.Tensor:
    """K2-bwd's dense route, as :func:`hash_encode_bwd`, at F = 2: the
    gradient is allocated with ``torch.empty`` and the kernels write every
    entry, a zeroing launch then the scatter; counted as
    ``hash_encode_bwd``."""
    name = "hash_encode_bwd"
    (n, d, n_levels, level_stride, f), coords, grad_out, resolutions = (
        _hash_bwd_inputs(name, coords, grad_out, resolutions, tables_shape,
                         table_size))
    _require(hash_bwd_dense_route(f), f"{name}: the dense route takes F = 2")
    if grad_out.data_ptr() % 8:  # the scatter reads it a float2 at a time
        grad_out = grad_out.clone()
    grad_tables = torch.empty((n_levels, level_stride, f),
                              device=coords.device, dtype=torch.float32)
    rc = library().hash_encode_bwd_dense(
        coords.data_ptr(), grad_out.data_ptr(), resolutions.data_ptr(),
        grad_tables.data_ptr(), n, d, n_levels, level_stride, table_size,
        int(linear), torch.cuda.current_stream(coords.device).cuda_stream)
    _check(name, rc)
    return grad_tables


def hash_encode_bwd_scalar(coords: torch.Tensor, grad_out: torch.Tensor,
                           resolutions: torch.Tensor, tables_shape,
                           table_size: int, linear: bool) -> torch.Tensor:
    """K2-bwd's scalar route, as :func:`hash_encode_bwd`, at any F: scalar
    fp32 atomics into a gradient zeroed by ``torch.zeros``; counted as
    ``hash_encode_bwd_scalar``."""
    name = "hash_encode_bwd_scalar"
    (n, d, n_levels, level_stride, f), coords, grad_out, resolutions = (
        _hash_bwd_inputs(name, coords, grad_out, resolutions, tables_shape,
                         table_size))
    grad_tables = torch.zeros((n_levels, level_stride, f),
                              device=coords.device, dtype=torch.float32)
    rc = library().hash_encode_bwd(
        coords.data_ptr(), grad_out.data_ptr(), resolutions.data_ptr(),
        grad_tables.data_ptr(), n, d, n_levels, level_stride, table_size, f,
        int(linear), torch.cuda.current_stream(coords.device).cuda_stream)
    _check(name, rc)
    return grad_tables


def hash_encode_bwd(coords: torch.Tensor, grad_out: torch.Tensor,
                    resolutions: torch.Tensor, tables_shape, table_size: int,
                    linear: bool) -> torch.Tensor:
    """K2 backward: the gradient of :func:`hash_encode_fwd` with respect to
    the tables. coords (N, D) fp32, grad_out (N, L*F) fp32, resolutions (L,)
    fp32 on one CUDA device; tables_shape (L, T, F). Returns (L, T, F) fp32,
    summed with atomics (the order of each sum differs from run to run), by
    the route :func:`hash_bwd_dense_route` picks from F:
    :func:`hash_encode_bwd_dense` (``hash_encode_bwd``) or
    :func:`hash_encode_bwd_scalar` (``hash_encode_bwd_scalar``)."""
    route = (hash_encode_bwd_dense if hash_bwd_dense_route(tables_shape[-1])
             else hash_encode_bwd_scalar)
    return route(coords, grad_out, resolutions, tables_shape, table_size,
                 linear)


class _Grid4DTable(ctypes.Structure):
    """One table of :func:`grid4d_encode_fwd` (``Grid4DTable`` in
    ``csrc/grid4d_encode.cu``)."""
    _fields_ = [("tables", _P), ("resolutions", _P), ("level_stride", _I64),
                ("table_size", _I64), ("n_levels", ctypes.c_int32),
                ("d", ctypes.c_int32), ("linear", ctypes.c_int32),
                ("mask", ctypes.c_int32), ("out_col", ctypes.c_int32),
                ("cols", ctypes.c_int32 * 4)]


_GRID4D_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grid4d_encode_route(tables_dims, out_dtype) -> bool:
    """Whether a Grid4D encoder's tables take the one-launch encode
    (``grid4d_encode_fwd``): every table with F = 2 and D <= 4
    (``tables_dims`` holds (F, D) of each) and an fp32 or bf16 compute
    dtype, as in every Grid4D configuration. Else each table goes through
    :func:`hash_encode_fwd`. A function of the config alone."""
    return (all(f == 2 and 1 <= d <= 4 for f, d in tables_dims)
            and out_dtype in _GRID4D_DTYPES)


def grid4d_encode_fwd(xyzt: torch.Tensor, encodings, spatial_mask,
                      temporal_mask, out_dtype) -> torch.Tensor:
    """K2-fwd as a Grid4D encoder runs it: every table's encoding, times its
    masks, concatenated and cast to ``out_dtype``, in one launch.

    xyzt (N, 4) fp32 on a CUDA device, read in place with its strides;
    ``encodings`` one (tables (L, T, 2) fp32, resolutions (L,) fp32,
    table_size, linear, cols, mask_bits) per table in output order, cols the
    xyzt columns of its coordinates, mask_bits 1 (times spatial_mask), 2
    (temporal_mask) or 3 (both); a mask (N,) bool or None, a bit whose mask
    is None ignored. Returns (N, sum of 2 L) in ``out_dtype`` (fp32 or
    bf16), the plain composition's bits; counted as ``grid4d_encode_fwd``.
    Under an export trace: the operator
    ``torch.ops.deepearth.grid4d_encode_fwd``, which calls this.
    """
    if torch.compiler.is_exporting():
        return torch.ops.deepearth.grid4d_encode_fwd(
            xyzt, [e[0] for e in encodings], [e[1] for e in encodings],
            [int(e[2]) for e in encodings], [bool(e[3]) for e in encodings],
            [c for e in encodings for c in e[4]],
            [len(e[4]) for e in encodings], [int(e[5]) for e in encodings],
            spatial_mask, temporal_mask, out_dtype)
    name = "grid4d_encode_fwd"
    n = xyzt.shape[0]
    _require(xyzt.is_cuda and xyzt.dtype == torch.float32 and xyzt.dim() == 2,
             f"{name}: xyzt must be a 2-D float32 CUDA tensor")
    _require(grid4d_encode_route([(t.shape[-1], len(c))
                                  for t, _, _, _, c, _ in encodings],
                                 out_dtype),
             f"{name}: takes tables of F = 2, D <= 4, and an fp32 or bf16 "
             "output")
    given = 0
    for bit, mask in ((1, spatial_mask), (2, temporal_mask)):
        if mask is not None:
            _require(mask.device == xyzt.device and mask.dtype == torch.bool
                     and mask.shape == (n,),
                     f"{name}: a mask must be (N,) bool on xyzt's device")
            given |= bit
    spatial_mask, temporal_mask = (
        m.contiguous() if m is not None else None
        for m in (spatial_mask, temporal_mask))
    descs = (_Grid4DTable * len(encodings))()
    col = 0
    for desc, (tables, res, table_size, linear, cols, bits) in zip(
            descs, encodings):
        n_levels, level_stride, _ = tables.shape
        _require(tables.device == res.device == xyzt.device
                 and tables.dtype == res.dtype == torch.float32
                 and tables.is_contiguous() and res.is_contiguous()
                 and res.shape == (n_levels,),
                 f"{name}: tables (L, T, 2) and resolutions (L,) must be "
                 "contiguous float32 on xyzt's device")
        _require(0 < table_size <= level_stride,
                 f"{name}: table_size must fit the tables")
        _require(all(0 <= c < xyzt.shape[1] for c in cols),
                 f"{name}: coordinate columns out of xyzt")
        desc.tables, desc.resolutions = tables.data_ptr(), res.data_ptr()
        desc.level_stride, desc.table_size = level_stride, table_size
        desc.n_levels, desc.d, desc.linear = n_levels, len(cols), int(linear)
        desc.mask, desc.out_col = bits & given, col
        desc.cols[:len(cols)] = cols
        col += 2 * n_levels
    out = torch.empty((n, col), device=xyzt.device, dtype=out_dtype)
    rc = library().grid4d_encode_fwd(
        xyzt.data_ptr(), n, xyzt.stride(0), xyzt.stride(1),
        _ptr(spatial_mask), _ptr(temporal_mask), descs, len(encodings),
        out.data_ptr(), col, _GRID4D_DTYPES[out_dtype],
        torch.cuda.current_stream(xyzt.device).cuda_stream)
    _check(name, rc)
    return out


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


def pairwise_attention_fwd_warp(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, n_heads: int, scale: float,
                                key_mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """K1-fwd's kernel of ``csrc/pairwise_attention.cu`` (one warp per
    (row, head)), as :func:`pairwise_attention_fwd`, on any shapes; counted
    as ``pairwise_attention_fwd_warp``."""
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    strides, mask_ptr = _attention_inputs(q, k, v, n_heads, key_mask)
    nq, b, d = q.shape
    out = torch.empty((nq, b, d), device=q.device, dtype=q.dtype)
    rc = library().pairwise_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        nq, k.shape[0], b, n_heads, d // n_heads, *strides, float(scale),
        _ATTN_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check("pairwise_attention_fwd_warp", rc)
    return out


def _pairwise_bwd_inputs(q, k, v, dout, n_heads, key_mask):
    """Checks of K1-bwd's inputs (both routes); returns q, k, v's strides,
    the key mask's pointer (or None), contiguous dout and the outputs (dq,
    dk, dv), allocated."""
    strides, mask_ptr = _attention_inputs(q, k, v, n_heads, key_mask)
    nq, b, d = q.shape
    nk = k.shape[0]
    _require(dout.shape == q.shape and dout.dtype == q.dtype
             and dout.device == q.device,
             "pairwise_attention_bwd: dout must be (Nq, B, D) like q")
    grads = [torch.empty((n, b, d), device=q.device, dtype=q.dtype)
             for n in (nq, nk, nk)]
    return strides, mask_ptr, dout.contiguous(), grads


PAIRWISE_TMA_MAX_TOKENS, PAIRWISE_TMA_MAX_HEAD_DIM = 3, 256


def _pairwise_strides(x: torch.Tensor):
    """x's element strides along tokens and rows, each of a dim of extent 1
    given as 8 (its index is always 0, so any aligned stride reads it)."""
    return [s if n > 1 else 8 for s, n in zip(x.stride()[:2], x.shape[:2])]


def pairwise_bwd_tma_route(dtype, nq: int, nk: int, head_dim: int,
                           strides) -> bool:
    """Whether K1-bwd takes its streaming route (8 lanes a (row, head),
    16-byte vectors loaded into registers,
    ``csrc/pairwise_attention_bwd_tma.cu``): bf16, 1 <= Nq, Nk <= 3, the
    head dim a multiple of 8 up to 256, and ``strides`` (the token and row
    strides of q, k and v, as :func:`_pairwise_strides` gives them)
    positive multiples of 8 elements, so that every vector is 16-byte
    aligned. A base off a 16-byte boundary is copied by the wrapper. Else
    the kernel of one warp per (row, head)
    (``pairwise_attention_bwd_warp``). A function of the shapes and strides
    alone."""
    return (dtype == torch.bfloat16
            and 1 <= nq <= PAIRWISE_TMA_MAX_TOKENS
            and 1 <= nk <= PAIRWISE_TMA_MAX_TOKENS
            and 8 <= head_dim <= PAIRWISE_TMA_MAX_HEAD_DIM
            and head_dim % 8 == 0
            and all(s > 0 and s % 8 == 0 for s in strides))


def pairwise_fwd_tma_route(dtype, nq: int, nk: int, head_dim: int,
                           strides) -> bool:
    """Whether K1-fwd takes its streaming route (8 lanes a (row, head),
    16-byte vectors loaded into registers,
    ``csrc/pairwise_attention_fwd_tma.cu``): the shapes and strides
    :func:`pairwise_bwd_tma_route` takes, so that both directions of a site
    take the same route. Else the kernel of one warp per (row, head)
    (``pairwise_attention_fwd_warp``). A function of the shapes and strides
    alone."""
    return pairwise_bwd_tma_route(dtype, nq, nk, head_dim, strides)


def _pairwise_on_grid(route, q, k, v, n_heads) -> bool:
    """Whether ``route`` (a ``pairwise_*_tma_route`` rule) takes q, k, v."""
    return (q.dim() == 3 and k.dim() == 3 and v.dim() == 3
            and n_heads > 0 and q.shape[2] % n_heads == 0
            and route(q.dtype, q.shape[0], k.shape[0], q.shape[2] // n_heads,
                      [s for x in (q, k, v) for s in _pairwise_strides(x)]))


def pairwise_attention_fwd_tma(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, n_heads: int, scale: float,
                               key_mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """K1-fwd's streaming route (``csrc/pairwise_attention_fwd_tma.cu``), as
    :func:`pairwise_attention_fwd`, on the shapes and strides
    :func:`pairwise_fwd_tma_route` takes. Counted as
    ``pairwise_attention_fwd``."""
    name = "pairwise_attention_fwd"
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    _, mask_ptr = _attention_inputs(q, k, v, n_heads, key_mask)
    _require(_pairwise_on_grid(pairwise_fwd_tma_route, q, k, v, n_heads),
             f"{name}: the streaming route takes bfloat16 with Nq, Nk <= "
             f"{PAIRWISE_TMA_MAX_TOKENS}, head dims multiples of 8 up to "
             f"{PAIRWISE_TMA_MAX_HEAD_DIM} and strides multiples of 8")
    nq, b, d = q.shape
    out = torch.empty((nq, b, d), device=q.device, dtype=q.dtype)
    q, k, v = (_aligned16_view(x) for x in (q, k, v))
    rc = library().pairwise_attention_fwd_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        nq, k.shape[0], b, n_heads, d // n_heads,
        *(s for x in (q, k, v) for s in _pairwise_strides(x)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(name, rc)
    return out


def pairwise_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_heads: int, scale: float,
                           key_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K1 forward: q (Nq, B, D), k and v (Nk, B, D) on one CUDA device,
    float32 or bfloat16, unit stride along D; key_mask optional (B, Nk)
    bool, True = visible. Returns (Nq, B, D) in q's dtype. One launch, by
    the route :func:`pairwise_fwd_tma_route` picks from the shapes and
    strides: :func:`pairwise_attention_fwd_tma` (``pairwise_attention_fwd``)
    or :func:`pairwise_attention_fwd_warp` (``pairwise_attention_fwd_warp``).
    Under an export trace: the operator
    ``torch.ops.deepearth.pairwise_attention_fwd``, which calls this.
    """
    if torch.compiler.is_exporting():
        return torch.ops.deepearth.pairwise_attention_fwd(
            q, k, v, key_mask, n_heads, float(scale))
    route = (pairwise_attention_fwd_tma
             if _pairwise_on_grid(pairwise_fwd_tma_route, q, k, v, n_heads)
             else pairwise_attention_fwd_warp)
    return route(q, k, v, n_heads, scale, key_mask)


def pairwise_attention_bwd_tma(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, dout: torch.Tensor,
                               n_heads: int, scale: float,
                               key_mask: Optional[torch.Tensor] = None):
    """K1-bwd's streaming route (``csrc/pairwise_attention_bwd_tma.cu``), as
    :func:`pairwise_attention_bwd`, on the shapes and strides
    :func:`pairwise_bwd_tma_route` takes; counted as
    ``pairwise_attention_bwd``."""
    name = "pairwise_attention_bwd"
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    _, mask_ptr, dout, grads = _pairwise_bwd_inputs(q, k, v, dout, n_heads,
                                                    key_mask)
    nq, b, d = q.shape
    nk, head_dim = k.shape[0], d // n_heads
    _require(_pairwise_on_grid(pairwise_bwd_tma_route, q, k, v, n_heads),
             f"{name}: the streaming route takes bfloat16 with Nq, Nk <= "
             f"{PAIRWISE_TMA_MAX_TOKENS}, head dims multiples of 8 up to "
             f"{PAIRWISE_TMA_MAX_HEAD_DIM} and strides multiples of 8")
    q, k, v, dout = (_aligned16_view(x) for x in (q, k, v, dout))
    rc = library().pairwise_attention_bwd_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), mask_ptr,
        *(g.data_ptr() for g in grads), nq, nk, b, n_heads, head_dim,
        *(s for x in (q, k, v) for s in _pairwise_strides(x)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(name, rc)
    return tuple(grads)


def pairwise_attention_bwd_warp(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, dout: torch.Tensor,
                                n_heads: int, scale: float,
                                key_mask: Optional[torch.Tensor] = None):
    """K1-bwd's kernel of ``csrc/pairwise_attention_bwd.cu`` (one warp per
    (row, head)), as :func:`pairwise_attention_bwd`, on any shapes; counted
    as ``pairwise_attention_bwd_warp``."""
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    strides, mask_ptr, dout, grads = _pairwise_bwd_inputs(q, k, v, dout,
                                                          n_heads, key_mask)
    nq, b, d = q.shape
    rc = library().pairwise_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), mask_ptr,
        *(g.data_ptr() for g in grads), nq, k.shape[0], b, n_heads,
        d // n_heads, *strides, float(scale), _ATTN_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _check("pairwise_attention_bwd_warp", rc)
    return tuple(grads)


def pairwise_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, n_heads: int, scale: float,
                           key_mask: Optional[torch.Tensor] = None):
    """K1 backward: the forward's inputs plus dout (Nq, B, D), the gradient
    of its output, in q's dtype. Returns (dq, dk, dv), contiguous, in q's
    dtype. One launch, by the route :func:`pairwise_bwd_tma_route` picks
    from the shapes and strides: :func:`pairwise_attention_bwd_tma`
    (``pairwise_attention_bwd``) or :func:`pairwise_attention_bwd_warp`
    (``pairwise_attention_bwd_warp``)."""
    route = (pairwise_attention_bwd_tma
             if _pairwise_on_grid(pairwise_bwd_tma_route, q, k, v, n_heads)
             else pairwise_attention_bwd_warp)
    return route(q, k, v, dout, n_heads, scale, key_mask)


# head dims: K3 takes at most ATTN_MAX_DIM, K4 at most FLASH_MAX_DIM
VMEM_MAX_SEQ, ATTN_MAX_DIM, FLASH_MAX_DIM = 1024, 128, 256


def _bhnd_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, key_mask: Optional[torch.Tensor],
                 max_dim: int = ATTN_MAX_DIM):
    """Checks shared by K3 and K4 (both directions), head dims at most
    ``max_dim``. Returns (B, H, Nq, Nk, Dqk, Dv), the (B, H, N) strides of
    q, k and v, and the key mask, made contiguous, or None."""
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
    _require(1 <= dqk <= max_dim and 1 <= dv <= max_dim,
             f"{name}: head dims {dqk}, {dv} must be at most {max_dim}")
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


def _vmem_fwd_inputs(q, k, v, key_mask):
    """Checks of K3-fwd's inputs; returns the shapes, q, k, v's strides, the
    key mask, and the output, allocated."""
    (b, h, nq, nk, dqk, dv), strides, key_mask = _bhnd_inputs(
        "vmem attention", q, k, v, key_mask)
    _require(nk <= VMEM_MAX_SEQ and nq <= VMEM_MAX_SEQ,
             f"vmem attention: Nq {nq} and Nk {nk} must be at most "
             f"{VMEM_MAX_SEQ}")
    out = torch.empty((b, h, nq, dv), device=q.device, dtype=q.dtype)
    return (b, h, nq, nk, dqk, dv), strides, key_mask, out


def vmem_fwd_tma_route(dtype, d_qk: int, d_v: int, strides) -> bool:
    """Whether K3-fwd takes its TMA route (wgmma over TMA-fed tiles with a
    stats sweep, ``csrc/attention_vmem_fwd_tma.cu``): the shapes and strides
    :func:`vmem_bwd_tma_route` takes. Else bf16 takes the mma.sync route,
    fp32 the CUDA cores. A function of the shapes and strides alone."""
    return vmem_bwd_tma_route(dtype, d_qk, d_v, strides)


def vmem_attention_fwd_tma(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, scale: float,
                           key_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K3-fwd's TMA route (wgmma over TMA tiles,
    ``csrc/attention_vmem_fwd_tma.cu``), as :func:`vmem_attention_fwd`, on
    the shapes and strides :func:`vmem_fwd_tma_route` takes; counted as
    ``vmem_attention_fwd``."""
    name = "vmem_attention_fwd"
    shapes, _, key_mask, out = _vmem_fwd_inputs(q, k, v, key_mask)
    strides = [s for x in (q, k, v) for s in _tma_strides(x)]
    _require(vmem_fwd_tma_route(q.dtype, shapes[4], shapes[5], strides),
             f"{name}: the TMA route takes bfloat16 with head dims and "
             "strides multiples of 8")
    q, k, v = (_aligned16_view(x) for x in (q, k, v))
    rc = library().attention_vmem_fwd_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), *shapes,
        *(s for x in (q, k, v) for s in _tma_strides(x)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(name, rc)
    return out


def vmem_attention_fwd_mma(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, scale: float,
                           key_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K3-fwd's kernels of ``csrc/attention_vmem.cu``, as
    :func:`vmem_attention_fwd`, on any shapes: mma.sync for bf16 (counted
    ``vmem_attention_fwd_mma``), the CUDA cores for fp32 (``_fp32``)."""
    shapes, strides, key_mask, out = _vmem_fwd_inputs(q, k, v, key_mask)
    rc = library().attention_vmem_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), *shapes, *strides, float(scale),
        _ATTN_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check("vmem_attention_fwd"
           + ("_mma" if q.dtype == torch.bfloat16 else "_fp32"), rc)
    return out


def vmem_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, key_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K3 forward: q (B, H, Nq, Dqk), k (B, H, Nk, Dqk), v (B, H, Nk, Dv) on
    one CUDA device, float32 or bfloat16, unit stride along the head dim
    (any strides along B, H, N); 1 <= Nk <= 1024, Nq <= 1024, Dqk and Dv <=
    128; key_mask optional (B, Nk) bool, True = visible. Returns
    (B, H, Nq, Dv), contiguous, in q's dtype. One launch, by the route
    :func:`vmem_fwd_tma_route` picks from the shapes and strides:
    :func:`vmem_attention_fwd_tma` (``vmem_attention_fwd``) or
    :func:`vmem_attention_fwd_mma` (``_mma``, ``_fp32``)."""
    route = (vmem_attention_fwd_tma if _on_tma_grid(vmem_fwd_tma_route, q, k,
                                                    v)
             else vmem_attention_fwd_mma)
    return route(q, k, v, scale, key_mask)


def _vmem_bwd_inputs(name, q, k, v, dout, key_mask):
    """Checks of K3-bwd's inputs; returns the shapes, q, k, v's strides, the
    key mask, contiguous dout, the outputs (dq, dk, dv) and the scratch lse
    and delta (per query row, written by the dq kernel for the dk/dv
    kernel), allocated."""
    (b, h, nq, nk, dqk, dv), strides, key_mask = _bhnd_inputs(
        "vmem attention", q, k, v, key_mask)
    _require(nk <= VMEM_MAX_SEQ and nq <= VMEM_MAX_SEQ,
             f"vmem attention: Nq {nq} and Nk {nk} must be at most "
             f"{VMEM_MAX_SEQ}")
    dout = _like_output(f"{name}: dout", dout, q, (b, h, nq, dv), q.dtype)
    grads = [torch.empty(shape, device=q.device, dtype=q.dtype) for shape in
             ((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv))]
    lse, delta = (torch.empty((b, h, nq), device=q.device,
                              dtype=torch.float32) for _ in range(2))
    return ((b, h, nq, nk, dqk, dv), strides, key_mask, dout, grads, lse,
            delta)


def vmem_bwd_tma_route(dtype, d_qk: int, d_v: int, strides) -> bool:
    """Whether K3-bwd takes its TMA route (wgmma over TMA-fed tiles,
    ``csrc/flash_attention_bwd_tma.cu`` with the dq kernel's stats sweep):
    the shapes and strides :func:`flash_bwd_tma_route` takes, head dims at
    most ATTN_MAX_DIM. Else bf16 takes the mma.sync route, fp32 the CUDA
    cores. A function of the shapes and strides alone."""
    return _tma_route(dtype, d_qk, d_v, strides, ATTN_MAX_DIM)


def vmem_attention_bwd_tma(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor, scale: float,
                           key_mask: Optional[torch.Tensor] = None):
    """K3-bwd's TMA route (wgmma over TMA tiles,
    ``csrc/flash_attention_bwd_tma.cu``), as :func:`vmem_attention_bwd`, on
    the shapes and strides :func:`vmem_bwd_tma_route` takes; counted as
    ``vmem_attention_bwd``."""
    name = "vmem_attention_bwd"
    shapes, _, key_mask, dout, grads, lse, delta = _vmem_bwd_inputs(
        name, q, k, v, dout, key_mask)
    strides = [s for x in (q, k, v) for s in _tma_strides(x)]
    _require(vmem_bwd_tma_route(q.dtype, shapes[4], shapes[5], strides),
             f"{name}: the TMA route takes bfloat16 with head dims and "
             "strides multiples of 8")
    q, k, v, dout = (_aligned16_view(x) for x in (q, k, v, dout))
    rc = library().attention_vmem_bwd_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        dout.data_ptr(), *(g.data_ptr() for g in grads), lse.data_ptr(),
        delta.data_ptr(), *shapes,
        *(s for x in (q, k, v) for s in _tma_strides(x)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(name, rc)
    return tuple(grads)


def vmem_attention_bwd_mma(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor, scale: float,
                           key_mask: Optional[torch.Tensor] = None):
    """K3-bwd's kernels of ``csrc/attention_bwd.cuh``
    (``csrc/attention_vmem_bwd.cu``), as :func:`vmem_attention_bwd`, on any
    shapes: mma.sync for bf16 (counted ``vmem_attention_bwd_mma``), the
    CUDA cores for fp32 (``_fp32``)."""
    shapes, strides, key_mask, dout, grads, lse, delta = _vmem_bwd_inputs(
        "vmem_attention_bwd", q, k, v, dout, key_mask)
    rc = library().attention_vmem_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        dout.data_ptr(), *(g.data_ptr() for g in grads), lse.data_ptr(),
        delta.data_ptr(), *shapes, *strides, float(scale),
        _ATTN_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check("vmem_attention_bwd"
           + ("_mma" if q.dtype == torch.bfloat16 else "_fp32"), rc)
    return tuple(grads)


def vmem_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, scale: float,
                       key_mask: Optional[torch.Tensor] = None):
    """K3 backward: the forward's inputs plus dout (B, H, Nq, Dv), the
    gradient of its output, in q's dtype. Returns (dq, dk, dv), contiguous,
    in q's dtype. One launch of the dq kernel and one of the dk/dv kernel,
    counted as one, by the route :func:`vmem_bwd_tma_route` picks from the
    shapes and strides: :func:`vmem_attention_bwd_tma`
    (``vmem_attention_bwd``) or :func:`vmem_attention_bwd_mma` (``_mma``,
    ``_fp32``)."""
    route = (vmem_attention_bwd_tma if _on_tma_grid(vmem_bwd_tma_route, q, k,
                                                    v)
             else vmem_attention_bwd_mma)
    return route(q, k, v, dout, scale, key_mask)


def _on_tma_grid(route, q, k, v) -> bool:
    """Whether ``route`` (a ``*_tma_route`` rule) takes these q, k, v."""
    return q.dim() == 4 and v.dim() == 4 and route(
        q.dtype, q.shape[-1], v.shape[-1],
        [s for x in (q, k, v) for s in _tma_strides(x)])


def _flash_fwd_inputs(q, k, v, key_mask):
    """Checks of K4-fwd's inputs; returns the shapes, q, k, v's strides, the
    key mask, and the outputs (out, lse), allocated."""
    (b, h, nq, nk, dqk, dv), strides, key_mask = _bhnd_inputs(
        "flash attention", q, k, v, key_mask, FLASH_MAX_DIM)
    out = torch.empty((b, h, nq, dv), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
    return (b, h, nq, nk, dqk, dv), strides, key_mask, out, lse


def flash_fwd_tma_route(dtype, d_qk: int, d_v: int, strides) -> bool:
    """Whether K4-fwd takes its TMA route (wgmma over TMA-fed tiles,
    ``csrc/flash_attention_fwd_tma.cu``): the shapes and strides
    :func:`flash_bwd_tma_route` takes. Else bf16 takes the mma.sync route,
    fp32 the CUDA cores. A function of the shapes and strides alone."""
    return flash_bwd_tma_route(dtype, d_qk, d_v, strides)


def flash_attention_fwd_tma(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float,
                            key_mask: Optional[torch.Tensor] = None,
                            causal: bool = False):
    """K4-fwd's TMA route (wgmma over TMA tiles,
    ``csrc/flash_attention_fwd_tma.cu``), as :func:`flash_attention_fwd`, on
    the shapes and strides :func:`flash_fwd_tma_route` takes; counted as
    ``flash_attention_fwd``."""
    name = "flash_attention_fwd"
    shapes, _, key_mask, out, lse = _flash_fwd_inputs(q, k, v, key_mask)
    strides = [s for x in (q, k, v) for s in _tma_strides(x)]
    _require(flash_fwd_tma_route(q.dtype, shapes[4], shapes[5], strides),
             f"{name}: the TMA route takes bfloat16 with head dims and "
             "strides multiples of 8")
    q, k, v = (_aligned16_view(x) for x in (q, k, v))
    rc = library().flash_attention_fwd_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), lse.data_ptr(), *shapes,
        *(s for x in (q, k, v) for s in _tma_strides(x)), float(scale),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _check(name, rc)
    return out, lse


def flash_attention_fwd_mma(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float,
                            key_mask: Optional[torch.Tensor] = None,
                            causal: bool = False):
    """K4-fwd's kernels of ``csrc/flash_attention.cu``, as
    :func:`flash_attention_fwd`, on any shapes: mma.sync for bf16 (counted
    ``flash_attention_fwd_mma``), the CUDA cores for fp32 (``_fp32``)."""
    shapes, strides, key_mask, out, lse = _flash_fwd_inputs(q, k, v,
                                                            key_mask)
    rc = library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), lse.data_ptr(), *shapes, *strides, float(scale),
        int(causal), _ATTN_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _check("flash_attention_fwd"
           + ("_mma" if q.dtype == torch.bfloat16 else "_fp32"), rc)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, key_mask: Optional[torch.Tensor] = None,
                        causal: bool = False):
    """K4 forward: q (B, H, Nq, Dqk), k (B, H, Nk, Dqk), v (B, H, Nk, Dv) on
    one CUDA device, float32 or bfloat16, unit stride along the head dim;
    any N >= 1, Dqk and Dv <= 256; key_mask optional (B, Nk) bool; causal:
    key j visible to query i iff j <= i. Returns (out (B, H, Nq, Dv) in q's
    dtype, lse (B, H, Nq) float32), both contiguous; a row whose keys are
    all masked gives out 0 and lse +inf. One launch, by the route
    :func:`flash_fwd_tma_route` picks from the shapes and strides:
    :func:`flash_attention_fwd_tma` (``flash_attention_fwd``) or
    :func:`flash_attention_fwd_mma` (``_mma``, ``_fp32``)."""
    route = (flash_attention_fwd_tma if _on_tma_grid(flash_fwd_tma_route, q,
                                                     k, v)
             else flash_attention_fwd_mma)
    return route(q, k, v, scale, key_mask, causal)


def _tma_strides(x: torch.Tensor):
    """x's element strides along B, H and N, each of a dim of extent 1 given
    as 8 (its coordinate is always 0, so any TMA-valid stride reads it)."""
    return [s if n > 1 else 8 for s, n in zip(x.stride()[:3], x.shape[:3])]


def _tma_route(dtype, d_qk: int, d_v: int, strides, max_dim: int) -> bool:
    """bf16, head dims Dqk and Dv multiples of 8 up to ``max_dim``, and
    ``strides`` positive multiples of 8, TMA's 16-byte strides."""
    return (dtype == torch.bfloat16
            and all(8 <= d <= max_dim and d % 8 == 0 for d in (d_qk, d_v))
            and all(s > 0 and s % 8 == 0 for s in strides))


def flash_bwd_tma_route(dtype, d_qk: int, d_v: int, strides) -> bool:
    """Whether K4-bwd takes its TMA route (wgmma over TMA-fed tiles):
    bf16, head dims Dqk and Dv multiples of 8 up to FLASH_MAX_DIM (256),
    and ``strides`` (the element strides of q, k and v along B, H and N, as
    :func:`_tma_strides` gives them) positive multiples of 8, TMA's 16-byte
    strides. Else bf16 takes the mma.sync route, fp32 the CUDA cores. A
    function of the shapes and strides alone."""
    return _tma_route(dtype, d_qk, d_v, strides, FLASH_MAX_DIM)


def _aligned16_view(x: torch.Tensor) -> torch.Tensor:
    """x itself where it starts on a 16-byte boundary (TMA's), else a
    contiguous copy, which does."""
    return x if x.data_ptr() % 16 == 0 else x.contiguous().clone()


def _flash_bwd_inputs(q, k, v, out, lse, dout, key_mask):
    """Checks of K4-bwd's inputs; returns the shapes, q, k, v's strides, the
    key mask, contiguous out, lse and dout, and the outputs (dq, dk, dv and
    the scratch delta), allocated."""
    (b, h, nq, nk, dqk, dv), strides, key_mask = _bhnd_inputs(
        "flash attention", q, k, v, key_mask, FLASH_MAX_DIM)
    out = _like_output("flash_attention_bwd: out", out, q, (b, h, nq, dv),
                       q.dtype)
    dout = _like_output("flash_attention_bwd: dout", dout, q, (b, h, nq, dv),
                        q.dtype)
    lse = _like_output("flash_attention_bwd: lse", lse, q, (b, h, nq),
                       torch.float32)
    grads = [torch.empty(shape, device=q.device, dtype=q.dtype) for shape in
             ((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv))]
    delta = torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
    return ((b, h, nq, nk, dqk, dv), strides, key_mask, out, lse, dout,
            grads, delta)


def flash_attention_bwd_tma(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            scale: float,
                            key_mask: Optional[torch.Tensor] = None,
                            causal: bool = False):
    """K4-bwd's TMA route (wgmma over TMA tiles,
    ``csrc/flash_attention_bwd_tma.cu``), as :func:`flash_attention_bwd`,
    on the shapes and strides :func:`flash_bwd_tma_route` takes; counted as
    ``flash_attention_bwd``."""
    name = "flash_attention_bwd"
    shapes, _, key_mask, out, lse, dout, grads, delta = _flash_bwd_inputs(
        q, k, v, out, lse, dout, key_mask)
    strides = [s for x in (q, k, v) for s in _tma_strides(x)]
    _require(flash_bwd_tma_route(q.dtype, shapes[4], shapes[5], strides),
             f"{name}: the TMA route takes bfloat16 with head dims and "
             "strides multiples of 8")
    q, k, v, out, dout = (_aligned16_view(x) for x in (q, k, v, out, dout))
    rc = library().flash_attention_bwd_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        *(g.data_ptr() for g in grads), delta.data_ptr(), *shapes,
        *(s for x in (q, k, v) for s in _tma_strides(x)), float(scale),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _check(name, rc)
    return tuple(grads)


def flash_attention_bwd_mma(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            scale: float,
                            key_mask: Optional[torch.Tensor] = None,
                            causal: bool = False):
    """K4-bwd's kernels of ``csrc/attention_bwd.cuh``, as
    :func:`flash_attention_bwd`, on any shapes: mma.sync for bf16 (counted
    ``flash_attention_bwd_mma``), the CUDA cores for fp32 (``_fp32``)."""
    shapes, strides, key_mask, out, lse, dout, grads, delta = (
        _flash_bwd_inputs(q, k, v, out, lse, dout, key_mask))
    rc = library().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        *(g.data_ptr() for g in grads), delta.data_ptr(), *shapes, *strides,
        float(scale), int(causal), _ATTN_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _check("flash_attention_bwd"
           + ("_mma" if q.dtype == torch.bfloat16 else "_fp32"), rc)
    return tuple(grads)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, scale: float,
                        key_mask: Optional[torch.Tensor] = None,
                        causal: bool = False):
    """K4 backward: the forward's inputs, its out and lse, and dout
    (B, H, Nq, Dv) in q's dtype. Returns (dq, dk, dv), contiguous, in q's
    dtype. One launch of the dq kernel and one of the dk/dv kernel (on the
    TMA route, heads above 256 columns in all: a dk kernel and a dv
    kernel), counted as one, by the route :func:`flash_bwd_tma_route` picks
    from the shapes and strides: :func:`flash_attention_bwd_tma`
    (``flash_attention_bwd``) or :func:`flash_attention_bwd_mma` (``_mma``,
    ``_fp32``)."""
    route = (flash_attention_bwd_tma if _on_tma_grid(flash_bwd_tma_route, q,
                                                     k, v)
             else flash_attention_bwd_mma)
    return route(q, k, v, out, lse, dout, scale, key_mask, causal)


GMM_MAX_GROUPS = 1024


def _gmm_inputs(name: str, dtype, group_sizes: torch.Tensor, n_groups: int,
                *tensors: torch.Tensor) -> None:
    """Checks shared by K5's wrappers: every tensor on one CUDA device, lhs
    and rhs of one type, float32 or bfloat16, group_sizes (E,) int32 with
    1 <= E <= GMM_MAX_GROUPS."""
    _require(all(x.is_cuda and x.device == tensors[0].device
                 for x in (*tensors, group_sizes)),
             f"{name}: inputs must lie on one CUDA device")
    _require(dtype in _ATTN_DTYPES,
             f"{name}: lhs and rhs must share float32 or bfloat16")
    _require(group_sizes.dtype == torch.int32
             and tuple(group_sizes.shape) == (n_groups,),
             f"{name}: group_sizes must be (E,) int32")
    _require(1 <= n_groups <= GMM_MAX_GROUPS,
             f"{name}: E must be in 1..{GMM_MAX_GROUPS}")


def _gmm_dout(name: str, dout: torch.Tensor, m: int, n: int) -> torch.Tensor:
    _require(dout.dtype == torch.float32 and tuple(dout.shape) == (m, n),
             f"{name}: dout must be (M, N) float32, the forward's output")
    return dout.contiguous()


def gmm_fwd_tma_route(dtype, m: int, k: int, n: int) -> bool:
    """Whether K5-fwd takes its TMA route (wgmma over TMA-fed tiles): the
    shapes :func:`gmm_bwd_tma_route` takes (bf16, M >= 1, K and N positive
    multiples of 8). Else bf16 takes the mma.sync route, fp32 the CUDA
    cores. A function of the shapes alone."""
    return gmm_bwd_tma_route(dtype, m, k, n)


def _gmm_fwd_inputs(name, lhs, rhs, group_sizes):
    """Checks of K5-fwd's inputs; returns (M, K, N, E) and the output,
    allocated."""
    _require(lhs.dim() == 2 and rhs.dim() == 3 and rhs.shape[1] == lhs.shape[1],
             f"{name}: lhs must be (M, K) and rhs (E, K, N)")
    _gmm_inputs(name, lhs.dtype if lhs.dtype == rhs.dtype else None,
                group_sizes, rhs.shape[0], lhs, rhs)
    (m, k), n, n_groups = lhs.shape, rhs.shape[2], rhs.shape[0]
    out = torch.empty((m, n), device=lhs.device, dtype=torch.float32)
    return (m, k, n, n_groups), out


def grouped_matmul_fwd_tma(lhs: torch.Tensor, rhs: torch.Tensor,
                           group_sizes: torch.Tensor) -> torch.Tensor:
    """K5-fwd's TMA route (wgmma over TMA tiles,
    ``csrc/grouped_matmul_tma.cu``), as :func:`grouped_matmul_fwd`, on the
    shapes :func:`gmm_fwd_tma_route` takes; counted as
    ``grouped_matmul_fwd``."""
    name = "grouped_matmul_fwd"
    (m, k, n, n_groups), out = _gmm_fwd_inputs(name, lhs, rhs, group_sizes)
    _require(gmm_fwd_tma_route(lhs.dtype, m, k, n),
             f"{name}: the TMA route takes bfloat16 with M >= 1 and K, N "
             "multiples of 8")
    lhs, rhs = _aligned16(lhs), _aligned16(rhs)
    rc = library().grouped_matmul_fwd_tma(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.contiguous().data_ptr(),
        out.data_ptr(), m, k, n, n_groups,
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _check(name, rc)
    return out


def grouped_matmul_fwd_mma(lhs: torch.Tensor, rhs: torch.Tensor,
                           group_sizes: torch.Tensor) -> torch.Tensor:
    """K5-fwd's kernels of ``csrc/grouped_matmul.cu``, as
    :func:`grouped_matmul_fwd`, on any shapes: mma.sync for bf16 (counted
    ``grouped_matmul_fwd_mma``), the CUDA cores for fp32 (``_fp32``). M = 0
    launches nothing."""
    name = "grouped_matmul_fwd"
    (m, k, n, n_groups), out = _gmm_fwd_inputs(name, lhs, rhs, group_sizes)
    if m == 0 or n == 0:
        return out
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    rc = library().grouped_matmul_fwd(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.contiguous().data_ptr(),
        out.data_ptr(), m, k, n, n_groups, _ATTN_DTYPES[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _check(name + ("_mma" if lhs.dtype == torch.bfloat16 else "_fp32"), rc)
    return out


def grouped_matmul_fwd(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """K5 forward: lhs (M, K) and rhs (E, K, N), both float32 or both
    bfloat16, and group_sizes (E,) int32, all on one CUDA device; rows
    [offset_g, offset_g + size_g) of lhs go through rhs[g]. Returns (M, N)
    float32, rows past the sum of the sizes 0. The sizes stay on the device:
    the kernel reads them itself. M = 0 launches nothing. The route is
    chosen from the shapes alone (:func:`gmm_fwd_tma_route`):
    :func:`grouped_matmul_fwd_tma` (counted ``grouped_matmul_fwd``) or
    :func:`grouped_matmul_fwd_mma` (``_mma``, ``_fp32``)."""
    if (lhs.dim() == 2 and rhs.dim() == 3 and rhs.shape[1] == lhs.shape[1]
            and lhs.dtype == rhs.dtype
            and gmm_fwd_tma_route(lhs.dtype, *lhs.shape, rhs.shape[2])):
        return grouped_matmul_fwd_tma(lhs, rhs, group_sizes)
    return grouped_matmul_fwd_mma(lhs, rhs, group_sizes)


def gmm_bwd_tma_route(dtype, m: int, k: int, n: int) -> bool:
    """Whether K5-bwd takes its TMA route (wgmma over TMA-fed tiles) for
    these shapes: bf16, M >= 1, and K and N positive multiples of 8 (TMA's
    16-byte row strides). Else bf16 takes the mma.sync route, fp32 the
    CUDA cores. A function of the shapes alone."""
    return (dtype == torch.bfloat16 and m >= 1 and k >= 8 and n >= 8
            and k % 8 == 0 and n % 8 == 0)


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned address (TMA's), copied if not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def grouped_matmul_split_dout(dout: torch.Tensor):
    """K5-bwd's split of dout (M, N) float32 on a CUDA device into (hi, lo),
    two (M, N) bfloat16 tensors: hi = bf16(x), lo = bf16(x - hi), each
    rounded to nearest even; hi + lo keeps x to ~2^-16 of |x|. The TMA
    route's dlhs and drhs read them. M * N = 0 launches nothing."""
    name = "grouped_matmul_split_dout"
    _require(dout.is_cuda, f"{name}: dout must lie on a CUDA device")
    _require(dout.dtype == torch.float32 and dout.dim() == 2,
             f"{name}: dout must be (M, N) float32")
    dout = dout.contiguous()
    hi, lo = (torch.empty(dout.shape, device=dout.device,
                          dtype=torch.bfloat16) for _ in range(2))
    if dout.numel() == 0:
        return hi, lo
    rc = library().grouped_matmul_split_dout(
        dout.data_ptr(), hi.data_ptr(), lo.data_ptr(), dout.numel(),
        torch.cuda.current_stream(dout.device).cuda_stream)
    _check(name, rc)
    return hi, lo


def _gmm_parts(name: str, hi: torch.Tensor, lo: torch.Tensor,
               dtype, k: int):
    """(hi, lo) for the TMA route, checked: (M, N) bfloat16 each, dout's
    split, on a shape gmm_bwd_tma_route takes; 16-byte aligned."""
    _require(hi.dim() == 2 and hi.dtype == lo.dtype == torch.bfloat16
             and hi.shape == lo.shape,
             f"{name}: hi and lo must be dout's split, (M, N) bfloat16")
    _require(gmm_bwd_tma_route(dtype, hi.shape[0], k, hi.shape[1]),
             f"{name}: the TMA route takes bfloat16 with M >= 1 and K, N "
             "multiples of 8")
    return _aligned16(hi), _aligned16(lo)


def grouped_matmul_bwd_dlhs_tma(hi: torch.Tensor, lo: torch.Tensor,
                                rhs: torch.Tensor,
                                group_sizes: torch.Tensor) -> torch.Tensor:
    """K5-bwd's gradient of lhs on the TMA route (wgmma over TMA tiles):
    hi and lo (M, N) bfloat16, :func:`grouped_matmul_split_dout` of dout,
    rhs (E, K, N) bfloat16 and group_sizes (E,) int32, all on one CUDA
    device, shapes that :func:`gmm_bwd_tma_route` takes. Returns (M, K)
    bfloat16: row r of group g is hi[r] . rhs[g]^T + lo[r] . rhs[g]^T,
    summed in fp32 and rounded once; rows past the sum of the sizes 0.
    Counted as ``grouped_matmul_bwd_dlhs``."""
    name = "grouped_matmul_bwd_dlhs"
    _require(rhs.dim() == 3 and hi.dim() == 2 and rhs.shape[2] == hi.shape[1],
             f"{name}: hi must be (M, N) and rhs (E, K, N)")
    _gmm_inputs(name, rhs.dtype, group_sizes, rhs.shape[0], rhs, hi, lo)
    (m, n), k, n_groups = hi.shape, rhs.shape[1], rhs.shape[0]
    hi, lo = _gmm_parts(name, hi, lo, rhs.dtype, k)
    rhs, group_sizes = _aligned16(rhs), group_sizes.contiguous()
    dlhs = torch.empty((m, k), device=rhs.device, dtype=rhs.dtype)
    rc = library().grouped_matmul_bwd_dlhs_tma(
        hi.data_ptr(), lo.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
        dlhs.data_ptr(), m, k, n, n_groups,
        torch.cuda.current_stream(rhs.device).cuda_stream)
    _check(name, rc)
    return dlhs


def grouped_matmul_bwd_drhs_tma(lhs: torch.Tensor, hi: torch.Tensor,
                                lo: torch.Tensor,
                                group_sizes: torch.Tensor) -> torch.Tensor:
    """K5-bwd's gradient of rhs on the TMA route: lhs (M, K) bfloat16, hi
    and lo as for :func:`grouped_matmul_bwd_dlhs_tma`, group_sizes (E,)
    int32. Returns (E, K, N) bfloat16: drhs[g] = lhs[rows of g]^T .
    (hi + lo)[rows of g], summed in fp32 and rounded once; an empty group's
    exactly 0 (the kernel writes every element). Counted as
    ``grouped_matmul_bwd_drhs``."""
    name = "grouped_matmul_bwd_drhs"
    _require(lhs.dim() == 2 and hi.dim() == 2 and hi.shape[0] == lhs.shape[0]
             and group_sizes.dim() == 1,
             f"{name}: lhs must be (M, K), hi (M, N), group_sizes (E,)")
    _gmm_inputs(name, lhs.dtype, group_sizes, group_sizes.shape[0], lhs, hi,
                lo)
    (m, k), n, n_groups = lhs.shape, hi.shape[1], group_sizes.shape[0]
    hi, lo = _gmm_parts(name, hi, lo, lhs.dtype, k)
    lhs, group_sizes = _aligned16(lhs), group_sizes.contiguous()
    drhs = torch.empty((n_groups, k, n), device=lhs.device, dtype=lhs.dtype)
    rc = library().grouped_matmul_bwd_drhs_tma(
        lhs.data_ptr(), hi.data_ptr(), lo.data_ptr(), group_sizes.data_ptr(),
        drhs.data_ptr(), m, k, n, n_groups,
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _check(name, rc)
    return drhs


def grouped_matmul_bwd_dlhs_mma(dout: torch.Tensor, rhs: torch.Tensor,
                                group_sizes: torch.Tensor) -> torch.Tensor:
    """K5-bwd's gradient of lhs reading fp32 dout itself: dout (M, N)
    float32, rhs (E, K, N) float32 or bfloat16 and group_sizes (E,) int32,
    all on one CUDA device, any shapes. bf16 runs the mma.sync kernel
    (counted ``grouped_matmul_bwd_dlhs_mma``), fp32 the CUDA-core one
    (``_fp32``). Returns (M, K) in rhs's type (lhs's): row r of group g is
    dout[r] . rhs[g]^T, summed in fp32 with dout kept at fp32 accuracy and
    rounded once; rows past the sum of the sizes 0. M = 0 launches
    nothing."""
    name = "grouped_matmul_bwd_dlhs"
    _require(dout.dim() == 2 and rhs.dim() == 3
             and rhs.shape[2] == dout.shape[1],
             f"{name}: dout must be (M, N) and rhs (E, K, N)")
    _gmm_inputs(name, rhs.dtype, group_sizes, rhs.shape[0], rhs, dout)
    (m, n), k, n_groups = dout.shape, rhs.shape[1], rhs.shape[0]
    dout = _gmm_dout(name, dout, m, n)
    dlhs = torch.empty((m, k), device=rhs.device, dtype=rhs.dtype)
    if m == 0 or k == 0:
        return dlhs
    rhs, group_sizes = rhs.contiguous(), group_sizes.contiguous()
    rc = library().grouped_matmul_bwd_dlhs(
        dout.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
        dlhs.data_ptr(), m, k, n, n_groups, _ATTN_DTYPES[rhs.dtype],
        torch.cuda.current_stream(rhs.device).cuda_stream)
    _check(name + ("_mma" if rhs.dtype == torch.bfloat16 else "_fp32"), rc)
    return dlhs


def grouped_matmul_bwd_drhs_mma(lhs: torch.Tensor, dout: torch.Tensor,
                                group_sizes: torch.Tensor) -> torch.Tensor:
    """K5-bwd's gradient of rhs reading fp32 dout itself: lhs (M, K)
    float32 or bfloat16, dout (M, N) float32 and group_sizes (E,) int32,
    all on one CUDA device, any shapes; counted as
    :func:`grouped_matmul_bwd_dlhs_mma` is. Returns (E, K, N) in lhs's type
    (rhs's): drhs[g] = lhs[rows of g]^T . dout[rows of g], summed in fp32
    with dout kept at fp32 accuracy and rounded once; an empty group's
    exactly 0 (the kernel writes every element). K = 0 or N = 0 launches
    nothing."""
    name = "grouped_matmul_bwd_drhs"
    _require(lhs.dim() == 2 and dout.dim() == 2
             and dout.shape[0] == lhs.shape[0] and group_sizes.dim() == 1,
             f"{name}: lhs must be (M, K), dout (M, N), group_sizes (E,)")
    _gmm_inputs(name, lhs.dtype, group_sizes, group_sizes.shape[0], lhs,
                dout)
    (m, k), n, n_groups = lhs.shape, dout.shape[1], group_sizes.shape[0]
    dout = _gmm_dout(name, dout, m, n)
    drhs = torch.empty((n_groups, k, n), device=lhs.device, dtype=lhs.dtype)
    if k == 0 or n == 0:
        return drhs
    lhs, group_sizes = lhs.contiguous(), group_sizes.contiguous()
    rc = library().grouped_matmul_bwd_drhs(
        lhs.data_ptr(), dout.data_ptr(), group_sizes.data_ptr(),
        drhs.data_ptr(), m, k, n, n_groups, _ATTN_DTYPES[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _check(name + ("_mma" if lhs.dtype == torch.bfloat16 else "_fp32"), rc)
    return drhs


def grouped_matmul_bwd(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor, dout: torch.Tensor,
                       need_lhs: bool = True, need_rhs: bool = True):
    """K5-bwd, megablox's ``_gmm_bwd``: lhs (M, K) and rhs (E, K, N), both
    float32 or both bfloat16, group_sizes (E,) int32 and dout (M, N)
    float32, all on one CUDA device. Returns (dlhs, drhs) as
    ``ops.grouped_matmul.gmm_bwd_plain`` does, each None when not needed.
    The route is chosen here from the shapes alone
    (:func:`gmm_bwd_tma_route`): on the TMA route dout is split once
    (:func:`grouped_matmul_split_dout`) and both gradients read the parts;
    else each reads dout itself (mma.sync for bf16, CUDA cores for fp32)."""
    name = "grouped_matmul_bwd"
    _require(lhs.dim() == 2 and rhs.dim() == 3 and dout.dim() == 2
             and rhs.shape[1] == lhs.shape[1]
             and tuple(dout.shape) == (lhs.shape[0], rhs.shape[2]),
             f"{name}: lhs must be (M, K), rhs (E, K, N), dout (M, N)")
    _gmm_inputs(name, lhs.dtype if lhs.dtype == rhs.dtype else None,
                group_sizes, rhs.shape[0], lhs, rhs, dout)
    (m, k), n = lhs.shape, rhs.shape[2]
    if not (need_lhs or need_rhs):
        return None, None
    if gmm_bwd_tma_route(lhs.dtype, m, k, n):
        hi, lo = grouped_matmul_split_dout(_gmm_dout(name, dout, m, n))
        return (grouped_matmul_bwd_dlhs_tma(hi, lo, rhs, group_sizes)
                if need_lhs else None,
                grouped_matmul_bwd_drhs_tma(lhs, hi, lo, group_sizes)
                if need_rhs else None)
    return (grouped_matmul_bwd_dlhs_mma(dout, rhs, group_sizes)
            if need_lhs else None,
            grouped_matmul_bwd_drhs_mma(lhs, dout, group_sizes)
            if need_rhs else None)


QUANT_SMS = 132  # the H100's SMs: the reduction split aims at 4 blocks each
QUANT_COLS, QUANT_SUB = 128, 64  # quant_matmul.cu's tiles


def quant_rows(c: int) -> int:
    """Rows of x per block of K6 / K7: the fewest of 4, 8, 16 that hold C."""
    return 4 if c <= 4 else 8 if c <= 8 else 16


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def quant_splits(e: int, c: int, rows: int, fp: int):
    """(splits, chunk): the reduction rows of K6 / K7 cut into ``splits``
    chunks of ``chunk`` rows (the last may be shorter), so that a product
    with few column tiles still fills the card, with at least 128 rows a
    chunk. A pure function of the shapes."""
    tiles = _ceil_div(fp, QUANT_COLS) * e * _ceil_div(c, quant_rows(c))
    splits = max(1, min(_ceil_div(4 * QUANT_SMS, tiles),
                        _ceil_div(rows, 128)))
    chunk = _ceil_div(_ceil_div(rows, splits), QUANT_SUB) * QUANT_SUB
    return _ceil_div(rows, chunk), chunk


def _quant_inputs(name: str, x: torch.Tensor, w: torch.Tensor,
                  scale: torch.Tensor, out_dtype, int4: bool):
    """Checks shared by K6's and K7's routes; returns (E, C, D, Fp, F) and
    the output, allocated."""
    _require(x.is_cuda and w.device == x.device and scale.device == x.device,
             f"{name}: inputs must lie on one CUDA device")
    _require(x.dim() == 3 and x.dtype in _ATTN_DTYPES,
             f"{name}: x must be (E, C, D) float32 or bfloat16")
    e, c, d = x.shape
    rows = d // 2 if int4 else d
    _require(not (int4 and d % 2), f"{name}: D must be even")
    _require(w.dtype == torch.int8 and w.dim() == 3
             and tuple(w.shape[:2]) == (e, rows),
             f"{name}: w must be (E, {'D/2' if int4 else 'D'}, Fp) int8")
    fp = w.shape[2]
    _require(scale.dtype == torch.float32 and scale.dim() == 3
             and tuple(scale.shape[:2]) == (e, 1) and scale.shape[2] <= fp,
             f"{name}: scale must be (E, 1, F) float32 with F <= Fp")
    _require(fp % 4 == 0, f"{name}: Fp must be a multiple of 4")
    _require(out_dtype in _ATTN_DTYPES,
             f"{name}: out_dtype must be float32 or bfloat16")
    f = scale.shape[2]
    out = torch.empty((e, c, f), device=x.device, dtype=out_dtype)
    return (e, c, d, fp, f), out


def _quant_bmm(name: str, x: torch.Tensor, w: torch.Tensor,
               scale: torch.Tensor, out_dtype, int4: bool,
               counter: str) -> torch.Tensor:
    """K6's or K7's CUDA-core route, ``csrc/quant_matmul.cu``."""
    (e, c, d, fp, f), out = _quant_inputs(name, x, w, scale, out_dtype, int4)
    rows = d // 2 if int4 else d
    ct = quant_rows(c)
    _require(e * _ceil_div(c, ct) <= 65535,
             f"{name}: E * ceil(C / {ct}) must be at most 65535")
    if out.numel() == 0:
        return out
    if rows == 0:
        return out.zero_()
    x, w, scale = x.contiguous(), w.contiguous(), scale.contiguous()
    _require(w.data_ptr() % 4 == 0, f"{name}: w must be 4-byte aligned")
    splits, chunk = quant_splits(e, c, rows, fp)
    partial = (torch.empty((splits, e, c, f), device=x.device,
                           dtype=torch.float32) if splits > 1 else None)
    rc = getattr(library(), name)(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        _ptr(partial), e, c, d, fp, f, ct, splits, chunk,
        _ATTN_DTYPES[x.dtype], _ATTN_DTYPES[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(counter, rc)
    return out


# quant_matmul_tc.cu's grid: 128 features a block tile, stages of 64 (K7:
# packed) rows, clusters of up to 16 blocks, at most 1024 rows a block, x in
# tiles of up to 32 rows and at most 128 rows in all
QUANT_TC_COLS, QUANT_TC_ROWS = 128, 64
QUANT_TC_MAX_CLUSTER, QUANT_TC_MAX_CHUNK, QUANT_TC_MAX_C = 16, 1024, 128


def int4_tc_plan(e: int, c: int, rows: int, fp: int):
    """(nt, c_tiles, cluster, chunk) of K7's tensor-core route: x in
    ``c_tiles`` tiles of 8 nt rows (nt 1, 2 or 4: C <= 8, <= 16, else tiles
    of 32), and the ``rows`` packed rows of each 128-feature tile split over
    a cluster of ``cluster`` blocks of ``chunk`` rows each: the fewest (a
    power of two up to 16, each chunk whole 64-row stages) that give the
    card's 132 SMs a block each. A pure function of the shapes; K6's
    tensor-core route plans the same way (:func:`int8_tc_plan`)."""
    nt = 1 if c <= 8 else 2 if c <= 16 else 4
    c_tiles = _ceil_div(c, 8 * nt)
    tiles = e * (fp // QUANT_TC_COLS) * c_tiles
    cluster = 1
    while (cluster < QUANT_TC_MAX_CLUSTER and cluster * tiles < QUANT_SMS
           and rows % (2 * cluster * QUANT_TC_ROWS) == 0):
        cluster *= 2
    return nt, c_tiles, cluster, rows // cluster


def int8_tc_plan(e: int, c: int, rows: int, fp: int):
    """(nt, c_tiles, cluster, chunk) of K6's tensor-core route over the
    ``rows`` = D rows of its int8 weights: :func:`int4_tc_plan`'s rule,
    then the cluster doubled while a chunk is past 1024 rows (as many as
    x's rows in shared memory take: the experts' 2048 rows at 128 slots).
    A pure function of the shapes."""
    nt, c_tiles, cluster, chunk = int4_tc_plan(e, c, rows, fp)
    while (chunk > QUANT_TC_MAX_CHUNK and cluster < QUANT_TC_MAX_CLUSTER
           and rows % (2 * cluster * QUANT_TC_ROWS) == 0):
        cluster *= 2
        chunk = rows // cluster
    return nt, c_tiles, cluster, chunk


def _quant_tc_route(e: int, c: int, rows: int, fp: int, plan) -> bool:
    """Whether quant_matmul_tc.cu takes ``rows`` weight rows (packed rows
    for K7): a positive multiple of 64 that ``plan`` splits into chunks of
    at most 1024, Fp a positive multiple of 128, and 1 <= C <= 128."""
    if (e < 1 or not 1 <= c <= QUANT_TC_MAX_C or rows < QUANT_TC_ROWS
            or rows % QUANT_TC_ROWS or fp < QUANT_TC_COLS
            or fp % QUANT_TC_COLS):
        return False
    _, c_tiles, _, chunk = plan(e, c, rows, fp)
    return chunk <= QUANT_TC_MAX_CHUNK and e * c_tiles <= 65535


def int4_bmm_tc_route(e: int, c: int, d: int, fp: int) -> bool:
    """Whether K7 takes its tensor-core route (``csrc/quant_matmul_tc.cu``,
    one cluster launch) for x (E, C, D) and weights (E, D/2, Fp): D even,
    the D/2 packed rows a positive multiple of 64 that int4_tc_plan splits
    into chunks of at most 1024, Fp a positive multiple of 128, and
    1 <= C <= 128. Else the CUDA-core route (``int4_bmm_fma``). A function
    of the shapes alone."""
    return d % 2 == 0 and _quant_tc_route(e, c, d // 2, fp, int4_tc_plan)


def int8_bmm_tc_route(e: int, c: int, d: int, fp: int) -> bool:
    """Whether K6 takes its tensor-core route (``csrc/quant_matmul_tc.cu``,
    one cluster launch) for x (E, C, D) and weights (E, D, Fp) int8: D a
    positive multiple of 64 that :func:`int8_tc_plan` splits into chunks of
    at most 1024, Fp a positive multiple of 128, and 1 <= C <= 128. Else the
    CUDA-core route (``int8_bmm_fma``). A function of the shapes alone."""
    return _quant_tc_route(e, c, d, fp, int8_tc_plan)


def _quant_bmm_tc(name: str, x: torch.Tensor, w: torch.Tensor,
                  scale: torch.Tensor, out_dtype, int4: bool) -> torch.Tensor:
    """K6's or K7's tensor-core route (``csrc/quant_matmul_tc.cu``), counted
    as ``name``."""
    (e, c, d, fp, f), out = _quant_inputs(name, x, w, scale, out_dtype, int4)
    route, plan = ((int4_bmm_tc_route, int4_tc_plan) if int4
                   else (int8_bmm_tc_route, int8_tc_plan))
    _require(route(e, c, d, fp),
             f"{name}: the tensor-core route takes "
             f"{'D/2' if int4 else 'D'} a multiple of 64, Fp of 128 and "
             "1 <= C <= 128")
    if f == 0:
        return out
    nt, _, cluster, _ = plan(e, c, d // 2 if int4 else d, fp)
    x, w = _aligned16(x), _aligned16(w)
    scale = scale.contiguous()
    rc = getattr(library(), name + "_tc")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), e, c,
        d, fp, f, nt, cluster, _ATTN_DTYPES[x.dtype], _ATTN_DTYPES[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(name, rc)
    return out


def int8_bmm_tc(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """K6's tensor-core route, as :func:`int8_bmm`, on the shapes
    :func:`int8_bmm_tc_route` takes: one launch of a thread block cluster,
    no partial tensor; counted as ``int8_bmm``."""
    return _quant_bmm_tc("int8_bmm", x, w_q, scale, out_dtype, int4=False)


def int8_bmm_fma(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """K6's CUDA-core route (``csrc/quant_matmul.cu``, a split reduction
    added by a second kernel), as :func:`int8_bmm`, on any shapes; counted
    as ``int8_bmm_fma``."""
    return _quant_bmm("int8_bmm", x, w_q, scale, out_dtype, int4=False,
                      counter="int8_bmm_fma")


def int8_bmm(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """K6: x (E, C, D) float32 or bfloat16, w_q (E, D, Fp) int8 (Fp a
    multiple of 4), scale (E, 1, F) float32 with F <= Fp, on one CUDA
    device. Returns (E, C, F) in ``out_dtype`` (float32 or bfloat16):
    scale times the fp32 sum of bf16(x) times w_q, no atomics. The route is
    chosen from the shapes alone (:func:`int8_bmm_tc_route`):
    :func:`int8_bmm_tc` (counted ``int8_bmm``) or :func:`int8_bmm_fma`
    (``int8_bmm_fma``)."""
    if (x.dim() == 3 and w_q.dim() == 3
            and int8_bmm_tc_route(*x.shape, w_q.shape[2])
            and tuple(w_q.shape[:2]) == (x.shape[0], x.shape[2])):
        return int8_bmm_tc(x, w_q, scale, out_dtype)
    return int8_bmm_fma(x, w_q, scale, out_dtype)


def int4_bmm_tc(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """K7's tensor-core route, as :func:`int4_bmm`, on the shapes
    :func:`int4_bmm_tc_route` takes: one launch of a thread block cluster,
    no partial tensor; counted as ``int4_bmm``."""
    return _quant_bmm_tc("int4_bmm", x, w_p, scale, out_dtype, int4=True)


def int4_bmm_fma(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """K7's CUDA-core route (``csrc/quant_matmul.cu``, a split reduction
    added by a second kernel), as :func:`int4_bmm`, on any shapes; counted
    as ``int4_bmm_fma``."""
    return _quant_bmm("int4_bmm", x, w_p, scale, out_dtype, int4=True,
                      counter="int4_bmm_fma")


def int4_bmm(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """K7: as :func:`int8_bmm` over w_p (E, D/2, Fp) split-half int4 bytes
    (row i in the low nibble, row i + D/2 in the high nibble); D even. The
    route is chosen from the shapes alone (:func:`int4_bmm_tc_route`):
    :func:`int4_bmm_tc` (counted ``int4_bmm``) or :func:`int4_bmm_fma`
    (``int4_bmm_fma``)."""
    if (x.dim() == 3 and w_p.dim() == 3
            and int4_bmm_tc_route(*x.shape, w_p.shape[2])
            and tuple(w_p.shape[:2]) == (x.shape[0], x.shape[2] // 2)):
        return int4_bmm_tc(x, w_p, scale, out_dtype)
    return int4_bmm_fma(x, w_p, scale, out_dtype)


# -- K8 and K9: Gaussian splatting (csrc/gaussian_splat.cu) ------------------ #


def _float_inputs(name: str, device, *tensors) -> None:
    _require(all(t.device == device and t.dtype == torch.float32
                 for t in tensors),
             f"{name}: inputs must be float32 on one CUDA device")


# K8's chunks: the depth-sorted Gaussians cut into at most SPLAT_BIN_CHUNKS
# chunks of a power of two from SPLAT_BIN_CHUNK_MIN to SPLAT_BIN_CHUNK_MAX
# Gaussians (the write pass holds a chunk's rectangles in shared memory and
# scans them a ballot of 32 at a time for each tile)
SPLAT_BIN_CHUNK_MIN, SPLAT_BIN_CHUNK_MAX, SPLAT_BIN_CHUNKS = 64, 256, 32


def splat_bin_chunk(g: int) -> int:
    """K8's chunk from G alone: the least power of two from 64 that cuts G
    into at most 32 chunks, at most 256 (64 at G = 2,000, 256 from 8,192
    up: 63 chunks at 16,000, 1,024 at 262,144)."""
    chunk = SPLAT_BIN_CHUNK_MIN
    while chunk < SPLAT_BIN_CHUNK_MAX and chunk * SPLAT_BIN_CHUNKS < g:
        chunk *= 2
    return chunk


def splat_bin(xy: torch.Tensor, radius: torch.Tensor, valid: torch.Tensor,
              tiles_x: int, tiles_y: int, tile_size: int, k: int):
    """K8, the tile binning of ``render_tiled``: xy (G, 2) and radius (G,)
    fp32 and valid (G,) bool of the depth-sorted Gaussians, on one CUDA
    device; a tiles_x x tiles_y grid of tile_size-pixel tiles. Returns idx
    (tiles, k) int32, each tile's first k Gaussians (in sorted order) that
    are valid and whose box of half width tile_size / 2 + radius about their
    mean holds the tile's centre, unfilled slots 0, and count (tiles,)
    int32, the slots filled. The Gaussians are taken in chunks of
    :func:`splat_bin_chunk` (G): three launches (count, prefix, write) over
    tiles * (chunks + 1) + 1 int32 of slots and a rectangle of tiles for
    each Gaussian as scratch, counted once as ``splat_bin``."""
    name = "splat_bin"
    _require(xy.is_cuda, f"{name}: xy must lie on a CUDA device")
    g = xy.shape[0]
    _require(xy.shape == (g, 2) and radius.shape == (g,)
             and valid.shape == (g,) and valid.dtype == torch.bool
             and valid.device == xy.device,
             f"{name}: xy must be (G, 2), radius (G,) and valid (G,) bool")
    _float_inputs(name, xy.device, xy, radius)
    _require(0 < k <= g and tile_size > 0, f"{name}: k must be in 1..G")
    chunk = splat_bin_chunk(g)
    tiles = tiles_x * tiles_y
    chunks = -(-g // chunk)
    _require(tiles_x >= 0 and tiles_y >= 0
             and tiles * (chunks + 1) < 2 ** 31 - 1,
             f"{name}: {tiles_x} x {tiles_y} tiles do not fit an int32 grid")
    xy, radius, valid = (t.contiguous() for t in (xy, radius, valid))
    # the chunks' slots on each tile and the last live chunk, then each
    # Gaussian's rectangle of tiles (int4, from a multiple of 4)
    offsets = torch.empty(((tiles * (chunks + 1) + 4) // 4 * 4 + 4 * g,),
                          device=xy.device, dtype=torch.int32)
    idx = torch.empty((tiles, k), device=xy.device, dtype=torch.int32)
    count = torch.empty((tiles,), device=xy.device, dtype=torch.int32)
    rc = library().splat_bin(
        xy.data_ptr(), radius.data_ptr(), valid.data_ptr(), g, tiles_x,
        tiles_y, tile_size, k, chunk, offsets.data_ptr(), idx.data_ptr(),
        count.data_ptr(), torch.cuda.current_stream(xy.device).cuda_stream)
    _check(name, rc)
    return idx, count


# K9's split of a region's list: runs of at least SPLAT_SEGMENT_MIN
# entries, at most SPLAT_SEGMENTS_MAX of them, and blocks of at most
# SPLAT_BLOCK_WARPS warps, one a (run, 8 x 16 pixel group)
SPLAT_SEGMENT_MIN, SPLAT_SEGMENTS_MAX, SPLAT_BLOCK_WARPS = 128, 8, 16
SPLAT_GROUP = (8, 16)  # a warp's pixels: rows, columns
SPLAT_STATE = 5  # kept a (pixel, segment): T mantissa, exponent; B (3)


def splat_plan(k: int, region_h: int, region_w: int):
    """K9's split, from the list's length and the region's size alone:
    (segments, pixel groups a block). A list of K entries is cut into
    ``segments`` runs of ``ceil(K / segments)`` entries, a warp compositing
    one run over an 8 x 16 group of pixels. Where a region's groups fit in
    one block with a warp each, the block holds the whole region (a 16 x 16
    tile: 2 groups x 4 runs of 128 at K = 512) and its gradients are added
    once, in a fixed order; else a block holds one group (the dense image:
    512 blocks of 8 runs)."""
    groups = -(-region_h // SPLAT_GROUP[0]) * -(-region_w // SPLAT_GROUP[1])
    segments = max(1, min(SPLAT_SEGMENTS_MAX, -(-k // SPLAT_SEGMENT_MIN)))
    if groups <= SPLAT_BLOCK_WARPS:
        return min(segments, SPLAT_BLOCK_WARPS // groups), groups
    return segments, 1


def splat_state_shape(lists: int, k: int, region_h: int, region_w: int):
    """The shape of the state K9-fwd keeps for K9-bwd: (L, segments, 5,
    region_h * region_w), per segment and region pixel (row-major) the
    transmittance after the segment as mantissa and binary exponent and
    the colour seen behind the segment."""
    return (lists, splat_plan(k, region_h, region_w)[0], SPLAT_STATE,
            region_h * region_w)


def _splat_lists(name, xy, abc, opac, color, background, height, width,
                 region_h, region_w):
    """Checks of K9's inputs; returns (L, K) and the inputs contiguous."""
    _require(xy.is_cuda, f"{name}: xy must lie on a CUDA device")
    _require(xy.dim() == 3 and xy.shape[2] == 2,
             f"{name}: xy must be (L, K, 2)")
    lists, k = xy.shape[:2]
    _require(abc.shape == (lists, k, 3) and opac.shape == (lists, k)
             and color.shape == (lists, k, 3),
             f"{name}: abc and color must be (L, K, 3), opac (L, K)")
    _float_inputs(name, xy.device, xy, abc, opac, color,
                  *([] if background is None else [background]))
    _require(background is None or background.shape == (3,),
             f"{name}: background must be (3,)")
    _require(region_h > 0 and region_w > 0 and height % region_h == 0
             and width % region_w == 0
             and lists == (height // region_h) * (width // region_w),
             f"{name}: one list a region_h x region_w region of the image")
    return (lists, k), [None if t is None else t.contiguous()
                        for t in (xy, abc, opac, color, background)]


def splat_composite_fwd(xy: torch.Tensor, abc: torch.Tensor,
                        opac: torch.Tensor, color: torch.Tensor,
                        background: Optional[torch.Tensor], height: int,
                        width: int, region_h: int, region_w: int,
                        keep_state: bool = False):
    """K9 forward: front-to-back compositing of ordered lists. xy (L, K, 2)
    entry means in pixels, abc (L, K, 3) the coefficients of the quadratic
    form a dx^2 + b dx dy + c dy^2, opac (L, K), color (L, K, 3), background
    (3,) or None, fp32 on one CUDA device; list l is composited over region
    l (row-major) of a height x width image cut into region_h x region_w
    regions. Per pixel, alpha_j = clip(opac_j exp(-q_j / 2), 0, 0.995) and
    the colour is sum_j alpha_j T_j color_j + T_K background, T_j the
    product of (1 - alpha_i) over i < j. Each list is composited in
    :func:`splat_plan`'s segments and the segments combined. Returns
    (height, width, 3) fp32; with ``keep_state`` also the state
    (:func:`splat_state_shape`) :func:`splat_composite_bwd` reads. Counted
    as ``splat_composite_fwd``."""
    name = "splat_composite_fwd"
    (lists, k), (xy, abc, opac, color, background) = _splat_lists(
        name, xy, abc, opac, color, background, height, width, region_h,
        region_w)
    segments, groups = splat_plan(k, region_h, region_w)
    out = torch.empty((height, width, 3), device=xy.device,
                      dtype=torch.float32)
    state = (torch.empty(splat_state_shape(lists, k, region_h, region_w),
                         device=xy.device, dtype=torch.float32)
             if keep_state else None)
    rc = library().splat_composite_fwd(
        xy.data_ptr(), abc.data_ptr(), opac.data_ptr(), color.data_ptr(),
        _ptr(background), lists, k, height, width, region_h, region_w,
        segments, groups, out.data_ptr(), _ptr(state),
        torch.cuda.current_stream(xy.device).cuda_stream)
    _check(name, rc)
    return (out, state) if keep_state else out


def splat_composite_bwd(xy: torch.Tensor, abc: torch.Tensor,
                        opac: torch.Tensor, color: torch.Tensor,
                        background: Optional[torch.Tensor],
                        state: torch.Tensor, dout: torch.Tensor,
                        height: int, width: int, region_h: int,
                        region_w: int):
    """K9 backward: the forward's inputs, the state it kept and dout
    (height, width, 3) fp32; each segment walked once, back to front.
    Returns the gradients of xy, abc, opac, color and background (None
    without one), each summed over the pixels of its region with one atomic
    add a block and entry (a 16 x 16 tile is one block, so the tiled
    gradients are added once, in a fixed order). jnp.clip's gradient: 1
    inside (0, 0.995), 1/2 on a bound. Counted as
    ``splat_composite_bwd``."""
    name = "splat_composite_bwd"
    (lists, k), (xy, abc, opac, color, background) = _splat_lists(
        name, xy, abc, opac, color, background, height, width, region_h,
        region_w)
    _require(dout.shape == (height, width, 3) and dout.dtype == torch.float32
             and dout.device == xy.device,
             f"{name}: dout must be (height, width, 3) float32")
    shape = splat_state_shape(lists, k, region_h, region_w)
    _require(state.shape == shape and state.dtype == torch.float32
             and state.device == xy.device,
             f"{name}: state must be {shape} float32")
    segments, groups = splat_plan(k, region_h, region_w)
    dout, state = dout.contiguous(), state.contiguous()
    grads = [torch.zeros_like(t) for t in (xy, abc, opac, color)]
    dbg = None if background is None else torch.zeros_like(background)
    rc = library().splat_composite_bwd(
        xy.data_ptr(), abc.data_ptr(), opac.data_ptr(), color.data_ptr(),
        _ptr(background), state.data_ptr(), dout.data_ptr(), lists, k,
        height, width, region_h, region_w, segments, groups,
        *(g.data_ptr() for g in grads), _ptr(dbg),
        torch.cuda.current_stream(xy.device).cuda_stream)
    _check(name, rc)
    return (*grads, dbg)


# -- custom operators for torch.export --------------------------------------- #


@torch.library.custom_op("deepearth::pairwise_attention_fwd", mutates_args=())
def _pairwise_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               key_mask: Optional[torch.Tensor],
                               n_heads: int, scale: float) -> torch.Tensor:
    """K1-fwd as an operator: :func:`pairwise_attention_fwd`."""
    return pairwise_attention_fwd(q, k, v, n_heads, scale, key_mask)


@_pairwise_attention_fwd_op.register_fake
def _(q, k, v, key_mask, n_heads, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("deepearth::grid4d_encode_fwd", mutates_args=())
def _grid4d_encode_fwd_op(xyzt: torch.Tensor, tables: List[torch.Tensor],
                          resolutions: List[torch.Tensor],
                          table_sizes: List[int], linear: List[bool],
                          cols: List[int], n_cols: List[int],
                          mask_bits: List[int],
                          spatial_mask: Optional[torch.Tensor],
                          temporal_mask: Optional[torch.Tensor],
                          out_dtype: torch.dtype) -> torch.Tensor:
    """K2-fwd's Grid4D encode as an operator: :func:`grid4d_encode_fwd`,
    each table's coordinate columns flattened into ``cols`` (``n_cols`` a
    table)."""
    starts = [sum(n_cols[:i]) for i in range(len(n_cols))]
    encodings = [(t, r, size, lin, tuple(cols[s:s + n]), bits)
                 for t, r, size, lin, s, n, bits in zip(
                     tables, resolutions, table_sizes, linear, starts,
                     n_cols, mask_bits)]
    return grid4d_encode_fwd(xyzt, encodings, spatial_mask, temporal_mask,
                             out_dtype)


@_grid4d_encode_fwd_op.register_fake
def _(xyzt, tables, resolutions, table_sizes, linear, cols, n_cols,
      mask_bits, spatial_mask, temporal_mask, out_dtype):
    width = sum(t.shape[0] * t.shape[2] for t in tables)
    return xyzt.new_empty((xyzt.shape[0], width), dtype=out_dtype)
