// Multi-resolution hash-grid encoding, forward (K2-fwd) and backward
// (K2-bwd).
//
// Replaces: deepearth_tpu/ops/hash_encoding.py `hash_encode` and its
// `_packed_gather` (K2-fwd), and the gather's hand-written transpose
// `_packed_gather_bwd` (K2-bwd). Both are XLA on the TPU: Mosaic cannot
// express a random gather or scatter into a large table, so the JAX package
// never had a Pallas kernel here.
//
// Bound on the H100: random 8-byte gathers. At the A-stack shape a point
// reads 8 corners x 16 spatial levels plus 2 corners x 8 temporal levels,
// each one float2 from a table row chosen by the hash. The 16-level spatial
// table is 16 x 2^19 x 2 x 4 B = 64 MiB, larger than the 50 MB L2, so the
// fine levels miss to HBM; the coarse levels (16^3 .. 128^3 cells map onto
// few distinct rows) stay resident in L2.
//
// The per-table forward here serves HashEncoding used alone, and Grid4D
// where grid4d_encode.cu does not take its tables (F != 2); Grid4D's encode
// at F = 2 is one launch of grid4d_encode.cu. Design: one thread per
// (point, level). Consecutive threads take the levels of one point, so the
// (N, L*F) output row of a point is written by neighbouring threads. The
// thread computes its cell and the 2^D corner rows and weights
// (hash_grid.cuh), then issues one float2 load per corner. The result is
// bit-identical to the plain PyTorch version, which sums the corners in the
// same order (corner c has offset bit d = (c >> d) & 1). Nothing is staged
// in shared memory: there is no reuse across threads to exploit beyond
// what L2 already gives.
//
// K2-bwd writes the dense (L, T, F) fp32 table gradient. Its bound is that
// one write (67.1 MB at the A-stack's spatial tables, 0.020 ms at 3.35
// TB/s); the scatter itself touches at most 2^D rows a (point, level).
// At F = 2 (every Grid4D configuration) the kernels write every entry
// themselves, so the wrapper allocates the gradient with torch.empty. Two
// launches on the stream:
//  1. hash_bwd_zero_kernel zeroes the gradient with 16-byte stores;
//  2. hash_bwd_scatter_kernel, one thread per (point, level, corner), level
//     by level from the finest, recomputes its corner and weight with the
//     forward's own hash_grid::cell_position and cell_corner and adds
//     w_c * grad_out[point, level, :] into the corner's row with one
//     float2 reduction (atomicAdd on a float2, native for global memory on
//     sm_90), not two scalar atomics. On the coarse levels few cells hold
//     many points (5 rows at the temporal table's first level for 4096
//     points), and reductions on one address serialise: there the lanes of
//     a warp that hit one row add their terms first (__match_any_sync),
//     and one of them reduces the sum.
// Other F keep the first design: the wrapper passes a zeroed gradient and
// hash_encode_bwd adds each feature with a scalar atomicAdd, one thread per
// (point, level). Atomics make the order of each sum differ from run to
// run, so the result is not bit-reproducible; every sum is over the same
// terms as the plain version's index_add_.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

// The 2^D (linear) or 1 (nearest) table rows that point p reads on level l,
// and their d-linear weights, as rows of the flattened (L * level_stride)
// table. The forward and both backward designs build them from
// hash_grid.cuh's cell_position and cell_corner, so the backward scatters
// to exactly the rows, with exactly the weights, that the forward gathered.
template <int D, bool LINEAR>
__device__ __forceinline__ void cell_corners(
    const float* __restrict__ coords, const float* __restrict__ resolutions,
    int64_t p, int l, int64_t level_stride, uint32_t table_size,
    int64_t* row, float* w) {
  constexpr int NC = LINEAR ? (1 << D) : 1;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = coords[p * D + d];
  int grid[D];
  float frac[D];
  hash_grid::cell_position<D>(x, resolutions[l], grid, frac);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    uint32_t h;
    hash_grid::cell_corner<D, LINEAR>(grid, frac, c, table_size, h, w[c]);
    row[c] = static_cast<int64_t>(l) * level_stride + h;
  }
}

template <int D, bool LINEAR, int FS>
__global__ void hash_encode_fwd_kernel(const float* __restrict__ coords,
                                       const float* __restrict__ tables,
                                       const float* __restrict__ resolutions,
                                       float* __restrict__ out, int64_t n,
                                       int n_levels, int64_t level_stride,
                                       uint32_t table_size, int f_runtime) {
  constexpr int NC = LINEAR ? (1 << D) : 1;
  const int F = FS > 0 ? FS : f_runtime;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * n_levels) return;
  const int64_t p = tid / n_levels;
  const int l = static_cast<int>(tid - p * n_levels);
  int64_t row[NC];
  float w[NC];
  cell_corners<D, LINEAR>(coords, resolutions, p, l, level_stride, table_size,
                          row, w);

  float* o = out + (p * n_levels + l) * F;
  if constexpr (FS == 2) {
    const float2* t2 = reinterpret_cast<const float2*>(tables);
    float ax = 0.0f, ay = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float2 v = __ldg(t2 + row[c]);
      ax = __fadd_rn(ax, __fmul_rn(w[c], v.x));
      ay = __fadd_rn(ay, __fmul_rn(w[c], v.y));
    }
    *reinterpret_cast<float2*>(o) = make_float2(ax, ay);
  } else {
    for (int f = 0; f < F; ++f) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc = __fadd_rn(acc, __fmul_rn(w[c], __ldg(tables + row[c] * F + f)));
      o[f] = acc;
    }
  }
}

// K2-bwd's first design, kept for F != 2: the transpose of the gather.
// Thread (p, l) recomputes its corners and adds w_c * grad_out[p, l, f]
// into grad_tables[row_c, f] with scalar fp32 atomics; grad_tables must be
// zero on entry.
template <int D, bool LINEAR, int FS>
__global__ void hash_encode_bwd_kernel(const float* __restrict__ coords,
                                       const float* __restrict__ grad_out,
                                       const float* __restrict__ resolutions,
                                       float* __restrict__ grad_tables,
                                       int64_t n, int n_levels,
                                       int64_t level_stride,
                                       uint32_t table_size, int f_runtime) {
  constexpr int NC = LINEAR ? (1 << D) : 1;
  const int F = FS > 0 ? FS : f_runtime;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * n_levels) return;
  const int64_t p = tid / n_levels;
  const int l = static_cast<int>(tid - p * n_levels);
  int64_t row[NC];
  float w[NC];
  cell_corners<D, LINEAR>(coords, resolutions, p, l, level_stride, table_size,
                          row, w);

  const float* g = grad_out + (p * n_levels + l) * F;
  if constexpr (FS == 2) {
    const float2 gv = *reinterpret_cast<const float2*>(g);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      atomicAdd(grad_tables + row[c] * 2, __fmul_rn(w[c], gv.x));
      atomicAdd(grad_tables + row[c] * 2 + 1, __fmul_rn(w[c], gv.y));
    }
  } else {
    for (int f = 0; f < F; ++f) {
      const float gf = g[f];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        atomicAdd(grad_tables + row[c] * F + f, __fmul_rn(w[c], gf));
    }
  }
}

struct DenseArgs {
  const float* coords;
  const float* grad_out;
  const float* resolutions;
  float* grad_tables;
  int64_t n_pairs, n_floats, level_stride;
  int n_levels;
  uint32_t table_size;
};

// K2-bwd at F = 2, its first launch: n floats at g (16-byte aligned)
// zeroed, 16 bytes a store, a grid-stride loop.
__global__ void hash_bwd_zero_kernel(float* __restrict__ g, int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float4* g4 = reinterpret_cast<float4*>(g);
  const int64_t n4 = n / 4;
  for (int64_t i = t; i < n4; i += stride)
    g4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t i = 4 * n4 + t; i < n; i += stride) g[i] = 0.0f;
}

// Corner t of the scatter, t < n_pairs * 2^D in level-major order, finest
// level first: w_c * grad_out[p, l, :] into the corner's row with one
// float2 reduction. The lanes of a warp, which hold neighbouring points of
// one level, that hit one row (on the coarse levels, where few cells hold
// many points and reductions on one address serialise) add their terms
// first, and the lowest of them reduces the sum. Every lane of the warp
// must call it; a t past the end adds nothing.
template <int D, bool LINEAR>
__device__ __forceinline__ void scatter_corner(const DenseArgs& a,
                                               int64_t t) {
  constexpr int NC = LINEAR ? (1 << D) : 1;
  const int64_t per_level = a.n_pairs / a.n_levels * NC;
  const bool valid = t < a.n_pairs * NC;
  const int64_t tv = valid ? t : 0;
  const int64_t level_from_top = tv / per_level;
  const int l = a.n_levels - 1 - static_cast<int>(level_from_top);
  const int64_t p = (tv - level_from_top * per_level) / NC;
  const int c = static_cast<int>(tv % NC);
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = a.coords[p * D + d];
  int grid[D];
  float frac[D];
  hash_grid::cell_position<D>(x, a.resolutions[l], grid, frac);
  uint32_t h;
  float w;
  hash_grid::cell_corner<D, LINEAR>(grid, frac, c, a.table_size, h, w);
  int64_t row = static_cast<int64_t>(l) * a.level_stride + h;
  const float2 g = __ldg(reinterpret_cast<const float2*>(a.grad_out) +
                         p * a.n_levels + l);
  float2 term = make_float2(__fmul_rn(w, g.x), __fmul_rn(w, g.y));
  if (!valid) row = -1;
  float2* out = reinterpret_cast<float2*>(a.grad_tables);
  const unsigned lane = threadIdx.x % 32;
  const unsigned peers =
      __match_any_sync(0xFFFFFFFFu, static_cast<unsigned long long>(row));
  if (__any_sync(0xFFFFFFFFu, peers != 1u << lane)) {
    float2 sum = make_float2(0.0f, 0.0f);
    for (int src = 0; src < 32; ++src) {
      const float x = __shfl_sync(0xFFFFFFFFu, term.x, src);
      const float y = __shfl_sync(0xFFFFFFFFu, term.y, src);
      if (peers >> src & 1u) {
        sum.x += x;
        sum.y += y;
      }
    }
    if (lane != static_cast<unsigned>(__ffs(peers) - 1)) return;
    term = sum;
  }
  if (valid) atomicAdd(out + row, term);
}

// The second launch, after hash_bwd_zero_kernel: one thread a corner.
template <int D, bool LINEAR>
__global__ void hash_bwd_scatter_kernel(const DenseArgs a) {
  scatter_corner<D, LINEAR>(
      a, static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
}

constexpr int kThreads = 256;

template <int D, bool LINEAR>
int launch_dense(const DenseArgs& a, cudaStream_t stream) {
  const auto blocks_for = [](int64_t n) {
    return static_cast<unsigned>((n + kThreads - 1) / kThreads);
  };
  constexpr int NC = LINEAR ? (1 << D) : 1;
  unsigned zero_blocks = blocks_for(a.n_floats / 4 + 1);
  if (zero_blocks > 4096u) zero_blocks = 4096u;  // then a grid-stride loop
  hash_bwd_zero_kernel<<<zero_blocks, kThreads, 0, stream>>>(a.grad_tables,
                                                             a.n_floats);
  if (a.n_pairs > 0)
    hash_bwd_scatter_kernel<D, LINEAR>
        <<<blocks_for(a.n_pairs * NC), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One thread per (point, level); F = 2 is a compile-time case.
template <bool BWD, int D, bool LINEAR, int FS>
void launch_f(const float* coords, const float* in, const float* res,
              float* out, int64_t n, int n_levels, int64_t level_stride,
              uint32_t table_size, int f, cudaStream_t stream) {
  const int64_t total = n * n_levels;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if constexpr (BWD)
    hash_encode_bwd_kernel<D, LINEAR, FS><<<blocks, kThreads, 0, stream>>>(
        coords, in, res, out, n, n_levels, level_stride, table_size, f);
  else
    hash_encode_fwd_kernel<D, LINEAR, FS><<<blocks, kThreads, 0, stream>>>(
        coords, in, res, out, n, n_levels, level_stride, table_size, f);
}

template <bool BWD, int D, bool LINEAR>
void launch_d(const float* coords, const float* in, const float* res,
              float* out, int64_t n, int n_levels, int64_t level_stride,
              uint32_t table_size, int f, cudaStream_t stream) {
  if (f == 2)
    launch_f<BWD, D, LINEAR, 2>(coords, in, res, out, n, n_levels,
                                level_stride, table_size, f, stream);
  else
    launch_f<BWD, D, LINEAR, 0>(coords, in, res, out, n, n_levels,
                                level_stride, table_size, f, stream);
}

template <bool BWD, bool LINEAR>
int launch(const float* coords, const float* in, const float* res,
           float* out, int64_t n, int d, int n_levels, int64_t level_stride,
           uint32_t table_size, int f, cudaStream_t stream) {
  switch (d) {
    case 1: launch_d<BWD, 1, LINEAR>(coords, in, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 2: launch_d<BWD, 2, LINEAR>(coords, in, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 3: launch_d<BWD, 3, LINEAR>(coords, in, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 4: launch_d<BWD, 4, LINEAR>(coords, in, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <bool BWD>
int run(const void* coords, const void* in, const void* resolutions,
        void* out, int64_t n, int d, int n_levels, int64_t level_stride,
        int64_t table_size, int f, int linear, void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(coords);
  const auto* i = static_cast<const float*>(in);
  const auto* r = static_cast<const float*>(resolutions);
  auto* o = static_cast<float*>(out);
  const auto ts = static_cast<uint32_t>(table_size);
  const int rc = linear
      ? launch<BWD, true>(c, i, r, o, n, d, n_levels, level_stride, ts, f, s)
      : launch<BWD, false>(c, i, r, o, n, d, n_levels, level_stride, ts, f, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coords (n, d) fp32, tables (n_levels, level_stride, f) fp32, resolutions
// (n_levels,) fp32, out (n, n_levels * f) fp32; all contiguous on the device.
// Returns a cudaError_t value; 0 on a clean launch.
extern "C" int hash_encode_fwd(const void* coords, const void* tables,
                               const void* resolutions, void* out, int64_t n,
                               int d, int n_levels, int64_t level_stride,
                               int64_t table_size, int f, int linear,
                               void* stream) {
  return run<false>(coords, tables, resolutions, out, n, d, n_levels,
                    level_stride, table_size, f, linear, stream);
}

// coords (n, d) fp32, grad_out (n, n_levels * 2) fp32, resolutions
// (n_levels,) fp32, grad_tables (n_levels, level_stride, 2) fp32, whatever
// it holds on entry; all contiguous on the device, grad_out 8-byte and
// grad_tables 16-byte aligned. Writes the gradient of the gather at F = 2
// into every entry of grad_tables, in two launches. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int hash_encode_bwd_dense(const void* coords, const void* grad_out,
                                     const void* resolutions,
                                     void* grad_tables, int64_t n, int d,
                                     int n_levels, int64_t level_stride,
                                     int64_t table_size, int linear,
                                     void* stream) {
  if (reinterpret_cast<uintptr_t>(grad_tables) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(grad_out) % 8 != 0 || d < 1 || d > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  DenseArgs a;
  a.coords = static_cast<const float*>(coords);
  a.grad_out = static_cast<const float*>(grad_out);
  a.resolutions = static_cast<const float*>(resolutions);
  a.grad_tables = static_cast<float*>(grad_tables);
  a.n_pairs = n * n_levels;
  a.n_floats = static_cast<int64_t>(n_levels) * level_stride * 2;
  a.level_stride = level_stride;
  a.n_levels = n_levels;
  a.table_size = static_cast<uint32_t>(table_size);
  if (a.n_floats == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (d * 2 + (linear ? 1 : 0)) {
    case 2: return launch_dense<1, false>(a, s);
    case 3: return launch_dense<1, true>(a, s);
    case 4: return launch_dense<2, false>(a, s);
    case 5: return launch_dense<2, true>(a, s);
    case 6: return launch_dense<3, false>(a, s);
    case 7: return launch_dense<3, true>(a, s);
    case 8: return launch_dense<4, false>(a, s);
    default: return launch_dense<4, true>(a, s);
  }
}

// coords (n, d) fp32, grad_out (n, n_levels * f) fp32, resolutions
// (n_levels,) fp32, grad_tables (n_levels, level_stride, f) fp32 and zero on
// entry; all contiguous on the device. Adds the gradient of the gather into
// grad_tables. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int hash_encode_bwd(const void* coords, const void* grad_out,
                               const void* resolutions, void* grad_tables,
                               int64_t n, int d, int n_levels,
                               int64_t level_stride, int64_t table_size,
                               int f, int linear, void* stream) {
  return run<true>(coords, grad_out, resolutions, grad_tables, n, d, n_levels,
                   level_stride, table_size, f, linear, stream);
}
