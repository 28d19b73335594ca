// Grid4D's whole hash encode in one launch: K2-fwd as the Grid4D encoder
// calls it (grid4d_encode_fwd).
//
// Replaces: each HashEncoding of deepearth_tpu/models/grid4d.py
// (deepearth_tpu/ops/hash_encoding.py `hash_encode`, XLA on the TPU) with
// the mask multiplies, the concatenation and the cast to the compute dtype
// around them (deepearth_tpu/models/grid4d.py:53-84), which XLA fuses into
// the gathers under jit. One launch computes `combined`, the projection's
// input, from xyzt: the spatial (x, y, z) and temporal (t) tables, and the
// xyt / yzt / xzt tables when the config has them.
//
// Bound on the H100: random 8-byte gathers. At the A-stack shape a point
// reads 8 corners x 16 spatial levels plus 2 corners x 8 temporal levels.
// Each corner is one float2 of a row chosen by the hash, so each lands on a
// 32-byte sector of its own (x-neighbours share one: prime 1 on x), and the
// spatial table (64 MiB) is larger than L2: the sectors the fine levels
// touch, not the rows, set the floor.
//
// Design:
//  - one thread a (point, level) of one table; the blocks of a table are
//    contiguous in the grid, so the table's parameters (a descriptor passed
//    by value) are uniform across a block and the (D, linear) case is
//    resolved once a block;
//  - consecutive lanes take consecutive levels of one point, so a warp
//    writes whole runs of a row of `combined`, neighbouring lanes on
//    neighbouring columns;
//  - xyzt is read in place with its strides, each lane its point's D
//    coordinates (L1 serves the point's other lanes);
//  - every corner's row is computed first and all 2^D float2 loads are
//    issued before the first multiply-add;
//  - 32-bit point / level arithmetic; the whole encode of the A-stack at
//    B = 4096 is 98,304 threads of 256 a block, one wave on 132 SMs.
// Tried on the H100 and dropped, each no faster (PERF.md): one
// coordinate load a lane exchanged by shuffles; 128 or 512 threads a
// block; L2-only loads (ld.global.cg); one 16-byte load for the two
// x-neighbour corners where they share an aligned pair of rows. What is
// left is one dependent chain (coordinates, hash, gathers, store) behind
// the launch, about 3 us at B = 1, and the gathers' random sectors.
// The rows, weights and fp32 sums are hash_grid.cuh's, in the per-table
// kernel's order, and the mask is an fp32 multiply by 0 or 1 followed by
// one round-to-nearest-even cast, as the plain composition does: the output
// is the plain version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

// One table of the encode, as the wrapper fills it (kernels/__init__.py
// _Grid4DTable).
struct Grid4DTable {
  const void* tables;       // (n_levels, level_stride, 2) fp32
  const void* resolutions;  // (n_levels,) fp32
  int64_t level_stride;
  int64_t table_size;
  int32_t n_levels, d, linear;
  int32_t mask;     // bit 0: times spatial_mask, bit 1: times temporal_mask
  int32_t out_col;  // its first column of the output row
  int32_t cols[4];  // the xyzt columns of its coordinates
};

namespace {

constexpr int kMaxTables = 5;
constexpr int kThreads = 256;

struct Table {
  const float2* rows;
  const float* res;
  uint32_t level_stride, table_size;
  int n_levels, linear_d;  // linear_d = 2 * d + linear
  int mask, out_col, block_begin;
  int cols[4];
};

struct Args {
  const float* xyzt;
  int64_t row_stride, col_stride;
  const uint8_t* spatial_mask;
  const uint8_t* temporal_mask;
  void* out;
  int64_t out_stride;
  uint32_t n;
  int n_tables;
  Table t[kMaxTables];
};

__device__ __forceinline__ void store(float* out, int64_t i, float x,
                                      float y) {
  *reinterpret_cast<float2*>(out + i) = make_float2(x, y);
}

__device__ __forceinline__ void store(__nv_bfloat16* out, int64_t i, float x,
                                      float y) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(x, y);
}

template <int D, bool LINEAR, typename Out>
__device__ __forceinline__ void encode(const Args& a, const Table& e) {
  constexpr int NC = LINEAR ? (1 << D) : 1;
  const uint32_t L = e.n_levels;
  const uint32_t t = (blockIdx.x - e.block_begin) * kThreads + threadIdx.x;
  const uint32_t pt = t / L;
  const int l = static_cast<int>(t - pt * L);
  const bool valid = pt < a.n;
  const int64_t p = valid ? pt : a.n - 1;  // stores nothing if not valid
  const float* row = a.xyzt + p * a.row_stride;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = __ldg(row + e.cols[d] * a.col_stride);
  bool keep = true;
  if (e.mask & 1) keep = __ldg(a.spatial_mask + p) != 0;
  if (e.mask & 2) keep = keep && __ldg(a.temporal_mask + p) != 0;

  int grid[D];
  float frac[D];
  hash_grid::cell_position<D>(x, __ldg(e.res + l), grid, frac);
  uint32_t h[NC];
  float w[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    hash_grid::cell_corner<D, LINEAR>(grid, frac, c, e.table_size, h[c], w[c]);
  const float2* level = e.rows + static_cast<int64_t>(l) * e.level_stride;
  float2 v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) v[c] = __ldg(level + h[c]);
  float ox = v[0].x, oy = v[0].y;  // nearest: the row itself
  if (LINEAR) {
    ox = 0.0f;
    oy = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ox = __fadd_rn(ox, __fmul_rn(w[c], v[c].x));
      oy = __fadd_rn(oy, __fmul_rn(w[c], v[c].y));
    }
  }
  if (e.mask) {  // f * mask.to(f32), as the plain composition multiplies
    const float m = keep ? 1.0f : 0.0f;
    ox = __fmul_rn(ox, m);
    oy = __fmul_rn(oy, m);
  }
  if (valid)
    store(static_cast<Out*>(a.out), p * a.out_stride + e.out_col + 2 * l, ox,
          oy);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    grid4d_encode_kernel(const Args a) {
  Table e = a.t[0];  // the table whose blocks this block is among
#pragma unroll
  for (int i = 1; i < kMaxTables; ++i)
    if (i < a.n_tables && static_cast<int>(blockIdx.x) >= a.t[i].block_begin)
      e = a.t[i];
  switch (e.linear_d) {
    case 2: encode<1, false, Out>(a, e); break;
    case 3: encode<1, true, Out>(a, e); break;
    case 4: encode<2, false, Out>(a, e); break;
    case 5: encode<2, true, Out>(a, e); break;
    case 6: encode<3, false, Out>(a, e); break;
    case 7: encode<3, true, Out>(a, e); break;
    case 8: encode<4, false, Out>(a, e); break;
    default: encode<4, true, Out>(a, e); break;
  }
}

}  // namespace

// xyzt (n, >= 4) fp32 with strides (row_stride, col_stride) in elements;
// spatial_mask, temporal_mask (n,) bool or null (used by the tables whose
// mask bits name them); tables: n_tables descriptors in host memory; out
// (n, out_stride) fp32 (out_bf16 = 0) or bf16 (1), its columns
// [out_col, out_col + 2 n_levels) of each table written. All on one device,
// out 8-byte aligned. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int grid4d_encode_fwd(const void* xyzt, int64_t n,
                                 int64_t row_stride, int64_t col_stride,
                                 const void* spatial_mask,
                                 const void* temporal_mask,
                                 const Grid4DTable* tables, int n_tables,
                                 void* out, int64_t out_stride, int out_bf16,
                                 void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || n < 0 || n >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.xyzt = static_cast<const float*>(xyzt);
  a.row_stride = row_stride;
  a.col_stride = col_stride;
  a.spatial_mask = static_cast<const uint8_t*>(spatial_mask);
  a.temporal_mask = static_cast<const uint8_t*>(temporal_mask);
  a.out = out;
  a.out_stride = out_stride;
  a.n = static_cast<uint32_t>(n);
  a.n_tables = n_tables;
  int64_t blocks = 0;
  for (int i = 0; i < n_tables; ++i) {
    const Grid4DTable& s = tables[i];
    if (s.d < 1 || s.d > 4 || s.n_levels < 1 || s.table_size < 1 ||
        s.table_size > s.level_stride || s.level_stride > 0xFFFFFFFFll ||
        ((s.mask & 1) && !spatial_mask) || ((s.mask & 2) && !temporal_mask))
      return static_cast<int>(cudaErrorInvalidValue);
    Table& e = a.t[i];
    e.rows = static_cast<const float2*>(s.tables);
    e.res = static_cast<const float*>(s.resolutions);
    e.level_stride = static_cast<uint32_t>(s.level_stride);
    e.table_size = static_cast<uint32_t>(s.table_size);
    e.n_levels = s.n_levels;
    e.linear_d = 2 * s.d + (s.linear ? 1 : 0);
    e.mask = s.mask;
    e.out_col = s.out_col;
    e.block_begin = static_cast<int>(blocks);
    for (int d = 0; d < 4; ++d) e.cols[d] = s.cols[d];
    blocks += (n * s.n_levels + kThreads - 1) / kThreads;
  }
  if (blocks == 0) return 0;
  if (blocks * kThreads >= (1ll << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    grid4d_encode_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  else
    grid4d_encode_kernel<float>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
