// Grouped matmul over expert-sorted rows, backward (K5-bwd): the split of
// dout into bf16 hi + lo that the TMA route (grouped_matmul_bwd_tma.cu)
// reads, and the routes for what TMA cannot take: bf16 with K or N off the
// 8-element grid (mma.sync), and fp32 (CUDA cores).
//
// Replaces: the megablox VJP `_gmm_bwd`
// (jax/experimental/pallas/ops/tpu/megablox/ops.py:63), which makes two
// Pallas calls: `gmm(grad, rhs, ..., transpose_rhs=True)` (ops.py:80) for
// dlhs and `tgmm(lhs^T, grad, ...)` (ops.py:90; gmm.py:573, pallas_call
// :763) for drhs. deepearth_tpu/ops/moe.py `ragged_expert_ffn` reaches it
// through its three `gmm`s (:359, :362, :366) in every ragged MoE layer of
// a train step.
//
// Computes, for group g holding rows [offset_g, offset_g + size_g) (every
// bound cut at M, grouped_matmul.cuh):
//   dlhs[r] = dout[r] . rhs[g]^T  for each row r of group g, 0 for the rows
//             past the last group;
//   drhs[g] = lhs[rows of g]^T . dout[rows of g], 0 for an empty group
//             (every element is written: an output from torch.empty is
//             fine).
// Shapes: dout (M, N) float32 (the forward's output type); lhs (M, K) and
// rhs (E, K, N), both float32 or both bfloat16, contiguous; dlhs (M, K) in
// lhs's type, drhs (E, K, N) in rhs's; fp32 sums, each rounded once.
//
// Bound on the H100: the flagship's simulator at a request of 64
// observations (M = 2816, E = 8, K = N = 2048, bf16 lhs/rhs, fp32 dout):
// each product is 23.6 GFLOP, 0.024 ms at 989 TFLOP/s; dlhs moves 23 MB of
// dout, 67 MB of rhs and 11.5 MB of dlhs, drhs 11.5 MB of lhs, 23 MB of
// dout and 67 MB of drhs: ~101.7 MB, 0.030 ms each at 3.35 TB/s. Counted
// once the operations would fall under the bytes; the two tensor-core
// passes per product (below) double them, and they bound both at 0.048 ms.
//
// dout stays fp32 inside the product. The gradients into the gate and up
// products are genuine fp32 values; megablox multiplies them at fp32, and
// rounding dout to bf16 first agrees with it in only ~58% of the bf16
// outputs. So dout is split into two bf16 parts, hi = bf16(x) and
// lo = bf16(x - hi), and each k-step runs two mma.sync m16n8k16 (hi and lo
// against the same bf16 operand) into one fp32 accumulator: x is kept to
// ~2^-16 of |x|, far under the output's one rounding to bf16.
//
// The split (gmm_split_dout_kernel) writes hi and lo of fp32 dout once, as
// two bf16 (M, N) tensors, for both gradients of the TMA route: one pass,
// 4 bytes read and 4 written per element, bound by the bytes.
//
// Schedule of the mma.sync route: no host synchronisation, as in K5-fwd.
//  - dlhs: K5-fwd's schedule (find_tile: row tiles per group, none mixing
//    two groups, the rows past the last group a zero-filled segment) with
//    rhs[g] read as (K, N) rows: a 64 x 128 tile of dlhs per block, 4
//    warps of 32 x 64, the reduction over N in steps of 32. dout's fp32
//    tile and rhs's bf16 tile stream through shared memory by cp.async,
//    double buffered; rhs's rows are the B fragments as they lie (n
//    contiguous per column of dlhs), dout's A fragments are split while
//    they load.
//  - drhs: one block per (N-tile of 128, K-tile of 64, group), reducing
//    over the group's rows in steps of 32; lhs's (rows, K) tile gives the
//    A fragments of lhs^T by ldmatrix.x4.trans, dout's fp32 (rows, N) tile
//    the B fragments, split while they load. A block of an empty group
//    writes its zeros.
//  - fp32 lhs/rhs (for the tests): CUDA-core tiles of 64 x 64, 256
//    threads, 4 x 4 outputs each, fmaf in reduction order, exact fp32.
//
// The mma.sync route re-splits dout in every tile; the TMA route splits it
// once (PERF.md).

#include "grouped_matmul.cuh"

namespace {

// Rows [lo, hi) of group g, for a block that owns one group whole.
__device__ TileRows group_rows(const int* group_sizes, int g, int m) {
  __shared__ TileRows found;
  if (threadIdx.x == 0) {
    int start = 0, end = 0;
    for (int e = 0; e <= g; ++e) {
      start = end;
      const int64_t stop =
          static_cast<int64_t>(start) + max(group_sizes[e], 0);
      end = stop < m ? static_cast<int>(stop) : m;
    }
    found = TileRows{g, start, end};
  }
  __syncthreads();
  return found;
}

// stage_rows (attention_common.cuh) for fp32 rows: `vec` 4 moves 16 bytes
// by cp.async (landing by the next cp_async_wait), anything else one
// element by a load and a store.
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld,
                                               const float* x,
                                               int64_t n_stride, int row0,
                                               int rows, int n, int width,
                                               int width_pad, int vec) {
  const int chunks = width_pad / vec;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, d = vec * (idx % chunks);
    const bool valid = row0 + r < n && d < width;
    const float* src = valid ? x + (row0 + r) * n_stride + d : x;
    float* to = dst + r * ld + d;
    if (vec == 4) {
      cp_async16(reinterpret_cast<bf16*>(to),
                 reinterpret_cast<const bf16*>(src), valid);
    } else {
      *to = valid ? *src : 0.0f;
    }
  }
}

// hi and lo bf16 parts of two fp32 values, each pair packed as one mma
// operand register (the lower index in the low half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - back.x, x1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// hi and lo of `count` fp32 values (split2's, in place of dout's);
// `vec4`: four per thread step, the pointers 16-byte aligned.
__global__ void gmm_split_dout_kernel(const float* __restrict__ x,
                                      bf16* __restrict__ hi,
                                      bf16* __restrict__ lo, int64_t count,
                                      int vec4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec4) {
    for (; 4 * i < count; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      uint2 h, l;
      split2(v.x, v.y, h.x, l.x);
      split2(v.z, v.w, h.y, l.y);
      reinterpret_cast<uint2*>(hi)[i] = h;
      reinterpret_cast<uint2*>(lo)[i] = l;
    }
    return;
  }
  for (; i < count; i += stride) {
    const bf16 h = __float2bfloat16_rn(x[i]);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(x[i] - __bfloat162float(h));
  }
}

// Four 8 x 8 bf16 matrices, transposed on the way: lanes 8 i .. 8 i + 7
// give the row addresses of matrix i, register i receives it.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

constexpr int kThreadsMma = 128;  // 4 warps, 2 x 2 over a 64 x 128 tile
constexpr int kBM = 64, kBN = 128, kBK = 32;

// Store a warp's 32 x 64 quarter of a 64 x 128 fp32 accumulator tile into
// rows [0, rows) and columns [0, cols) of a row-major matrix `ld` apart,
// rounded to bf16.
__device__ __forceinline__ void store_quarter(bf16* dst, int64_t ld,
                                              const float (&acc)[2][8][4],
                                              int rows, int cols, int wm,
                                              int wn, int g, int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 32 * wm + 16 * i + g + 8 * half;
      if (row >= rows) continue;
      bf16* to = dst + row * ld;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * wn + 8 * j + 2 * c;
        if (col < cols) to[col] = __float2bfloat16_rn(acc[i][j][2 * half]);
        if (col + 1 < cols)
          to[col + 1] = __float2bfloat16_rn(acc[i][j][2 * half + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ bf16 dlhs ----

constexpr int kLdDout = kBK + 8;  // fp32: rows 8 banks apart for float2
constexpr int kLdRhs = kBK + kRowPad;

__global__ void __launch_bounds__(kThreadsMma)
    gmm_dlhs_mma_kernel(const float* __restrict__ dout,
                         const bf16* __restrict__ rhs,
                         const int* __restrict__ group_sizes,
                         bf16* __restrict__ dlhs, int m, int k, int n,
                         int n_groups, int vec_d, int vec_r) {
  const TileRows tr = find_tile<kBM>(group_sizes, n_groups, m);
  if (tr.lo >= tr.hi) return;
  const int rows = tr.hi - tr.lo;
  const int k0 = blockIdx.y * kBN;  // this tile's columns of dlhs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wm = warp / 2, wn = warp % 2;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] =
        acc[i][j][3] = 0.0f;

  if (tr.g >= 0) {
    __shared__ __align__(16) float d_tile[2][kBM * kLdDout];
    __shared__ __align__(16) bf16 r_tile[2][kBN * kLdRhs];
    const float* d_rows = dout + static_cast<int64_t>(tr.lo) * n;
    const bf16* r_rows = rhs + (static_cast<int64_t>(tr.g) * k + k0) * n;
    auto stage = [&](int buf, int n0) {
      stage_rows_f32(d_tile[buf], kLdDout, d_rows + n0, n, 0, kBM, rows,
                     n - n0, kBK, vec_d);
      stage_rows(r_tile[buf], kLdRhs, r_rows + n0, n, 0, kBN, k - k0, n - n0,
                 kBK, vec_r);
    };
    const int n_tiles = (n + kBK - 1) / kBK;
    if (n_tiles > 0) stage(0, 0);
    cp_async_commit();
    for (int nt = 0; nt < n_tiles; ++nt) {
      if (nt + 1 < n_tiles) stage((nt + 1) & 1, (nt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* dt = d_tile[nt & 1] + (32 * wm) * kLdDout;
      const bf16* rt = r_tile[nt & 1] + (64 * wn) * kLdRhs;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t hi[2][4], lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* r = dt + (16 * i + g) * kLdDout + 16 * ks + 2 * c;
          const float2 v0 = *reinterpret_cast<const float2*>(r);
          const float2 v1 =
              *reinterpret_cast<const float2*>(r + 8 * kLdDout);
          const float2 v2 = *reinterpret_cast<const float2*>(r + 8);
          const float2 v3 =
              *reinterpret_cast<const float2*>(r + 8 * kLdDout + 8);
          split2(v0.x, v0.y, hi[i][0], lo[i][0]);
          split2(v1.x, v1.y, hi[i][1], lo[i][1]);
          split2(v2.x, v2.y, hi[i][2], lo[i][2]);
          split2(v3.x, v3.y, hi[i][3], lo[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // column 8 j + g of dlhs is row 8 j + g of rhs[g]'s tile
          const bf16* r = rt + (8 * j + g) * kLdRhs + 16 * ks + 2 * c;
          const uint32_t b[2] = {ld32(r), ld32(r + 8)};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_16816(acc[i][j], lo[i], b);
            mma_16816(acc[i][j], hi[i], b);
          }
        }
      }
      __syncthreads();
    }
  }
  // rows of this tile only (zeros past the last group); columns past k
  // dropped
  store_quarter(dlhs + static_cast<int64_t>(tr.lo) * k + k0, k, acc, rows,
                k - k0, wm, wn, g, c);
}

// ------------------------------------------------------------ bf16 drhs ----

constexpr int kRK = 64, kRN = 128, kRM = 32;  // drhs tile K x N, row step
constexpr int kLdLhs = kRK + kRowPad;
constexpr int kLdDoutT = kRN + 4;  // fp32: rows 2c, 2c + 1 in distinct banks

__global__ void __launch_bounds__(kThreadsMma)
    gmm_drhs_mma_kernel(const bf16* __restrict__ lhs,
                         const float* __restrict__ dout,
                         const int* __restrict__ group_sizes,
                         bf16* __restrict__ drhs, int m, int k, int n,
                         int vec_l, int vec_d) {
  const TileRows gr = group_rows(group_sizes, blockIdx.z, m);
  const int rows = gr.hi - gr.lo;
  const int k0 = blockIdx.y * kRK, n0 = blockIdx.x * kRN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wm = warp / 2, wn = warp % 2;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] =
        acc[i][j][3] = 0.0f;

  if (rows > 0) {
    __shared__ __align__(16) bf16 l_tile[2][kRM * kLdLhs];
    __shared__ __align__(16) float d_tile[2][kRM * kLdDoutT];
    const bf16* l_cols = lhs + static_cast<int64_t>(gr.lo) * k + k0;
    const float* d_cols = dout + static_cast<int64_t>(gr.lo) * n + n0;
    auto stage = [&](int buf, int r0) {
      stage_rows(l_tile[buf], kLdLhs, l_cols, k, r0, kRM, rows, k - k0, kRK,
                 vec_l);
      stage_rows_f32(d_tile[buf], kLdDoutT, d_cols, n, r0, kRM, rows, n - n0,
                     kRN, vec_d);
    };
    // ldmatrix.x4.trans of lhs^T's 16 x 16 A fragment (rows k, columns the
    // group's rows): matrices (k 0-7, rows 0-7), (k 8-15, rows 0-7),
    // (k 0-7, rows 8-15), (k 8-15, rows 8-15), lanes 8 i .. 8 i + 7 giving
    // the row addresses of matrix i
    const int a_row = (lane & 7) + ((lane >> 4) << 3);
    const int a_col = 32 * wm + ((lane >> 3) & 1) * 8;
    const int r_tiles = (rows + kRM - 1) / kRM;
    stage(0, 0);
    cp_async_commit();
    for (int rt = 0; rt < r_tiles; ++rt) {
      if (rt + 1 < r_tiles) stage((rt + 1) & 1, (rt + 1) * kRM);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* lt = l_tile[rt & 1];
      const float* dt = d_tile[rt & 1] + 64 * wn;
#pragma unroll
      for (int ks = 0; ks < kRM / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_trans(a[i], lt + (16 * ks + a_row) * kLdLhs + a_col +
                                  16 * i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // B (rows x N): b[0] rows 2c, 2c + 1 of column 8 j + g, b[1]
          // rows 8 + 2c, 9 + 2c
          const float* col = dt + (16 * ks + 2 * c) * kLdDoutT + 8 * j + g;
          uint32_t hi[2], lo[2];
          split2(col[0], col[kLdDoutT], hi[0], lo[0]);
          split2(col[8 * kLdDoutT], col[9 * kLdDoutT], hi[1], lo[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_16816(acc[i][j], a[i], lo);
            mma_16816(acc[i][j], a[i], hi);
          }
        }
      }
      __syncthreads();
    }
  }
  store_quarter(drhs + (static_cast<int64_t>(blockIdx.z) * k + k0) * n + n0,
                n, acc, k - k0, n - n0, wm, wn, g, c);
}

// ---------------------------------------------------------------- fp32 ----

constexpr int kFT = 64, kFK = 16;
constexpr int kThreadsF = 256;  // 16 x 16, a 4 x 4 output tile each

// acc (this thread's 4 x 4 of a 64 x 64 tile) += A . B over `depth`, where
// a_at(i, d) gives A's element (tile row i, reduction index d) and
// b_at(d, j) B's (reduction index d, tile column j), each 0 out of range.
template <typename LoadA, typename LoadB>
__device__ __forceinline__ void fp32_tile(float (&acc)[4][4], int depth,
                                          LoadA a_at, LoadB b_at) {
  __shared__ float a_t[kFK][kFT + 4];  // a_t[d][i]
  __shared__ float b_t[kFK][kFT + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int d0 = 0; d0 < depth; d0 += kFK) {
    for (int idx = threadIdx.x; idx < kFT * kFK; idx += kThreadsF) {
      // consecutive threads on consecutive reduction indices of A and on
      // consecutive columns of B, as the callers' layouts want
      const int i = idx / kFK, d = idx % kFK;
      a_t[d][i] = d0 + d < depth ? a_at(i, d0 + d) : 0.0f;
      const int bd = idx / kFT, j = idx % kFT;
      b_t[bd][j] = d0 + bd < depth ? b_at(d0 + bd, j) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kFK; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_t[d][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_t[d][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_f32(float* dst, int64_t ld,
                                          const float (&acc)[4][4], int rows,
                                          int cols) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * tx + j;
      if (col < cols) dst[row * ld + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreadsF)
    gmm_dlhs_fp32_kernel(const float* __restrict__ dout,
                         const float* __restrict__ rhs,
                         const int* __restrict__ group_sizes,
                         float* __restrict__ dlhs, int m, int k, int n,
                         int n_groups) {
  const TileRows tr = find_tile<kFT>(group_sizes, n_groups, m);
  if (tr.lo >= tr.hi) return;
  const int rows = tr.hi - tr.lo, k0 = blockIdx.y * kFT;
  float acc[4][4] = {};
  if (tr.g >= 0) {
    const float* d_rows = dout + static_cast<int64_t>(tr.lo) * n;
    const float* r_rows = rhs + (static_cast<int64_t>(tr.g) * k + k0) * n;
    fp32_tile(
        acc, n,
        [&](int i, int d) {
          return i < rows ? d_rows[static_cast<int64_t>(i) * n + d] : 0.0f;
        },
        // B[d][j] = rhs[g][k0 + j][d]
        [&](int d, int j) {
          return k0 + j < k ? r_rows[static_cast<int64_t>(j) * n + d] : 0.0f;
        });
  }
  store_f32(dlhs + static_cast<int64_t>(tr.lo) * k + k0, k, acc, rows,
            k - k0);
}

__global__ void __launch_bounds__(kThreadsF)
    gmm_drhs_fp32_kernel(const float* __restrict__ lhs,
                         const float* __restrict__ dout,
                         const int* __restrict__ group_sizes,
                         float* __restrict__ drhs, int m, int k, int n) {
  const TileRows gr = group_rows(group_sizes, blockIdx.z, m);
  const int rows = gr.hi - gr.lo;
  const int k0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  float acc[4][4] = {};
  const float* l_rows = lhs + static_cast<int64_t>(gr.lo) * k + k0;
  const float* d_rows = dout + static_cast<int64_t>(gr.lo) * n + n0;
  fp32_tile(
      acc, rows,
      // A[i][d] = lhs[lo + d][k0 + i]
      [&](int i, int d) {
        return k0 + i < k ? l_rows[static_cast<int64_t>(d) * k + i] : 0.0f;
      },
      [&](int d, int j) {
        return n0 + j < n ? d_rows[static_cast<int64_t>(d) * n + j] : 0.0f;
      });
  store_f32(drhs + (static_cast<int64_t>(blockIdx.z) * k + k0) * n + n0, n,
            acc, k - k0, n - n0);
}

}  // namespace

// dout (m, n) float32, rhs (n_groups, k, n) and dlhs (m, k) of one type,
// dtype 0 = float32, 1 = bfloat16, all contiguous; group_sizes (n_groups,)
// int32 on the device. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int grouped_matmul_bwd_dlhs(const void* dout, const void* rhs,
                                       const void* group_sizes, void* dlhs,
                                       int m, int k, int n, int n_groups,
                                       int dtype, void* stream) {
  if (m < 0 || k < 0 || n < 0 || n_groups < 1 || n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || k == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  const float* d = static_cast<const float*>(dout);
  if (dtype == 0) {
    const dim3 grid((m + kFT - 1) / kFT + n_groups, (k + kFT - 1) / kFT);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    gmm_dlhs_fp32_kernel<<<grid, kThreadsF, 0, s>>>(
        d, static_cast<const float*>(rhs), sizes, static_cast<float*>(dlhs),
        m, k, n, n_groups);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kBM - 1) / kBM + n_groups, (k + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gmm_dlhs_mma_kernel<<<grid, kThreadsMma, 0, s>>>(
      d, static_cast<const bf16*>(rhs), sizes, static_cast<bf16*>(dlhs), m,
      k, n, n_groups, row_vec<float>(dout, n), row_vec<bf16>(rhs, n));
  return static_cast<int>(cudaGetLastError());
}

// lhs (m, k) and drhs (n_groups, k, n) of one type, dtype 0 = float32,
// 1 = bfloat16, dout (m, n) float32, all contiguous; group_sizes
// (n_groups,) int32 on the device. Every element of drhs is written.
// Returns a cudaError_t value; 0 on a clean launch.
extern "C" int grouped_matmul_bwd_drhs(const void* lhs, const void* dout,
                                       const void* group_sizes, void* drhs,
                                       int m, int k, int n, int n_groups,
                                       int dtype, void* stream) {
  if (m < 0 || k < 0 || n < 0 || n_groups < 1 || n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  const float* d = static_cast<const float*>(dout);
  if (dtype == 0) {
    const dim3 grid((n + kFT - 1) / kFT, (k + kFT - 1) / kFT, n_groups);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    gmm_drhs_fp32_kernel<<<grid, kThreadsF, 0, s>>>(
        static_cast<const float*>(lhs), d, sizes, static_cast<float*>(drhs),
        m, k, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRN - 1) / kRN, (k + kRK - 1) / kRK, n_groups);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gmm_drhs_mma_kernel<<<grid, kThreadsMma, 0, s>>>(
      static_cast<const bf16*>(lhs), d, sizes, static_cast<bf16*>(drhs), m,
      k, n, row_vec<bf16>(lhs, k), row_vec<float>(dout, n));
  return static_cast<int>(cudaGetLastError());
}

// dout (count fp32 values) into hi and lo (count bf16 each), all on the
// device: hi = bf16(x), lo = bf16(x - hi), each rounded to nearest even.
// Returns a cudaError_t value; 0 on a clean launch.
extern "C" int grouped_matmul_split_dout(const void* dout, void* hi,
                                         void* lo, int64_t count,
                                         void* stream) {
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  const int vec4 = count % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(dout) |
                    reinterpret_cast<uintptr_t>(hi) |
                    reinterpret_cast<uintptr_t>(lo)) % 16 == 0;
  const int64_t items = vec4 ? count / 4 : count;
  const int threads = 256;
  const int64_t blocks = (items + threads - 1) / threads;
  gmm_split_dout_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                          threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<bf16*>(hi),
      static_cast<bf16*>(lo), count, vec4);
  return static_cast<int>(cudaGetLastError());
}
