// Grouped matmul over expert-sorted rows, forward (K5-fwd).
//
// Replaces: the megablox `gmm` Pallas kernel
// (jax/experimental/pallas/ops/tpu/megablox/gmm.py `gmm`, pallas_call
// `_gmm`), which deepearth_tpu/ops/moe.py `ragged_expert_ffn` calls three
// times per MoE layer (gate, up and down projections of the experts).
//
// Computes out[r] = lhs[r] . rhs[g(r)] for every row r, where g(r) is the
// group whose rows [offset_g, offset_g + size_g) hold r and offset_g is the
// sum of the sizes before g. Shapes: lhs (M, K), rhs (E, K, N), both float32
// or both bfloat16, contiguous; group_sizes (E,) int32 on the device; out
// (M, N) float32 (megablox's preferred_element_type=float32). Rows past the
// sum of the sizes come out 0; a group running past M is cut at M.
//
// Bound on the H100: the flagship's simulator at a request of 64
// observations sends M = 2816 sorted rows through E = 8 experts of
// K = N = 2048 in bf16: 23.6 GFLOP, 0.024 ms at 989 TFLOP/s, against 101 MB
// to move (67 MB of weights, 11.5 MB in, 23 MB of fp32 out), 0.030 ms at
// 3.35 TB/s. Both bounds are near; the weights dominate the bytes.
//
// Schedule: no host synchronisation. Every block reads group_sizes itself
// (into shared memory; E <= kMaxGroups) and walks the groups to find its
// row tile: group g owns ceil(size_g / kBM) tiles of kBM rows, starting at
// offset_g, and the rows past the last group form one more (zero-filled)
// segment. That is at most ceil(M / kBM) + E tiles, so the host launches
// that many along x and the surplus blocks exit at once (megablox computes
// the same tile -> group table with make_group_metadata on the TPU, and
// pads each group to its 128-row tiles; nothing is padded here). A tile
// whose last rows belong to the next group masks them: their lhs rows load
// as zeros and their outputs are not stored.
//
// bf16 design: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
// accumulate). A block of 4 warps owns a 64 x 128 output tile, each warp a
// 32 x 64 quarter of it (2 x 8 accumulator fragments in registers). lhs and
// the group's rhs stream through shared memory in k-tiles of 32, double
// buffered with cp.async so that tile i + 1 loads while tile i is
// multiplied; rhs's B fragments come out of its row-major (k, n) tile by
// ldmatrix.trans. The fp32 sums are rounded nowhere: the output is fp32.
//
// fp32 design (exact fp32 products, for the tests): 256 threads on the CUDA
// cores per 64 x 64 output tile, k-tiles of 16 staged in shared memory,
// each thread accumulating a 4 x 4 register tile with fmaf in k order.
//
// Simple first: no wgmma, TMA or fused SwiGLU epilogue yet (PERF.md).

#include "grouped_matmul.cuh"

namespace {

// ---------------------------------------------------------------- bf16 ----

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kThreadsMma = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kLdA = kBK + kRowPad, kLdB = kBN + kRowPad;

__global__ void __launch_bounds__(kThreadsMma)
    grouped_matmul_bf16_kernel(const bf16* __restrict__ lhs,
                               const bf16* __restrict__ rhs,
                               const int* __restrict__ group_sizes,
                               float* __restrict__ out, int m, int k, int n,
                               int n_groups, int vec_a, int vec_b) {
  const TileRows tr = find_tile<kBM>(group_sizes, n_groups, m);
  if (tr.lo >= tr.hi) return;
  const int rows = tr.hi - tr.lo;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wm = warp / 2, wn = warp % 2;  // 32-row, 64-column quarter

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] =
        acc[i][j][3] = 0.0f;

  if (tr.g >= 0) {
    __shared__ __align__(16) bf16 a_tile[2][kBM * kLdA];
    __shared__ __align__(16) bf16 b_tile[2][kBK * kLdB];
    const bf16* a_rows = lhs + static_cast<int64_t>(tr.lo) * k;
    const bf16* b_cols = rhs + static_cast<int64_t>(tr.g) * k * n + n0;
    const int n_width = n - n0;
    auto stage = [&](int buf, int k0) {
      stage_rows(a_tile[buf], kLdA, a_rows + k0, k, 0, kBM, rows, k - k0,
                 kBK, vec_a);
      stage_rows(b_tile[buf], kLdB, b_cols + static_cast<int64_t>(k0) * n, n,
                 0, kBK, k - k0, n_width, kBN, vec_b);
    };
    const int k_tiles = (k + kBK - 1) / kBK;
    if (k_tiles > 0) stage(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < k_tiles; ++kt) {
      if (kt + 1 < k_tiles) stage((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* at = a_tile[kt & 1] + (32 * wm) * kLdA;
      const bf16* bt = b_tile[kt & 1] + 64 * wn;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bf16* r = at + (16 * i + g) * kLdA + 16 * ks + 2 * c;
          a[i][0] = ld32(r);
          a[i][1] = ld32(r + 8 * kLdA);
          a[i][2] = ld32(r + 8);
          a[i][3] = ld32(r + 8 * kLdA + 8);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b[2];
          ldsm_x2_trans(b, bt + (16 * ks + (lane & 15)) * kLdB + 8 * j);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_16816(acc[i][j], a[i], b);
        }
      }
      __syncthreads();
    }
  }

  // rows of this group only; columns past n dropped
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 32 * wm + 16 * i + g + 8 * half;
      if (row >= rows) continue;
      float* dst = out + static_cast<int64_t>(tr.lo + row) * n;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + 64 * wn + 8 * j + 2 * c;
        if (col < n) dst[col] = acc[i][j][2 * half];
        if (col + 1 < n) dst[col + 1] = acc[i][j][2 * half + 1];
      }
    }
  }
}

// ---------------------------------------------------------------- fp32 ----

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kThreadsF = 256;  // 16 x 16, a 4 x 4 output tile each

__global__ void __launch_bounds__(kThreadsF)
    grouped_matmul_fp32_kernel(const float* __restrict__ lhs,
                               const float* __restrict__ rhs,
                               const int* __restrict__ group_sizes,
                               float* __restrict__ out, int m, int k, int n,
                               int n_groups) {
  const TileRows tr = find_tile<kFM>(group_sizes, n_groups, m);
  if (tr.lo >= tr.hi) return;
  const int rows = tr.hi - tr.lo;
  const int n0 = blockIdx.y * kFN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __shared__ float a_t[kFK][kFM + 4];  // transposed: a_t[kk][row]
  __shared__ float b_t[kFK][kFN + 4];
  float acc[4][4] = {};
  if (tr.g >= 0) {
    const float* a_rows = lhs + static_cast<int64_t>(tr.lo) * k;
    const float* b_cols = rhs + static_cast<int64_t>(tr.g) * k * n + n0;
    for (int k0 = 0; k0 < k; k0 += kFK) {
      for (int idx = threadIdx.x; idx < kFM * kFK; idx += kThreadsF) {
        const int r = idx / kFK, kk = idx % kFK;
        a_t[kk][r] = r < rows && k0 + kk < k
                         ? a_rows[static_cast<int64_t>(r) * k + k0 + kk]
                         : 0.0f;
      }
      for (int idx = threadIdx.x; idx < kFK * kFN; idx += kThreadsF) {
        const int kk = idx / kFN, col = idx % kFN;
        b_t[kk][col] =
            k0 + kk < k && n0 + col < n
                ? b_cols[static_cast<int64_t>(k0 + kk) * n + col]
                : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_t[kk][4 * ty + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = b_t[kk][4 * tx + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    if (row >= rows) continue;
    float* dst = out + static_cast<int64_t>(tr.lo + row) * n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col < n) dst[col] = acc[i][j];
    }
  }
}

}  // namespace

// lhs (m, k) and rhs (n_groups, k, n) contiguous, dtype 0 = float32,
// 1 = bfloat16; group_sizes (n_groups,) int32 on the device; out (m, n)
// float32 contiguous. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int grouped_matmul_fwd(const void* lhs, const void* rhs,
                                  const void* group_sizes, void* out, int m,
                                  int k, int n, int n_groups, int dtype,
                                  void* stream) {
  if (m < 0 || k < 0 || n < 0 || n_groups < 1 || n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  if (dtype == 0) {
    const dim3 grid((m + kFM - 1) / kFM + n_groups, (n + kFN - 1) / kFN);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    grouped_matmul_fp32_kernel<<<grid, kThreadsF, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs), sizes,
        static_cast<float*>(out), m, k, n, n_groups);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kBM - 1) / kBM + n_groups, (n + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  grouped_matmul_bf16_kernel<<<grid, kThreadsMma, 0, s>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), sizes,
      static_cast<float*>(out), m, k, n, n_groups, row_vec<bf16>(lhs, k),
      row_vec<bf16>(rhs, n));
  return static_cast<int>(cudaGetLastError());
}
