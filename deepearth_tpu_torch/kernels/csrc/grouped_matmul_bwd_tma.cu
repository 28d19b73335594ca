// Grouped matmul backward (K5-bwd), the TMA route: wgmma over TMA-fed,
// 128-byte-swizzled tiles, for bf16 lhs/rhs whose K and N are multiples of
// 8 (TMA's 16-byte row strides). Other shapes, and fp32, take the kernels
// of grouped_matmul_bwd.cu; kernels.gmm_bwd_tma_route chooses from the
// shapes alone.
//
// Replaces: the megablox VJP `_gmm_bwd`
// (jax/experimental/pallas/ops/tpu/megablox/ops.py:63): `gmm(grad, rhs,
// ..., transpose_rhs=True)` (ops.py:80) for dlhs and `tgmm` (ops.py:90;
// gmm.py:573, pallas_call :763) for drhs, reached from
// deepearth_tpu/ops/moe.py `ragged_expert_ffn` (:359, :362, :366).
//
// dout is fp32 and stays so in the product: grouped_matmul_bwd.cu's
// split kernel writes it once as two bf16 tensors, hi = bf16(x) and
// lo = bf16(x - hi), and every k-step here runs two wgmma (hi and lo)
// into one fp32 accumulator against the same bf16 operand. The values are
// those of the mma.sync route's in-register split, so the output rounds
// as before (once, to bf16).
//
// Bound on the H100 at the flagship simulator's B=64 shape (M = 2816,
// E = 8, K = N = 2048): each gradient is two products of 23.6 GFLOP,
// 0.0477 ms at 989 TFLOP/s, against ~102 MB of bytes (0.030 ms at
// 3.35 TB/s): the tensor cores bound it. The design keeps them fed:
//  - one producer warp issues TMA loads into a ring of 48 KB stages (4 for
//    dlhs, 3 for drhs; mbarriers full / empty); two consumer warpgroups
//    (64 rows of the 128 x 128 output tile each) issue wgmma as stages
//    land, one wgmma group in flight while the next stage is awaited;
//  - persistent blocks, one per SM, walk the output tiles, so the producer
//    runs ahead into the next tile while the consumers store this one;
//  - drhs's 67 MB of output leaves through shared memory by TMA stores
//    that run on under the next tile's mainloop (stored from registers, 4
//    bytes a thread, with 4 stages, the kernel took 0.119 ms at the
//    flagship shape on an H100, against 0.090 so). dlhs (11.5 MB) stores
//    from registers, since a TMA store could not stop at a group's last
//    row.
//
// dlhs[r] = (hi[r] + lo[r]) . rhs[g]^T: A = the hi or lo rows (K-major,
// the reduction n contiguous), B = rhs[g]'s (K, N) rows (K-major). Row
// tiles of 128 per group from its first row (find_tile's walk: no tile
// mixes two groups, the rows past the last group one more segment, stored
// as zeros), tiles in row-major order so that the blocks in flight share
// rhs[g]'s slab in L2. A tile's rows past its group's end load the next
// group's dout but are never stored: a dlhs row depends on its own row
// alone.
//
// drhs[g] = lhs[rows of g]^T . (hi + lo)[rows of g]: the reduction runs
// over the group's rows, the strided dim of both operands, so A (lhs^T)
// and B (hi, lo) are MN-major. One block owns an output tile (128 x 128 of
// (K, N)) over all its group's rows: no split-K, no atomics, the same bits
// every run. Groups are walked largest first. The last row step of a group
// reaches into the next group's rows (or past M, where TMA gives zeros);
// each consumer zeroes those rows of its lhs tile in shared memory before
// its wgmma reads it, so they add nothing. An empty group's tiles are
// stored as zeros.

#include "grouped_matmul.cuh"
#include "hopper_gemm.cuh"

namespace {

using namespace hopper;
using hopper_host::launch_persistent;
using hopper_host::matrix_map;

constexpr int kTM = 128, kTN = 128;  // output tile
constexpr int kTK = 64;              // reduction per stage (one swizzled row)
constexpr int kBox = 64 * kTileRowBytes;      // a 64-row box, 8 KB
constexpr int kPart = 2 * kBox;               // 128 rows, 16 KB
constexpr int kStageBytes = 3 * kPart;        // 48 KB
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerWarps = 8;
// dlhs: 4 stages; drhs: 3 and its output tile (2 x 16 KB), staged for the
// TMA store. With the tables in static shared memory both fit in 227 KB.
constexpr int kDlhsStages = 4, kDrhsStages = 3;
constexpr int kDrhsOut = 2 * kPart;

// Stores a consumer warpgroup's 64 x 128 accumulator, rounded to bf16,
// into rows [0, rows) and columns [0, cols) of a row-major matrix `ld`
// apart (cols even, ld even: 4-byte stores).
__device__ __forceinline__ void store_tile(bf16* dst, int64_t ld,
                                           const float (&acc)[64], int rows,
                                           int cols) {
  const int t = threadIdx.x % 128;
  const int row0 = 16 * (t / 32) + (t % 32) / 4, col0 = 2 * (t % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= rows) continue;
    bf16* to = dst + row * ld;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + col0;
      if (col < cols)
        *reinterpret_cast<uint32_t*>(to + col) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Writes a consumer warpgroup's 64 x 128 accumulator, rounded to bf16, into
// `out` as two 64 x 64 boxes (columns 0-63, 64-127) in TMA's 128-byte
// swizzle: the 16-byte chunk c of row r at chunk c ^ (r % 8), which also
// keeps each warp's 4-byte stores on 32 distinct banks.
__device__ __forceinline__ void stage_out(uint8_t* out,
                                          const float (&acc)[64]) {
  const int t = threadIdx.x % 128;
  const int row0 = 16 * (t / 32) + (t % 32) / 4, word = t % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(
          out + (j / 8) * kBox + row * kTileRowBytes +
          ((j % 8) ^ (row % 8)) * 16 + 4 * word) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// ------------------------------------------------------------------ dlhs ----

__global__ void __launch_bounds__(kThreads, 1)
    gmm_dlhs_wgmma_kernel(const __grid_constant__ CUtensorMap map_hi,
                          const __grid_constant__ CUtensorMap map_lo,
                          const __grid_constant__ CUtensorMap map_rhs,
                          const int* __restrict__ group_sizes,
                          bf16* __restrict__ dlhs, int m, int k, int n,
                          int n_groups) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int sizes[kMaxGroups];
  __shared__ int tile_start[kMaxGroups + 2], row_start[kMaxGroups + 2];
  for (int e = threadIdx.x; e < n_groups; e += blockDim.x)
    sizes[e] = max(group_sizes[e], 0);
  __syncthreads();
  auto ring =
      make_ring<kDlhsStages>(smem_raw, kStageBytes, 0, 1, kConsumerWarps);
  if (threadIdx.x == 0)
    row_tile_tables<kTM>(sizes, n_groups, m, tile_start, row_start);
  __syncthreads();
  const int col_tiles = (k + kTN - 1) / kTN;
  const int n_tiles = tile_start[n_groups + 1] * col_tiles;
  const int steps = (n + kTK - 1) / kTK;

  if (threadIdx.x >= 256) {  // producer: one thread issues every load
    if (threadIdx.x == 256) {
      Cursor<kDlhsStages> at;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const TileRows tr =
            row_tile<kTM>(t / col_tiles, tile_start, row_start, n_groups);
        if (tr.g < 0) continue;
        const int k0 = (t % col_tiles) * kTN;
        for (int s = 0; s < steps; ++s, at.next()) {
          mbar_wait(&ring.empty[at.stage], at.phase ^ 1);
          uint8_t* st = ring.tiles + at.stage * kStageBytes;
          uint64_t* full = &ring.full[at.stage];
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(st, &map_hi, full, s * kTK, tr.lo);
          tma_load_2d(st + kPart, &map_lo, full, s * kTK, tr.lo);
          tma_load_3d(st + 2 * kPart, &map_rhs, full, s * kTK, k0, tr.g);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128;
  Cursor<kDlhsStages> at;
  float acc[64];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const TileRows tr =
        row_tile<kTM>(t / col_tiles, tile_start, row_start, n_groups);
    const int k0 = (t % col_tiles) * kTN;
    zero_acc(acc);
    if (tr.g >= 0 && steps > 0) {
      int last = 0;
      for (int s = 0; s < steps; ++s, at.next()) {
        mbar_wait(&ring.full[at.stage], at.phase);
        const uint8_t* st = ring.tiles + at.stage * kStageBytes;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kTK / 16; ++j) {
          const uint64_t b = sw128_desc(st + 2 * kPart + 32 * j, 16, 1024);
          wgmma_m64n128k16<0, 0>(
              acc, sw128_desc(st + wg * kBox + 32 * j, 16, 1024), b);
          wgmma_m64n128k16<0, 0>(
              acc, sw128_desc(st + kPart + wg * kBox + 32 * j, 16, 1024), b);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(acc);
        if (s > 0) release(ring, last);
        last = at.stage;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      release(ring, last);
    }
    const int rows = tr.hi - tr.lo - 64 * wg;
    if (rows > 0)
      store_tile(dlhs + (static_cast<int64_t>(tr.lo) + 64 * wg) * k + k0, k,
                 acc, rows, k - k0);
  }
}

// ------------------------------------------------------------------ drhs ----

__global__ void __launch_bounds__(kThreads, 1)
    gmm_drhs_wgmma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                          const __grid_constant__ CUtensorMap map_hi,
                          const __grid_constant__ CUtensorMap map_lo,
                          const __grid_constant__ CUtensorMap map_drhs,
                          const int* __restrict__ group_sizes, int m, int k,
                          int n, int n_groups) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int sizes[kMaxGroups];
  __shared__ int order[kMaxGroups];  // groups by size, largest first
  __shared__ int row_start[kMaxGroups + 1];
  for (int e = threadIdx.x; e < n_groups; e += blockDim.x)
    sizes[e] = max(group_sizes[e], 0);
  __syncthreads();
  auto ring = make_ring<kDrhsStages>(smem_raw, kStageBytes, kDrhsOut, 1,
                                     kConsumerWarps);
  for (int e = threadIdx.x; e < n_groups; e += blockDim.x) {
    int rank = 0;
    for (int f = 0; f < n_groups; ++f)
      rank += sizes[f] > sizes[e] || (sizes[f] == sizes[e] && f < e);
    order[rank] = e;
  }
  if (threadIdx.x == 0) {
    int start = 0;
    for (int e = 0; e < n_groups; ++e) {
      row_start[e] = start;
      const int64_t stop = static_cast<int64_t>(start) + sizes[e];
      start = stop < m ? static_cast<int>(stop) : m;
    }
    row_start[n_groups] = start;
  }
  __syncthreads();
  const int k_tiles = (k + kTM - 1) / kTM, n_tiles = (n + kTN - 1) / kTN;
  const int per_group = k_tiles * n_tiles;
  const int all_tiles = n_groups * per_group;

  if (threadIdx.x >= 256) {  // producer
    if (threadIdx.x == 256) {
      Cursor<kDrhsStages> at;
      for (int t = blockIdx.x; t < all_tiles; t += gridDim.x) {
        const int g = order[t / per_group], within = t % per_group;
        const int k0 = (within / n_tiles) * kTM, n0 = (within % n_tiles) * kTN;
        for (int r = row_start[g]; r < row_start[g + 1]; r += kTK, at.next()) {
          mbar_wait(&ring.empty[at.stage], at.phase ^ 1);
          uint8_t* st = ring.tiles + at.stage * kStageBytes;
          uint64_t* full = &ring.full[at.stage];
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(st, &map_lhs, full, k0, r);
          tma_load_2d(st + kBox, &map_lhs, full, k0 + 64, r);
          tma_load_2d(st + kPart, &map_hi, full, n0, r);
          tma_load_2d(st + kPart + kBox, &map_hi, full, n0 + 64, r);
          tma_load_2d(st + 2 * kPart, &map_lo, full, n0, r);
          tma_load_2d(st + 2 * kPart + kBox, &map_lo, full, n0 + 64, r);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns K rows [64 wg, 64 wg + 64) of the tile,
  // its lhs box the A operand, its half of the output buffer
  const int wg = threadIdx.x / 128;
  const bool issuer = threadIdx.x % 128 == 0;
  uint8_t* out = ring.tiles + kDrhsStages * kStageBytes + wg * kPart;
  Cursor<kDrhsStages> at;
  float acc[64];
  for (int t = blockIdx.x; t < all_tiles; t += gridDim.x) {
    const int g = order[t / per_group], within = t % per_group;
    const int k0 = (within / n_tiles) * kTM, n0 = (within % n_tiles) * kTN;
    const int end = row_start[g + 1];
    zero_acc(acc);
    if (row_start[g] < end) {
      int last = 0;
      for (int r = row_start[g]; r < end; r += kTK, at.next()) {
        mbar_wait(&ring.full[at.stage], at.phase);
        uint8_t* st = ring.tiles + at.stage * kStageBytes;
        uint8_t* a_box = st + wg * kBox;
        if (end - r < kTK) {
          // the rows past the group's end add nothing: zero them in this
          // warpgroup's lhs box (whole 128-byte rows, so the swizzle does
          // not matter), then hand the writes to the async proxy
          uint4* rows = reinterpret_cast<uint4*>(a_box + (end - r) *
                                                             kTileRowBytes);
          const int chunks = (kTK - (end - r)) * kTileRowBytes / 16;
          for (int i = threadIdx.x % 128; i < chunks; i += 128)
            rows[i] = make_uint4(0, 0, 0, 0);
          fence_proxy_async();
          named_barrier(1 + wg, 128);
        }
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kTK / 16; ++j) {
          const uint64_t a = sw128_desc(a_box + 2048 * j, kBox, 1024);
          wgmma_m64n128k16<1, 1>(
              acc, a, sw128_desc(st + kPart + 2048 * j, kBox, 1024));
          wgmma_m64n128k16<1, 1>(
              acc, a, sw128_desc(st + 2 * kPart + 2048 * j, kBox, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(acc);
        if (r > row_start[g]) release(ring, last);
        last = at.stage;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      release(ring, last);
    }
    // the epilogue: the tile through shared memory into a TMA store, which
    // runs on while the next tile's mainloop starts (its rows and columns
    // past K and N are not written)
    if (issuer) bulk_wait_read<0>();  // the last store has read `out`
    named_barrier(1 + wg, 128);
    stage_out(out, acc);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (issuer && k0 + 64 * wg < k) {
      tma_store_3d(&map_drhs, out, n0, k0 + 64 * wg, g);
      if (n0 + 64 < n)
        tma_store_3d(&map_drhs, out + kBox, n0 + 64, k0 + 64 * wg, g);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait<0>();
}

}  // namespace

// hi, lo (m, n) bf16 (dout's split), rhs (n_groups, k, n) bf16 and dlhs
// (m, k) bf16, all contiguous and 16-byte aligned, k and n multiples of 8,
// m >= 1; group_sizes (n_groups,) int32 on the device. Every row of dlhs
// is written. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int grouped_matmul_bwd_dlhs_tma(const void* hi, const void* lo,
                                           const void* rhs,
                                           const void* group_sizes,
                                           void* dlhs, int m, int k, int n,
                                           int n_groups, void* stream) {
  if (m < 1 || k < 8 || n < 8 || k % 8 || n % 8 || n_groups < 1 ||
      n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_hi, map_lo, map_rhs;
  const uint64_t dims[3] = {static_cast<uint64_t>(n),
                            static_cast<uint64_t>(k),
                            static_cast<uint64_t>(n_groups)};
  const uint64_t strides[2] = {static_cast<uint64_t>(n) * 2,
                               static_cast<uint64_t>(n) * k * 2};
  const uint32_t box[3] = {64, kTN, 1};
  if (!matrix_map(&map_hi, hi, m, n, kTM) ||
      !matrix_map(&map_lo, lo, m, n, kTM) ||
      !hopper_host::bf16_map(&map_rhs, rhs, 3, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  // at most ceil(m / 128) + n_groups row tiles (find_tile's count)
  const int64_t tiles = (static_cast<int64_t>(m + kTM - 1) / kTM + n_groups) *
                        ((k + kTN - 1) / kTN);
  if (tiles > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(gmm_dlhs_wgmma_kernel, static_cast<int>(tiles),
                           kThreads,
                           ring_smem_bytes(kDlhsStages, kStageBytes, 0),
                           static_cast<cudaStream_t>(stream), map_hi, map_lo,
                           map_rhs, static_cast<const int*>(group_sizes),
                           static_cast<bf16*>(dlhs), m, k, n, n_groups);
}

// lhs (m, k) bf16, hi, lo (m, n) bf16 (dout's split) and drhs
// (n_groups, k, n) bf16, all contiguous and 16-byte aligned, k and n
// multiples of 8, m >= 1; group_sizes (n_groups,) int32 on the device.
// Every element of drhs is written (an empty group's as 0). Returns a
// cudaError_t value; 0 on a clean launch.
extern "C" int grouped_matmul_bwd_drhs_tma(const void* lhs, const void* hi,
                                           const void* lo,
                                           const void* group_sizes,
                                           void* drhs, int m, int k, int n,
                                           int n_groups, void* stream) {
  if (m < 1 || k < 8 || n < 8 || k % 8 || n % 8 || n_groups < 1 ||
      n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_lhs, map_hi, map_lo, map_drhs;
  const uint64_t dims[3] = {static_cast<uint64_t>(n),
                            static_cast<uint64_t>(k),
                            static_cast<uint64_t>(n_groups)};
  const uint64_t strides[2] = {static_cast<uint64_t>(n) * 2,
                               static_cast<uint64_t>(n) * k * 2};
  const uint32_t box[3] = {64, 64, 1};
  if (!matrix_map(&map_lhs, lhs, m, k, kTK) ||
      !matrix_map(&map_hi, hi, m, n, kTK) ||
      !matrix_map(&map_lo, lo, m, n, kTK) ||
      !hopper_host::bf16_map(&map_drhs, drhs, 3, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>(n_groups) *
                        ((k + kTM - 1) / kTM) * ((n + kTN - 1) / kTN);
  if (tiles > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(gmm_drhs_wgmma_kernel, static_cast<int>(tiles),
                           kThreads,
                           ring_smem_bytes(kDrhsStages, kStageBytes,
                                           kDrhsOut),
                           static_cast<cudaStream_t>(stream), map_lhs, map_hi,
                           map_lo, map_drhs,
                           static_cast<const int*>(group_sizes), m, k, n,
                           n_groups);
}
