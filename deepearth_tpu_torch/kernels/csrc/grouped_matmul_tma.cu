// Grouped matmul forward (K5-fwd), the TMA route: wgmma over TMA-fed,
// 128-byte-swizzled tiles, for bf16 lhs/rhs whose K and N are multiples of
// 8 (TMA's 16-byte row strides). Other bf16 shapes take grouped_matmul.cu's
// mma.sync kernel, fp32 its CUDA-core kernel; kernels.gmm_fwd_tma_route
// chooses from the shapes alone.
//
// Replaces: the megablox `gmm` Pallas kernel
// (jax/experimental/pallas/ops/tpu/megablox/gmm.py `gmm` :314, pallas_call
// :526), reached from deepearth_tpu/ops/moe.py `ragged_expert_ffn` (:359,
// :362, :366: the experts' gate, up and down products).
//
// Computes what grouped_matmul.cu computes: out[r] = lhs[r] . rhs[g(r)],
// lhs (M, K) and rhs (E, K, N) bf16, group_sizes (E,) int32 on the device,
// out (M, N) fp32; rows past the last group 0; no host synchronisation.
//
// Bound on the H100 at the flagship simulator's B=64 shape (M = 2816,
// E = 8, K = N = 2048): 23.6 GFLOP (0.024 ms at 989 TFLOP/s) against
// ~101 MB to move (67 MB of weights, 11.5 MB of lhs, 23 MB of fp32 out;
// 0.030 ms at 3.35 TB/s): bytes bound it, narrowly. The design:
//  - persistent blocks, one per SM, walk the output tiles (128 rows of one
//    group by 128 columns) in row-major order, so that the blocks in flight
//    share rhs[g]'s slab in L2. Row tiles follow find_tile's walk
//    (row_tile_tables): no tile mixes two groups, the rows past the last
//    group form one more segment, stored as zeros;
//  - one producer warp issues TMA loads into a ring of 4 stages of 32 KB
//    (lhs's 128 x 64 box, K-major; rhs[g]'s 64 x 128 block, N contiguous:
//    MN-major, taken by wgmma's transpose bit); two consumer warpgroups
//    (64 rows each) issue wgmma.m64n128k16 as stages land, one group in
//    flight while the next stage is awaited;
//  - the 23 MB fp32 epilogue leaves through shared memory: each warpgroup
//    stages its 64 x 128 accumulator (rows padded by 8 floats, so the
//    stores spread over the banks), then its first 64 threads each send one
//    row by a bulk copy (cp.async.bulk, no tensor map), predicated per row:
//    a tile's rows past its group's end belong to the next group's tile and
//    are not written. The copies run on under the next tile's mainloop; the
//    staging buffer is reused once they have read it.
// A tile's rows past its group's end load the next group's lhs rows into
// the accumulator's tail but are never stored.

#include "grouped_matmul.cuh"
#include "hopper_gemm.cuh"

namespace {

using namespace hopper;
using hopper_host::launch_persistent;
using hopper_host::matrix_map;

constexpr int kTM = 128, kTN = 128;  // output tile
constexpr int kTK = 64;              // reduction per stage (one swizzled row)
constexpr int kBox = 64 * kTileRowBytes;  // a 64-row box, 8 KB
constexpr int kPart = 2 * kBox;           // 16 KB
constexpr int kStageBytes = 2 * kPart;    // lhs box, rhs block: 32 KB
constexpr int kStages = 4;
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerWarps = 8;
constexpr int kOutLd = kTN + 8;             // floats per staged output row
constexpr int kWgOut = 64 * kOutLd * 4;     // one warpgroup's rows, 34 KB
constexpr int kOutBytes = 2 * kWgOut;

__global__ void __launch_bounds__(kThreads, 1)
    gmm_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                         const __grid_constant__ CUtensorMap map_rhs,
                         const int* __restrict__ group_sizes,
                         float* __restrict__ out, int m, int k, int n,
                         int n_groups) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int sizes[kMaxGroups];
  __shared__ int tile_start[kMaxGroups + 2], row_start[kMaxGroups + 2];
  for (int e = threadIdx.x; e < n_groups; e += blockDim.x)
    sizes[e] = max(group_sizes[e], 0);
  __syncthreads();
  auto ring = make_ring<kStages>(smem_raw, kStageBytes, kOutBytes, 1,
                                 kConsumerWarps);
  if (threadIdx.x == 0)
    row_tile_tables<kTM>(sizes, n_groups, m, tile_start, row_start);
  __syncthreads();
  const int col_tiles = (n + kTN - 1) / kTN;
  const int n_tiles = tile_start[n_groups + 1] * col_tiles;
  const int steps = (k + kTK - 1) / kTK;

  if (threadIdx.x >= 256) {  // producer: one thread issues every load
    if (threadIdx.x == 256) {
      Cursor<kStages> at;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const TileRows tr =
            row_tile<kTM>(t / col_tiles, tile_start, row_start, n_groups);
        if (tr.g < 0) continue;
        const int n0 = (t % col_tiles) * kTN;
        for (int s = 0; s < steps; ++s, at.next()) {
          mbar_wait(&ring.empty[at.stage], at.phase ^ 1);
          uint8_t* st = ring.tiles + at.stage * kStageBytes;
          uint64_t* full = &ring.full[at.stage];
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(st, &map_lhs, full, s * kTK, tr.lo);
          tma_load_3d(st + kPart, &map_rhs, full, n0, s * kTK, tr.g);
          tma_load_3d(st + kPart + kBox, &map_rhs, full, n0 + 64, s * kTK,
                      tr.g);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  float* staged = reinterpret_cast<float*>(ring.tiles +
                                           kStages * kStageBytes +
                                           wg * kWgOut);
  Cursor<kStages> at;
  float acc[64];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const TileRows tr =
        row_tile<kTM>(t / col_tiles, tile_start, row_start, n_groups);
    const int n0 = (t % col_tiles) * kTN;
    zero_acc(acc);
    if (tr.g >= 0 && steps > 0) {
      int last = 0;
      for (int s = 0; s < steps; ++s, at.next()) {
        mbar_wait(&ring.full[at.stage], at.phase);
        const uint8_t* st = ring.tiles + at.stage * kStageBytes;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kTK / 16; ++j)
          wgmma_m64n128k16<0, 1>(
              acc, sw128_desc(st + wg * kBox + 32 * j, 16, 1024),
              sw128_desc(st + kPart + 2048 * j, kBox, 1024));
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
    // the epilogue: the last tile's row copies have read `staged`, then the
    // accumulator goes in, then one bulk copy per row of this group
    if (t128 < 64) bulk_wait_read<0>();
    named_barrier(1 + wg, 128);
    {
      const int row0 = 16 * (t128 / 32) + (t128 % 32) / 4;
      const int col0 = 2 * (t128 % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(staged + (row0 + 8 * h) * kOutLd +
                                     8 * j + col0) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    const int row = tr.lo + 64 * wg + t128;
    if (t128 < 64 && row < tr.hi) {
      bulk_store(out + static_cast<int64_t>(row) * n + n0,
                 staged + t128 * kOutLd, 4 * min(kTN, n - n0));
      bulk_commit();
    }
  }
  if (t128 < 64) bulk_wait<0>();
}

}  // namespace

// lhs (m, k) bf16 and rhs (n_groups, k, n) bf16, contiguous and 16-byte
// aligned, k and n multiples of 8, m >= 1; group_sizes (n_groups,) int32 on
// the device; out (m, n) fp32 contiguous, 16-byte aligned. Every row of out
// is written. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int grouped_matmul_fwd_tma(const void* lhs, const void* rhs,
                                      const void* group_sizes, void* out,
                                      int m, int k, int n, int n_groups,
                                      void* stream) {
  if (m < 1 || k < 8 || n < 8 || k % 8 || n % 8 || n_groups < 1 ||
      n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_lhs, map_rhs;
  const uint64_t dims[3] = {static_cast<uint64_t>(n),
                            static_cast<uint64_t>(k),
                            static_cast<uint64_t>(n_groups)};
  const uint64_t strides[2] = {static_cast<uint64_t>(n) * 2,
                               static_cast<uint64_t>(n) * k * 2};
  const uint32_t box[3] = {64, kTK, 1};
  if (!matrix_map(&map_lhs, lhs, m, k, kTM) ||
      !hopper_host::bf16_map(&map_rhs, rhs, 3, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  // at most ceil(m / 128) + n_groups row tiles (find_tile's count)
  const int64_t tiles = (static_cast<int64_t>(m + kTM - 1) / kTM + n_groups) *
                        ((n + kTN - 1) / kTN);
  if (tiles > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(
      gmm_fwd_wgmma_kernel, static_cast<int>(tiles), kThreads,
      ring_smem_bytes(kStages, kStageBytes, kOutBytes),
      static_cast<cudaStream_t>(stream), map_lhs, map_rhs,
      static_cast<const int*>(group_sizes), static_cast<float*>(out), m, k,
      n, n_groups);
}
