// Fused-dequant batched matmuls on tensor cores, one launch of a thread
// block cluster per product: K7 over split-half int4 weights and K6 over
// int8 weights. Shapes off their grid take the CUDA-core kernels of
// quant_matmul.cu; kernels.int4_bmm_tc_route and kernels.int8_bmm_tc_route
// choose from the shapes alone.
//
// Replaces: deepearth_tpu/ops/quant.py `_bmm4_kernel` (:240; pallas_call
// :311, reached through `int4_bmm`) and `_bmm_kernel` (:159; pallas_call
// :221, through `int8_bmm`). The decode path reaches them through
// `linear_p` (E = 1, every quantized dense layer) and `expert_ffn_q` (three
// per MoE layer, E experts).
//
// Computes what quant_matmul.cu computes: out[e, c, f] = scale[e, 0, f]
// * sum_d bf16(x[e, c, d]) * w[e, d, f] for f < F, the sum in fp32 and the
// output rounded once. w stays the JAX package's: (E, D, Fp) int8 for K6,
// (E, D/2, Fp) bytes for K7, split half (byte i of a column holds row i in
// its low nibble and row i + D/2 in its high nibble, both signed). A nibble
// or an int8 value is exact in bf16 and its product with a bf16 exact in
// fp32, so the only rounding is the fp32 sum's (in another order than the
// plain version's) and the one cast of the scaled sum.
//
// Bound on the H100: bytes. A decode step reads each weight once and uses it
// C times (C the batch of a dense layer, a few slots an expert): at q_proj,
// B = 8 (1, 8, 2048 -> 3072) 3.2 MB in int4, 6.3 MB in int8, 0.00097 and
// 0.0019 ms at 3.35 TB/s. The CUDA-core kernels cannot stream that fast:
// each weight costs 2 C FMAs, and an SM does 128 a clock. Design:
//  - tensor cores: mma.sync m16n8k16 (bf16 in, fp32 accumulate) on the
//    swapped product, the widened weights as the A operand (16 features x 16
//    reductions) and x, rounded to bf16, as the B operand (16 reductions x 8
//    rows of x: C padded to 8, 16 or 32). mma.sync rather than wgmma: the A
//    operand is built in registers anyway, the B operand (x) is a few KB
//    that each thread reads as 32-bit pairs, and at N = 8 to 32 the product
//    is bound by the weight bytes and the widening, not the tensor cores'
//    issue rate; its per-warp fragments also let each thread's 16-byte
//    weight load serve 8 m16 tiles (below). A thread's A fragment
//    (mma.sync's layout: rows g and g + 8, reductions 2 c, 2 c + 1 and
//    + 8) lies at two features of each tile; the m16 tiles' rows are
//    permuted over the features so that a thread's two features of each of
//    8 tiles are the 16 bytes 16 g .. 16 g + 15 of a weight row: one
//    16-byte shared load per row feeds 8 tiles;
//  - K7: one k16 step is 8 packed rows: its reductions 0..7 are the low
//    nibbles of the 8 rows (against x[:, i ..]), 8..15 their high nibbles
//    (against x[:, i + D/2 ..]): both halves in one product, each byte read
//    once. A thread's A fragment is then the bytes of packed rows 2 c and
//    2 c + 1 at two features. Widening: XOR 0x8 makes each nibble u
//    unsigned (u - 8 its value), a byte permute pairs two rows' bytes, one
//    LOP3 puts u into the mantissa of the bf16 128 + u, one bf16x2
//    subtraction of 136 leaves u - 8: exact;
//  - K6: one k16 step is 16 rows, a thread's A fragment the bytes of rows
//    2 c, 2 c + 1, 2 c + 8 and 2 c + 9 at two features (four 16-byte loads
//    feed 8 tiles). Widening (widen_int8_pair): a byte permute pairs two
//    rows' bytes b; one LOP3 puts b's low 7 bits m into the mantissa of the
//    bf16 128 (128 + m, exact: bf16 holds 8 significant bits), another puts
//    b's sign bit into the lowest exponent bit of the bias 128 (256 when b
//    is negative), and one bf16x2 subtraction leaves m or m - 128, which is
//    b: exact, since every integer of magnitude up to 256 is a bf16 and so
//    the difference is never rounded. Four instructions a pair, against
//    five for widening through an fp32 (PRMT into the mantissa of 2^23, a
//    subtraction, a PRMT to pack the top halves);
//  - bytes in flight: a producer warp streams the block's weight tile (128
//    features, its chunk of the rows) by TMA in stages of 64 rows x 128
//    bytes (8 KB, 128-byte swizzled: the 16-byte loads of a warp's 8-thread
//    phases hit 8 distinct bank groups) through a ring of 6 stages on
//    mbarriers, 48 KB in flight a block, two or three blocks an SM at
//    C <= 16 (fewer at 32 rows of x, whose sums and x rows take more). Four
//    consumer warps take the stage's k16 steps (two each for K7, one for
//    K6); the block's x rows (its chunk, both halves for K7, rounded to
//    bf16) sit in shared memory, rows padded by 8 so that the B loads hit
//    distinct banks;
//  - one launch, no atomics: a dense decode layer has few 128-feature tiles
//    (kv_a 5, q_proj 24), so the rows are split over the R blocks of a
//    thread block cluster (R a power of two up to 16, the fewest that give
//    132 blocks; chunks of whole stages; kernels.int4_tc_plan and
//    int8_tc_plan, pure functions of the shapes). Each block adds its four
//    warps' fp32 sums in warp order, then every block adds the cluster's
//    partial tiles in rank order through distributed shared memory, each
//    for its 1 / R of the tile (rank 0 alone would read R - 1 tiles in
//    turn), scales, casts and stores it. No partial tensor, no second
//    kernel: two runs are bitwise equal. C past 32 takes column tiles of
//    32 rows of x (each reads the weights again, mostly from L2).

#include <cooperative_groups.h>

#include "hopper_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kCols = 128;      // features a block: one swizzled 128-byte row
constexpr int kStageRows = 64;  // weight rows (K7: packed rows) a stage
constexpr int kStageBytes = kCols * kStageRows;  // 8 KB
constexpr int kStages = 6;
constexpr int kWarps = 4;  // consumer warps
constexpr int kConsumers = 32 * kWarps, kThreads = kConsumers + 32;
constexpr int kMaxCluster = 16, kMaxChunk = 1024;

struct TcArgs {
  const void* x;       // (E, C, D)
  const float* scale;  // (E, 1, F)
  void* out;           // (E, C, F)
  int c, d, f, chunk, c_tiles;
};

// fp32 sums of one block: its four warps' tiles, then (tile 0) the block's
__host__ __device__ constexpr int tile_floats(int nt) {
  return kCols * 8 * nt;
}
__host__ __device__ constexpr int region_bytes(int nt) {
  return kStages * kStageBytes > kWarps * tile_floats(nt) * 4
             ? kStages * kStageBytes
             : kWarps * tile_floats(nt) * 4;
}
// x's rows in shared memory: 8 nt rows of the chunk (K7: of its two
// halves), padded
__host__ __device__ constexpr int x_ld(bool int8, int chunk) {
  return (int8 ? 1 : 2) * chunk + 8;
}
constexpr int smem_bytes(bool int8, int nt, int chunk) {
  return ring_smem_bytes(kStages, kStageBytes,
                         region_bytes(nt) - kStages * kStageBytes +
                             8 * nt * x_ld(int8, chunk) * 2);
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The nibbles u at bits 0-3 and 16-19 of v (each a signed int4 plus 8) as
// the bf16 pair u - 8: 128 + u by one LOP3 into the mantissa of 128, then
// minus 136 (0x4308), both exact.
__device__ __forceinline__ uint32_t widen_pair(uint32_t v) {
  return bf16x2_sub((v & 0x000F000Fu) | 0x43004300u, 0x43084308u);
}

// The int8 values b at bits 0-7 and 16-23 of v as the bf16 pair b: 128 +
// (b & 127) over 128 + 128 * sign(b) (0x4300, or 0x4380 = 256 with b's
// sign bit as the lowest exponent bit), both exact, and their difference
// exact (see the header).
__device__ __forceinline__ uint32_t widen_int8_pair(uint32_t v) {
  return bf16x2_sub((v & 0x007F007Fu) | 0x43004300u,
                    (v & 0x00800080u) | 0x43004300u);
}

// The A fragment of one m16 tile of a K7 k16 step: w0, w1 the thread's
// words of packed rows 2 c and 2 c + 1 (nibbles XOR 8), kByte the byte of
// each word that holds the tile's feature of row g (kByte + 1: of row
// g + 8). a[0], a[1]: the low nibbles (reductions 2 c, 2 c + 1) of rows g,
// g + 8; a[2], a[3]: the high nibbles (reductions 8 + 2 c, 9 + 2 c).
template <int kByte>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], uint32_t w0,
                                       uint32_t w1) {
  constexpr uint32_t kSelG = kByte == 0 ? 0x4400u : 0x6622u;
  constexpr uint32_t kSelG8 = kByte == 0 ? 0x5511u : 0x7733u;
  const uint32_t vg = __byte_perm(w0, w1, kSelG);
  const uint32_t vg8 = __byte_perm(w0, w1, kSelG8);
  a[0] = widen_pair(vg);
  a[1] = widen_pair(vg8);
  a[2] = widen_pair(vg >> 4);
  a[3] = widen_pair(vg8 >> 4);
}

// The A fragment of one m16 tile of a K6 k16 step: w0, w1, w8, w9 the
// thread's words of rows 2 c, 2 c + 1, 2 c + 8, 2 c + 9, kByte the byte of
// each word that holds the tile's feature of row g (kByte + 1: of row
// g + 8). a[0], a[1]: reductions 2 c, 2 c + 1 of rows g, g + 8; a[2], a[3]:
// reductions 2 c + 8, 2 c + 9.
template <int kByte>
__device__ __forceinline__ void a_frag_int8(uint32_t (&a)[4], uint32_t w0,
                                            uint32_t w1, uint32_t w8,
                                            uint32_t w9) {
  // byte kByte of each word into bytes 0 and 2 (bytes 1, 3: don't care)
  constexpr uint32_t kSelG = ((4u + kByte) << 8) | kByte;
  constexpr uint32_t kSelG8 = kSelG + 0x0101u;
  a[0] = widen_int8_pair(__byte_perm(w0, w1, kSelG));
  a[1] = widen_int8_pair(__byte_perm(w0, w1, kSelG8));
  a[2] = widen_int8_pair(__byte_perm(w8, w9, kSelG));
  a[3] = widen_int8_pair(__byte_perm(w8, w9, kSelG8));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 8 elements of x (16-byte aligned) rounded to bf16
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                    pack2(b.z, b.w));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of row `row` of a stage: features 16 g .. 16 g + 15 (the
// swizzle puts 16-byte chunk g of row r at chunk g ^ (r % 8))
__device__ __forceinline__ uint4 stage_row(const uint8_t* st, int row,
                                           int g) {
  return *reinterpret_cast<const uint4*>(st + row * kCols +
                                         ((g ^ (row & 7)) << 4));
}

// The body of both kernels. NT: 8-row tiles of x a block (1, 2 or 4: C <=
// 8, <= 16, tiles of 32). The grid: x = feature tile * R + rank (clusters of
// R along x), y = e * c_tiles + column tile.
template <bool kInt8, int NT, typename XT, typename OT>
__device__ __forceinline__ void tc_body(const CUtensorMap* map_w,
                                        const TcArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kTile = tile_floats(NT);
  constexpr int kHalves = kInt8 ? 1 : 2;
  const int ld = x_ld(kInt8, a.chunk);
  auto ring = make_ring<kStages>(
      smem_raw, kStageBytes,
      region_bytes(NT) - kStages * kStageBytes + 8 * NT * ld * 2, 1, kWarps);
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring.tiles);  // after the ring's use
  bf16* xs = reinterpret_cast<bf16*>(ring.tiles + region_bytes(NT));
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int f0 = blockIdx.x / n_ranks * kCols;
  const int e = blockIdx.y / a.c_tiles;
  const int c0 = blockIdx.y % a.c_tiles * 8 * NT;
  const int r0 = rank * a.chunk;  // the block's (packed) rows
  const int n_stages = a.chunk / kStageRows;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      Cursor<kStages> at;
      for (int i = 0; i < n_stages; ++i, at.next()) {
        mbar_wait(&ring.empty[at.stage], at.phase ^ 1);
        mbar_expect_tx(&ring.full[at.stage], kStageBytes);
        tma_load_3d(ring.tiles + at.stage * kStageBytes, map_w,
                    &ring.full[at.stage], f0, r0 + i * kStageRows, e);
      }
    }
  } else {
    // the chunk's x rows c0 .. c0 + 8 NT - 1 (zeros past C) in bf16: rows
    // [r0, r0 + chunk) (K7: the low half, then the high half [D/2 + r0,
    // ...))
    const XT* xe = static_cast<const XT*>(a.x) +
                   static_cast<int64_t>(e) * a.c * a.d;
    const int groups = a.chunk / 8;
    for (int idx = threadIdx.x; idx < 8 * NT * kHalves * groups;
         idx += kConsumers) {
      const int n = idx / (kHalves * groups), q = idx % (kHalves * groups);
      const int half = q / groups, k = 8 * (q % groups);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + n < a.c)
        v = load8(xe + static_cast<int64_t>(c0 + n) * a.d +
                  half * (a.d / 2) + r0 + k);
      *reinterpret_cast<uint4*>(xs + n * ld + half * a.chunk + k) = v;
    }
    named_barrier(1, kConsumers);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, cq = lane % 4;
    float acc[8][NT][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = 0.0f;
    Cursor<kStages> at;
    for (int i = 0; i < n_stages; ++i, at.next()) {
      mbar_wait(&ring.full[at.stage], at.phase);
      const uint8_t* st = ring.tiles + at.stage * kStageBytes;
      if constexpr (kInt8) {
        // the warp's k16 step: rows 16 warp .. 16 warp + 15 of the stage
        const int row = 16 * warp + 2 * cq;
        const uint4 p0 = stage_row(st, row, g);
        const uint4 p1 = stage_row(st, row + 1, g);
        const uint4 p8 = stage_row(st, row + 8, g);
        const uint4 p9 = stage_row(st, row + 9, g);
        const uint32_t w0[4] = {p0.x, p0.y, p0.z, p0.w};
        const uint32_t w1[4] = {p1.x, p1.y, p1.z, p1.w};
        const uint32_t w8[4] = {p8.x, p8.y, p8.z, p8.w};
        const uint32_t w9[4] = {p9.x, p9.y, p9.z, p9.w};
        // B: x rows 8 j + g at the chunk's reductions row, row + 1 and
        // row + 8, row + 9
        const int kr = i * kStageRows + row;
        uint32_t bx[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const bf16* xr = xs + (8 * j + g) * ld + kr;
          bx[j][0] = *reinterpret_cast<const uint32_t*>(xr);
          bx[j][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          // m16 tile t: its rows g, g + 8 are features 16 g + 2 t, + 1
          uint32_t af[4];
          if (t % 2 == 0)
            a_frag_int8<0>(af, w0[t / 2], w1[t / 2], w8[t / 2], w9[t / 2]);
          else
            a_frag_int8<2>(af, w0[t / 2], w1[t / 2], w8[t / 2], w9[t / 2]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_16816(acc[t][j], af, bx[j][0], bx[j][1]);
        }
      } else {
        constexpr int kSteps = kStageRows / 8 / kWarps;
#pragma unroll
        for (int ss = 0; ss < kSteps; ++ss) {
          // packed rows row, row + 1 of the stage
          const int row = 8 * (kSteps * warp + ss) + 2 * cq;
          const uint4 p0 = stage_row(st, row, g);
          const uint4 p1 = stage_row(st, row + 1, g);
          const uint32_t w0[4] = {p0.x ^ 0x88888888u, p0.y ^ 0x88888888u,
                                  p0.z ^ 0x88888888u, p0.w ^ 0x88888888u};
          const uint32_t w1[4] = {p1.x ^ 0x88888888u, p1.y ^ 0x88888888u,
                                  p1.z ^ 0x88888888u, p1.w ^ 0x88888888u};
          // B: x rows 8 j + g at the chunk's reductions row, row + 1 (low
          // half) and D/2 + row, + 1 (high half)
          const int kr = i * kStageRows + row;
          uint32_t bx[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const bf16* xr = xs + (8 * j + g) * ld + kr;
            bx[j][0] = *reinterpret_cast<const uint32_t*>(xr);
            bx[j][1] = *reinterpret_cast<const uint32_t*>(xr + a.chunk);
          }
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            // m16 tile t: its rows g, g + 8 are features 16 g + 2 t, + 1
            uint32_t af[4];
            if (t % 2 == 0)
              a_frag<0>(af, w0[t / 2], w1[t / 2]);
            else
              a_frag<2>(af, w0[t / 2], w1[t / 2]);
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_16816(acc[t][j], af, bx[j][0], bx[j][1]);
          }
        }
      }
      __syncwarp();
      release(ring, at.stage);
    }

    // the four warps' sums, added in warp order into tile 0 (the ring is
    // read by every warp before it is written over)
    named_barrier(1, kConsumers);
    float* mine = red + warp * kTile;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int f = 16 * g + 2 * t, n = 8 * j + 2 * cq;
        *reinterpret_cast<float2*>(mine + n * kCols + f) =
            make_float2(acc[t][j][0], acc[t][j][2]);
        *reinterpret_cast<float2*>(mine + (n + 1) * kCols + f) =
            make_float2(acc[t][j][1], acc[t][j][3]);
      }
    }
    named_barrier(1, kConsumers);
    for (int idx = threadIdx.x; idx < kTile; idx += kConsumers)
      red[idx] = ((red[idx] + red[idx + kTile]) + red[idx + 2 * kTile]) +
                 red[idx + 3 * kTile];
  }

  // the cluster's tiles, added in rank order: this block sums its 1 / R of
  // the tile over every rank, scales, casts and stores it; the second sync
  // keeps every block's tile alive until all have read it
  cluster.sync();
  const int per = kTile / n_ranks;
  OT* out = static_cast<OT*>(a.out);
  for (int idx = threadIdx.x; idx < per; idx += kThreads) {
    const int el = rank * per + idx;
    float sum = 0.0f;
    for (int q = 0; q < n_ranks; ++q)
      sum += cluster.map_shared_rank(red, q)[el];
    const int n = c0 + el / kCols, f = f0 + el % kCols;
    if (n < a.c && f < a.f)
      store(out + (static_cast<int64_t>(e) * a.c + n) * a.f + f,
            sum * a.scale[static_cast<int64_t>(e) * a.f + f]);
  }
  cluster.sync();
}

template <int NT, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
    int4_bmm_tc_kernel(const __grid_constant__ CUtensorMap map_w,
                       const TcArgs a) {
  tc_body<false, NT, XT, OT>(&map_w, a);
}

template <int NT, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
    int8_bmm_tc_kernel(const __grid_constant__ CUtensorMap map_w,
                       const TcArgs a) {
  tc_body<true, NT, XT, OT>(&map_w, a);
}

// ------------------------------------------------------------------ host ----

template <bool kInt8, int NT, typename XT, typename OT>
int launch_tc(const CUtensorMap& map, const TcArgs& a, int e, int tiles,
              int cluster, cudaStream_t stream) {
  const auto kernel = kInt8 ? int8_bmm_tc_kernel<NT, XT, OT>
                            : int4_bmm_tc_kernel<NT, XT, OT>;
  static const cudaError_t attr = [&] {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(kInt8, NT, kMaxChunk));
    return rc != cudaSuccess
               ? rc
               : cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                     1);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, e * a.c_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(kInt8, NT, a.chunk);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, map, a);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <bool kInt8, int NT>
int launch_types(const CUtensorMap& map, const TcArgs& a, int e, int tiles,
                 int cluster, int x_dtype, int out_dtype, cudaStream_t s) {
  if (x_dtype == 0)
    return out_dtype == 0 ? launch_tc<kInt8, NT, float, float>(
                                map, a, e, tiles, cluster, s)
                          : launch_tc<kInt8, NT, float, bf16>(
                                map, a, e, tiles, cluster, s);
  return out_dtype == 0
             ? launch_tc<kInt8, NT, bf16, float>(map, a, e, tiles, cluster, s)
             : launch_tc<kInt8, NT, bf16, bf16>(map, a, e, tiles, cluster, s);
}

// Checks, the weights' tensor map and the launch of either kernel; rows:
// D (int8) or D/2 (int4).
template <bool kInt8>
int bmm_tc(const void* x, const void* w, const void* scale, void* out, int e,
           int c, int d, int fp, int f, int nt, int cluster, int x_dtype,
           int out_dtype, void* stream) {
  const int rows = kInt8 ? d : d / 2;
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 ||
                          cluster == 8 || cluster == kMaxCluster;
  if (e < 1 || c < 1 || (!kInt8 && d % 2) || f < 1 || fp < f ||
      fp % kCols || !cluster_ok || rows % (kStageRows * cluster) ||
      rows / cluster > kMaxChunk || rows < kStageRows ||
      (nt != 1 && nt != 2 && nt != 4) || x_dtype < 0 || x_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs a;
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.c = c;
  a.d = d;
  a.f = f;
  a.chunk = rows / cluster;
  a.c_tiles = (c + 8 * nt - 1) / (8 * nt);
  if (static_cast<int64_t>(e) * a.c_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the weights as (E, rows, Fp) bytes, boxes of 64 rows x 128 features,
  // 128-byte swizzled
  CUtensorMap map;
  const uint64_t dims[3] = {static_cast<uint64_t>(fp),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(e)};
  const uint64_t strides[2] = {static_cast<uint64_t>(fp),
                               static_cast<uint64_t>(rows) * fp};
  const uint32_t box[3] = {kCols, kStageRows, 1};
  if (!hopper_host::tiled_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 3, dims,
                              strides, box))
    return static_cast<int>(cudaErrorInvalidPitchValue);  // map refused
  const int tiles = fp / kCols;
  const auto s = static_cast<cudaStream_t>(stream);
  if (nt == 1)
    return launch_types<kInt8, 1>(map, a, e, tiles, cluster, x_dtype,
                                  out_dtype, s);
  if (nt == 2)
    return launch_types<kInt8, 2>(map, a, e, tiles, cluster, x_dtype,
                                  out_dtype, s);
  return launch_types<kInt8, 4>(map, a, e, tiles, cluster, x_dtype, out_dtype,
                                s);
}

}  // namespace

// K7 on tensor cores: x (E, C, D) float32 or bfloat16 (x_dtype 0 / 1),
// contiguous and 16-byte aligned; w (E, D/2, Fp) split-half int4 bytes,
// 16-byte aligned; scale (E, 1, F) fp32; out (E, C, F) float32 or bfloat16
// (out_dtype 0 / 1). nt: 8-row tiles of x a block (1, 2 or 4; C past 8 nt
// in column tiles); cluster: the blocks the packed rows are split over (1,
// 2, 4, 8 or 16, each a multiple of 64 rows and at most 1024). Fp a
// multiple of 128, D/2 of 64 cluster. Returns a cudaError_t value; 0 on a
// clean launch.
extern "C" int int4_bmm_tc(const void* x, const void* w, const void* scale,
                           void* out, int e, int c, int d, int fp, int f,
                           int nt, int cluster, int x_dtype, int out_dtype,
                           void* stream) {
  return bmm_tc<false>(x, w, scale, out, e, c, d, fp, f, nt, cluster,
                       x_dtype, out_dtype, stream);
}

// K6 on tensor cores: as int4_bmm_tc over w (E, D, Fp) int8, 16-byte
// aligned; D a multiple of 64 cluster, each block's chunk at most 1024 rows.
extern "C" int int8_bmm_tc(const void* x, const void* w, const void* scale,
                           void* out, int e, int c, int d, int fp, int f,
                           int nt, int cluster, int x_dtype, int out_dtype,
                           void* stream) {
  return bmm_tc<true>(x, w, scale, out, e, c, d, fp, f, nt, cluster, x_dtype,
                      out_dtype, stream);
}
