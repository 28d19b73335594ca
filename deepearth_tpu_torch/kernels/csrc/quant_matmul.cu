// Fused-dequant batched matmul over weight-only int8 (K6) and split-half
// int4 (K7) weights, on CUDA cores: the route of the shapes off
// quant_matmul_tc.cu's tensor-core grid (kernels.int8_bmm_tc_route,
// kernels.int4_bmm_tc_route), counted int8_bmm_fma and int4_bmm_fma.
//
// Replaces: deepearth_tpu/ops/quant.py `_bmm_kernel` (:159; pallas_call
// :221, reached through `int8_bmm`) and `_bmm4_kernel` (:240; pallas_call
// :311, through `int4_bmm`). The decode path reaches them through
// `linear_p` (E = 1, every quantized dense layer) and `expert_ffn_q` (three
// per MoE layer, E experts).
//
// Computes out[e, c, f] = scale[e, 0, f] * sum_d bf16(x[e, c, d]) * w[e, d, f]
// for f < F, with x (E, C, D) float32 or bfloat16 (rounded to bf16 first,
// as the JAX package feeds its kernel x.astype(bfloat16)), w (E, D, Fp)
// int8, scale (E, 1, F) float32 (F <= Fp; never read past F), out (E, C, F)
// float32 or bfloat16. An int8 value is exact in bf16 and a bf16 x int8
// product is exact in fp32, so the only rounding is the fp32 sum's (in
// another order than the plain version's) and the one cast of the scaled
// sum. K7: w is (E, D/2, Fp) bytes; byte i of a column holds row i in its
// low nibble and row i + D/2 in its high nibble, both sign-extended
// (lo = (b << 28) >> 28, hi = b >> 4 on the signed byte), so each packed row
// pairs x[:, i] with lo and x[:, i + D/2] with hi.
//
// Bound on the H100: bytes. The decode path's weights are read once per
// step and reused C times (C = the batch for a dense layer, a few slots per
// expert): at C <= 32 that is at most 64 operations a byte, far below the
// ~600 of the card's int8 or bf16 tensor rate over its 3.35 TB/s. One
// expert w_gate call at C = 32 moves 33.6 MB of int8 weights, 0.010 ms.
//
// Schedule: a block of 4 warps owns 128 columns (4 a lane, one 32-bit load
// of 4 weight bytes a row) and ct = 4, 8 or 16 rows of x (the fewest that
// hold C: the FMAs of padded rows would cost more than the bytes at
// decode's C of 1 to 8), and walks a chunk of the reduction. Each warp
// takes every 4th row of the chunk: its 32 lanes read one 128-byte run of a
// weight row, and the chunk's x (rounded to bf16, kept as fp32) sits in
// shared memory, read as one broadcast per warp. A step first loads the
// warp's 16 weight rows into registers, then widens each byte (PRMT into a
// float's mantissa, one subtraction) and does its ct FMAs, so that 16 loads
// are in flight per thread. At the end the 4 warps' sums are added in a
// fixed order through shared memory.
// A dense decode layer has too few column tiles (Fp / 128 <= 64) to fill
// 132 SMs, so the wrapper splits the reduction into `splits` chunks (a pure
// function of the shapes): each chunk's block writes its fp32 sums to
// `partial`, and a second kernel adds the chunks in order, scales and
// casts. No float atomics: the result does not depend on run order.
//
// Simple first: CUDA-core FMAs, no tensor cores, no TMA (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;  // columns per block, 4 per lane
constexpr int kSub = 64;    // reduction rows staged per step
constexpr int kPerWarp = kSub / kWarps;

__device__ __forceinline__ float as_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float as_bf16(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Byte k of u (an unsigned value 0..255) as the float 2^23 + u: the byte
// goes into the low mantissa bits of 0x4B000000 by one PRMT, and a
// subtraction of 2^23 + bias gives u - bias exactly. Two full-rate
// instructions instead of the quarter-rate I2F.
__device__ __forceinline__ float widen(uint32_t u, int k, float bias) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) -
         (8388608.0f + bias);
}

// rows: D (int8) or D / 2 (int4, whose x rows i and rows + i pair up);
// rows [chunk * blockIdx.z, ...) of the reduction are this block's, and
// rows [kCT * (blockIdx.y % c_tiles), ...) of x.
template <bool kInt4, int kCT, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
    quant_bmm_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, OT* __restrict__ out,
                     float* __restrict__ partial, int c, int d, int fp, int f,
                     int rows, int chunk, int c_tiles, int splits,
                     int64_t n) {
  constexpr int kHalves = kInt4 ? 2 : 1;
  __shared__ float xs[kHalves][kCT][kSub];
  __shared__ float red[kWarps - 1][kCT][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.y / c_tiles;
  const int c0 = (blockIdx.y % c_tiles) * kCT;
  const int col = blockIdx.x * kCols + 4 * lane;
  const bool col_ok = col < fp;
  const int r0 = blockIdx.z * chunk;
  const int r1 = min(rows, r0 + chunk);
  const XT* xe = x + static_cast<int64_t>(e) * c * d;
  const int8_t* we = w + static_cast<int64_t>(e) * rows * fp;

  float acc[kCT][4];
#pragma unroll
  for (int i = 0; i < kCT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int sub = r0; sub < r1; sub += kSub) {
    __syncthreads();  // the previous step's x is read
    for (int i = threadIdx.x; i < kCT * kSub; i += kThreads) {
      const int row = c0 + i / kSub, dd = sub + i % kSub;
      const bool ok = row < c && dd < r1;
      const XT* xr = xe + static_cast<int64_t>(row) * d + dd;
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
        xs[h][i / kSub][i % kSub] = ok ? as_bf16(xr[h * rows]) : 0.0f;
    }
    __syncthreads();
    uint32_t wv[kPerWarp];
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int dd = sub + warp + t * kWarps;
      wv[t] = (col_ok && dd < r1)
                  ? __ldg(reinterpret_cast<const unsigned int*>(
                        we + static_cast<int64_t>(dd) * fp + col))
                  : 0u;
    }
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int j = warp + t * kWarps;
      if (kInt4) {
        // each byte's nibbles plus 8, unsigned: 0..15
        const uint32_t u = wv[t] ^ 0x88888888u;
        const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wl = widen(lo, k, 8.0f), wh = widen(hi, k, 8.0f);
#pragma unroll
          for (int i = 0; i < kCT; ++i) {
            acc[i][k] = fmaf(xs[0][i][j], wl, acc[i][k]);
            acc[i][k] = fmaf(xs[kHalves - 1][i][j], wh, acc[i][k]);
          }
        }
      } else {
        const uint32_t u = wv[t] ^ 0x80808080u;  // each byte plus 128
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = widen(u, k, 128.0f);
#pragma unroll
          for (int i = 0; i < kCT; ++i)
            acc[i][k] = fmaf(xs[0][i][j], wk, acc[i][k]);
        }
      }
    }
  }

  // the warps' sums, added in warp order
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < kCT; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) red[warp - 1][i][4 * lane + k] = acc[i][k];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < kCT; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int v = 0; v < kWarps - 1; ++v) acc[i][k] += red[v][i][4 * lane + k];

#pragma unroll
  for (int i = 0; i < kCT; ++i) {
    const int row = c0 + i;
    if (row >= c) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int cc = col + k;
      if (cc >= f) break;
      const int64_t o = (static_cast<int64_t>(e) * c + row) * f + cc;
      if (splits == 1)
        store(out + o, acc[i][k] * scale[static_cast<int64_t>(e) * f + cc]);
      else
        partial[blockIdx.z * n + o] = acc[i][k];
    }
  }
}

// out[i] = scale * the chunks' sums of element i, added in chunk order.
template <typename OT>
__global__ void __launch_bounds__(256)
    quant_bmm_reduce_kernel(const float* __restrict__ partial,
                            const float* __restrict__ scale,
                            OT* __restrict__ out, int64_t n, int c, int f,
                            int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[z * n + i];
  const int64_t e = i / (static_cast<int64_t>(c) * f);
  store(out + i, s * scale[e * f + i % f]);
}

template <bool kInt4, int kCT, typename XT, typename OT>
void launch(const void* x, const void* w, const void* scale, void* out,
            void* partial, int e, int c, int d, int fp, int f, int splits,
            int chunk, cudaStream_t s) {
  const int rows = kInt4 ? d / 2 : d;
  const int c_tiles = (c + kCT - 1) / kCT;
  const int64_t n = static_cast<int64_t>(e) * c * f;  // outputs
  const dim3 grid((fp + kCols - 1) / kCols, e * c_tiles, splits);
  quant_bmm_kernel<kInt4, kCT, XT, OT><<<grid, kThreads, 0, s>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<OT*>(out),
      static_cast<float*>(partial), c, d, fp, f, rows, chunk, c_tiles,
      splits, n);
  if (splits > 1)
    quant_bmm_reduce_kernel<OT><<<static_cast<unsigned>((n + 255) / 256), 256,
                                  0, s>>>(
        static_cast<const float*>(partial), static_cast<const float*>(scale),
        static_cast<OT*>(out), n, c, f, splits);
}

template <bool kInt4, typename XT, typename OT>
void launch_rows(int ct, const void* x, const void* w, const void* scale,
                 void* out, void* partial, int e, int c, int d, int fp, int f,
                 int splits, int chunk, cudaStream_t s) {
  if (ct == 4)
    launch<kInt4, 4, XT, OT>(x, w, scale, out, partial, e, c, d, fp, f,
                             splits, chunk, s);
  else if (ct == 8)
    launch<kInt4, 8, XT, OT>(x, w, scale, out, partial, e, c, d, fp, f,
                             splits, chunk, s);
  else
    launch<kInt4, 16, XT, OT>(x, w, scale, out, partial, e, c, d, fp, f,
                              splits, chunk, s);
}

// x_dtype and out_dtype: 0 float32, 1 bfloat16; ct: rows of x per block
// (4, 8 or 16; the wrapper takes the smallest that holds C, so that a
// decode step's few rows do not pay for 16).
template <bool kInt4>
int quant_bmm(const void* x, const void* w, const void* scale, void* out,
              void* partial, int e, int c, int d, int fp, int f, int ct,
              int splits, int chunk, int x_dtype, int out_dtype,
              void* stream) {
  const int rows = kInt4 ? d / 2 : d;
  if (e < 1 || c < 1 || rows < 1 || f < 1 || fp < f || fp % 4 ||
      (kInt4 && d % 2) || (ct != 4 && ct != 8 && ct != 16) || splits < 1 ||
      chunk < 1 || static_cast<int64_t>(splits - 1) * chunk >= rows ||
      static_cast<int64_t>(splits) * chunk < rows ||
      (splits > 1 && partial == nullptr) || x_dtype < 0 || x_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(e) * ((c + ct - 1) / ct) > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0)
    launch_rows<kInt4, float, float>(ct, x, w, scale, out, partial, e, c, d,
                                     fp, f, splits, chunk, s);
  else if (x_dtype == 0)
    launch_rows<kInt4, float, bf16>(ct, x, w, scale, out, partial, e, c, d,
                                    fp, f, splits, chunk, s);
  else if (out_dtype == 0)
    launch_rows<kInt4, bf16, float>(ct, x, w, scale, out, partial, e, c, d,
                                    fp, f, splits, chunk, s);
  else
    launch_rows<kInt4, bf16, bf16>(ct, x, w, scale, out, partial, e, c, d,
                                   fp, f, splits, chunk, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6: x (E, C, D), w (E, D, Fp) int8, scale (E, 1, F) fp32 -> out (E, C, F);
// ct rows of x per block; partial (splits, E, C, F) fp32 scratch when
// splits > 1, chunk the reduction rows of each split (the last may be
// shorter).
extern "C" int int8_bmm(const void* x, const void* w, const void* scale,
                        void* out, void* partial, int e, int c, int d, int fp,
                        int f, int ct, int splits, int chunk, int x_dtype,
                        int out_dtype, void* stream) {
  return quant_bmm<false>(x, w, scale, out, partial, e, c, d, fp, f, ct,
                          splits, chunk, x_dtype, out_dtype, stream);
}

// K7: the same over w (E, D/2, Fp) split-half int4 bytes; chunk counts
// packed rows.
extern "C" int int4_bmm(const void* x, const void* w, const void* scale,
                        void* out, void* partial, int e, int c, int d, int fp,
                        int f, int ct, int splits, int chunk, int x_dtype,
                        int out_dtype, void* stream) {
  return quant_bmm<true>(x, w, scale, out, partial, e, c, d, fp, f, ct,
                         splits, chunk, x_dtype, out_dtype, stream);
}
