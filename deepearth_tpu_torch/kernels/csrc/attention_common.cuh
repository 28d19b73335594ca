// Building blocks shared by the attention kernels K3 and K4: bf16 tensor-core
// fragments (mma.sync m16n8k16, bf16 in, fp32 accumulate), cp.async staging
// of strided rows into shared memory, and quad reductions over the
// accumulator layout.
//
// Fragment layouts of m16n8k16 (lane = 4 g + c):
//   A (16 x 16, row-major):  a[0] rows g, cols 2c..2c+1; a[1] row g + 8;
//                            a[2], a[3] the same rows, cols 8 + 2c..
//   B (16 x 8, k x n):       b[0] k 2c..2c+1 of column g; b[1] k 8 + 2c..
//   C (16 x 8):              c[0..1] row g, cols 2c, 2c+1; c[2..3] row g + 8.
// The accumulator of one product is the A operand of the next (as P of
// P.V): a 16 x 16 slice of it, two n-tiles side by side, packed to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMmaKeys = 64;       // rows per staged key (or query) tile
constexpr int kNT = kMmaKeys / 8;  // its n-tiles of 8
constexpr int kRowPad = 8;  // bf16 padding of staged rows: fragment loads of
                            // the 8 row groups land in distinct banks
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of a (B, H, N, D) operand along B, H, N
  int64_t b, h, n;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a (16 x 16, row-major fragment) . b (16 x 8, column fragment)
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragment of a 16 x 8 block of a row-major (k, n) matrix in shared
// memory, transposed on the way by ldmatrix; p: this lane's row (lane % 16).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&b)[2],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory without passing through registers;
// zeros when `valid` is false.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [row0, row0 + rows) of x into dst (bf16, ld elements apart),
// `width` elements each, zero-padded to width_pad; rows past n are zeros.
// `vec` elements move per load: the host picks the widest that the width,
// the strides and the base's alignment allow. 16-byte moves go through
// cp.async and land by the next cp_async_wait; narrower ones are stores.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* x,
                                           int64_t n_stride, int row0,
                                           int rows, int n, int width,
                                           int width_pad, int vec) {
  const int chunks = width_pad / vec;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, d = vec * (idx % chunks);
    const bool valid = row0 + r < n && d < width;
    const bf16* src = valid ? x + (row0 + r) * n_stride + d : x;
    bf16* to = dst + r * ld + d;
    if (vec == 8) {
      cp_async16(to, src, valid);
    } else if (vec == 2) {
      *reinterpret_cast<uint32_t*>(to) = valid ? ld32(src) : 0u;
    } else {
      *to = valid ? *src : __float2bfloat16_rn(0.0f);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One MUFU.EX2; a result below 2^-126 flushes to 0 (such a probability
// would vanish beside the row's largest, which is at least 1 / Nk).
// exp2(-inf) is +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments of a warp's 16 rows x (16 * ks) columns of a row-major
// bf16 tile in shared memory (ks <= KS).
template <int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[KS][4],
                                             const bf16* rows, int ld, int ks,
                                             int g, int c) {
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    if (t >= ks) break;
    a[t][0] = ld32(rows + g * ld + 16 * t + 2 * c);
    a[t][1] = ld32(rows + (g + 8) * ld + 16 * t + 2 * c);
    a[t][2] = ld32(rows + g * ld + 16 * t + 8 + 2 * c);
    a[t][3] = ld32(rows + (g + 8) * ld + 16 * t + 8 + 2 * c);
  }
}

// s (16 x 64, accumulator layout) = A . T^T, T a row-major tile of 64 rows
// in shared memory whose first 16 * ks columns meet A's. (Loading two
// n-tiles' B fragments per ldmatrix.x4 instead ran 6-13% slower in every
// kernel on an H100 80GB HBM3 at 700 W; PERF.md.)
template <int KS>
__device__ __forceinline__ void product_nt(float (&s)[kNT][4],
                                           const uint32_t (&a)[KS][4],
                                           const bf16* tile, int ld, int ks,
                                           int g, int c) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    if (t >= ks) break;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const bf16* r = tile + (8 * j + g) * ld + 16 * t + 2 * c;
      const uint32_t b[2] = {ld32(r), ld32(r + 8)};
      mma_16816(s[j], a[t], b);
    }
  }
}

// o (16 x 8 no) += P . T: P (16 x 64) in accumulator layout, rounded to bf16
// here; T a row-major (64, >= 8 no) tile in shared memory (no <= NO).
template <int NO>
__device__ __forceinline__ void product_pn(float (&o)[NO][4],
                                           const float (&p)[kNT][4],
                                           const bf16* tile, int ld, int no,
                                           int lane) {
#pragma unroll
  for (int t = 0; t < kMmaKeys / 16; ++t) {
    // columns 16 t .. 16 t + 15 of P are its n-tiles 2 t and 2 t + 1
    uint32_t pa[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        pa[2 * half + r] = pack_bf16(p[2 * t + half][2 * r],
                                     p[2 * t + half][2 * r + 1]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n >= no) break;
      uint32_t b[2];
      ldsm_x2_trans(b, tile + (16 * t + (lane & 15)) * ld + 8 * n);
      mma_16816(o[n], pa, b);
    }
  }
}

// Store a warp's 16 x (8 no) accumulator as rows row0 + g (+ 8) of a
// contiguous (rows, width) bf16 matrix; rows past n and columns past width
// are dropped.
template <int NO>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&o)[NO][4],
                                           int row0, int n, int width, int g,
                                           int c, float mul0 = 1.0f,
                                           float mul1 = 1.0f) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    const float mul = r == 0 ? mul0 : mul1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * c;
      bf16* to = dst + static_cast<int64_t>(row) * width + col;
      if (col < width) to[0] = __float2bfloat16_rn(o[j][2 * r] * mul);
      if (col + 1 < width) to[1] = __float2bfloat16_rn(o[j][2 * r + 1] * mul);
    }
  }
}

// The widest staging load (8, 2 or 1 elements) that the width, the strides
// and the base's alignment allow.
inline int staging_vec(const void* base, const Strides& s, int width) {
  const int widest[2] = {8, 2};
  for (const int vec : widest) {
    if (width % vec == 0 && s.b % vec == 0 && s.h % vec == 0 &&
        s.n % vec == 0 &&
        reinterpret_cast<uintptr_t>(base) % (sizeof(bf16) * vec) == 0)
      return vec;
  }
  return 1;
}

// Warps per block: 16 rows each, at most `most`, chosen to leave the fewest
// idle rows in the last block (nq = 576 takes 6 warps of 6, 16 takes 1).
inline int mma_warps(int n, int most_warps) {
  const int groups = (n + 15) / 16;
  const int most = groups < most_warps ? groups : most_warps;
  int best = most, best_idle = 1 << 30;
  for (int w = most; w >= (most + 1) / 2; --w) {
    const int idle = (groups + w - 1) / w * w - groups;
    if (idle < best_idle) best = w, best_idle = idle;
  }
  return best;
}

}  // namespace
