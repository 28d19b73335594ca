// Mid-length multi-head attention with the whole score row on chip, forward
// (K3-fwd).
//
// Replaces: deepearth_tpu/ops/attention_vmem.py `_fwd_kernel` (Pallas,
// launched by `_run_fwd` through `vmem_attention`).
//
// Shapes: q (B, H, Nq, Dqk), k (B, H, Nk, Dqk), v (B, H, Nk, Dv), any strides
// along B, H and N with unit stride along the head dim; Nk <= 1024 and Dqk,
// Dv <= 128, Dqk != Dv allowed; an optional (B, Nk) key mask. Output
// (B, H, Nq, Dv), contiguous, in q's type. The multimodal model's vision
// encoder calls it twice per forward: MLA self-attention at Nq = Nk = 576,
// Dqk = 48, Dv = 32, and the query-token cross-attention at Nq = 16,
// Nk = 576, Dqk = Dv = 64, both with H = 8.
//
// Semantics, those of the JAX kernel: scores q.k * scale in fp32, plus 0 for
// a visible key and NEG_BIG = -0.7 * FLT_MAX for a masked one; a guarded
// softmax, m = max(rowmax, -1e30) and l = max(rowsum, 1e-30), so that a row
// whose keys are all masked gives exactly zero; the probabilities p = e / l
// rounded to v's type, then P.V accumulated in fp32 and rounded once to the
// output type. The bf16 path takes e as exp2 on the MUFU unit and p as
// e * (1 / l): each may differ from the fp32 expression in its last bits,
// before p is rounded to bf16.
//
// Bound on the H100: at the MLA site with B = 512 in bf16 the function moves
// 755 MB (q, k, v in, out back) and does 217 GFLOP, so memory and tensor
// cores bound it about equally, near 0.22 ms.
//
// bf16 design (the model's path): tensor cores through mma.sync m16n8k16
// (bf16 in, fp32 accumulate). One block of up to 6 warps per (b, h, tile of
// queries); each warp owns 16 query rows and keeps their q fragments in
// registers. k and v stream through shared memory in tiles of 64 keys,
// double-buffered with cp.async so that tile i + 1 loads while tile i is
// computed; the P.V operand comes out of the row-major v tile through
// ldmatrix.trans. The exact softmax needs the row's max and sum before any
// probability is rounded, so the kernel runs two passes over the keys
// instead of storing the scores: pass 1 computes the scores and keeps a
// running max and a rescaled running sum per row; pass 2 recomputes the
// scores, forms p, rounds it to bf16 straight into the A fragments of P.V
// (the accumulator layout of q.k is the operand layout of P.V) and
// accumulates the output in registers. Scores never leave the registers;
// the price is q.k done twice and exp taken twice.
//
// fp32 design (exact fp32 products, no tensor cores): one block of 256
// threads per (b, h, tile of 32 queries) on the CUDA cores. It stages its q
// rows in shared memory, streams k in tiles of 64 keys, each thread computing
// a 2 x 4 register tile of scores into a 32 x Nk fp32 score buffer that stays
// in shared memory (at most 129 KiB for Nk = 1024); the two-pass softmax runs
// on that buffer, then v streams through and each thread accumulates a 4 x 4
// output tile. Staged rows are padded to an odd length so that column walks
// hit distinct banks.
//
// Neither pads anything in device memory: ragged query rows, key tiles and
// head dims are masked inside the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // queries per block
constexpr int kTile = 64;      // keys per staged k or v tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxKeys = 1024;
constexpr int kMaxDim = 128;
constexpr float kNegBig = -0.7f * FLT_MAX;

// Shared memory of a block, in floats: q rows, one k/v tile, score rows.
__host__ __device__ constexpr int score_stride(int nk) {
  // a multiple of 64 plus 8: the two query rows a warp writes in the score
  // phase land 16 banks apart
  return (nk + kTile - 1) / kTile * kTile + 8;
}
constexpr size_t kMaxSmemBytes =
    sizeof(float) * (kRows * (kMaxDim + 1) + kTile * (kMaxDim + 1) +
                     kRows * score_stride(kMaxKeys));

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {  // element strides of a (B, H, N, D) operand along B, H, N
  int64_t b, h, n;
};

// Stage rows [row0, row0 + rows) of one (b, h) slice of x into dst, `width`
// elements each, rows ld floats apart; rows past `n` become zeros.
__device__ __forceinline__ void stage(float* dst, int ld, const float* x,
                                      int64_t n_stride, int row0, int rows,
                                      int n, int width) {
  for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
    const int r = idx / width, d = idx % width;
    dst[r * ld + d] = row0 + r < n ? x[(row0 + r) * n_stride + d] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) attention_vmem_fwd_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
    float* __restrict__ out, int n_heads,
    int nq, int nk, int dqk, int dv, Strides qs, Strides ks, Strides vs,
    float scale) {
  extern __shared__ float smem[];
  const int ldq = dqk + 1;
  const int ldkv = (dqk > dv ? dqk : dv) + 1;
  const int lds = score_stride(nk);
  float* q_s = smem;                 // kRows x ldq
  float* kv_s = q_s + kRows * ldq;   // kTile x ldkv
  float* s_s = kv_s + kTile * ldkv;  // kRows x lds

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const float* qbh = q + b * qs.b + h * qs.h;
  const float* kbh = k + b * ks.b + h * ks.h;
  const float* vbh = v + b * vs.b + h * vs.h;
  const uint8_t* mask_row = key_mask ? key_mask + static_cast<int64_t>(b) * nk
                                     : nullptr;

  stage(q_s, ldq, qbh, qs.n, row0, kRows, nq, dqk);

  // -- scores: rows 2 ty + i, keys tx + 16 m of each tile ------------------ //
  {
    const int tx = tid % 16, ty = tid / 16;
    const float* qa = q_s + (2 * ty) * ldq;
    const float* qb = qa + ldq;
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      __syncthreads();  // q staged; the previous tile's readers are done
      stage(kv_s, ldkv, kbh, ks.n, j0, kTile, nk, dqk);
      __syncthreads();
      float acc[2][4] = {};
      for (int d = 0; d < dqk; ++d) {
        const float a0 = qa[d], a1 = qb[d];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float kv = kv_s[(tx + 16 * m) * ldkv + d];
          acc[0][m] = fmaf(a0, kv, acc[0][m]);
          acc[1][m] = fmaf(a1, kv, acc[1][m]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = j0 + tx + 16 * m;
        if (j >= nk) continue;
        const float bias =
            mask_row == nullptr || mask_row[j] != 0 ? 0.0f : kNegBig;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          s_s[(2 * ty + i) * lds + j] = acc[i][m] * scale + bias;
      }
    }
  }
  __syncthreads();

  // -- guarded softmax, one warp per row ----------------------------------- //
  {
    const int warp = tid / 32, lane = tid % 32;
    const int nk_tiles = (nk + kTile - 1) / kTile * kTile;
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float* srow = s_s + r * lds;
      float m = -FLT_MAX;
      for (int j = lane; j < nk; j += 32) m = fmaxf(m, srow[j]);
      m = fmaxf(warp_max(m), -1e30f);
      float l = 0.0f;
      for (int j = lane; j < nk; j += 32) {
        const float e = expf(srow[j] - m);
        srow[j] = e;
        l += e;
      }
      l = fmaxf(warp_sum(l), 1e-30f);
      for (int j = lane; j < nk; j += 32) srow[j] /= l;
      for (int j = nk + lane; j < nk_tiles; j += 32) srow[j] = 0.0f;
    }
  }

  // -- out = P.V: rows 4 ry + i, columns cx + 32 m ------------------------- //
  const int cx = tid % 32, ry = tid / 32;
  const int col_groups = (dv + 31) / 32;
  float o[4][4] = {};
  for (int j0 = 0; j0 < nk; j0 += kTile) {
    __syncthreads();  // probabilities written; the previous tile is read
    stage(kv_s, ldkv, vbh, vs.n, j0, kTile, nk, dv);
    __syncthreads();
    const int jn = nk - j0 < kTile ? nk - j0 : kTile;
    for (int j = 0; j < jn; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(4 * ry + i) * lds + j0 + j];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m >= col_groups) break;
        const float x = kv_s[j * ldkv + cx + 32 * m];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][m] = fmaf(p[i], x, o[i][m]);
      }
    }
  }

  float* obh = out + (static_cast<int64_t>(b) * n_heads + h) * nq * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ry + i;
    if (r >= nq) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = cx + 32 * m;
      if (c < dv) obh[static_cast<int64_t>(r) * dv + c] = o[i][m];
    }
  }
}

// -------------------------------------------------------------------------- //
// bf16 on the tensor cores
// -------------------------------------------------------------------------- //

using bf16 = __nv_bfloat16;
// A warp owns 16 query rows, a block at most 6 warps (576 queries: 6 blocks
// with no idle row); the small-head instantiations are held to 3 blocks per
// SM by their launch bounds, which ran faster at the MLA site than 8-warp
// blocks at 2 per SM.
constexpr int kMmaMaxWarps = 6;
constexpr int kMmaKeys = 64;       // keys per staged tile (128 ran slower:
                                   // registers)
constexpr int kNT = kMmaKeys / 8;  // its n-tiles of 8 keys
constexpr int kRowPad = 8;  // bf16 padding of staged rows: fragment loads of
                            // the 8 row groups land in distinct banks
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block: its q rows, two k tiles, two v tiles (row-major)
// and two tiles of key biases (the double buffer of the key loop).
__host__ __device__ constexpr size_t mma_smem_bytes(int warps, int dqk,
                                                    int dv) {
  return sizeof(bf16) * ((16 * warps + 2 * kMmaKeys) *
                             ((dqk + 15) / 16 * 16 + kRowPad) +
                         2 * kMmaKeys * ((dv + 7) / 8 * 8 + kRowPad)) +
         sizeof(float) * 2 * kMmaKeys;
}

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

// The warp's 16 x 64 scores of the staged key tile: q.k * scale + bias, in
// the accumulator layout (s[j]: keys 8 j + 2 c + {0, 1} of rows g (0, 1) and
// g + 8 (2, 3)). bias is 0 for a visible key, NEG_BIG for a masked one and
// -inf past Nk.
template <int KQ>
__device__ __forceinline__ void tile_scores(float (&s)[kNT][4],
                                            const uint32_t (&qa)[KQ][4],
                                            const bf16* k_s, int ldq, int kq,
                                            const float* bias_s, int g,
                                            int c, float scale) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int t = 0; t < KQ; ++t) {
    if (t >= kq) break;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const bf16* kr = k_s + (8 * j + g) * ldq + 16 * t + 2 * c;
      const uint32_t kb[2] = {ld32(kr), ld32(kr + 8)};
      mma_16816(s[j], qa[t], kb);
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float b0 = bias_s[8 * j + 2 * c], b1 = bias_s[8 * j + 2 * c + 1];
    s[j][0] = s[j][0] * scale + b0;
    s[j][1] = s[j][1] * scale + b1;
    s[j][2] = s[j][2] * scale + b0;
    s[j][3] = s[j][3] * scale + b1;
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
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// exp(s - m) as exp2(s log2 e - m log2 e): one FFMA and one MUFU.EX2
__device__ __forceinline__ float exp_shifted(float s, float m_log2e) {
  return exp2_approx(fmaf(s, kLog2e, -m_log2e));
}

struct Vecs {  // elements per staging load of q, k and v
  int q, k, v;
};

// KQ: the most 16-wide steps of Dqk, NV: the most 8-wide tiles of Dv. The
// block has blockDim.x / 32 warps, 16 query rows each.
template <int KQ, int NV>
__global__ void __launch_bounds__(32 * kMmaMaxWarps,
                                  KQ <= 4 && NV <= 8 ? 3 : 1)
    attention_vmem_fwd_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const uint8_t* __restrict__ key_mask,
        bf16* __restrict__ out, int n_heads, int nq, int nk, int dqk, int dv,
        Strides qs, Strides ks, Strides vs, float scale, Vecs vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kq = (dqk + 15) / 16, nv = (dv + 7) / 8;
  const int ldq = kq * 16 + kRowPad, ldv = nv * 8 + kRowPad;
  const int rows = 16 * (blockDim.x / 32);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // rows x ldq
  bf16* k_s = q_s + rows * ldq;                   // 2 x kMmaKeys x ldq
  bf16* v_s = k_s + 2 * kMmaKeys * ldq;           // 2 x kMmaKeys x ldv
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kMmaKeys * ldv);

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const bf16* qbh = q + b * qs.b + h * qs.h;
  const bf16* kbh = k + b * ks.b + h * ks.h;
  const bf16* vbh = v + b * vs.b + h * vs.h;
  const uint8_t* mask_row = key_mask ? key_mask + static_cast<int64_t>(b) * nk
                                     : nullptr;
  const int n_tiles = (nk + kMmaKeys - 1) / kMmaKeys;

  // Start loading key tile `tile` (and its v rows) into buffer tile % 2,
  // with its biases: 0 for a visible key, NEG_BIG for a masked one, -inf
  // past Nk. One cp.async group per tile.
  auto load_tile = [&](int tile, bool with_v) {
    const int buf = tile & 1, j0 = tile * kMmaKeys;
    stage_rows(k_s + buf * kMmaKeys * ldq, ldq, kbh, ks.n, j0, kMmaKeys, nk,
               dqk, kq * 16, vec.k);
    if (with_v)
      stage_rows(v_s + buf * kMmaKeys * ldv, ldv, vbh, vs.n, j0, kMmaKeys,
                 nk, dv, nv * 8, vec.v);
    for (int i = threadIdx.x; i < kMmaKeys; i += blockDim.x) {
      const int key = j0 + i;
      float bias = 0.0f;
      if (key >= nk)
        bias = -INFINITY;
      else if (mask_row != nullptr && mask_row[key] == 0)
        bias = kNegBig;
      bias_s[buf * kMmaKeys + i] = bias;
    }
    cp_async_commit();
  };

  stage_rows(q_s, ldq, qbh, qs.n, row0, rows, nq, dqk, kq * 16, vec.q);
  cp_async_commit();
  load_tile(0, false);
  cp_async_wait<1>();  // q landed
  __syncthreads();
  uint32_t qa[KQ][4];
  const bf16* qw = q_s + 16 * warp * ldq;
#pragma unroll
  for (int t = 0; t < KQ; ++t) {
    if (t >= kq) break;
    qa[t][0] = ld32(qw + g * ldq + 16 * t + 2 * c);
    qa[t][1] = ld32(qw + (g + 8) * ldq + 16 * t + 2 * c);
    qa[t][2] = ld32(qw + g * ldq + 16 * t + 8 + 2 * c);
    qa[t][3] = ld32(qw + (g + 8) * ldq + 16 * t + 8 + 2 * c);
  }

  // pass 1: the row max m (at least -1e30) and the sum l of exp(s - m);
  // tile i + 1 loads while tile i is computed
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1, false);
    else cp_async_commit();  // an empty group keeps the count uniform
    cp_async_wait<1>();      // tile i landed
    __syncthreads();
    float s[kNT][4];
    tile_scores<KQ>(s, qa, k_s + (i & 1) * kMmaKeys * ldq, ldq, kq,
                    bias_s + (i & 1) * kMmaKeys, g, c, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // two chains each for the max and the sum: shorter dependencies
      float mx[2] = {s[0][2 * r], s[0][2 * r + 1]};
#pragma unroll
      for (int j = 1; j < kNT; ++j) {
        mx[0] = fmaxf(mx[0], s[j][2 * r]);
        mx[1] = fmaxf(mx[1], s[j][2 * r + 1]);
      }
      const float m_new = fmaxf(m[r], quad_max(fmaxf(mx[0], mx[1])));
      const float m_log2e = m_new * kLog2e;
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        part[0] += exp_shifted(s[j][2 * r], m_log2e);
        part[1] += exp_shifted(s[j][2 * r + 1], m_log2e);
      }
      // the rescale from the old max: exactly 1 when the max stays, even at
      // the -1e30 floor of a row whose keys are all masked so far
      l[r] = l[r] * exp2_approx((m[r] - m_new) * kLog2e) +
             (part[0] + part[1]);
      m[r] = m_new;
    }
    __syncthreads();  // buffer i % 2 is refilled by the next load_tile
  }
  float m_log2e[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_log2e[r] = m[r] * kLog2e;
    inv_l[r] = 1.0f / fmaxf(quad_sum(l[r]), 1e-30f);
  }

  // pass 2: p = exp(s - m) / l rounded to bf16, out += p . v
  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  load_tile(0, true);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1, true);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* vt = v_s + (i & 1) * kMmaKeys * ldv;
    float s[kNT][4];
    tile_scores<KQ>(s, qa, k_s + (i & 1) * kMmaKeys * ldq, ldq, kq,
                    bias_s + (i & 1) * kMmaKeys, g, c, scale);
#pragma unroll
    for (int t = 0; t < kMmaKeys / 16; ++t) {
      // keys 16 t .. 16 t + 15 are the n-tiles 2 t and 2 t + 1
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          pa[2 * half + r] = pack_bf16(
              exp_shifted(s[2 * t + half][2 * r], m_log2e[r]) * inv_l[r],
              exp_shifted(s[2 * t + half][2 * r + 1], m_log2e[r]) * inv_l[r]);
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (n >= nv) break;
        uint32_t vb[2];
        ldsm_x2_trans(vb, vt + (16 * t + (lane & 15)) * ldv + 8 * n);
        mma_16816(o[n], pa, vb);
      }
    }
    __syncthreads();
  }

  bf16* obh = out + (static_cast<int64_t>(b) * n_heads + h) * nq * dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      if (n >= nv) break;
      const int col = 8 * n + 2 * c;
      bf16* dst = obh + static_cast<int64_t>(row) * dv + col;
      if (col < dv) dst[0] = __float2bfloat16_rn(o[n][2 * r]);
      if (col + 1 < dv) dst[1] = __float2bfloat16_rn(o[n][2 * r + 1]);
    }
  }
}

// The widest staging load (8, 2 or 1 elements) that the width, the strides
// and the base's alignment allow.
int staging_vec(const void* base, const Strides& s, int width) {
  const int widest[2] = {8, 2};
  for (const int vec : widest) {
    if (width % vec == 0 && s.b % vec == 0 && s.h % vec == 0 &&
        s.n % vec == 0 &&
        reinterpret_cast<uintptr_t>(base) % (sizeof(bf16) * vec) == 0)
      return vec;
  }
  return 1;
}

// Warps per block: 16 query rows each, at most 8, chosen to leave the
// fewest idle rows in the last block (nq = 576 takes 6 warps, 16 takes 1).
int mma_warps(int nq) {
  const int groups = (nq + 15) / 16;
  const int most = groups < kMmaMaxWarps ? groups : kMmaMaxWarps;
  int best = most, best_idle = 1 << 30;
  for (int w = most; w >= (most + 1) / 2; --w) {
    const int idle = (groups + w - 1) / w * w - groups;
    if (idle < best_idle) best = w, best_idle = idle;
  }
  return best;
}

template <int KQ, int NV>
int launch_mma(const void* q, const void* k, const void* v,
               const void* key_mask, void* out, int batch, int n_heads,
               int nq, int nk, int dqk, int dv, Strides qs, Strides ks,
               Strides vs, float scale, cudaStream_t stream) {
  const auto kernel = attention_vmem_fwd_mma_kernel<KQ, NV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(mma_smem_bytes(kMmaMaxWarps, KQ * 16, NV * 8)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Vecs vec{staging_vec(q, qs, dqk), staging_vec(k, ks, dqk),
                 staging_vec(v, vs, dv)};
  const int warps = mma_warps(nq);
  const dim3 grid((nq + 16 * warps - 1) / (16 * warps), n_heads, batch);
  kernel<<<grid, 32 * warps, mma_smem_bytes(warps, dqk, dv), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<bf16*>(out), n_heads, nq, nk, dqk, dv, qs, ks, vs, scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_fp32(const void* q, const void* k, const void* v,
                const void* key_mask, void* out, int batch, int n_heads,
                int nq, int nk, int dqk, int dv, Strides qs, Strides ks,
                Strides vs, float scale, cudaStream_t stream) {
  // once: allow the largest block's dynamic shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_vmem_fwd_fp32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int ldq = dqk + 1, ldkv = (dqk > dv ? dqk : dv) + 1;
  const size_t smem = sizeof(float) * (kRows * ldq + kTile * ldkv +
                                       kRows * score_stride(nk));
  const dim3 grid((nq + kRows - 1) / kRows, n_heads, batch);
  attention_vmem_fwd_fp32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<float*>(out), n_heads, nq, nk, dqk, dv, qs, ks, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (batch, n_heads, nq, dqk), k (.., nk, dqk), v (.., nk, dv) with unit
// stride along the head dim and the given element strides along batch, head
// and sequence; key_mask (batch, nk) bytes or null; out (batch, n_heads, nq,
// dv) contiguous. dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t
// value; 0 on a clean launch.
extern "C" int attention_vmem_fwd(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, int batch, int n_heads, int nq, int nk, int dqk, int dv,
    int64_t q_b, int64_t q_h, int64_t q_n, int64_t k_b, int64_t k_h,
    int64_t k_n, int64_t v_b, int64_t v_h, int64_t v_n, float scale,
    int dtype, void* stream) {
  if (nk < 1 || nk > kMaxKeys || dqk < 1 || dqk > kMaxDim || dv < 1 ||
      dv > kMaxDim || n_heads > 65535 || batch > 65535 || nq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0 || n_heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_b, q_h, q_n}, ks{k_b, k_h, k_n}, vs{v_b, v_h, v_n};
  if (dtype == 0)
    return launch_fp32(q, k, v, key_mask, out, batch, n_heads, nq, nk, dqk,
                       dv, qs, ks, vs, scale, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dqk <= 48 && dv <= 32)  // the MLA site: fewer registers, 3 blocks/SM
    return launch_mma<3, 4>(q, k, v, key_mask, out, batch, n_heads, nq, nk,
                            dqk, dv, qs, ks, vs, scale, s);
  if (dqk <= 64 && dv <= 64)
    return launch_mma<4, 8>(q, k, v, key_mask, out, batch, n_heads, nq, nk,
                            dqk, dv, qs, ks, vs, scale, s);
  if (dqk <= 64)
    return launch_mma<4, 16>(q, k, v, key_mask, out, batch, n_heads, nq, nk,
                             dqk, dv, qs, ks, vs, scale, s);
  if (dv <= 64)
    return launch_mma<8, 8>(q, k, v, key_mask, out, batch, n_heads, nq, nk,
                            dqk, dv, qs, ks, vs, scale, s);
  return launch_mma<8, 16>(q, k, v, key_mask, out, batch, n_heads, nq, nk,
                           dqk, dv, qs, ks, vs, scale, s);
}
