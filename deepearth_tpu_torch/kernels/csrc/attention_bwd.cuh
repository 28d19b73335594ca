// The backward of multi-head attention, shared by K3-bwd
// (attention_vmem_bwd.cu) and K4-bwd (flash_attention_bwd.cu).
//
// Given q (B, H, Nq, Dqk), k (B, H, Nk, Dqk), v (B, H, Nk, Dv), an optional
// (B, Nk) key mask (and for K4 a causal mask, key j visible to query i iff
// j <= i) and dout (B, H, Nq, Dv), with per row the log-sum-exp lse of the
// scores and delta:
//   p = exp(s - lse), 0 where masked;     s = q.k * scale in fp32
//   dv = (p -> bf16)^T . dout             fp32 sums, rounded once
//   ds = p (dout.v^T - delta) * scale     fp32
//   dq = (ds -> bf16) . k,  dk = (ds -> bf16)^T . q
// (in fp32 the roundings to bf16 are not taken). A row whose keys are all
// masked has lse = +inf, so p = 0 there: its dq is 0 and it adds nothing to
// dk or dv. Where lse and delta come from is the one difference between the
// two kernels, the template flag kStats:
//   K3 (kStats): the JAX kernel recomputes the exact softmax and takes
//     delta = rowsum(dp o p) with the fp32 p. The dq kernel first runs a
//     pass over the keys that keeps, per row, the running max m, the sum l
//     of exp(s - m) and the sum t of exp(s - m) dp, all rescaled as the max
//     grows; then lse = m + log l and delta = t / l.
//   K4 (!kStats): lse comes from the forward, and delta = di =
//     rowsum(out o dout) as the library's flash backward takes it.
//
// Two kernels per call, on one stream: the dq kernel (one block per (b, h,
// tile of queries), a loop over the keys) writes dq and each row's lse and
// delta; the dk/dv kernel (one block per (b, h, tile of keys), a loop over
// the queries) reads them and writes dk and dv. Every sum stays inside one
// block: no atomics, no order that changes from run to run.
//
// bf16 (the model's path): tensor cores through mma.sync m16n8k16. A warp
// owns 16 rows and keeps their q and dout fragments (dq kernel) or k and v
// fragments (dk/dv kernel) in registers; the other side streams through
// shared memory in tiles of 64 rows, double-buffered with cp.async. The
// probabilities and ds come out of the q.k^T and dout.v^T accumulators and
// feed the next products as their A operands, so scores never leave the
// registers. fp32: the same two kernels with one thread per row on the CUDA
// cores, exact fp32 products.
//
// Bound on the H100: at the multimodal MLA site (B = 512, H = 8, 576 x 576,
// Dqk 48, Dv 32) the function moves q, k, v, dout in and dq, dk, dv out,
// 1.36 GB, about 0.4 ms at 3.35 TB/s; its five products (q.k, dout.v,
// p^T.dout, ds.k, ds^T.q) are 0.68 TFLOP, 0.69 ms at the bf16 peak. This
// design does q.k and dout.v three times (the dq kernel's two passes and the
// dk/dv kernel) for 1.0 TFLOP of mma.sync work.

#pragma once

#include "attention_common.cuh"

namespace {

// One backward call. dout, out, dq, dk, dv, lse and delta are contiguous.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;   // K4: the forward's output (for di); K3: null
  const void* dout;  // (B, H, Nq, Dv)
  const uint8_t* key_mask;  // (B, Nk) or null
  float* lse;    // (B, H, Nq): K4 reads the forward's; K3's dq kernel writes
  float* delta;  // (B, H, Nq): written by the dq kernel
  void* dq;      // (B, H, Nq, Dqk)
  void* dk;      // (B, H, Nk, Dqk)
  void* dv;      // (B, H, Nk, Dv)
  int batch, n_heads, nq, nk, d_qk, d_v;
  Strides qs, ks, vs;
  float scale;
  int causal;
};

struct BwdVecs {  // elements per staging load of q, k, v and dout
  int q, k, v, o;
};

constexpr int kBwdWarps = 4;
constexpr int kSimtThreads = 128;

// Shared memory of either bf16 block with `rows` rows of its own: those rows
// of both operands, two tiles of 64 rows of each streamed operand, and per
// streamed row (and own row) two floats.
__host__ __device__ constexpr size_t bwd_smem_bytes(int rows, int d_qk,
                                                    int d_v) {
  return sizeof(bf16) * (rows + 2 * kMmaKeys) *
             ((d_qk + 15) / 16 * 16 + (d_v + 15) / 16 * 16 + 2 * kRowPad) +
         sizeof(float) * (4 * kMmaKeys + 2 * rows);
}

// The dq kernel's scores and dp = dout.v^T against one staged key tile:
// s = q.k * scale, -inf where the key is masked (bias_t: 0 or -inf per key)
// or, causal, after the row; dp unmasked.
template <int KQ, int KV>
__device__ __forceinline__ void scores_and_dp(
    float (&s)[kNT][4], float (&dp)[kNT][4], const uint32_t (&qa)[KQ][4],
    const uint32_t (&da)[KV][4], const bf16* k_t, const bf16* v_t,
    const float* bias_t, int ldq, int ldv, int kq, int kv, int g, int c,
    float scale, int causal, int key0, int row_g) {
  product_nt<KQ>(s, qa, k_t, ldq, kq, g, c);
  product_nt<KV>(dp, da, v_t, ldv, kv, g, c);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * c + (e & 1);
      float bias = bias_t[col];
      if (causal && key0 + col > row_g + 8 * (e >> 1)) bias = -INFINITY;
      s[j][e] = fmaf(s[j][e], scale, bias);
    }
  }
}

template <int KQ, int KV, bool kStats>
__global__ void __launch_bounds__(32 * kBwdWarps)
    attention_bwd_dq_mma_kernel(BwdArgs a, BwdVecs vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kq = (a.d_qk + 15) / 16, kv = (a.d_v + 15) / 16;
  const int ldq = 16 * kq + kRowPad, ldv = 16 * kv + kRowPad;
  const int rows = 16 * (blockDim.x / 32);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // rows x ldq
  bf16* do_s = q_s + rows * ldq;                  // rows x ldv
  bf16* k_s = do_s + rows * ldv;                  // 2 x kMmaKeys x ldq
  bf16* v_s = k_s + 2 * kMmaKeys * ldq;           // 2 x kMmaKeys x ldv
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kMmaKeys * ldv);
  float* stat_s = bias_s + 2 * kMmaKeys;  // rows x (lse, delta), K4

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int64_t bh = static_cast<int64_t>(b) * a.n_heads + h;
  const bf16* qbh = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kbh = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vbh = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* dobh = static_cast<const bf16*>(a.dout) + bh * a.nq * a.d_v;
  const uint8_t* mask_row =
      a.key_mask ? a.key_mask + static_cast<int64_t>(b) * a.nk : nullptr;
  // causal: no row of this block sees a key after its last row
  const int n_keys = a.causal ? min(a.nk, row0 + rows) : a.nk;
  const int n_tiles = (n_keys + kMmaKeys - 1) / kMmaKeys;

  // Start loading key tile `tile` (its k and v rows) into buffer tile % 2,
  // with its biases: 0 for a visible key, -inf for a masked one or one past
  // Nk. One cp.async group per tile.
  auto load_tile = [&](int tile) {
    const int buf = tile & 1, j0 = tile * kMmaKeys;
    stage_rows(k_s + buf * kMmaKeys * ldq, ldq, kbh, a.ks.n, j0, kMmaKeys,
               a.nk, a.d_qk, 16 * kq, vec.k);
    stage_rows(v_s + buf * kMmaKeys * ldv, ldv, vbh, a.vs.n, j0, kMmaKeys,
               a.nk, a.d_v, 16 * kv, vec.v);
    for (int i = threadIdx.x; i < kMmaKeys; i += blockDim.x) {
      const int key = j0 + i;
      const bool visible =
          key < a.nk && (mask_row == nullptr || mask_row[key] != 0);
      bias_s[buf * kMmaKeys + i] = visible ? 0.0f : -INFINITY;
    }
    cp_async_commit();
  };

  stage_rows(q_s, ldq, qbh, a.qs.n, row0, rows, a.nq, a.d_qk, 16 * kq,
             vec.q);
  stage_rows(do_s, ldv, dobh, a.d_v, row0, rows, a.nq, a.d_v, 16 * kv,
             vec.o);
  cp_async_commit();
  if (!kStats) {
    // the forward's lse, and di = rowsum(out o dout) in fp32
    const bf16* obh = static_cast<const bf16*>(a.out) + bh * a.nq * a.d_v;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int row = row0 + r;
      float lse = INFINITY, di = 0.0f;
      if (row < a.nq) {
        lse = a.lse[bh * a.nq + row];
        const int64_t at = static_cast<int64_t>(row) * a.d_v;
        for (int d = 0; d < a.d_v; ++d)
          di = fmaf(__bfloat162float(obh[at + d]),
                    __bfloat162float(dobh[at + d]), di);
        a.delta[bh * a.nq + row] = di;
      }
      stat_s[2 * r] = lse;
      stat_s[2 * r + 1] = di;
    }
  }
  load_tile(0);
  cp_async_wait<1>();  // q and dout landed
  __syncthreads();
  uint32_t qa[KQ][4], da[KV][4];
  load_a_frags<KQ>(qa, q_s + 16 * warp * ldq, ldq, kq, g, c);
  load_a_frags<KV>(da, do_s + 16 * warp * ldv, ldv, kv, g, c);
  const int wrow0 = row0 + 16 * warp;

  float lse2[2], delta[2];  // lse * log2 e and delta of rows g, g + 8
  if (kStats) {
    // pass 1: m, l = sum exp(s - m), t = sum exp(s - m) dp per row
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
          t[2] = {0.0f, 0.0f};
    for (int i = 0; i < n_tiles; ++i) {
      if (i + 1 < n_tiles) load_tile(i + 1);
      else cp_async_commit();  // an empty group keeps the count uniform
      cp_async_wait<1>();      // tile i landed
      __syncthreads();
      const int buf = i & 1;
      float s[kNT][4], dp[kNT][4];
      scores_and_dp<KQ, KV>(s, dp, qa, da, k_s + buf * kMmaKeys * ldq,
                            v_s + buf * kMmaKeys * ldv,
                            bias_s + buf * kMmaKeys, ldq, ldv, kq, kv, g, c,
                            a.scale, a.causal, i * kMmaKeys, wrow0 + g);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        // a row with no visible key so far keeps m = -inf and l = t = 0
        const float ms = m_new == -INFINITY ? 0.0f : m_new * kLog2e;
        const float alpha = exp2_approx(m[r] * kLog2e - ms);
        float le = 0.0f, te = 0.0f;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = exp2_approx(fmaf(s[j][e], kLog2e, -ms));
            le += p;
            te = fmaf(p, dp[j][e], te);
          }
        }
        l[r] = fmaf(l[r], alpha, le);
        t[r] = fmaf(t[r], alpha, te);
        m[r] = m_new;
      }
      __syncthreads();  // buffer i % 2 is refilled by the next load_tile
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = quad_sum(l[r]), tt = quad_sum(t[r]);
      const float lse = lt > 0.0f ? m[r] + logf(lt) : INFINITY;
      delta[r] = lt > 0.0f ? tt / lt : 0.0f;
      lse2[r] = lse * kLog2e;
      const int row = wrow0 + g + 8 * r;
      if (c == 0 && row < a.nq) {
        a.lse[bh * a.nq + row] = lse;
        a.delta[bh * a.nq + row] = delta[r];
      }
    }
    load_tile(0);  // the dq pass starts over
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 16 * warp + g + 8 * r;
      lse2[r] = stat_s[2 * lr] * kLog2e;
      delta[r] = stat_s[2 * lr + 1];
    }
  }

  // the dq pass: ds = p (dp - delta) scale, dq += ds . k
  float dq[2 * KQ][4];
#pragma unroll
  for (int n = 0; n < 2 * KQ; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  const int nq8 = (a.d_qk + 7) / 8;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = i & 1;
    float s[kNT][4], dp[kNT][4];
    scores_and_dp<KQ, KV>(s, dp, qa, da, k_s + buf * kMmaKeys * ldq,
                          v_s + buf * kMmaKeys * ldv, bias_s + buf * kMmaKeys,
                          ldq, ldv, kq, kv, g, c, a.scale, a.causal,
                          i * kMmaKeys, wrow0 + g);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2_approx(fmaf(s[j][e], kLog2e, -lse2[r]));
        s[j][e] = p * (dp[j][e] - delta[r]) * a.scale;
      }
    }
    product_pn<2 * KQ>(dq, s, k_s + buf * kMmaKeys * ldq, ldq, nq8, lane);
    __syncthreads();
  }
  store_rows<2 * KQ>(static_cast<bf16*>(a.dq) + bh * a.nq * a.d_qk, dq,
                     wrow0, a.nq, a.d_qk, g, c);
}

template <int KQ, int KV>
__global__ void __launch_bounds__(32 * kBwdWarps)
    attention_bwd_dkdv_mma_kernel(BwdArgs a, BwdVecs vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kq = (a.d_qk + 15) / 16, kv = (a.d_v + 15) / 16;
  const int ldq = 16 * kq + kRowPad, ldv = 16 * kv + kRowPad;
  const int rows = 16 * (blockDim.x / 32);
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // rows x ldq
  bf16* v_s = k_s + rows * ldq;                   // rows x ldv
  bf16* q_s = v_s + rows * ldv;                   // 2 x kMmaKeys x ldq
  bf16* do_s = q_s + 2 * kMmaKeys * ldq;          // 2 x kMmaKeys x ldv
  // 2 x kMmaKeys x (lse * log2 e, delta)
  float* stat_s = reinterpret_cast<float*>(do_s + 2 * kMmaKeys * ldv);

  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int64_t bh = static_cast<int64_t>(b) * a.n_heads + h;
  const bf16* qbh = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kbh = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vbh = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* dobh = static_cast<const bf16*>(a.dout) + bh * a.nq * a.d_v;
  const uint8_t* mask_row =
      a.key_mask ? a.key_mask + static_cast<int64_t>(b) * a.nk : nullptr;
  // causal: the queries before this block's first key see none of its keys
  const int first = a.causal ? key0 / kMmaKeys : 0;
  const int n_tiles = (a.nq + kMmaKeys - 1) / kMmaKeys;

  // Start loading query tile `tile` (its q and dout rows, lse and delta)
  // into buffer tile % 2; queries past Nq get lse = +inf, so p = 0.
  auto load_tile = [&](int tile) {
    const int buf = tile & 1, i0 = tile * kMmaKeys;
    stage_rows(q_s + buf * kMmaKeys * ldq, ldq, qbh, a.qs.n, i0, kMmaKeys,
               a.nq, a.d_qk, 16 * kq, vec.q);
    stage_rows(do_s + buf * kMmaKeys * ldv, ldv, dobh, a.d_v, i0, kMmaKeys,
               a.nq, a.d_v, 16 * kv, vec.o);
    for (int i = threadIdx.x; i < kMmaKeys; i += blockDim.x) {
      const int qi = i0 + i;
      float* st = stat_s + 2 * (buf * kMmaKeys + i);
      st[0] = qi < a.nq ? a.lse[bh * a.nq + qi] * kLog2e : INFINITY;
      st[1] = qi < a.nq ? a.delta[bh * a.nq + qi] : 0.0f;
    }
    cp_async_commit();
  };

  stage_rows(k_s, ldq, kbh, a.ks.n, key0, rows, a.nk, a.d_qk, 16 * kq,
             vec.k);
  stage_rows(v_s, ldv, vbh, a.vs.n, key0, rows, a.nk, a.d_v, 16 * kv, vec.v);
  cp_async_commit();
  if (first < n_tiles) load_tile(first);
  else cp_async_commit();
  cp_async_wait<1>();  // k and v landed
  __syncthreads();
  uint32_t ka[KQ][4], va[KV][4];
  load_a_frags<KQ>(ka, k_s + 16 * warp * ldq, ldq, kq, g, c);
  load_a_frags<KV>(va, v_s + 16 * warp * ldv, ldv, kv, g, c);
  int key[2];
  bool key_visible[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = key0 + 16 * warp + g + 8 * r;
    key_visible[r] = key[r] < a.nk &&
                     (mask_row == nullptr || mask_row[key[r]] != 0);
  }

  float dk[2 * KQ][4], dv[2 * KV][4];
#pragma unroll
  for (int n = 0; n < 2 * KQ; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
#pragma unroll
  for (int n = 0; n < 2 * KV; ++n)
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
  const int nq8 = (a.d_qk + 7) / 8, nv8 = (a.d_v + 7) / 8;
  for (int i = first; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = i & 1;
    const bf16* q_t = q_s + buf * kMmaKeys * ldq;
    const bf16* do_t = do_s + buf * kMmaKeys * ldv;
    const float* st_t = stat_s + 2 * buf * kMmaKeys;
    // transposed: rows are this warp's keys, columns the tile's queries
    float s[kNT][4], dp[kNT][4];
    product_nt<KQ>(s, ka, q_t, ldq, kq, g, c);
    product_nt<KV>(dp, va, do_t, ldv, kv, g, c);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * c + (e & 1);
        const bool visible = key_visible[r] &&
                             (!a.causal || key[r] <= i * kMmaKeys + col);
        const float p =
            visible ? exp2_approx(fmaf(s[j][e] * a.scale, kLog2e,
                                       -st_t[2 * col]))
                    : 0.0f;
        dp[j][e] = p * (dp[j][e] - st_t[2 * col + 1]) * a.scale;  // ds
        s[j][e] = p;
      }
    }
    product_pn<2 * KV>(dv, s, do_t, ldv, nv8, lane);
    product_pn<2 * KQ>(dk, dp, q_t, ldq, nq8, lane);
    __syncthreads();
  }
  store_rows<2 * KQ>(static_cast<bf16*>(a.dk) + bh * a.nk * a.d_qk, dk,
                     key0 + 16 * warp, a.nk, a.d_qk, g, c);
  store_rows<2 * KV>(static_cast<bf16*>(a.dv) + bh * a.nk * a.d_v, dv,
                     key0 + 16 * warp, a.nk, a.d_v, g, c);
}

// ------------------------------------------------------------------------ //
// fp32 on the CUDA cores: one thread per row, its vectors in registers
// ------------------------------------------------------------------------ //

template <int D>
__device__ __forceinline__ float dot_row(const float (&r)[D],
                                         const float* x, int n) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < n) acc = fmaf(r[d], x[d], acc);
  return acc;
}

template <int D>
__device__ __forceinline__ void load_row(float (&r)[D], const float* x,
                                         int n) {
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = d < n ? x[d] : 0.0f;
}

template <int DQ, int DV, bool kStats>
__global__ void __launch_bounds__(kSimtThreads)
    attention_bwd_dq_simt_kernel(BwdArgs a) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int i = blockIdx.x * kSimtThreads + threadIdx.x;
  if (i >= a.nq) return;
  const int64_t bh = static_cast<int64_t>(b) * a.n_heads + h;
  const int64_t row = bh * a.nq + i;
  const float* kbh = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vbh = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const uint8_t* mask_row =
      a.key_mask ? a.key_mask + static_cast<int64_t>(b) * a.nk : nullptr;
  float qr[DQ], dor[DV], dq[DQ];
  load_row<DQ>(qr, static_cast<const float*>(a.q) + b * a.qs.b +
                       h * a.qs.h + i * a.qs.n, a.d_qk);
  load_row<DV>(dor, static_cast<const float*>(a.dout) + row * a.d_v, a.d_v);
  const int n_keys = a.causal ? min(a.nk, i + 1) : a.nk;

  float lse, delta;
  if (kStats) {
    float m = -INFINITY, l = 0.0f, t = 0.0f;
    for (int j = 0; j < n_keys; ++j) {
      if (mask_row != nullptr && mask_row[j] == 0) continue;
      const float s = dot_row<DQ>(qr, kbh + j * a.ks.n, a.d_qk) * a.scale;
      const float dp = dot_row<DV>(dor, vbh + j * a.vs.n, a.d_v);
      if (s > m) {
        const float alpha = expf(m - s);
        l *= alpha;
        t *= alpha;
        m = s;
      }
      const float e = expf(s - m);
      l += e;
      t = fmaf(e, dp, t);
    }
    lse = l > 0.0f ? m + logf(l) : INFINITY;
    delta = l > 0.0f ? t / l : 0.0f;
    a.lse[row] = lse;
  } else {
    lse = a.lse[row];
    delta = dot_row<DV>(dor, static_cast<const float*>(a.out) + row * a.d_v,
                        a.d_v);
  }
  a.delta[row] = delta;

#pragma unroll
  for (int d = 0; d < DQ; ++d) dq[d] = 0.0f;
  for (int j = 0; j < n_keys; ++j) {
    if (mask_row != nullptr && mask_row[j] == 0) continue;
    const float* kj = kbh + j * a.ks.n;
    const float s = dot_row<DQ>(qr, kj, a.d_qk) * a.scale;
    const float p = expf(s - lse);
    const float dp = dot_row<DV>(dor, vbh + j * a.vs.n, a.d_v);
    const float ds = p * (dp - delta) * a.scale;
#pragma unroll
    for (int d = 0; d < DQ; ++d)
      if (d < a.d_qk) dq[d] = fmaf(ds, kj[d], dq[d]);
  }
  float* dst = static_cast<float*>(a.dq) + row * a.d_qk;
#pragma unroll
  for (int d = 0; d < DQ; ++d)
    if (d < a.d_qk) dst[d] = dq[d];
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kSimtThreads)
    attention_bwd_dkdv_simt_kernel(BwdArgs a) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int j = blockIdx.x * kSimtThreads + threadIdx.x;
  if (j >= a.nk) return;
  const int64_t bh = static_cast<int64_t>(b) * a.n_heads + h;
  const float* qbh = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* dobh = static_cast<const float*>(a.dout) + bh * a.nq * a.d_v;
  float kr[DQ], vr[DV], dk[DQ], dv[DV];
  load_row<DQ>(kr, static_cast<const float*>(a.k) + b * a.ks.b +
                       h * a.ks.h + j * a.ks.n, a.d_qk);
  load_row<DV>(vr, static_cast<const float*>(a.v) + b * a.vs.b +
                       h * a.vs.h + j * a.vs.n, a.d_v);
#pragma unroll
  for (int d = 0; d < DQ; ++d) dk[d] = 0.0f;
#pragma unroll
  for (int d = 0; d < DV; ++d) dv[d] = 0.0f;
  const bool visible =
      a.key_mask == nullptr ||
      a.key_mask[static_cast<int64_t>(b) * a.nk + j] != 0;
  for (int i = a.causal ? j : 0; visible && i < a.nq; ++i) {
    const float* qi = qbh + i * a.qs.n;
    const float* doi = dobh + static_cast<int64_t>(i) * a.d_v;
    // an all-masked query row has lse = +inf: p = 0
    const float p = expf(dot_row<DQ>(kr, qi, a.d_qk) * a.scale -
                         a.lse[bh * a.nq + i]);
    const float ds = p * (dot_row<DV>(vr, doi, a.d_v) -
                          a.delta[bh * a.nq + i]) * a.scale;
#pragma unroll
    for (int d = 0; d < DV; ++d)
      if (d < a.d_v) dv[d] = fmaf(p, doi[d], dv[d]);
#pragma unroll
    for (int d = 0; d < DQ; ++d)
      if (d < a.d_qk) dk[d] = fmaf(ds, qi[d], dk[d]);
  }
  float* dk_dst = static_cast<float*>(a.dk) + (bh * a.nk + j) * a.d_qk;
  float* dv_dst = static_cast<float*>(a.dv) + (bh * a.nk + j) * a.d_v;
#pragma unroll
  for (int d = 0; d < DQ; ++d)
    if (d < a.d_qk) dk_dst[d] = dk[d];
#pragma unroll
  for (int d = 0; d < DV; ++d)
    if (d < a.d_v) dv_dst[d] = dv[d];
}

// ------------------------------------------------------------------------ //
// launches
// ------------------------------------------------------------------------ //

template <int KQ, int KV, bool kStats>
int launch_bwd_mma(const BwdArgs& a, cudaStream_t stream) {
  const auto dq_kernel = attention_bwd_dq_mma_kernel<KQ, KV, kStats>;
  const auto dkdv_kernel = attention_bwd_dkdv_mma_kernel<KQ, KV>;
  // once per instantiation: allow its largest block's dynamic shared memory
  static const cudaError_t attr = [&] {
    const int most =
        static_cast<int>(bwd_smem_bytes(16 * kBwdWarps, 16 * KQ, 16 * KV));
    const cudaError_t e = cudaFuncSetAttribute(
        dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(
                     dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     most);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides os{static_cast<int64_t>(a.n_heads) * a.nq * a.d_v,
                   static_cast<int64_t>(a.nq) * a.d_v, a.d_v};
  const BwdVecs vec{staging_vec(a.q, a.qs, a.d_qk),
                    staging_vec(a.k, a.ks, a.d_qk),
                    staging_vec(a.v, a.vs, a.d_v),
                    staging_vec(a.dout, os, a.d_v)};
  int warps = mma_warps(a.nq, kBwdWarps);
  dim3 grid((a.nq + 16 * warps - 1) / (16 * warps), a.n_heads, a.batch);
  dq_kernel<<<grid, 32 * warps, bwd_smem_bytes(16 * warps, a.d_qk, a.d_v),
              stream>>>(a, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  warps = mma_warps(a.nk, kBwdWarps);
  grid.x = (a.nk + 16 * warps - 1) / (16 * warps);
  dkdv_kernel<<<grid, 32 * warps, bwd_smem_bytes(16 * warps, a.d_qk, a.d_v),
                stream>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DQ, int DV, bool kStats>
int launch_bwd_simt(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.nq + kSimtThreads - 1) / kSimtThreads, a.n_heads, a.batch);
  attention_bwd_dq_simt_kernel<DQ, DV, kStats>
      <<<grid, kSimtThreads, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grid.x = (a.nk + kSimtThreads - 1) / kSimtThreads;
  attention_bwd_dkdv_simt_kernel<DQ, DV>
      <<<grid, kSimtThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The shapes K4's mma.sync and CUDA-core entries take: head dims up to
// 256.
inline bool bad_flash_shape(int batch, int n_heads, int nq, int nk, int d_qk,
                            int d_v) {
  return nq < 0 || nk < 1 || d_qk < 1 || d_qk > 256 || d_v < 1 ||
         d_v > 256 || n_heads > 65535 || batch > 65535;
}

// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
// Head dims above 128 are K4's alone (K3 takes at most 128).
template <bool kStats>
int launch_attention_bwd(const BwdArgs& a, int dtype, cudaStream_t stream) {
  const bool wide = a.d_qk > 128 || a.d_v > 128;
  if (dtype == 0) {
    if (a.d_qk <= 64 && a.d_v <= 64)
      return launch_bwd_simt<64, 64, kStats>(a, stream);
    if (!wide) return launch_bwd_simt<128, 128, kStats>(a, stream);
    if constexpr (!kStats) return launch_bwd_simt<256, 256, false>(a, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.d_qk <= 48 && a.d_v <= 32)  // the MLA site
    return launch_bwd_mma<3, 2, kStats>(a, stream);
  if (a.d_qk <= 64 && a.d_v <= 64)  // the query-token cross-attention
    return launch_bwd_mma<4, 4, kStats>(a, stream);
  if (!wide) return launch_bwd_mma<8, 8, kStats>(a, stream);
  if constexpr (!kStats) {
    if (a.d_qk <= 192 && a.d_v <= 128)  // DeepSeek-V3's MLA
      return launch_bwd_mma<12, 8, false>(a, stream);
    return launch_bwd_mma<16, 16, false>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
