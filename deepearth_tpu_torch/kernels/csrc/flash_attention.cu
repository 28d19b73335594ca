// Long-sequence multi-head attention, forward and backward (K4-fwd, K4-bwd).
//
// Replaces: the library flash attention that deepearth_tpu/models/deepseek.py
// `MLAttention` calls at N >= flash_min_seq (jax.experimental.pallas.ops.tpu
// .flash_attention: `_flash_attention_kernel` for the forward,
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq` for the backward).
//
// Shapes: q (B, H, Nq, Dqk), k (B, H, Nk, Dqk), v (B, H, Nk, Dv), any strides
// along B, H and N with unit stride along the head dim; Dqk, Dv <= 128,
// Dqk != Dv allowed; any N (nothing is padded in device memory); an optional
// (B, Nk) key mask; `causal`: key j visible to query i iff j <= i. The
// multimodal model's vision encoder calls it at the V-JEPA2 clip shape:
// MLA self-attention over 4608 patches, 8 heads, Dqk 48, Dv 32.
//
// Forward, as the library computes it: online softmax over tiles of 64 keys,
// fp32 scores and sums; each tile's p = exp(s - m_running) rounded to v's
// type before P.V, accumulated in fp32 and rescaled as the max grows; the
// output divided by the row's sum once at the end and rounded once. It
// writes each row's log-sum-exp (fp32) for the backward. A row whose keys
// are all masked outputs 0 and gets lse = +inf: the repository's convention.
// The library kernel differs there: it adds a finite mask value and guards
// only a zero sum, so such a row comes out as the mean of v.
//
// Backward: attention_bwd.cuh (shared with K3-bwd), with delta = di =
// rowsum(out o dout), taken in the dq kernel's prologue, and the forward's
// lse.
//
// Bound on the H100: at the MLA shape, B = 64, the forward does 2 B H N^2
// (Dqk + Dv) = 1.74 TFLOP, 1.76 ms at the bf16 peak, against 0.25 GB moved:
// tensor cores bound it. The bf16 forward runs on mma.sync m16n8k16: a warp
// owns 16 query rows with their q fragments in registers, k and v stream
// through shared memory in tiles of 64 keys, double-buffered with cp.async,
// and p goes from the q.k accumulator straight into the A operand of P.V.
// Causal blocks stop at their last row's key. The fp32 forward runs one
// thread per query row on the CUDA cores, with exact fp32 products.

#include "attention_bwd.cuh"

namespace {

constexpr int kFwdWarps = 4;

struct FwdVecs {  // elements per staging load of q, k and v
  int q, k, v;
};

// Shared memory of a forward block: its q rows, two k tiles, two v tiles and
// two tiles of key biases.
__host__ __device__ constexpr size_t fwd_smem_bytes(int rows, int d_qk,
                                                    int d_v) {
  return sizeof(bf16) * ((rows + 2 * kMmaKeys) *
                             ((d_qk + 15) / 16 * 16 + kRowPad) +
                         2 * kMmaKeys * ((d_v + 15) / 16 * 16 + kRowPad)) +
         sizeof(float) * 2 * kMmaKeys;
}

// KQ: the most 16-wide steps of Dqk, KV: of Dv.
template <int KQ, int KV>
__global__ void __launch_bounds__(32 * kFwdWarps) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ key_mask,
    bf16* __restrict__ out, float* __restrict__ lse, int n_heads, int nq,
    int nk, int d_qk, int d_v, Strides qs, Strides ks, Strides vs,
    float scale, int causal, FwdVecs vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kq = (d_qk + 15) / 16, kv = (d_v + 15) / 16;
  const int ldq = 16 * kq + kRowPad, ldv = 16 * kv + kRowPad;
  const int rows = 16 * (blockDim.x / 32);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // rows x ldq
  bf16* k_s = q_s + rows * ldq;                   // 2 x kMmaKeys x ldq
  bf16* v_s = k_s + 2 * kMmaKeys * ldq;           // 2 x kMmaKeys x ldv
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kMmaKeys * ldv);

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int64_t bh = static_cast<int64_t>(b) * n_heads + h;
  const bf16* qbh = q + b * qs.b + h * qs.h;
  const bf16* kbh = k + b * ks.b + h * ks.h;
  const bf16* vbh = v + b * vs.b + h * vs.h;
  const uint8_t* mask_row =
      key_mask ? key_mask + static_cast<int64_t>(b) * nk : nullptr;
  const int n_keys = causal ? min(nk, row0 + rows) : nk;
  const int n_tiles = (n_keys + kMmaKeys - 1) / kMmaKeys;

  // Start loading key tile `tile` into buffer tile % 2 with its biases: 0
  // for a visible key, -inf for a masked one or one past Nk.
  auto load_tile = [&](int tile) {
    const int buf = tile & 1, j0 = tile * kMmaKeys;
    stage_rows(k_s + buf * kMmaKeys * ldq, ldq, kbh, ks.n, j0, kMmaKeys, nk,
               d_qk, 16 * kq, vec.k);
    stage_rows(v_s + buf * kMmaKeys * ldv, ldv, vbh, vs.n, j0, kMmaKeys, nk,
               d_v, 16 * kv, vec.v);
    for (int i = threadIdx.x; i < kMmaKeys; i += blockDim.x) {
      const int key = j0 + i;
      const bool visible =
          key < nk && (mask_row == nullptr || mask_row[key] != 0);
      bias_s[buf * kMmaKeys + i] = visible ? 0.0f : -INFINITY;
    }
    cp_async_commit();
  };

  stage_rows(q_s, ldq, qbh, qs.n, row0, rows, nq, d_qk, 16 * kq, vec.q);
  cp_async_commit();
  load_tile(0);
  cp_async_wait<1>();  // q landed
  __syncthreads();
  uint32_t qa[KQ][4];
  load_a_frags<KQ>(qa, q_s + 16 * warp * ldq, ldq, kq, g, c);
  const int wrow = row0 + 16 * warp + g;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[2 * KV][4];
#pragma unroll
  for (int n = 0; n < 2 * KV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  const int nv8 = (d_v + 7) / 8;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    else cp_async_commit();  // an empty group keeps the count uniform
    cp_async_wait<1>();      // tile i landed
    __syncthreads();
    const int buf = i & 1;
    const float* bias_t = bias_s + buf * kMmaKeys;
    float s[kNT][4];
    product_nt<KQ>(s, qa, k_s + buf * kMmaKeys * ldq, ldq, kq, g, c);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1);
        float bias = bias_t[col];
        if (causal && i * kMmaKeys + col > wrow + 8 * (e >> 1))
          bias = -INFINITY;
        s[j][e] = fmaf(s[j][e], scale, bias);
      }
    }
    float ms[2];  // the new max times log2 e; 0 while no key is visible
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      ms[r] = m_new == -INFINITY ? 0.0f : m_new * kLog2e;
      // exactly 1 when the max stays; 0 from a row with no visible key yet
      const float alpha = exp2_approx(m[r] * kLog2e - ms[r]);
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < 2 * KV; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[j][e], kLog2e, -ms[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
    product_pn<2 * KV>(o, s, v_s + buf * kMmaKeys * ldv, ldv, nv8, lane);
    __syncthreads();  // buffer i % 2 is refilled by the next load_tile
  }

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    inv_l[r] = lt > 0.0f ? 1.0f / lt : 0.0f;
    const int row = wrow + 8 * r;
    if (c == 0 && row < nq)
      lse[bh * nq + row] = lt > 0.0f ? m[r] + logf(lt) : INFINITY;
  }
  store_rows<2 * KV>(out + bh * nq * d_v, o, row0 + 16 * warp, nq, d_v, g, c,
                     inv_l[0], inv_l[1]);
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kSimtThreads) flash_fwd_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
    float* __restrict__ out, float* __restrict__ lse, int n_heads, int nq,
    int nk, int d_qk, int d_v, Strides qs, Strides ks, Strides vs,
    float scale, int causal) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int i = blockIdx.x * kSimtThreads + threadIdx.x;
  if (i >= nq) return;
  const int64_t row = (static_cast<int64_t>(b) * n_heads + h) * nq + i;
  const float* kbh = k + b * ks.b + h * ks.h;
  const float* vbh = v + b * vs.b + h * vs.h;
  const uint8_t* mask_row =
      key_mask ? key_mask + static_cast<int64_t>(b) * nk : nullptr;
  float qr[DQ], o[DV];
  load_row<DQ>(qr, q + b * qs.b + h * qs.h + i * qs.n, d_qk);
#pragma unroll
  for (int d = 0; d < DV; ++d) o[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;
  const int n_keys = causal ? min(nk, i + 1) : nk;
  for (int j = 0; j < n_keys; ++j) {
    if (mask_row != nullptr && mask_row[j] == 0) continue;
    const float s = dot_row<DQ>(qr, kbh + j * ks.n, d_qk) * scale;
    if (s > m) {
      const float alpha = expf(m - s);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DV; ++d) o[d] *= alpha;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
    const float* vj = vbh + j * vs.n;
#pragma unroll
    for (int d = 0; d < DV; ++d)
      if (d < d_v) o[d] = fmaf(p, vj[d], o[d]);
  }
  const float inv_l = l > 0.0f ? 1.0f / l : 0.0f;
#pragma unroll
  for (int d = 0; d < DV; ++d)
    if (d < d_v) out[row * d_v + d] = o[d] * inv_l;
  lse[row] = l > 0.0f ? m + logf(l) : INFINITY;
}

template <int KQ, int KV>
int launch_fwd_mma(const void* q, const void* k, const void* v,
                   const void* key_mask, void* out, float* lse, int batch,
                   int n_heads, int nq, int nk, int d_qk, int d_v, Strides qs,
                   Strides ks, Strides vs, float scale, int causal,
                   cudaStream_t stream) {
  const auto kernel = flash_fwd_mma_kernel<KQ, KV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(fwd_smem_bytes(16 * kFwdWarps, 16 * KQ, 16 * KV)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const FwdVecs vec{staging_vec(q, qs, d_qk), staging_vec(k, ks, d_qk),
                    staging_vec(v, vs, d_v)};
  const int warps = mma_warps(nq, kFwdWarps);
  const dim3 grid((nq + 16 * warps - 1) / (16 * warps), n_heads, batch);
  kernel<<<grid, 32 * warps, fwd_smem_bytes(16 * warps, d_qk, d_v),
           stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<bf16*>(out), lse, n_heads, nq, nk, d_qk, d_v, qs, ks, vs,
      scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DQ, int DV>
int launch_fwd_simt(const void* q, const void* k, const void* v,
                    const void* key_mask, void* out, float* lse, int batch,
                    int n_heads, int nq, int nk, int d_qk, int d_v,
                    Strides qs, Strides ks, Strides vs, float scale,
                    int causal, cudaStream_t stream) {
  const dim3 grid((nq + kSimtThreads - 1) / kSimtThreads, n_heads, batch);
  flash_fwd_simt_kernel<DQ, DV><<<grid, kSimtThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<float*>(out), lse, n_heads, nq, nk, d_qk, d_v, qs, ks, vs,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int n_heads, int nq, int nk, int d_qk, int d_v) {
  return nq < 0 || nk < 1 || d_qk < 1 || d_qk > 128 || d_v < 1 ||
         d_v > 128 || n_heads > 65535 || batch > 65535;
}

}  // namespace

// q (batch, n_heads, nq, d_qk), k (.., nk, d_qk), v (.., nk, d_v) with unit
// stride along the head dim and the given element strides along batch, head
// and sequence; key_mask (batch, nk) bytes or null; out (batch, n_heads, nq,
// d_v) and lse (batch, n_heads, nq) fp32, contiguous. dtype 0 = float32,
// 1 = bfloat16. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, void* lse, int batch, int n_heads, int nq, int nk, int d_qk,
    int d_v, int64_t q_b, int64_t q_h, int64_t q_n, int64_t k_b, int64_t k_h,
    int64_t k_n, int64_t v_b, int64_t v_h, int64_t v_n, float scale,
    int causal, int dtype, void* stream) {
  if (bad_shape(batch, n_heads, nq, nk, d_qk, d_v))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0 || n_heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_b, q_h, q_n}, ks{k_b, k_h, k_n}, vs{v_b, v_h, v_n};
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return d_qk <= 64 && d_v <= 64
               ? launch_fwd_simt<64, 64>(q, k, v, key_mask, out, l, batch,
                                         n_heads, nq, nk, d_qk, d_v, qs, ks,
                                         vs, scale, causal, s)
               : launch_fwd_simt<128, 128>(q, k, v, key_mask, out, l, batch,
                                           n_heads, nq, nk, d_qk, d_v, qs,
                                           ks, vs, scale, causal, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (d_qk <= 48 && d_v <= 32)  // the MLA site
    return launch_fwd_mma<3, 2>(q, k, v, key_mask, out, l, batch, n_heads,
                                nq, nk, d_qk, d_v, qs, ks, vs, scale, causal,
                                s);
  if (d_qk <= 64 && d_v <= 64)
    return launch_fwd_mma<4, 4>(q, k, v, key_mask, out, l, batch, n_heads,
                                nq, nk, d_qk, d_v, qs, ks, vs, scale, causal,
                                s);
  return launch_fwd_mma<8, 8>(q, k, v, key_mask, out, l, batch, n_heads, nq,
                              nk, d_qk, d_v, qs, ks, vs, scale, causal, s);
}

// The forward's inputs plus its out and lse and dout (batch, n_heads, nq,
// d_v), contiguous, in q's type; writes dq, dk, dv (contiguous, in q's type)
// and delta (batch, n_heads, nq) fp32, a scratch row sum.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* out, const void* dout, const void* lse, void* dq, void* dk,
    void* dv, void* delta, int batch, int n_heads, int nq, int nk, int d_qk,
    int d_v, int64_t q_b, int64_t q_h, int64_t q_n, int64_t k_b, int64_t k_h,
    int64_t k_n, int64_t v_b, int64_t v_h, int64_t v_n, float scale,
    int causal, int dtype, void* stream) {
  if (bad_shape(batch, n_heads, nq, nk, d_qk, d_v))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0 || n_heads == 0) return 0;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.dout = dout;
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.batch = batch;
  a.n_heads = n_heads;
  a.nq = nq;
  a.nk = nk;
  a.d_qk = d_qk;
  a.d_v = d_v;
  a.qs = Strides{q_b, q_h, q_n};
  a.ks = Strides{k_b, k_h, k_n};
  a.vs = Strides{v_b, v_h, v_n};
  a.scale = scale;
  a.causal = causal;
  return launch_attention_bwd<false>(a, dtype,
                                     static_cast<cudaStream_t>(stream));
}
