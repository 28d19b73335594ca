// Token-major small-sequence multi-head attention, forward (K1-fwd).
//
// Replaces: deepearth_tpu/ops/attention_smallseq.py `_pw_fwd_kernel`
// (Pallas, launched by `_pw_run_fwd` through `_pw_attend`).
//
// Shapes: q (Nq, B, D), k and v (Nk, B, D), D = H * Dh, token-major, with a
// softmax over the Nk keys of each (query, batch row, head). Nq * Nk <= 64.
// At the A-stack shape Nq = Nk = 3, B = 4096, D = 768, H = 12.
//
// Bound on the H100: memory. Each site reads (Nq + 2 Nk) * B * D elements
// and writes Nq * B * D; the arithmetic is 4 * Nq * Nk * B * D flops, a few
// flops per byte, far below the ~295 flop/byte where the tensor cores would
// become the limit. So the design moves the unavoidable bytes once and keeps
// everything else on chip, as the Pallas kernel kept it in VMEM: scores and
// probabilities never touch device memory.
//
// Design: one warp per (batch row, head). A lane holds 2 consecutive
// elements of the head (Dh = 64 is one pair per lane; larger Dh loops), so a
// warp reads one head's Dh contiguous elements per token in one coalesced
// transaction. Each score is a per-lane fp32 partial dot product finished by
// a butterfly shuffle reduction, which leaves the same value in every lane.
// The softmax runs in fp32 over the Nk scores kept in shared memory; the
// output accumulates p_j * v_j in fp32 registers and is rounded once to the
// input type. Masked keys score NEG_INF = -1e30 like the JAX code, and a row
// with no visible key writes zeros. The k and v rows are re-read for each
// query from L1; at Nq = 3 that costs cache bandwidth, not HBM bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxKeys = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {  // element strides of a token-major (N, B, D) operand
  int64_t tok, row;
};

template <typename T>
__global__ void pairwise_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ key_mask, T* __restrict__ out, int nq, int nk,
    int batch, int n_heads, int head_dim, Strides qs, Strides ks, Strides vs,
    float scale) {
  __shared__ float probs_smem[kWarpsPerBlock][kMaxKeys];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (pair >= static_cast<int64_t>(batch) * n_heads) return;  // whole warp
  const int b = static_cast<int>(pair / n_heads);
  const int64_t col = static_cast<int64_t>(pair % n_heads) * head_dim;
  const int64_t d_model = static_cast<int64_t>(n_heads) * head_dim;
  const int half = head_dim / 2;
  float* probs = probs_smem[warp];

  bool any_visible = key_mask == nullptr;
  if (key_mask != nullptr)
    for (int j = 0; j < nk; ++j) any_visible |= key_mask[b * nk + j] != 0;

  const T* krow = k + b * ks.row + col;
  const T* vrow = v + b * vs.row + col;
  for (int i = 0; i < nq; ++i) {
    const T* qi = q + i * qs.tok + b * qs.row + col;
    float m = kNegInf;
    for (int j = 0; j < nk; ++j) {
      const T* kj = krow + j * ks.tok;
      float part = 0.0f;
      for (int e = lane; e < half; e += 32) {
        const float2 a = load2(qi + 2 * e);
        const float2 c = load2(kj + 2 * e);
        part = fmaf(a.x, c.x, part);
        part = fmaf(a.y, c.y, part);
      }
      float s = warp_sum(part) * scale;
      if (key_mask != nullptr && key_mask[b * nk + j] == 0) s = kNegInf;
      if (lane == 0) probs[j] = s;
      m = fmaxf(m, s);
    }
    __syncwarp();
    float denom = 0.0f;
    for (int j = 0; j < nk; ++j) denom += expf(probs[j] - m);
    __syncwarp();
    for (int j = lane; j < nk; j += 32) probs[j] = expf(probs[j] - m) / denom;
    __syncwarp();

    T* oi = out + (static_cast<int64_t>(i) * batch + b) * d_model + col;
    for (int e = lane; e < half; e += 32) {
      float ax = 0.0f, ay = 0.0f;
      for (int j = 0; j < nk; ++j) {
        const float pj = probs[j];
        const float2 c = load2(vrow + j * vs.tok + 2 * e);
        ax = fmaf(pj, c.x, ax);
        ay = fmaf(pj, c.y, ay);
      }
      if (!any_visible) ax = ay = 0.0f;
      store2(oi + 2 * e, ax, ay);
    }
    __syncwarp();  // the next query overwrites probs
  }
}

}  // namespace

// q (nq, batch, d), k and v (nk, batch, d) with unit stride along d and the
// given token / row strides (in elements); key_mask (batch, nk) bytes or
// null; out (nq, batch, d) contiguous. dtype 0 = float32, 1 = bfloat16.
// Returns a cudaError_t value; 0 on a clean launch.
extern "C" int pairwise_attention_fwd(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, int nq, int nk, int batch, int n_heads, int head_dim,
    int64_t q_tok, int64_t q_row, int64_t k_tok, int64_t k_row, int64_t v_tok,
    int64_t v_row, float scale, int dtype, void* stream) {
  if (nk < 1 || nk > kMaxKeys || head_dim % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t pairs = static_cast<int64_t>(batch) * n_heads;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const Strides qs{q_tok, q_row}, ks{k_tok, k_row}, vs{v_tok, v_row};
  const auto* m = static_cast<const uint8_t*>(key_mask);
  if (dtype == 0) {
    pairwise_attention_fwd_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), m, static_cast<float*>(out), nq, nk,
        batch, n_heads, head_dim, qs, ks, vs, scale);
  } else if (dtype == 1) {
    pairwise_attention_fwd_kernel<__nv_bfloat16>
        <<<blocks, kWarpsPerBlock * 32, 0, s>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), m,
            static_cast<__nv_bfloat16*>(out), nq, nk, batch, n_heads,
            head_dim, qs, ks, vs, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
