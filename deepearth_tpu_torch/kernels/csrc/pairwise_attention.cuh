// Device helpers shared by the pairwise attention forward (K1-fwd,
// pairwise_attention.cu) and backward (K1-bwd, pairwise_attention_bwd.cu).
//
// Both kernels run one warp per (batch row, head). A lane holds 2
// consecutive elements of the head (Dh = 64 is one pair per lane; larger Dh
// loops). The backward recomputes the softmax with softmax_row, the very
// function the forward uses, so its probabilities are bit-identical to the
// forward's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pairwise {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxKeys = 64;  // Nq * Nk <= 64 as well: the backward keeps
                              // every probability of a (row, head) at once
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

// Per-head dot product of two rows of Dh = 2 * half elements, finished by a
// butterfly reduction: every lane returns the same fp32 value.
template <typename T, typename U>
__device__ __forceinline__ float head_dot(const T* a, const U* b, int half,
                                          int lane) {
  float part = 0.0f;
  for (int e = lane; e < half; e += 32) {
    const float2 x = load2(a + 2 * e);
    const float2 y = load2(b + 2 * e);
    part = fmaf(x.x, y.x, part);
    part = fmaf(x.y, y.y, part);
  }
  return warp_sum(part);
}

// Whether a batch row, whose Nk key flags mask_row points at, has a
// visible key (always, without a mask).
template <bool MASKED>
__device__ __forceinline__ bool any_visible(const uint8_t* mask_row, int nk) {
  if (!MASKED) return true;
  bool any = false;
  for (int j = 0; j < nk; ++j) any |= mask_row[j] != 0;
  return any;
}

// fp32 softmax over the Nk keys of one query qi of one (row, head), written
// to probs[0..nk) (the warp's shared memory). krow points at key 0 of the
// row and head; consecutive keys are k_tok elements apart. With MASKED,
// mask_row holds the row's Nk key flags: masked keys score kNegInf, as in
// the JAX code, and so get probability 0 whenever the row has a visible key.
// (MASKED is a template parameter so that the unmasked kernels test nothing
// per key: tested at run time, the check cost the forward 15% through
// register pressure.) Ends with __syncwarp: probs is readable by every lane.
template <bool MASKED, typename T>
__device__ __forceinline__ void softmax_row(const T* qi, const T* krow,
                                            int64_t k_tok,
                                            const uint8_t* mask_row, int nk,
                                            int half, int lane, float scale,
                                            float* probs) {
  float m = kNegInf;
  for (int j = 0; j < nk; ++j) {
    float s = head_dot(qi, krow + j * k_tok, half, lane) * scale;
    if (MASKED && mask_row[j] == 0) s = kNegInf;
    if (lane == 0) probs[j] = s;
    m = fmaxf(m, s);
  }
  __syncwarp();
  float denom = 0.0f;
  for (int j = 0; j < nk; ++j) denom += expf(probs[j] - m);
  __syncwarp();
  for (int j = lane; j < nk; j += 32) probs[j] = expf(probs[j] - m) / denom;
  __syncwarp();
}

}  // namespace pairwise
