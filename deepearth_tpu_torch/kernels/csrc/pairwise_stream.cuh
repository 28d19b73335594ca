// Device helpers shared by the streaming routes of the pairwise attention
// forward (K1-fwd, pairwise_attention_fwd_tma.cu) and backward (K1-bwd,
// pairwise_attention_bwd_tma.cu).
//
// Both kernels run 8 lanes a (batch row, head) unit: lane l holds the head's
// 16-byte vectors l, l + 8, ... of each operand, loaded into registers. A
// dot is each lane's fmaf chain over its vectors in element order, then a
// butterfly over the unit's 8 lanes (xor 4, 2, 1). The backward recomputes
// the probabilities with softmax(), the very function the forward uses, so
// its p is bit-identical to the forward's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pairwise_stream {

using bf16 = __nv_bfloat16;

constexpr int kLanes = 8;  // lanes a (row, head) unit
// the most tokens a side: the scores (and in the backward dp and ds) of
// 3 x 3 pairs in registers
constexpr int kTok = 3;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 8 bf16 as floats: exact
__device__ __forceinline__ void unpack(const uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 floats rounded to bf16 into global memory at p (16-byte aligned)
__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                 pack2(f[6], f[7]));
}

// acc[i][j] += a_i . b_j over one vector of each, for i < na, j < nb
__device__ __forceinline__ void dots(float (&acc)[kTok][kTok],
                                     const uint4 (&a)[kTok],
                                     const uint4 (&b)[kTok], int na, int nb) {
  float bf[kTok][8], x[8];
#pragma unroll
  for (int j = 0; j < kTok; ++j)
    if (j < nb) unpack(b[j], bf[j]);
#pragma unroll
  for (int i = 0; i < kTok; ++i) {
    if (i >= na) break;
    unpack(a[i], x);
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nb)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][j] = fmaf(x[e], bf[j][e], acc[i][j]);
  }
}

// Each (i, j) < (na, nb) entry of every array summed over the unit's 8
// lanes (xor 4, 2, 1): every lane of the unit ends with the same sum. The
// arrays' butterflies are interleaved. Every lane of the warp must call it.
template <typename... A>
__device__ __forceinline__ void butterfly(int na, int nb, A&... x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kTok; ++i)
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        if (i < na && j < nb)
          ((x[i][j] += __shfl_xor_sync(0xFFFFFFFFu, x[i][j], o)), ...);
  }
}

// Bit j set where key j of batch row b is visible (all nk keys without a
// mask); mask is (B, nk) bytes.
template <bool MASKED>
__device__ __forceinline__ uint32_t visible_keys(const uint8_t* mask,
                                                 int64_t b, int nk) {
  uint32_t vis = (1u << nk) - 1u;
  if (MASKED) {
    const uint8_t* m = mask + b * nk;
    vis = 0;
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk && __ldg(m + j) != 0) vis |= 1u << j;
  }
  return vis;
}

// The dots s[i][j] = q_i . k_j into probabilities, in place, for i < nq,
// j < nk: scaled, a masked key at kNegInf, exp(s - max) / sum with the max
// and the sum taken in key order; every p of a row with no visible key
// (vis == 0) is 0.
template <bool MASKED>
__device__ __forceinline__ void softmax(float (&s)[kTok][kTok], int nq,
                                        int nk, float scale, uint32_t vis) {
#pragma unroll
  for (int i = 0; i < kTok; ++i) {
    if (i >= nq) break;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk) {
        float x = s[i][j] * scale;
        if (MASKED && !(vis >> j & 1u)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
    float den = 0.0f;
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk) {
        s[i][j] = expf(s[i][j] - mx);
        den += s[i][j];
      }
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk) s[i][j] = vis != 0 ? s[i][j] / den : 0.0f;
  }
}

}  // namespace pairwise_stream
