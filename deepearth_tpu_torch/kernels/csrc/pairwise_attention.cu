// Token-major small-sequence multi-head attention, forward (K1-fwd), the
// warp route: fp32 and the shapes off the streaming route's grid
// (pairwise_attention_fwd_tma.cu; kernels.pairwise_fwd_tma_route).
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
// a butterfly shuffle reduction, which leaves the same value in every lane
// (softmax_row in pairwise_attention.cuh, shared with the backward).
// The softmax runs in fp32 over the Nk scores kept in shared memory; the
// output accumulates p_j * v_j in fp32 registers and is rounded once to the
// input type. Masked keys score NEG_INF = -1e30 like the JAX code, and a row
// with no visible key writes zeros. The k and v rows are re-read for each
// query from L1; at Nq = 3 that costs cache bandwidth, not HBM bytes.

#include "pairwise_attention.cuh"

using namespace pairwise;

namespace {

template <typename T, bool MASKED>
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
  const uint8_t* mask_row = MASKED ? key_mask + b * nk : nullptr;
  const bool visible = any_visible<MASKED>(mask_row, nk);

  const T* krow = k + b * ks.row + col;
  const T* vrow = v + b * vs.row + col;
  for (int i = 0; i < nq; ++i) {
    const T* qi = q + i * qs.tok + b * qs.row + col;
    softmax_row<MASKED>(qi, krow, ks.tok, mask_row, nk, half, lane, scale,
                        probs);

    T* oi = out + (static_cast<int64_t>(i) * batch + b) * d_model + col;
    for (int e = lane; e < half; e += 32) {
      float ax = 0.0f, ay = 0.0f;
      for (int j = 0; j < nk; ++j) {
        const float pj = probs[j];
        const float2 c = load2(vrow + j * vs.tok + 2 * e);
        ax = fmaf(pj, c.x, ax);
        ay = fmaf(pj, c.y, ay);
      }
      if (!visible) ax = ay = 0.0f;
      store2(oi + 2 * e, ax, ay);
    }
    __syncwarp();  // the next query overwrites probs
  }
}

// One instantiation for rows with a key mask and one without.
template <typename T>
void launch(const void* q, const void* k, const void* v, const void* key_mask,
            void* out, int nq, int nk, int batch, int n_heads, int head_dim,
            Strides qs, Strides ks, Strides vs, float scale,
            cudaStream_t stream) {
  const int64_t pairs = static_cast<int64_t>(batch) * n_heads;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto kernel = key_mask != nullptr
                          ? pairwise_attention_fwd_kernel<T, true>
                          : pairwise_attention_fwd_kernel<T, false>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<T*>(out), nq, nk, batch, n_heads, head_dim, qs, ks, vs,
      scale);
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
  const Strides qs{q_tok, q_row}, ks{k_tok, k_row}, vs{v_tok, v_row};
  if (dtype == 0)
    launch<float>(q, k, v, key_mask, out, nq, nk, batch, n_heads, head_dim,
                  qs, ks, vs, scale, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(q, k, v, key_mask, out, nq, nk, batch, n_heads,
                          head_dim, qs, ks, vs, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
