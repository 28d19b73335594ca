// Token-major small-sequence multi-head attention, backward (K1-bwd), one
// warp per (batch row, head): the route of fp32 and the shapes off
// pairwise_attention_bwd_tma.cu's grid (kernels.pairwise_bwd_tma_route),
// counted pairwise_attention_bwd_warp.
//
// Replaces: deepearth_tpu/ops/attention_smallseq.py `_pw_bwd_kernel`
// (Pallas, launched by `_pw_run_bwd` from the custom VJP of `_pw_attend`).
//
// Shapes: the forward's q (Nq, B, D), k and v (Nk, B, D), plus the output
// gradient do (Nq, B, D); D = H * Dh, Nq * Nk <= 64. Returns dq (Nq, B, D),
// dk and dv (Nk, B, D) in the input type, contiguous. At the A-stack shape
// Nq = Nk = 3, B = 4096, D = 768, H = 12, 16 sites per train step.
//
// Bound on the H100: memory, as the forward. Per site it must read q, k, v
// and do and write dq, dk, dv: (2 Nq + 2 Nk + Nq + 2 Nk) * B * D elements,
// against ~10 * Nq * Nk * B * D flops, a few flops per byte.
//
// Design: one warp per (batch row, head), as the forward. The warp
// recomputes the probabilities of every query with softmax_row, the
// forward's own function, and keeps all Nq * Nk of them in shared memory
// with the score gradients. Per (row, head), in fp32:
//   dp_ij = do_i . v_j            (warp-shuffle reduction over Dh)
//   delta_i = sum_j p_ij dp_ij
//   ds_ij = p_ij (dp_ij - delta_i) * scale
// then each lane, for its element pairs,
//   dv_j = sum_i p_ij do_i,  dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i
// and rounds each once to the input type. Nothing but the inputs and the
// three gradients touches device memory; rows are re-read from L1. A masked
// key has p = 0 and so gets no gradient. A batch row with no visible key
// produced zeros in the forward, so all its gradients are zero. The Pallas
// kernel's one-hot SEG head collapse and its batch tiling are TPU layout
// tricks and are not carried over.

#include "pairwise_attention.cuh"

using namespace pairwise;

namespace {

template <typename T, bool MASKED>
__global__ void pairwise_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const uint8_t* __restrict__ key_mask,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int nq,
    int nk, int batch, int n_heads, int head_dim, Strides qs, Strides ks,
    Strides vs, float scale) {
  __shared__ float probs_smem[kWarpsPerBlock][kMaxKeys];
  __shared__ float ds_smem[kWarpsPerBlock][kMaxKeys];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (pair >= static_cast<int64_t>(batch) * n_heads) return;  // whole warp
  const int b = static_cast<int>(pair / n_heads);
  const int64_t col = static_cast<int64_t>(pair % n_heads) * head_dim;
  const int64_t d_model = static_cast<int64_t>(n_heads) * head_dim;
  const int half = head_dim / 2;
  float* probs = probs_smem[warp];  // probs[i * nk + j]
  float* ds = ds_smem[warp];        // ds[i * nk + j]
  const uint8_t* mask_row = MASKED ? key_mask + b * nk : nullptr;
  const bool visible = any_visible<MASKED>(mask_row, nk);

  const T* krow = k + b * ks.row + col;
  const T* vrow = v + b * vs.row + col;
  const T* qrow = q + b * qs.row + col;
  // do, dq, dk and dv are contiguous (N, B, D)
  const int64_t tok = static_cast<int64_t>(batch) * d_model;
  const int64_t base = static_cast<int64_t>(b) * d_model + col;

  if (visible) {
    for (int i = 0; i < nq; ++i) {
      float* pi = probs + i * nk;
      softmax_row<MASKED>(qrow + i * qs.tok, krow, ks.tok, mask_row, nk,
                          half, lane, scale, pi);
      const T* doi = dout + i * tok + base;
      float delta = 0.0f;
      for (int j = 0; j < nk; ++j) {
        const float dp = head_dot(doi, vrow + j * vs.tok, half, lane);
        delta = fmaf(pi[j], dp, delta);
        if (lane == 0) ds[i * nk + j] = dp;
      }
      __syncwarp();
      for (int j = lane; j < nk; j += 32)
        ds[i * nk + j] = pi[j] * (ds[i * nk + j] - delta) * scale;
      __syncwarp();
    }
  }

  for (int e = lane; e < half; e += 32) {
    for (int i = 0; i < nq; ++i) {  // dq_i = sum_j ds_ij k_j
      float ax = 0.0f, ay = 0.0f;
      if (visible) {
        for (int j = 0; j < nk; ++j) {
          const float s = ds[i * nk + j];
          const float2 c = load2(krow + j * ks.tok + 2 * e);
          ax = fmaf(s, c.x, ax);
          ay = fmaf(s, c.y, ay);
        }
      }
      store2(dq + i * tok + base + 2 * e, ax, ay);
    }
    for (int j = 0; j < nk; ++j) {  // dk_j = sum_i ds_ij q_i,
      float kx = 0.0f, ky = 0.0f;   // dv_j = sum_i p_ij do_i
      float vx = 0.0f, vy = 0.0f;
      if (visible) {
        for (int i = 0; i < nq; ++i) {
          const float s = ds[i * nk + j];
          const float p = probs[i * nk + j];
          const float2 a = load2(qrow + i * qs.tok + 2 * e);
          const float2 g = load2(dout + i * tok + base + 2 * e);
          kx = fmaf(s, a.x, kx);
          ky = fmaf(s, a.y, ky);
          vx = fmaf(p, g.x, vx);
          vy = fmaf(p, g.y, vy);
        }
      }
      store2(dk + j * tok + base + 2 * e, kx, ky);
      store2(dv + j * tok + base + 2 * e, vx, vy);
    }
  }
}

// One instantiation for rows with a key mask and one without.
template <typename T>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const void* key_mask, void* dq, void* dk, void* dv, int nq,
            int nk, int batch, int n_heads, int head_dim, Strides qs,
            Strides ks, Strides vs, float scale, cudaStream_t stream) {
  const int64_t pairs = static_cast<int64_t>(batch) * n_heads;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto kernel = key_mask != nullptr
                          ? pairwise_attention_bwd_kernel<T, true>
                          : pairwise_attention_bwd_kernel<T, false>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const uint8_t*>(key_mask), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), nq, nk, batch, n_heads,
      head_dim, qs, ks, vs, scale);
}

}  // namespace

// q (nq, batch, d), k and v (nk, batch, d) with unit stride along d and the
// given token / row strides (in elements); dout (nq, batch, d) contiguous;
// key_mask (batch, nk) bytes or null; dq (nq, batch, d), dk and dv
// (nk, batch, d) contiguous. dtype 0 = float32, 1 = bfloat16.
// Returns a cudaError_t value; 0 on a clean launch.
extern "C" int pairwise_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* key_mask, void* dq, void* dk, void* dv, int nq, int nk,
    int batch, int n_heads, int head_dim, int64_t q_tok, int64_t q_row,
    int64_t k_tok, int64_t k_row, int64_t v_tok, int64_t v_row, float scale,
    int dtype, void* stream) {
  if (nk < 1 || nq * nk > kMaxKeys || head_dim % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_tok, q_row}, ks{k_tok, k_row}, vs{v_tok, v_row};
  if (dtype == 0)
    launch<float>(q, k, v, dout, key_mask, dq, dk, dv, nq, nk, batch,
                  n_heads, head_dim, qs, ks, vs, scale, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(q, k, v, dout, key_mask, dq, dk, dv, nq, nk, batch,
                          n_heads, head_dim, qs, ks, vs, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
