// Long-sequence multi-head attention backward (K4-bwd), its mma.sync
// route (bf16 shapes off TMA's 8-element grid) and its CUDA-core one
// (fp32): the entry over attention_bwd.cuh's kernels, with delta = di =
// rowsum(out o dout) and the forward's lse (flash_attention.cu describes
// both directions; the forward's entry is there). A file of its own so that
// its kernels and the forward's compile in parallel. bf16 on the grid takes
// the TMA route, flash_attention_bwd_tma.cu.
//
// Replaces: the library flash backward that deepearth_tpu/models/deepseek.py
// `MLAttention` reaches (jax.experimental.pallas.ops.tpu.flash_attention
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`).

#include "attention_bwd.cuh"

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
  if (bad_flash_shape(batch, n_heads, nq, nk, d_qk, d_v))
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
