// Mid-length multi-head attention, backward (K3-bwd).
//
// Replaces: deepearth_tpu/ops/attention_vmem.py `_bwd_kernel` (Pallas,
// launched by `_run_bwd` through the custom VJP of `vmem_attention`).
//
// Shapes: those of K3-fwd (attention_vmem.cu) plus dout (B, H, Nq, Dv),
// contiguous, in q's type: strided q, k, v with unit stride along the head
// dim, 1 <= Nk <= 1024, Nq <= 1024, Dqk, Dv <= 128, Dqk != Dv allowed, an
// optional (B, Nk) key mask. Returns dq, dk, dv, contiguous, in q's type. On
// the multimodal train step it runs twice: the vision encoder's MLA (576 x
// 576, 8 heads, Dqk 48, Dv 32, v a strided view of the kv projection) and the
// query-token cross-attention (16 x 576, 8 heads, 64).
//
// Semantics, those of the JAX kernel: p recomputed in fp32 with the guarded
// softmax of the forward (a row whose keys are all masked has p = 0);
// dv = (p -> do's type)^T . do; dp = do . v^T in fp32;
// delta = rowsum(dp o p) from the fp32 p; ds = (p (dp - delta) scale) -> q's
// type; dq = ds . k; dk = ds^T . q; every product accumulated in fp32 and
// rounded once. The kernels are those of attention_bwd.cuh, whose dq kernel
// here first takes each row's max, sum and delta in a pass over the keys
// (kStats): K3-fwd saves nothing for its backward. The bf16 path takes
// exp as exp2 on the MUFU unit, which may differ from the fp32 expression in
// its last bits before a product is rounded.

#include "attention_bwd.cuh"

// q (batch, n_heads, nq, d_qk), k (.., nk, d_qk), v (.., nk, d_v) with unit
// stride along the head dim and the given element strides along batch, head
// and sequence; key_mask (batch, nk) bytes or null; dout (batch, n_heads, nq,
// d_v) contiguous; dq, dk, dv contiguous outputs; lse and delta (batch,
// n_heads, nq) fp32 scratch. dtype 0 = float32, 1 = bfloat16. Returns a
// cudaError_t value; 0 on a clean launch.
extern "C" int attention_vmem_bwd(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int batch, int n_heads, int nq, int nk, int d_qk, int d_v, int64_t q_b,
    int64_t q_h, int64_t q_n, int64_t k_b, int64_t k_h, int64_t k_n,
    int64_t v_b, int64_t v_h, int64_t v_n, float scale, int dtype,
    void* stream) {
  if (nq < 0 || nq > 1024 || nk < 1 || nk > 1024 || d_qk < 1 ||
      d_qk > 128 || d_v < 1 || d_v > 128 || n_heads > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0 || n_heads == 0) return 0;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = nullptr;
  a.dout = dout;
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.lse = static_cast<float*>(lse);
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
  a.causal = 0;
  return launch_attention_bwd<true>(a, dtype,
                                    static_cast<cudaStream_t>(stream));
}
