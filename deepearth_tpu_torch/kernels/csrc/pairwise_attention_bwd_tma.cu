// Token-major small-sequence multi-head attention, backward (K1-bwd), the
// streaming route: 8 lanes a (batch row, head), each lane's 16-byte vectors
// of q, k, v and do loaded into registers, all issued before the first dot.
// Shapes off its grid take the one-warp-per-(row, head) kernel of
// pairwise_attention_bwd.cu; kernels.pairwise_bwd_tma_route chooses from the
// shapes and strides alone (the route keeps the name of the other
// redesigned kernels' routes; the design below says why its loads are not
// TMA's).
//
// Replaces: deepearth_tpu/ops/attention_smallseq.py `_pw_bwd_kernel` (:172;
// pallas_call :233, launched by `_pw_run_bwd` from the custom VJP of
// `_pw_attend`).
//
// Computes what pairwise_attention_bwd.cu computes: for the forward's q
// (Nq, B, D), k and v (Nk, B, D), bf16, D = H * Dh, and the output gradient
// do (Nq, B, D), per (batch row, head), in fp32: p recomputed (a masked key
// scores -1e30, as in the JAX code),
//   dp_ij = do_i . v_j,  delta_i = sum_j p_ij dp_ij,
//   ds_ij = p_ij (dp_ij - delta_i) * scale,
//   dv_j = sum_i p_ij do_i,  dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,
// each gradient rounded once to bf16; a row with no visible key gets
// exactly 0. Nq, Nk <= 3, Dh a multiple of 8 up to 256. At the A-stack
// shape Nq = Nk = 3, B = 4096, D = 768, H = 12, 16 sites per train step.
//
// Bound on the H100: bytes. It reads q, k, v and do and writes dq, dk, dv,
// 132 MB at the A-stack shape (0.039 ms at 3.35 TB/s), against ~10 Nq Nk
// flops an element; tensor cores have nothing to do here. The warp kernel
// keeps only a few hundred bytes in flight per warp (each dot waits on its
// own 4-byte-a-lane load, then 5 dependent shuffles) and reaches ~23% of
// the byte rate. Design:
//  - 8 lanes a (row, head) unit, 4 units a warp, 256-thread blocks, two an
//    SM: a lane holds the head's 16-byte vectors l, l + 8, ... (at Dh = 64
//    one vector of each of q, k, v and do a token: 192 bytes a lane at the
//    A-stack shape, all loads issued at once, ~100 KB in flight an SM).
//    Token and row strides come from the caller, so the fused qkv
//    projection's views are read in place;
//  - a dot is 8 FMAs and a 3-step butterfly (xor 4, 2, 1; every lane of
//    the unit ends with the same sum); all Nq Nk scores and dp are summed
//    first and their butterflies interleaved. p, dp and ds of the 3 x 3
//    pairs stay in registers, with the vectors beside them (108-128
//    registers, no spill). Past 3 tokens a side they would not fit: an
//    8 x 8 variant loading each vector where it is used (one block an SM)
//    ran no faster than the warp kernel at 2 x 5, 4 x 4 and 8 x 8
//    (PERF.md), so those shapes take the warp kernel;
//  - at Dh <= 64 (kHold) the gradients are computed from the vectors still
//    in registers; past it each of the lane's vectors is loaded again for
//    the gradients (from L1 or L2). The gradients go out as 16-byte
//    stores, coalesced over the unit's 8 lanes. Nothing but the inputs and
//    the three gradients touches device memory.
// A first design streamed tiles of rows into a shared-memory ring by
// cp.async.bulk on mbarriers (a producer warp, 3 stages of 36 KB, up to
// 216 KB in flight an SM), with the same per-lane arithmetic reading its
// operands from shared memory. It ran slower at the A-stack shape
// (PERF.md): its 12 consumer warps an SM, which also read every operand
// from shared memory, fell behind the stream that 16 warps of register
// loads keep up with.
// The arithmetic order: each lane's partial dot over its vectors in element
// order (fmaf), the butterfly, then p = exp(s - m) / sum in key order,
// delta and each gradient as fmaf chains from 0 in key (dq) or query (dk,
// dv) order. tests/test_torch_pairwise_tiles.py writes it out in plain
// PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // lanes a (row, head) unit
// the most tokens a side: p, dp and ds of 3 x 3 pairs in registers
constexpr int kTok = 3;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

struct Args {
  const bf16* in[4];       // q, k, v, do
  int64_t tok[4], row[4];  // their element strides
  const uint8_t* mask;     // (B, Nk) or null
  bf16* grad[3];           // dq, dk, dv, contiguous
  int nq, nk, batch, n_heads, head_dim;
  float scale;
};

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

// kHold: Dh <= 64, a lane's one vector a token kept in registers for the
// gradients (past it, each slot's vectors are loaded again).
template <bool kHold, bool MASKED>
__global__ void __launch_bounds__(kThreads, 2)
    pairwise_bwd_vec_kernel(const __grid_constant__ Args a) {
  const int64_t unit =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  const int l8 = threadIdx.x % kLanes;
  const int nq = a.nq, nk = a.nk, nvec = a.head_dim / 8;
  const bool valid = unit < static_cast<int64_t>(a.batch) * a.n_heads;
  const int64_t b = valid ? unit / a.n_heads : 0;
  const int64_t col = (valid ? unit % a.n_heads : 0) * a.head_dim;
  const bf16* src[4];
  int64_t tok[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    src[o] = a.in[o] + b * a.row[o] + col;
    tok[o] = a.tok[o];
  }

  float s[kTok][kTok], dp[kTok][kTok];
#pragma unroll
  for (int i = 0; i < kTok; ++i)
#pragma unroll
    for (int j = 0; j < kTok; ++j) s[i][j] = dp[i][j] = 0.0f;
  // the lane's vectors of one 8-column slot of the head: every load issued
  // before the first dot
  uint4 vq[kTok], vk[kTok], vv[kTok], vd[kTok];
  for (int slot = l8; slot < nvec; slot += kLanes) {
    const int off = 8 * slot;
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < nq) {
        vq[i] = load16(src[0] + i * tok[0] + off);
        vd[i] = load16(src[3] + i * tok[3] + off);
      }
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk) {
        vk[j] = load16(src[1] + j * tok[1] + off);
        vv[j] = load16(src[2] + j * tok[2] + off);
      }
    dots(s, vq, vk, nq, nk);
    dots(dp, vd, vv, nq, nk);
  }
  // the butterflies over the unit's 8 lanes, interleaved
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kTok; ++i)
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        if (i < nq && j < nk) {
          s[i][j] += __shfl_xor_sync(0xFFFFFFFFu, s[i][j], o);
          dp[i][j] += __shfl_xor_sync(0xFFFFFFFFu, dp[i][j], o);
        }
  }

  uint32_t vis = (1u << nk) - 1u;
  if (MASKED) {
    const uint8_t* m = a.mask + b * nk;
    vis = 0;
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk && __ldg(m + j) != 0) vis |= 1u << j;
  }
  // p (in s), then ds (in dp); a row with no visible key: p = ds = 0
#pragma unroll
  for (int i = 0; i < kTok; ++i) {
    if (i >= nq) break;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk) {
        float x = s[i][j] * a.scale;
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
    float delta = 0.0f;
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk) {
        s[i][j] = vis != 0 ? s[i][j] / den : 0.0f;
        delta = fmaf(s[i][j], dp[i][j], delta);
      }
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk) dp[i][j] = s[i][j] * (dp[i][j] - delta) * a.scale;
  }

  // the gradients of one slot: dq_i = sum_j ds_ij k_j, dk_j = sum_i ds_ij
  // q_i, dv_j = sum_i p_ij do_i (do is contiguous, like the gradients)
  const int64_t out = b * a.row[3] + col;
  auto gradients = [&](int off) {
    if (!kHold) {
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < nq) {
          vq[i] = load16(src[0] + i * tok[0] + off);
          vd[i] = load16(src[3] + i * tok[3] + off);
        }
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        if (j < nk) vk[j] = load16(src[1] + j * tok[1] + off);
    }
    float kf[kTok][8], x[8], acc[8];
#pragma unroll
    for (int j = 0; j < kTok; ++j)
      if (j < nk) unpack(vk[j], kf[j]);
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      if (i >= nq) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        if (j < nk)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[e] = fmaf(dp[i][j], kf[j][e], acc[e]);
      if (valid) store8(a.grad[0] + i * tok[3] + out + off, acc);
    }
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      if (j >= nk) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < nq) {
          unpack(vq[i], x);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(dp[i][j], x[e], acc[e]);
        }
      if (valid) store8(a.grad[1] + j * tok[3] + out + off, acc);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < nq) {
          unpack(vd[i], x);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(s[i][j], x[e], acc[e]);
        }
      if (valid) store8(a.grad[2] + j * tok[3] + out + off, acc);
    }
  };
  if (kHold) {
    if (l8 < nvec) gradients(8 * l8);
  } else {
    for (int slot = l8; slot < nvec; slot += kLanes) gradients(8 * slot);
  }
}

template <bool kHold, bool MASKED>
int launch(const Args& a, int64_t blocks, cudaStream_t stream) {
  pairwise_bwd_vec_kernel<kHold, MASKED>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (nq, batch, d), k and v (nk, batch, d), bfloat16, unit stride along d,
// the given token / row strides (in elements, multiples of 8) and 16-byte
// aligned bases; dout (nq, batch, d) contiguous, 16-byte aligned; key_mask
// (batch, nk) bytes or null; dq (nq, batch, d), dk and dv (nk, batch, d)
// contiguous. 1 <= nq, nk <= 3, head_dim a multiple of 8 up to 256.
// Returns a cudaError_t value; 0 on a clean launch.
extern "C" int pairwise_attention_bwd_tma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* key_mask, void* dq, void* dk, void* dv, int nq, int nk,
    int batch, int n_heads, int head_dim, int64_t q_tok, int64_t q_row,
    int64_t k_tok, int64_t k_row, int64_t v_tok, int64_t v_row, float scale,
    void* stream) {
  const int64_t strides[6] = {q_tok, q_row, k_tok, k_row, v_tok, v_row};
  bool ok = nq >= 1 && nk >= 1 && nq <= kTok && nk <= kTok && head_dim >= 8 &&
            head_dim <= kMaxHeadDim && head_dim % 8 == 0 && n_heads >= 1 &&
            batch >= 0;
  for (const int64_t s : strides) ok = ok && s > 0 && s % 8 == 0;
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (const void* p : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int64_t blocks =
      (static_cast<int64_t>(batch) * n_heads * kLanes + kThreads - 1) /
      kThreads;
  if (!ok || blocks > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int64_t d_model = static_cast<int64_t>(n_heads) * head_dim;
  Args a;
  a.in[0] = static_cast<const bf16*>(q);
  a.in[1] = static_cast<const bf16*>(k);
  a.in[2] = static_cast<const bf16*>(v);
  a.in[3] = static_cast<const bf16*>(dout);
  for (int i = 0; i < 3; ++i) {
    a.tok[i] = strides[2 * i];
    a.row[i] = strides[2 * i + 1];
  }
  a.tok[3] = batch * d_model;
  a.row[3] = d_model;
  a.mask = static_cast<const uint8_t*>(key_mask);
  a.grad[0] = static_cast<bf16*>(dq);
  a.grad[1] = static_cast<bf16*>(dk);
  a.grad[2] = static_cast<bf16*>(dv);
  a.nq = nq;
  a.nk = nk;
  a.batch = batch;
  a.n_heads = n_heads;
  a.head_dim = head_dim;
  a.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool hold = head_dim <= 8 * kLanes;
  if (key_mask != nullptr)
    return hold ? launch<true, true>(a, blocks, s)
                : launch<false, true>(a, blocks, s);
  return hold ? launch<true, false>(a, blocks, s)
              : launch<false, false>(a, blocks, s);
}
