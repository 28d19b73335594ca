// Token-major small-sequence multi-head attention, forward (K1-fwd), the
// streaming route: 8 lanes a (batch row, head), each lane's 16-byte vectors
// of q, k and v loaded into registers, all issued before the first dot.
// Shapes off its grid take the one-warp-per-(row, head) kernel of
// pairwise_attention.cu; kernels.pairwise_fwd_tma_route chooses from the
// shapes and strides alone (it is K1-bwd's rule, so both directions take
// the same shapes; the route keeps the name of the other redesigned
// kernels' routes, and the design below says why its loads are not TMA's).
//
// Replaces: deepearth_tpu/ops/attention_smallseq.py `_pw_fwd_kernel` (:156;
// pallas_call :216, launched by `_pw_run_fwd` through `_pw_attend`).
//
// Computes what pairwise_attention.cu computes: for q (Nq, B, D), k and v
// (Nk, B, D), bf16, D = H * Dh, per (batch row, head), fp32 scores
// q_i . k_j * scale (a masked key scores -1e30, as in the JAX code),
// p = exp(s - max) / sum, and o_i = sum_j p_ij v_j, rounded once to bf16;
// a row with no visible key writes exactly 0. Nq, Nk <= 3, Dh a multiple
// of 8 up to 256. At the A-stack shape Nq = Nk = 3, B = 4096, D = 768,
// H = 12, 16 sites per forward.
//
// Bound on the H100: bytes. It reads q, k, v and writes o, 75.5 MB at the
// A-stack shape (0.0225 ms at 3.35 TB/s), against ~4 Nq Nk flops an
// element; tensor cores have nothing to do here. The warp kernel keeps
// only a few hundred bytes in flight per warp (each score waits on its own
// 4-byte-a-lane load, then 5 dependent shuffles) and reaches ~27% of the
// byte rate. Design (K1-bwd's, pairwise_attention_bwd_tma.cu, whose loads,
// dots, butterfly and softmax are shared through pairwise_stream.cuh):
//  - 8 lanes a (row, head) unit: lane l holds the head's 16-byte vectors
//    l, l + 8, ... (at Dh = 64 one vector of each of q, k, v a token: 144
//    bytes a lane at the A-stack shape, all loads issued at once). Token
//    and row strides come from the caller, so the fused qkv projection's
//    views are read in place. The grid is one wave of resident blocks,
//    each lane group looping over the units: 49,152 units at the A-stack
//    shape are ~1.45 waves of one unit a lane group, and the loop drops
//    the tail wave (PERF.md times the launch shapes tried);
//  - a dot is 8 FMAs and a 3-step butterfly (xor 4, 2, 1; every lane of
//    the unit ends with the same sum); all Nq Nk scores are summed first
//    and their butterflies interleaved. p stays in registers;
//  - at Dh <= 64 (kHold) the output is computed from the v vectors still
//    in registers; past it v is loaded slot by slot for the output only
//    (q and k are what the scores need). o_i is an fmaf chain from 0 in
//    key order, 8 columns a lane, stored as 16 bytes, coalesced over the
//    unit's 8 lanes. Nothing but the inputs and the output touches device
//    memory.
// Why not TMA: a unit's operand is Dh contiguous bf16 (128 bytes at the
// A-stack), scattered over three tokens and a row stride; K1-bwd's first
// design streamed tiles of rows into a shared-memory ring by
// cp.async.bulk and ran slower than register loads (PERF.md), because its
// consumers also had to read every operand back from shared memory.

#include "pairwise_stream.cuh"

namespace {

using namespace pairwise_stream;

constexpr int kThreads = 256;

struct Args {
  const bf16* in[3];       // q, k, v
  int64_t tok[3], row[3];  // their element strides
  const uint8_t* mask;     // (B, Nk) or null
  bf16* out;               // (Nq, B, D), contiguous
  int nq, nk, batch, n_heads, head_dim;
  float scale;
};

// kHold: Dh <= 64, a lane's one v vector a token loaded with q and k and
// kept for the output.
template <bool kHold, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    pairwise_fwd_vec_kernel(const __grid_constant__ Args a) {
  const int l8 = threadIdx.x % kLanes;
  const int nq = a.nq, nk = a.nk, nvec = a.head_dim / 8;
  const int64_t units = static_cast<int64_t>(a.batch) * a.n_heads;
  const int64_t d_model = static_cast<int64_t>(a.n_heads) * a.head_dim;
  const int64_t out_tok = a.batch * d_model;
  const int64_t group =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  const int64_t groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / kLanes);
  // the warp's 4 lane groups step together, so every lane of a warp runs
  // the same number of passes (the butterflies shuffle over the warp)
  const int64_t warp_group = group & ~int64_t{3};
  for (int64_t pass = 0; pass * groups + warp_group < units; ++pass) {
    const int64_t unit = pass * groups + group;
    const bool valid = unit < units;
    const int64_t b = valid ? unit / a.n_heads : 0;
    const int64_t col = (valid ? unit % a.n_heads : 0) * a.head_dim;
    const bf16* src[3];
#pragma unroll
    for (int o = 0; o < 3; ++o) src[o] = a.in[o] + b * a.row[o] + col;

    float s[kTok][kTok];
    // the mask's bytes fetched with the operands
    const uint32_t vis = visible_keys<MASKED>(a.mask, b, nk);
#pragma unroll
    for (int i = 0; i < kTok; ++i)
#pragma unroll
      for (int j = 0; j < kTok; ++j) s[i][j] = 0.0f;
    // the lane's vectors of one 8-column slot of the head: every load
    // issued before the first dot
    uint4 vq[kTok], vk[kTok], vv[kTok];
    for (int slot = l8; slot < nvec; slot += kLanes) {
      const int off = 8 * slot;
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < nq) vq[i] = load16(src[0] + i * a.tok[0] + off);
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        if (j < nk) {
          vk[j] = load16(src[1] + j * a.tok[1] + off);
          if (kHold) vv[j] = load16(src[2] + j * a.tok[2] + off);
        }
      dots(s, vq, vk, nq, nk);
    }
    butterfly(nq, nk, s);
    softmax<MASKED>(s, nq, nk, a.scale, vis);

    // o_i of one slot: sum_j p_ij v_j
    auto output = [&](int off) {
      if (!kHold) {
#pragma unroll
        for (int j = 0; j < kTok; ++j)
          if (j < nk) vv[j] = load16(src[2] + j * a.tok[2] + off);
      }
      float vf[kTok][8], acc[8];
#pragma unroll
      for (int j = 0; j < kTok; ++j)
        if (j < nk) unpack(vv[j], vf[j]);
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
              acc[e] = fmaf(s[i][j], vf[j][e], acc[e]);
        if (MASKED && vis == 0)  // exactly 0, whatever v holds
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
        if (valid)
          store8(a.out + i * out_tok + b * d_model + col + off, acc);
      }
    };
    if (kHold) {
      if (l8 < nvec) output(8 * l8);
    } else {
      for (int slot = l8; slot < nvec; slot += kLanes) output(8 * slot);
    }
  }
}

// One wave: as many blocks as the card holds at once, no more than the
// units need.
template <bool kHold, bool MASKED>
int launch(const Args& a, cudaStream_t stream) {
  const auto kernel = pairwise_fwd_vec_kernel<kHold, MASKED>;
  const int64_t groups = static_cast<int64_t>(a.batch) * a.n_heads;
  int64_t blocks = (groups * kLanes + kThreads - 1) / kThreads;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (blocks > static_cast<int64_t>(sms) * per_sm)
    blocks = static_cast<int64_t>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (nq, batch, d), k and v (nk, batch, d), bfloat16, unit stride along d,
// the given token / row strides (in elements, multiples of 8) and 16-byte
// aligned bases; key_mask (batch, nk) bytes or null; out (nq, batch, d)
// contiguous, 16-byte aligned. 1 <= nq, nk <= 3, head_dim a multiple of 8
// up to 256. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int pairwise_attention_fwd_tma(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, int nq, int nk, int batch, int n_heads, int head_dim,
    int64_t q_tok, int64_t q_row, int64_t k_tok, int64_t k_row, int64_t v_tok,
    int64_t v_row, float scale, void* stream) {
  const int64_t strides[6] = {q_tok, q_row, k_tok, k_row, v_tok, v_row};
  bool ok = nq >= 1 && nk >= 1 && nq <= kTok && nk <= kTok && head_dim >= 8 &&
            head_dim <= kMaxHeadDim && head_dim % 8 == 0 && n_heads >= 1 &&
            batch >= 0;
  for (const int64_t s : strides) ok = ok && s > 0 && s % 8 == 0;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Args a;
  a.in[0] = static_cast<const bf16*>(q);
  a.in[1] = static_cast<const bf16*>(k);
  a.in[2] = static_cast<const bf16*>(v);
  for (int i = 0; i < 3; ++i) {
    a.tok[i] = strides[2 * i];
    a.row[i] = strides[2 * i + 1];
  }
  a.mask = static_cast<const uint8_t*>(key_mask);
  a.out = static_cast<bf16*>(out);
  a.nq = nq;
  a.nk = nk;
  a.batch = batch;
  a.n_heads = n_heads;
  a.head_dim = head_dim;
  a.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool hold = head_dim <= 8 * kLanes;
  if (key_mask != nullptr)
    return hold ? launch<true, true>(a, s) : launch<false, true>(a, s);
  return hold ? launch<true, false>(a, s) : launch<false, false>(a, s);
}
