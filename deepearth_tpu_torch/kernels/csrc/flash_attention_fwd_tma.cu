// Long-sequence attention forward (K4-fwd), the TMA route: wgmma over
// TMA-fed, 128-byte-swizzled tiles, for bf16 with head dims that are
// multiples of 8 (at most 256) and q, k, v strides along B, H and N that
// are multiples of 8 elements (TMA's 16-byte strides). Other bf16 shapes
// take the mma.sync kernel of flash_attention.cu, fp32 its CUDA-core one;
// kernels.flash_fwd_tma_route chooses from the shapes and strides alone.
//
// Replaces: the library flash attention that deepearth_tpu/models/deepseek.py
// `MLAttention` reaches (:267) at N >= flash_min_seq
// (jax/experimental/pallas/ops/tpu/flash_attention.py
// `_flash_attention_kernel` :331, pallas_call :758).
//
// Computes what flash_attention.cu's forward computes: an online softmax
// over tiles of keys with fp32 scores and sums; each tile's
// p = exp(s - m_running) rounded to bf16 before P.V, accumulated in fp32
// and rescaled as the max grows; one division by the row's sum at the end,
// rounded once; lse = m + log l in fp32 for the backward. A row whose keys
// are all masked gives out 0 and lse +inf (the repository's convention).
//
// Bound on the H100: 2 B H Nq Nk (Dqk + Dv) operations. At the flagship's
// vision MLA over a V-JEPA2 clip (B = 32, 8 heads, 4608 x 4608, 128 / 128)
// 2.78 TFLOP, 2.81 ms at 989 TFLOP/s; its 5.4e9 exps take ~1.4 ms at 16 per
// SM and clock. At the multimodal model's (B = 64, Dqk 48, Dv 32) 1.74
// TFLOP (1.76 ms) but 1.09e10 exps (~2.6-2.9 ms): there the exp unit is
// the floor. Design:
//  - a block is 128 query rows of one (b, h): two consumer warpgroups of 64
//    rows and a producer warpgroup, whose first warp loads the block's q
//    once and streams k and v in tiles of 128 keys (64 where anything is
//    masked) through a ring of stages by TMA (mbarriers full / empty), each
//    key's visibility (the key mask, keys past Nk) written by its lanes
//    beside the ring where anything is masked. One block an SM, launched
//    at 168 registers a thread: the producer warpgroup drops to 40
//    (setmaxnreg) and the consumers rise to 232, room for a 64 x 128 fp32
//    output (64 registers a thread), the score tile (64) and p (32);
//  - s = q.k^T is a shared-shared wgmma (m64nKN, both operands K-major)
//    over the head dim's k16 steps only: a head dim of 48 loads as one
//    64-wide panel that TMA fills with zeros past it, and issues 3;
//  - the softmax stays in registers, in log2 units (scale log2 e folded
//    into one FMA per score, one MUFU.EX2), with no masking where nothing
//    is masked; p is rounded to bf16 in the fragment layout of wgmma's
//    register A operand (wgmma_a_frag) and multiplied with the v tile as an
//    MN-major B operand (the transpose bit) at N = Dv: n32 for the
//    multimodal MLA's Dv 32, n128 at the flagship's;
//  - where the output is 64 wide or less, each warpgroup issues tile
//    j + 1's q.k^T before tile j's P.V has completed and runs tile j + 1's
//    softmax under it (the FlashAttention-3 intra-warpgroup overlap), p
//    in registers of its own: written over the scores, the accumulator of
//    an issued wgmma, it makes ptxas serialise the products. At 128-wide
//    outputs a second score tile would spill: each tile's products wait in
//    turn and p is written over the scores. The two warpgroups' products
//    and softmaxes interleave on the SM by themselves;
//  - strided views (the MLA's v) are read in place: the tensor maps take
//    the strides, their dims ordered by stride;
//  - heads wider than 128 (DeepSeek-V3's MLA: Dqk 192, Dv 128; up to 256 /
//    256) take q and k tiles padded to 192 or 256: 192 is three 64-wide
//    panels (a swizzled TMA box is 64 bf16 wide), and only the panels that
//    hold the head dim are loaded. At <192, 128> a stage of 128 keys is
//    80 KB and two fit beside the 48 KB q tile; at 256, tiles of 64 keys
//    (48 KB a stage, three stages, 64 KB of q). Dv above 128 is split
//    across blocks: each block of a query tile computes the scores and the
//    softmax and P.V for 128 of the output columns (two blocks a tile at
//    Dv 256, one extra q.k^T each). A 256-wide output in one block (128
//    registers a thread beside the scores and p) spilled and ran ~20 times
//    slower on an H100 (PERF.md);
//  - causal blocks stop at the key tile of their last row and mask the
//    rest per element; rows past Nq (zeros from TMA) are not stored. The
//    output goes out as bf16 pairs straight from the registers.

#include "attention_tma.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 128;  // a block's query rows: two warpgroups of 64
// two consumer warpgroups and a producer warpgroup, of which one warp
// works: the producer gives up registers so that the consumers may hold
// 232 a thread (168 each without)
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Stages of KN-key tiles with head dims padded to DP (q, k) and DVP (v)
// that fit in 227 KB beside the block's q panels: each takes its tiles, its
// biases and two barriers; the alignment 1024 bytes, q_bar 16.
constexpr int fwd_stages_fit(int dp, int dvp, int kn) {
  return (232448 - 1024 - 16 - dp / 64 * kRows * kTileRowBytes) /
         ((dp + dvp) / 64 * kn * kTileRowBytes + kn * 4 + 16);
}

// Keys a tile: 128, or 64 where anything is masked (at 128 the masking's
// registers would spill) or where two stages of 128 keys do not fit.
constexpr int fwd_key_tile(int dp, int dvp, bool masked) {
  return masked || fwd_stages_fit(dp, dvp, 128) < 2 ? 64 : 128;
}

// Shared memory for head dims padded to DP (q, k: 64, 128, 192 or 256) and
// DVP (the block's v columns: 64 or 128), and key tiles of KN: a stage
// holds a key tile's k panels then its v panels (KN rows of 64 columns
// each); after the stages,
// the block's q panels (kRows rows) and a float per key and stage (0 or
// -inf: the key's bias).
template <int DP, int DVP, int KN>
struct FwdLayout {
  static constexpr int kPanel = KN * kTileRowBytes;
  static constexpr int kQPanel = kRows * kTileRowBytes;
  static constexpr int kFirst = DP / 64, kSecond = DVP / 64;  // panels
  static constexpr int kStageBytes = (kFirst + kSecond) * kPanel;
  static constexpr int kResident = kFirst * kQPanel;
  // as many stages as fit beside q, at most 4
  static constexpr int kFit = fwd_stages_fit(DP, DVP, KN);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kExtra = kResident + kStages * KN * 4;
  static constexpr int kSmem = ring_smem_bytes(kStages, kStageBytes, kExtra);
  static_assert(kStages >= 2 && kSmem + 16 <= 232448, "shared memory");
};

struct FwdArgs {
  MapOrder q_order, k_order, v_order;
  const uint8_t* key_mask;  // (B, Nk) or null
  bf16* out;                // (B, H, Nq, Dv), contiguous
  float* lse;               // (B, H, Nq)
  int n_heads, nq, nk, d_qk, d_v;
  int v_blocks;  // blocks a query tile, each 128 output columns (Dv > 128)
  float scale;
  int causal;
};

// DP, DVP: the panel widths of q / k and of the block's v columns; NV: the
// width of P.V (Dv, or the panels' width); KN: keys a tile; kMasked: p is
// masked per key (a key mask, causal, or Nk not a multiple of KN).
template <int DP, int DVP, int NV, int KN, bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const FwdArgs a) {
  using L = FwdLayout<DP, DVP, KN>;
  // tile j + 1's scores beside tile j's p and a 64-wide output fit the
  // registers; beside a 128-wide one they would spill
  constexpr bool kOverlap = DVP == 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_bar;
  if (threadIdx.x == 0) mbar_init(&q_bar, 1);
  auto ring = make_ring<L::kStages>(smem_raw, L::kStageBytes, L::kExtra, 32,
                                    kConsumers / 32);
  __syncthreads();
  uint8_t* q_tile = ring.tiles + L::kStages * L::kStageBytes;
  float* biases = reinterpret_cast<float*>(q_tile + L::kResident);
  const int b = blockIdx.z, h = blockIdx.y;
  // the block's query tile and its output columns [v0, v0 + d_vb)
  const int q0 = blockIdx.x / a.v_blocks * kRows;
  const int vb = blockIdx.x % a.v_blocks, v0 = 128 * vb;
  const int d_vb = min(a.d_v - v0, 128);
  const int64_t bh = static_cast<int64_t>(b) * a.n_heads + h;
  // causal: no row of this block sees a key after its last row
  const int n_keys = a.causal ? min(a.nk, q0 + kRows) : a.nk;
  const int n_tiles = (n_keys + KN - 1) / KN;

  // the warpgroup's role, warp-uniform as the compiler sees it, so that it
  // allocates each role's registers to its own budget
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumers / 128) {  // the producer warpgroup's first warp
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x - kConsumers;
    const int n_first = head_panels(a.d_qk), n_second = head_panels(d_vb);
    if (lane == 0) {
      mbar_expect_tx(&q_bar, n_first * L::kQPanel);
      for (int p = 0; p < n_first; ++p)
        load_rows(q_tile + p * L::kQPanel, &map_q, a.q_order, &q_bar, p, q0,
                  h, b);
    }
    const uint8_t* mask_row =
        a.key_mask ? a.key_mask + static_cast<int64_t>(b) * a.nk : nullptr;
    Cursor<L::kStages> at;
    for (int i = 0; i < n_tiles; ++i, at.next()) {
      mbar_wait(&ring.empty[at.stage], at.phase ^ 1);
      uint8_t* st = ring.tiles + at.stage * L::kStageBytes;
      if (kMasked) {
        float* bias = biases + at.stage * KN;
#pragma unroll 1
        for (int r = lane; r < KN; r += 32) {
          const int kj = i * KN + r;
          const bool seen =
              kj < a.nk && (mask_row == nullptr || mask_row[kj] != 0);
          bias[r] = seen ? 0.0f : -INFINITY;
        }
      }
      if (lane == 0) {
        uint64_t* full = &ring.full[at.stage];
        mbar_expect_tx(full, (n_first + n_second) * L::kPanel);
        for (int p = 0; p < n_first; ++p)
          load_rows(st + p * L::kPanel, &map_k, a.k_order, full, p, i * KN,
                    h, b);
        for (int p = 0; p < n_second; ++p)
          load_rows(st + (L::kFirst + p) * L::kPanel, &map_v, a.v_order,
                    full, 2 * vb + p, i * KN, h, b);
      } else {
        mbar_arrive(&ring.full[at.stage]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 .. row0 + 63 of the block's queries;
  // thread t holds rows r and r + 8, columns 8 j + col0 (+1) of each tile
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = role, t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4, col0 = 2 * (t % 4);
  const int row0 = q0 + 64 * wg;
  const int query[2] = {row0 + r, row0 + r + 8};
  const int ks = (a.d_qk + 15) / 16;
  const float scale_log2 = a.scale * kLog2e;
  // descriptors of this warpgroup's q rows and of stage 0's k and v tiles;
  // the others are these plus byte offsets (sw128_desc)
  const uint64_t q_desc =
      sw128_desc(q_tile + 64 * wg * kTileRowBytes, 16, 1024);
  const uint64_t k_desc = sw128_desc(ring.tiles, 16, 1024);
  const uint64_t v_desc =
      sw128_desc(ring.tiles + L::kFirst * L::kPanel, L::kPanel, 1024);
  float o[NV / 2];
  zero_acc(o);
  // running max of s scale log2 e (-inf while no key is seen) and sum of p
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float s[KN / 2];
  // p: its own registers under the overlap, else the scores' (see above)
  float p_own[kOverlap ? KN / 2 : 1];
  auto& p = [&]() -> float(&)[KN / 2] {
    if constexpr (kOverlap) return p_own;
    else return s;
  }();
  uint32_t pa[KN / 16][4];

  // s = q . k^T over the key tile of `stage`: committed, not waited for
  auto issue_scores = [&](int stage) {
    const uint64_t kd = k_desc + ((stage * L::kStageBytes) >> 4);
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      if (j >= ks) break;
      wgmma_ss<KN, 0, 0>(
          s, q_desc + (((j / 4) * L::kQPanel + 32 * (j % 4)) >> 4),
          kd + (((j / 4) * L::kPanel + 32 * (j % 4)) >> 4), j > 0);
    }
    wgmma_commit();
  };
  // o += p . v over the tile of `stage`, p from pa: committed, not waited
  // for
  auto issue_pv = [&](int stage) {
    const uint64_t vd = v_desc + ((stage * L::kStageBytes) >> 4);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < KN / 16; ++k16)
      wgmma_rs<NV, 1>(o, pa[k16], vd + ((2048 * k16) >> 4));
    wgmma_commit();
  };
  // key tile i's scores in s (stage `stage`'s biases) to p, the running
  // max and sum updated; alpha: the factor the output takes
  auto softmax = [&](int i, int stage, float (&alpha)[2]) {
    const float* bias = biases + stage * KN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KN / 8; ++j) {
      const float2 b2 = kMasked
                            ? reinterpret_cast<const float2*>(bias)[4 * j +
                                                                   col0 / 2]
                            : float2{0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + col0 + e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          float sx = s[x];
          if (kMasked) {  // the masked scores go to p: s stays as wgmma left it
            sx += e ? b2.y : b2.x;
            if (a.causal && i * KN + col > query[hh]) sx = -INFINITY;
            p[x] = sx;
          }
          mx[hh] = fmaxf(mx[hh], sx);
        }
      }
    }
    float ms[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m2[hh], quad_max(mx[hh]) * scale_log2);
      ms[hh] = m_new == -INFINITY ? 0.0f : m_new;
      // exactly 1 while the max stays; 0 from a row with no key seen yet
      alpha[hh] = exp2_approx(m2[hh] - ms[hh]);
      m2[hh] = m_new;
    }
#pragma unroll
    for (int x = 0; x < KN / 2; ++x) {
      const int hh = (x / 2) % 2;
      p[x] = exp2_approx(fmaf(kMasked ? p[x] : s[x], scale_log2, -ms[hh]));
      ls[hh] += p[x];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(l[hh], alpha[hh], ls[hh]);
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int x = 0; x < NV / 2; ++x) o[x] *= alpha[(x / 2) % 2];
  };
  auto to_frags = [&] {
#pragma unroll
    for (int k16 = 0; k16 < KN / 16; ++k16) wgmma_a_frag(pa[k16], p, k16);
  };
  auto fence_frags = [&] {
#pragma unroll
    for (int k16 = 0; k16 < KN / 16; ++k16) fence_operands(pa[k16]);
  };

  mbar_wait(&q_bar, 0);
  Cursor<L::kStages> at;
  float alpha[2];
  if constexpr (kOverlap) {
    mbar_wait(&ring.full[0], 0);
    issue_scores(0);
    wgmma_wait<0>();
    fence_operands(s);
    softmax(0, 0, alpha);  // the output is 0: nothing to rescale
    to_frags();
    for (int i = 1; i < n_tiles; ++i) {
      const int prev = at.stage;
      at.next();
      mbar_wait(&ring.full[at.stage], at.phase);
      issue_scores(at.stage);
      issue_pv(prev);
      wgmma_wait<1>();  // the scores; tile i - 1's P.V runs on
      fence_operands(s);
      softmax(i, at.stage, alpha);
      wgmma_wait<0>();
      fence_operands(o);
      fence_frags();
      release(ring, prev);
      rescale(alpha);
      to_frags();
    }
    issue_pv(at.stage);
    wgmma_wait<0>();
    fence_operands(o);
    fence_frags();
    release(ring, at.stage);
  } else {
    for (int i = 0; i < n_tiles; ++i, at.next()) {
      mbar_wait(&ring.full[at.stage], at.phase);
      issue_scores(at.stage);
      wgmma_wait<0>();
      fence_operands(s);
      softmax(i, at.stage, alpha);
      rescale(alpha);
      to_frags();
      issue_pv(at.stage);
      wgmma_wait<0>();
      fence_operands(o);
      fence_frags();
      release(ring, at.stage);
    }
  }

  float inv_l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lt = quad_sum(l[hh]);
    inv_l[hh] = lt > 0.0f ? 1.0f / lt : 0.0f;
    if (vb == 0 && t % 4 == 0 && query[hh] < a.nq)
      a.lse[bh * a.nq + query[hh]] =
          lt > 0.0f ? m2[hh] * kLn2 + logf(lt) : INFINITY;
  }
  store_rows_bf16<NV>(a.out + bh * a.nq * a.d_v + v0, o, row0, a.nq, d_vb,
                      a.d_v, inv_l);
}

// ------------------------------------------------------------------ host ----

// The kernel for these head dims and masking, its tensor maps (boxes of
// kRows query rows, KN key rows) and its launch.
template <int DP, int DVP, int NV, bool kMasked>
int launch_fwd(FwdArgs& a, const void* q, const void* k, const void* v,
               int batch, const int64_t (&st)[9], cudaStream_t stream) {
  constexpr int KN = fwd_key_tile(DP, DVP, kMasked);
  using L = FwdLayout<DP, DVP, KN>;
  const auto kernel = flash_fwd_wgmma_kernel<DP, DVP, NV, KN, kMasked>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap maps[3];
  if (!bhnd_map(&maps[0], &a.q_order, q, batch, a.n_heads, a.nq, a.d_qk,
                st[0], st[1], st[2], kRows) ||
      !bhnd_map(&maps[1], &a.k_order, k, batch, a.n_heads, a.nk, a.d_qk,
                st[3], st[4], st[5], KN) ||
      !bhnd_map(&maps[2], &a.v_order, v, batch, a.n_heads, a.nk, a.d_v,
                st[6], st[7], st[8], KN))
    return static_cast<int>(cudaErrorInvalidPitchValue);  // map refused
  const dim3 grid((a.nq + kRows - 1) / kRows * a.v_blocks, a.n_heads,
                  batch);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

// Without the masking of p where nothing is masked: no key mask, not
// causal, Nk a multiple of the unmasked kernel's key tile.
template <int DP, int DVP, int NV = DVP>
int launch_fwd(FwdArgs& a, const void* q, const void* k, const void* v,
               int batch, const int64_t (&st)[9], cudaStream_t stream) {
  return a.key_mask != nullptr || a.causal ||
                 a.nk % fwd_key_tile(DP, DVP, false)
             ? launch_fwd<DP, DVP, NV, true>(a, q, k, v, batch, st, stream)
             : launch_fwd<DP, DVP, NV, false>(a, q, k, v, batch, st, stream);
}

}  // namespace

// As flash_attention_fwd (flash_attention.cu) for bf16 only: q, k, v
// 16-byte aligned with element strides along batch, head and sequence that
// are multiples of 8, head dims multiples of 8 up to 256; key_mask (batch,
// nk) bytes or null; writes out (batch, n_heads, nq, d_v) bf16 and lse
// (batch, n_heads, nq) fp32, contiguous. Returns a cudaError_t value; 0 on
// a clean launch.
extern "C" int flash_attention_fwd_tma(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, void* lse, int batch, int n_heads, int nq, int nk, int d_qk,
    int d_v, int64_t q_b, int64_t q_h, int64_t q_n, int64_t k_b, int64_t k_h,
    int64_t k_n, int64_t v_b, int64_t v_h, int64_t v_n, float scale,
    int causal, void* stream) {
  const int64_t st[9] = {q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n};
  if (bad_tma_inputs(batch, n_heads, nq, nk, d_qk, d_v, st, {q, k, v, out},
                     256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0 || n_heads == 0) return 0;
  FwdArgs a;
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.n_heads = n_heads;
  a.nq = nq;
  a.nk = nk;
  a.d_qk = d_qk;
  a.d_v = d_v;
  a.v_blocks = d_v > 128 ? 2 : 1;
  a.scale = scale;
  a.causal = causal;
  const auto s = static_cast<cudaStream_t>(stream);
  if (d_qk <= 64 && d_v <= 64)  // the multimodal MLA's Dv 32 at n32
    return d_v <= 32 ? launch_fwd<64, 64, 32>(a, q, k, v, batch, st, s)
                     : launch_fwd<64, 64>(a, q, k, v, batch, st, s);
  // Dv above 128: 128 columns a block
  if (d_qk <= 64) return launch_fwd<64, 128>(a, q, k, v, batch, st, s);
  if (d_qk <= 128)
    return d_v <= 64 ? launch_fwd<128, 64>(a, q, k, v, batch, st, s)
                     : launch_fwd<128, 128>(a, q, k, v, batch, st, s);
  if (d_qk <= 192)  // DeepSeek-V3's MLA: 192 / 128
    return launch_fwd<192, 128>(a, q, k, v, batch, st, s);
  return launch_fwd<256, 128>(a, q, k, v, batch, st, s);
}
