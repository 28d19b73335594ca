// Mid-length attention forward (K3-fwd), the TMA route: wgmma over TMA-fed,
// 128-byte-swizzled tiles, for bf16 with head dims that are multiples of 8
// (at most 128) and q, k, v strides along B, H and N that are multiples of
// 8 elements (TMA's 16-byte strides). Other bf16 shapes take the mma.sync
// kernel of attention_vmem.cu, fp32 its CUDA-core one;
// kernels.vmem_fwd_tma_route chooses from the shapes and strides alone.
//
// Replaces: deepearth_tpu/ops/attention_vmem.py `_fwd_kernel` (:64,
// pallas_call :110, reached through `vmem_attention`).
//
// Computes what the JAX kernel computes: scores q.k * scale in fp32; a
// masked key's score is NEG_BIG there, here -inf (a bias per key beside the
// ring: 0 if visible, -inf if masked or past Nk); the guarded softmax, whose
// m = max(rowmax, -1e30) and l = max(rowsum, 1e-30) give a row with no
// visible key exactly 0 (here: the row's l is 0 and its 1 / l is taken as 0,
// and every p is exp2(-inf) = 0: the same zeros, and the same p elsewhere,
// since exp of a NEG_BIG score is 0 too); p = exp(s - m) / l rounded to bf16
// only once the row's max and sum are known, then P.V summed in fp32 and
// rounded once. No lse is kept (K3-bwd recomputes its own). exp is taken as
// exp2 on the MUFU unit and p as e * (1 / l), as attention_vmem.cu does:
// each may differ from the fp32 expression in its last bit before p is
// rounded to bf16.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s; MUFU.EX2 16 a clock on
// each SM, ~3.87e12/s): at the multimodal model's MLA site (B = 512, 8
// heads, 576 x 576, Dqk 48, Dv 32, v strided) the function moves 755 MB
// (0.225 ms) and does 217 GFLOP (0.22 ms); this design takes two exps a
// score, 2.7e9, whose ~0.70 ms are its floor. At the flagship's MLA site
// (B = 64, 128 / 128) the products bound it (87 GFLOP, 0.088 ms; q.k^T twice,
// 130 GFLOP, 0.132 ms for this design). At the cross site (B = 512, 16
// queries over 576 keys, 64 / 64) the bytes of k and v (0.185 ms).
// Design:
//  - K3 rounds p = e / l, so l must be known before any p: two sweeps over
//    the (b, h) slice's keys instead of FlashAttention's one. The producer
//    streams the key tiles (64 keys) twice through one ring of stages by TMA
//    (mbarriers full / empty): first k alone, then k and v. The consumers'
//    stats sweep runs s = q.k^T (a shared-shared wgmma, both operands
//    K-major, over the head dim's k16 steps only: 48 issues 3) and keeps
//    each row's running max m2 of s scale log2 e and l = sum exp2(s scale
//    log2 e - m2), rescaled as m2 grows. The output sweep recomputes s,
//    forms p = exp2(s scale log2 e - m2) * (1 / l), rounds it to bf16
//    straight into the fragment layout of wgmma's register A operand
//    (wgmma_a_frag) and runs P.V as a register-shared wgmma with the v tile
//    MN-major (the transpose bit), at n32 for the MLA's Dv 32, n64 at the
//    cross site, n128 at the flagship's. Tile j + 1's q.k^T is issued
//    before tile j's P.V completes (p in registers of its own), and in the
//    stats sweep before tile j's exps (two score tiles). The output
//    goes out as bf16 pairs straight from the registers;
//  - a block is 128 query rows of one (b, h): two consumer warpgroups of 64
//    rows and a producer warpgroup whose first warp loads q once and issues
//    the TMA loads, each key's bias written by its lanes beside the stage
//    where anything is masked; launched at 168 registers a thread, the
//    producer drops to 40 (setmaxnreg) and the consumers rise to 232, room
//    for a 64 x 128 fp32 output (64 registers a thread), a score tile and p
//    (32 each). Heads of at most 64 take three consumer warpgroups (192
//    rows, 152 registers each) where that leaves fewer rows idle: the MLA
//    site's 576 queries are then 3 blocks, not 5 (the last half idle), and
//    each (b, h)'s k and v stream through 3 blocks, not 5. Where Nq <= 64
//    (the cross site's 16 queries) a block is one consumer warpgroup and a
//    producer warp, so that two or three blocks share an SM: the cross site
//    is bound by the bytes of k and v;
//  - device memory: the second read of k should hit L2: one (b, h) slice of
//    k is 55 KB at the MLA site (576 x 48 bf16), 74 KB at the cross site and
//    147 KB at the flagship site, read again within microseconds, so device
//    memory should see one read of it. Not measured: no hardware counter
//    has been read for it, and a kernel's time alone does not tell an L2
//    hit from a miss;
//  - head dims live in 64-wide swizzled panels: a head dim of 48 or 32 loads
//    as one panel that TMA fills with zeros past it. Strided views (the
//    MLA's v) are read in place: the tensor maps take the strides, their dims
//    ordered by stride. Rows past Nq (zeros from TMA) are not stored.

#include "attention_tma.cuh"

namespace {

using namespace hopper;

constexpr int kKeys = 64;  // keys a tile
// registers a thread once the producer warpgroup has given up its own:
// two consumer warpgroups rise from 168 to 232, three from 128 to 152
constexpr int kProducerRegs = 40;
template <int kWG>
constexpr int kConsumerRegs = kWG == 2 ? 232 : 152;

// Shared memory for head dims padded to DP (q, k) and DVP (v), each 64 or
// 128, and kWG consumer warpgroups: a stage holds a key tile's k panels then
// its v panels (kKeys rows of 64 columns each; the stats sweep fills only
// the k panels); after the stages, the block's q panels and a float per key
// and stage (the key's bias).
template <int DP, int DVP, int kWG>
struct VmemFwdLayout {
  static constexpr int kRows = 64 * kWG;  // query rows a block
  static constexpr int kConsumers = 128 * kWG;
  // kWG >= 2: a producer warpgroup (one warp of it works), so that
  // setmaxnreg can move its registers to the consumers; kWG = 1: a warp
  static constexpr int kThreads = kConsumers + (kWG >= 2 ? 128 : 32);
  static constexpr int kPanel = kKeys * kTileRowBytes;
  static constexpr int kQPanel = kRows * kTileRowBytes;
  static constexpr int kFirst = DP / 64, kSecond = DVP / 64;  // panels
  static constexpr int kKBytes = kFirst * kPanel;
  static constexpr int kStageBytes = (kFirst + kSecond) * kPanel;
  static constexpr int kResident = kFirst * kQPanel;
  // as many stages as fit in 227 KB beside q (at most 4): each takes its
  // tiles, its biases and two barriers; the alignment 1024 bytes, q_bar 16
  static constexpr int kFit = (232448 - 1024 - 16 - kResident) /
                              (kStageBytes + kKeys * 4 + 16);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kExtra = kResident + kStages * kKeys * 4;
  static constexpr int kSmem = ring_smem_bytes(kStages, kStageBytes, kExtra);
  static_assert(kStages >= 2 && kSmem + 16 <= 232448, "shared memory");
};

struct VmemFwdArgs {
  MapOrder q_order, k_order, v_order;
  const uint8_t* key_mask;  // (B, Nk) or null
  bf16* out;                // (B, H, Nq, Dv), contiguous
  int n_heads, nq, nk, d_qk, d_v;
  float scale;
};

// DP, DVP: the panel widths of q / k and v; NV: the width of P.V (Dv, or
// the panel's width); kMasked: a key mask, or Nk not a multiple of kKeys;
// kWG: consumer warpgroups (1 where Nq <= 64, 3 for heads of at most 64
// where 192-row blocks leave fewer rows idle than 128-row ones, else 2).
template <int DP, int DVP, int NV, bool kMasked, int kWG>
__global__ void __launch_bounds__(VmemFwdLayout<DP, DVP, kWG>::kThreads,
                                  kWG == 1 ? 2 : 1)
    vmem_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const VmemFwdArgs a) {
  using L = VmemFwdLayout<DP, DVP, kWG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_bar;
  if (threadIdx.x == 0) mbar_init(&q_bar, 1);
  auto ring = make_ring<L::kStages>(smem_raw, L::kStageBytes, L::kExtra, 32,
                                    L::kConsumers / 32);
  __syncthreads();
  uint8_t* q_tile = ring.tiles + L::kStages * L::kStageBytes;
  float* biases = reinterpret_cast<float*>(q_tile + L::kResident);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * L::kRows;
  const int64_t bh = static_cast<int64_t>(b) * a.n_heads + h;
  const int n_tiles = (a.nk + kKeys - 1) / kKeys;

  // the warpgroup's role, warp-uniform as the compiler sees it, so that it
  // allocates each role's registers to its own budget
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kWG) {  // the producer: its first warp
    if constexpr (kWG >= 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= L::kConsumers + 32) return;
    const int lane = threadIdx.x - L::kConsumers;
    if (lane == 0) {
      mbar_expect_tx(&q_bar, L::kResident);
      for (int p = 0; p < L::kFirst; ++p)
        load_rows(q_tile + p * L::kQPanel, &map_q, a.q_order, &q_bar, p, q0,
                  h, b);
    }
    const uint8_t* mask_row =
        a.key_mask ? a.key_mask + static_cast<int64_t>(b) * a.nk : nullptr;
    Cursor<L::kStages> at;
    // the stats sweep's k tiles, then the output sweep's k and v tiles
    for (int n = 0; n < 2 * n_tiles; ++n, at.next()) {
      const bool with_v = n >= n_tiles;
      const int i = with_v ? n - n_tiles : n;
      mbar_wait(&ring.empty[at.stage], at.phase ^ 1);
      uint8_t* st = ring.tiles + at.stage * L::kStageBytes;
      if (kMasked) {
        float* bias = biases + at.stage * kKeys;
        for (int r = lane; r < kKeys; r += 32) {
          const int kj = i * kKeys + r;
          const bool seen =
              kj < a.nk && (mask_row == nullptr || mask_row[kj] != 0);
          bias[r] = seen ? 0.0f : -INFINITY;
        }
      }
      if (lane == 0) {
        uint64_t* full = &ring.full[at.stage];
        mbar_expect_tx(full, with_v ? L::kStageBytes : L::kKBytes);
        for (int p = 0; p < L::kFirst; ++p)
          load_rows(st + p * L::kPanel, &map_k, a.k_order, full, p,
                    i * kKeys, h, b);
        if (with_v)
          for (int p = 0; p < L::kSecond; ++p)
            load_rows(st + (L::kFirst + p) * L::kPanel, &map_v, a.v_order,
                      full, p, i * kKeys, h, b);
      } else {
        mbar_arrive(&ring.full[at.stage]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 .. row0 + 63 of the block's queries;
  // thread t holds rows r and r + 8, columns 8 j + col0 (+1) of each tile
  if constexpr (kWG >= 2) setmaxnreg_inc<kConsumerRegs<kWG>>();
  const int wg = role, t = threadIdx.x % 128;
  const int col0 = 2 * (t % 4);
  const int row0 = q0 + 64 * wg;
  const int ks = (a.d_qk + 15) / 16;
  const float scale_log2 = a.scale * kLog2e;
  // descriptors of this warpgroup's q rows and of stage 0's k and v tiles;
  // the others are these plus byte offsets (sw128_desc)
  const uint64_t q_desc =
      sw128_desc(q_tile + 64 * wg * kTileRowBytes, 16, 1024);
  const uint64_t k_desc = sw128_desc(ring.tiles, 16, 1024);
  const uint64_t v_desc =
      sw128_desc(ring.tiles + L::kFirst * L::kPanel, L::kPanel, 1024);
  // two score tiles (the stats sweep issues the next while it takes the
  // exps of one), p and its bf16 fragments
  float s[kKeys / 2], s2[kKeys / 2], p[kKeys / 2];
  uint32_t pa[kKeys / 16][4];

  // acc = q . k^T over the key tile of `stage`: committed, not waited for
  auto issue_scores = [&](float (&acc)[kKeys / 2], int stage) {
    const uint64_t kd = k_desc + ((stage * L::kStageBytes) >> 4);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      if (j >= ks) break;
      wgmma_ss<kKeys, 0, 0>(
          acc, q_desc + (((j / 4) * L::kQPanel + 32 * (j % 4)) >> 4),
          kd + (((j / 4) * L::kPanel + 32 * (j % 4)) >> 4), j > 0);
    }
    wgmma_commit();
  };
  // the scores acc of the tile in `stage` with its keys' biases added (a
  // masked key's score -inf), written to p where anything is masked (acc,
  // a wgmma accumulator, stays as the product left it: written over, it
  // would make ptxas serialise the products); mx: each of the thread's two
  // rows' max
  auto biased = [&](const float (&acc)[kKeys / 2], int stage,
                    float (&mx)[2]) {
    const float* bias = biases + stage * kKeys;
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float2 b2 =
          kMasked ? reinterpret_cast<const float2*>(bias)[4 * j + col0 / 2]
                  : float2{0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          if (kMasked) p[x] = acc[x] + (e ? b2.y : b2.x);
          mx[hh] = fmaxf(mx[hh], kMasked ? p[x] : acc[x]);
        }
      }
    }
  };

  mbar_wait(&q_bar, 0);
  Cursor<L::kStages> at;

  // the stats sweep: m2 = max over the visible keys of s scale log2 e
  // (-inf while none) and l = sum exp2(s scale log2 e - m2), rescaled as
  // m2 grows; each stage is released as soon as its scores and biases are
  // read, and the next tile's scores are issued before this one's exps
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  auto stats = [&](float (&acc)[kKeys / 2], int stage) {
    float mx[2];
    biased(acc, stage, mx);
    release(ring, stage);
    float ms[2], alpha[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m2[hh], quad_max(mx[hh]) * scale_log2);
      ms[hh] = m_new == -INFINITY ? 0.0f : m_new;
      // exactly 1 while the max stays; 0 from a row with no key seen yet
      alpha[hh] = exp2_approx(m2[hh] - ms[hh]);
      m2[hh] = m_new;
    }
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x)
      ls[(x / 2) % 2] += exp2_approx(
          fmaf(kMasked ? p[x] : acc[x], scale_log2, -ms[(x / 2) % 2]));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(l[hh], alpha[hh], ls[hh]);
  };
  // tiles i (in s) and i + 1 (in s2) a round
  mbar_wait(&ring.full[at.stage], at.phase);
  issue_scores(s, at.stage);
  for (int i = 0; i < n_tiles; i += 2) {
    const int first = at.stage;
    at.next();
    if (i + 1 < n_tiles) {
      mbar_wait(&ring.full[at.stage], at.phase);
      issue_scores(s2, at.stage);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_operands(s);
    stats(s, first);
    if (i + 1 >= n_tiles) break;
    const int second = at.stage;
    at.next();
    if (i + 2 < n_tiles) {
      mbar_wait(&ring.full[at.stage], at.phase);
      issue_scores(s, at.stage);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_operands(s2);
    stats(s2, second);
  }
  // the row's shift and 1 / l: a row with no visible key has l = 0, and
  // its p (each exp2(-inf) = 0) times 0 is 0
  float ms[2], inv_l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ms[hh] = m2[hh] == -INFINITY ? 0.0f : m2[hh];
    const float lt = quad_sum(l[hh]);
    inv_l[hh] = lt > 0.0f ? 1.0f / lt : 0.0f;
  }

  // the output sweep: p = exp2(s scale log2 e - m2) / l rounded to bf16,
  // o += p . v; tile i + 1's scores are issued before tile i's P.V has
  // completed
  float o[NV / 2];
  zero_acc(o);
  auto probs = [&](int stage) {
    float mx[2];
    biased(s, stage, mx);
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x) {
      const int hh = (x / 2) % 2;
      p[x] = exp2_approx(fmaf(kMasked ? p[x] : s[x], scale_log2, -ms[hh])) *
             inv_l[hh];
    }
#pragma unroll
    for (int k16 = 0; k16 < kKeys / 16; ++k16) wgmma_a_frag(pa[k16], p, k16);
  };
  auto issue_pv = [&](int stage) {
    const uint64_t vd = v_desc + ((stage * L::kStageBytes) >> 4);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kKeys / 16; ++k16)
      wgmma_rs<NV, 1>(o, pa[k16], vd + ((2048 * k16) >> 4));
    wgmma_commit();
  };
  auto fence_frags = [&] {
#pragma unroll
    for (int k16 = 0; k16 < kKeys / 16; ++k16) fence_operands(pa[k16]);
  };

  mbar_wait(&ring.full[at.stage], at.phase);
  issue_scores(s, at.stage);
  wgmma_wait<0>();
  fence_operands(s);
  probs(at.stage);
  for (int i = 1; i < n_tiles; ++i) {
    const int prev = at.stage;
    at.next();
    mbar_wait(&ring.full[at.stage], at.phase);
    issue_scores(s, at.stage);
    issue_pv(prev);
    wgmma_wait<1>();  // the scores; tile i - 1's P.V runs on
    fence_operands(s);
    wgmma_wait<0>();
    fence_operands(o);
    fence_frags();
    release(ring, prev);
    probs(at.stage);
  }
  issue_pv(at.stage);
  wgmma_wait<0>();
  fence_operands(o);
  fence_frags();
  release(ring, at.stage);

  store_rows_bf16<NV>(a.out + bh * a.nq * a.d_v, o, row0, a.nq, a.d_v);
}

// ------------------------------------------------------------------ host ----

// The kernel for these head dims, masking and warpgroups, its tensor maps
// (boxes of the block's query rows, kKeys key rows) and its launch.
template <int DP, int DVP, int NV, bool kMasked, int kWG>
int launch_vmem_fwd(VmemFwdArgs& a, const void* q, const void* k,
                    const void* v, int batch, const int64_t (&st)[9],
                    cudaStream_t stream) {
  using L = VmemFwdLayout<DP, DVP, kWG>;
  const auto kernel = vmem_fwd_wgmma_kernel<DP, DVP, NV, kMasked, kWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap maps[3];
  if (!bhnd_map(&maps[0], &a.q_order, q, batch, a.n_heads, a.nq, a.d_qk,
                st[0], st[1], st[2], L::kRows) ||
      !bhnd_map(&maps[1], &a.k_order, k, batch, a.n_heads, a.nk, a.d_qk,
                st[3], st[4], st[5], kKeys) ||
      !bhnd_map(&maps[2], &a.v_order, v, batch, a.n_heads, a.nk, a.d_v,
                st[6], st[7], st[8], kKeys))
    return static_cast<int>(cudaErrorInvalidPitchValue);  // map refused
  const dim3 grid((a.nq + L::kRows - 1) / L::kRows, a.n_heads, batch);
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(maps[0], maps[1], maps[2],
                                                  a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int DVP, int NV, int kWG>
int launch_vmem_fwd(VmemFwdArgs& a, const void* q, const void* k,
                    const void* v, int batch, const int64_t (&st)[9],
                    cudaStream_t stream) {
  return a.key_mask != nullptr || a.nk % kKeys
             ? launch_vmem_fwd<DP, DVP, NV, true, kWG>(a, q, k, v, batch, st,
                                                       stream)
             : launch_vmem_fwd<DP, DVP, NV, false, kWG>(a, q, k, v, batch,
                                                        st, stream);
}

// The query rows a block takes: 64 where Nq <= 64; 192 where the heads are
// at most 64 wide (a consumer's registers fit 152) and 192-row blocks leave
// fewer rows idle (576 queries: 3 blocks, none idle, where 128-row blocks
// would be 5, the last half idle, each streaming k and v); else 128.
template <int DP, int DVP, int NV = DVP>
int launch_vmem_fwd(VmemFwdArgs& a, const void* q, const void* k,
                    const void* v, int batch, const int64_t (&st)[9],
                    cudaStream_t stream) {
  if (a.nq <= 64)
    return launch_vmem_fwd<DP, DVP, NV, 1>(a, q, k, v, batch, st, stream);
  if constexpr (DP == 64 && DVP == 64) {
    const int idle2 = (a.nq + 127) / 128 * 128 - a.nq;
    const int idle3 = (a.nq + 191) / 192 * 192 - a.nq;
    if (idle3 < idle2)
      return launch_vmem_fwd<DP, DVP, NV, 3>(a, q, k, v, batch, st, stream);
  }
  return launch_vmem_fwd<DP, DVP, NV, 2>(a, q, k, v, batch, st, stream);
}

}  // namespace

// As attention_vmem_fwd (attention_vmem.cu) for bf16 only: q, k, v 16-byte
// aligned with element strides along batch, head and sequence that are
// multiples of 8, head dims multiples of 8 up to 128, 1 <= nk <= 1024,
// nq <= 1024; key_mask (batch, nk) bytes or null; writes out (batch,
// n_heads, nq, d_v) bf16, contiguous. Returns a cudaError_t value; 0 on a
// clean launch.
extern "C" int attention_vmem_fwd_tma(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, int batch, int n_heads, int nq, int nk, int d_qk, int d_v,
    int64_t q_b, int64_t q_h, int64_t q_n, int64_t k_b, int64_t k_h,
    int64_t k_n, int64_t v_b, int64_t v_h, int64_t v_n, float scale,
    void* stream) {
  const int64_t st[9] = {q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n};
  if (bad_tma_inputs(batch, n_heads, nq, nk, d_qk, d_v, st, {q, k, v, out}) ||
      nq > 1024 || nk > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0 || n_heads == 0) return 0;
  VmemFwdArgs a;
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.out = static_cast<bf16*>(out);
  a.n_heads = n_heads;
  a.nq = nq;
  a.nk = nk;
  a.d_qk = d_qk;
  a.d_v = d_v;
  a.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  if (d_qk <= 64 && d_v <= 64)  // the multimodal MLA's Dv 32 at n32
    return d_v <= 32 ? launch_vmem_fwd<64, 64, 32>(a, q, k, v, batch, st, s)
                     : launch_vmem_fwd<64, 64>(a, q, k, v, batch, st, s);
  if (d_qk <= 64) return launch_vmem_fwd<64, 128>(a, q, k, v, batch, st, s);
  return d_v <= 64 ? launch_vmem_fwd<128, 64>(a, q, k, v, batch, st, s)
                   : launch_vmem_fwd<128, 128>(a, q, k, v, batch, st, s);
}
