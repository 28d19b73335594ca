// Attention backward on the TMA route, long-sequence (K4-bwd) and
// mid-length (K3-bwd): wgmma over TMA-fed, 128-byte-swizzled tiles, for
// bf16 with head dims that are multiples of 8 (at most 256 for K4, 128 for
// K3) and q, k, v
// strides along B, H and N that are multiples of 8 elements (TMA's 16-byte
// strides). Other bf16 shapes take the mma.sync kernels of
// attention_bwd.cuh, fp32 its CUDA-core ones; kernels.flash_bwd_tma_route
// and kernels.vmem_bwd_tma_route choose from the shapes and strides alone.
//
// Replaces: the library flash backward that deepearth_tpu/models/deepseek.py
// `MLAttention` reaches (:267) at N >= flash_min_seq
// (jax/experimental/pallas/ops/tpu/flash_attention.py
// `_flash_attention_bwd_dkv`, pallas_call :1121, and
// `_flash_attention_bwd_dq`, pallas_call :1456), and
// deepearth_tpu/ops/attention_vmem.py `_bwd_kernel` (:72, pallas_call :127).
//
// Computes what attention_bwd.cuh computes. K4 (flash_attention_bwd_tma):
// lse from the forward (+inf for an all-masked row, so p = 0 there) and
// delta = rowsum(out o dout). K3 (attention_vmem_bwd_tma): no forward
// output; the dq kernel's kStats sweep takes each row's lse and
// delta = rowsum(dp o p) from the fp32 p over the keys first. Then
//   p = exp(s - lse), s = q.k * scale, 0 where the key mask or `causal`
//   hides the key; dv = bf16(p)^T . dout; ds = p (dout.v^T - delta) scale;
//   dq = bf16(ds) . k; dk = bf16(ds)^T . q;
// fp32 sums, each output rounded once to bf16.
//
// Bound on the H100: at the vision MLA over a V-JEPA2 clip (B = 64, 8
// heads, 4608 x 4608, Dqk 48, Dv 32) the five products are 4.5 TFLOP,
// 4.57 ms at 989 TFLOP/s; the 1.09e10 (query, key) pairs also need one
// exp each per pass (~2.9 ms a pass at 16 per SM and clock). At K3's
// multimodal MLA site (B = 512, 8 heads, 576 x 576, 48 / 32) 0.68 TFLOP,
// 0.69 ms. Design:
//  - the library's split, two kernels on one stream, each sum inside one
//    block (no atomics: the same bits every run). The dq kernel (a block
//    per (b, h, 64 queries)) writes dq and delta (K3 also lse); the dk/dv
//    kernel (a block per (b, h, 64 keys)) reads them and writes dk and dv.
//    Each recomputes s and dout.v^T: seven products, two exp passes (K3's
//    stats sweep adds two products and an exp pass: the producer streams
//    the key tiles twice, so q and dout are read once, and no kernel is
//    launched for the stats);
//  - a block is one consumer warpgroup and one producer warp. The producer
//    loads the block's own rows once (q and dout, or k and v) and streams
//    the other side in tiles of 64 rows through a ring of 4 stages by TMA
//    (mbarriers full / empty), with each streamed row's floats (lse and
//    delta, fetched a tile ahead, or the key's visibility) written by its
//    lanes beside the tile. Two blocks share an SM where the heads are at
//    most 64 wide, so that one block's products run on the tensor cores
//    while the other computes p and ds; wider heads take one block an SM,
//    whose warpgroup may hold up to 255 registers a thread (two warpgroups
//    a block are held to 168, and spill dk and dv at 128-wide heads);
//  - the two products over the head dim (s and dout.v^T: 64 x 64 each)
//    read both operands from shared memory, K-major. Their
//    accumulators become p and ds in registers, rounded to bf16 in the
//    fragment layout of wgmma's register A operand, and feed the products
//    over the streamed rows (dv, dk, or dq) with the streamed tile as an
//    MN-major B operand, taken by wgmma's transpose bit;
//  - head dims live in 64-wide swizzled panels: a head dim of 48 or 32
//    loads as one panel whose columns past it TMA fills with zeros. The
//    products over the head dim issue only its k16 steps (3 for 48, 2 for
//    32). The products whose N is the head dim (dq, dk, dv) run at N = 48
//    and 32 for the multimodal MLA's 48 / 32 (the B operand's MN-major
//    panel read in part) and at the panel's width (64 or 128) elsewhere,
//    the padded columns dropped at the store;
//  - strided views (the MLA's v) are read in place: the tensor maps take
//    the strides, their dims ordered by stride;
//  - keys past Nk or masked get p = 0 (the dq kernel's bias, the dk/dv
//    kernel's per-row flag); queries past Nq get lse = +inf, so p = 0;
//    causal blocks skip the tiles that no row of theirs sees;
//  - K4's heads wider than 128 (DeepSeek-V3's MLA: 192 / 128; up to
//    256 / 256) take tiles padded to <192, 128> or <256, 256>, only the
//    panels that hold the head dims loaded, and as many ring stages as fit
//    (4 at <192, 128>, 2 at <256, 256>). Their dq accumulator (96 or 128
//    registers a thread) fits beside s, dp and ds; dk and dv together
//    (160 or 256) would not. So the dk/dv kernel runs twice, once for dk
//    (the s and dout.v^T products, ds, dk += ds^T q) and once for dv (the
//    s product alone, p, dv += p^T dout): three launches where narrower
//    heads take two. The second pass repeats q.k^T and its exps, 1 of the
//    7 products; splitting dk's columns across passes instead would repeat
//    both head products, and shrinking the key tile would not shrink the
//    accumulators. A product 192 or 256 wide is two wgmma (n128 + n64 or
//    n128 + n128, wgmma_rs_cols) into one accumulator.

#include "attention_tma.cuh"

namespace {

using namespace hopper;

constexpr int kOwn = 64;      // a block's own rows
constexpr int kStream = 64;   // rows of a streamed tile
constexpr int kConsumers = 128, kThreads = kConsumers + 32;
constexpr int kPanel = 64 * kTileRowBytes;  // 64 rows of one 64-wide panel

// Shared memory of both kernels for head dims padded to DP (q, k) and DVP
// (v, dout), each 64, 128, 192 or 256: a stage holds the streamed tile's
// panels (the q or k panels first, then the dout or v panels) and 2 x 64
// floats; the resident tile after the stages holds the block's own 64 rows
// the same way; as many stages as fit in 227 KB, at most 4. Two blocks
// share an SM where both panels are 64 wide (their accumulators fit 168
// registers a thread); wider heads take one block an SM and up to 255
// registers (dk and dv at 128 wide are 128 of them). Above 256 columns in
// all, the dk/dv kernel runs once for dk and once for dv (kSplit).
template <int DP, int DVP>
struct Layout {
  static constexpr int kFirst = DP / 64, kSecond = DVP / 64;  // panels
  static constexpr int kFloats = (kFirst + kSecond) * kPanel;
  static constexpr int kStageBytes = kFloats + 1024;
  static constexpr int kResident = (kFirst + kSecond) * kPanel;
  static constexpr int kFit =
      (232448 - 1024 - 16 - kResident) / (kStageBytes + 16);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem =
      ring_smem_bytes(kStages, kStageBytes, kResident);
  static constexpr int kMinBlocks = DP + DVP <= 128 ? 2 : 1;
  static constexpr bool kSplit = DP + DVP > 256;
  static_assert(kStages >= 2 && kSmem + 16 <= 232448, "shared memory");
};

// What a launch of the dk/dv kernel computes.
enum DkDv { kDkDv, kDkOnly, kDvOnly };

struct TmaArgs {
  MapOrder q_order, k_order, v_order, do_order;
  float* lse;    // (B, H, Nq): K4's from the forward; K3's dq kernel writes
  float* delta;  // (B, H, Nq): the dq kernel writes it
  const uint8_t* key_mask;  // (B, Nk) or null
  const bf16* out;        // (B, H, Nq, Dv), contiguous; K3: null
  const bf16* dout;       // (B, H, Nq, Dv), contiguous
  bf16* dq;               // (B, H, Nq, Dqk), contiguous
  bf16* dk;               // (B, H, Nk, Dqk)
  bf16* dv;               // (B, H, Nk, Dv)
  int n_heads, nq, nk, d_qk, d_v;
  float scale;
  int causal;
};

// The 64 rows from `row0` of each of two tensors, the first's panels then
// the second's (as many as hold `d1` and `d2` columns), into `dst`: the
// block's resident tile or a stage, completing on `bar` (one thread; a
// stage's full barrier also waits for the other lanes).
template <int DP, int DVP>
__device__ void load_pair(uint8_t* dst, uint64_t* bar,
                          const CUtensorMap* first, MapOrder fo, int d1,
                          const CUtensorMap* second, MapOrder so, int d2,
                          int row0, int h, int b) {
  using L = Layout<DP, DVP>;
  const int n1 = head_panels(d1), n2 = head_panels(d2);
  mbar_expect_tx(bar, (n1 + n2) * kPanel);
  for (int p = 0; p < n1; ++p)
    load_rows(dst + p * kPanel, first, fo, bar, p, row0, h, b);
  for (int p = 0; p < n2; ++p)
    load_rows(dst + (L::kFirst + p) * kPanel, second, so, bar, p, row0, h,
              b);
}

// The two products over the head dim: acc1 = (the block's 64 resident rows
// of the first tensor) . (the stage's first tensor)^T
// over `ks1` k16 steps, acc2 the same for the second tensors over `ks2`
// (not taken, and acc2 not touched, without kSecondProduct); both 64 x 64,
// both operands K-major. Waits for them.
template <int DP, int DVP, bool kSecondProduct = true>
__device__ __forceinline__ void head_products(float (&acc1)[32],
                                              float (&acc2)[32],
                                              const uint8_t* res,
                                              const uint8_t* st,
                                              int ks1, int ks2) {
  using L = Layout<DP, DVP>;
  zero_acc(acc1);
  fence_operands(acc1);
  if constexpr (kSecondProduct) {
    zero_acc(acc2);
    fence_operands(acc2);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    if (j >= ks1) break;
    wgmma_m64n64k16<0, 0>(
        acc1,
        sw128_desc(res + (j / 4) * kPanel + 32 * (j % 4), 16,
                   1024),
        sw128_desc(st + (j / 4) * kPanel + 32 * (j % 4), 16, 1024));
  }
  const uint8_t* res2 = res + L::kFirst * kPanel;
  const uint8_t* st2 = st + L::kFirst * kPanel;
#pragma unroll
  for (int j = 0; j < DVP / 16; ++j) {
    if (!kSecondProduct || j >= ks2) break;
    wgmma_m64n64k16<0, 0>(
        acc2,
        sw128_desc(res2 + (j / 4) * kPanel + 32 * (j % 4), 16,
                   1024),
        sw128_desc(st2 + (j / 4) * kPanel + 32 * (j % 4), 16, 1024));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc1);
  if constexpr (kSecondProduct) fence_operands(acc2);
}

// ----------------------------------------------------------------- dk/dv ----

// Both kernels: DP, DVP the panel widths of q / k and v / dout; NQ, NV the
// widths of the products whose N is Dqk or Dv (at most DP, DVP); kMasked:
// p is masked per key (a key mask, causal, or Nk not a multiple of 64).
// kWhat: dk and dv, or (heads above 256 columns in all) one of them.
template <int DP, int DVP, int NQ, int NV, bool kMasked, DkDv kWhat>
__global__ void __launch_bounds__(kThreads, Layout<DP, DVP>::kMinBlocks)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_do,
                                const TmaArgs a) {
  using L = Layout<DP, DVP>;
  constexpr int kStages = L::kStages;
  constexpr bool kDk = kWhat != kDvOnly, kDv = kWhat != kDkOnly;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t res_bar;
  if (threadIdx.x == 0) mbar_init(&res_bar, 1);
  auto ring = make_ring<kStages>(smem_raw, L::kStageBytes, L::kResident,
                                 32, kConsumers / 32);
  __syncthreads();
  uint8_t* res = ring.tiles + kStages * L::kStageBytes;
  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kOwn;
  const int64_t bh = static_cast<int64_t>(b) * a.n_heads + h;
  const int n_tiles = (a.nq + kStream - 1) / kStream;
  // causal: the queries before this block's first key see none of its keys
  const int first = a.causal ? key0 / kStream : 0;

  if (threadIdx.x >= kConsumers) {  // producer warp
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0)
      load_pair<DP, DVP>(res, &res_bar, &map_k, a.k_order, a.d_qk, &map_v,
                         a.v_order, a.d_v, key0, h, b);
    // each lane's two rows of a tile's stats, fetched a tile ahead so that
    // their latency passes while the ring is full
    float lse2[2], dscale[2];
    auto fetch = [&](int i) {
      for (int x = 0; x < 2; ++x) {
        const int qi = i * kStream + lane + 32 * x;
        lse2[x] = qi < a.nq ? a.lse[bh * a.nq + qi] * kLog2e : INFINITY;
        // delta * scale: ds = p (dp scale - delta scale)
        dscale[x] = qi < a.nq ? a.delta[bh * a.nq + qi] * a.scale : 0.0f;
      }
    };
    if (first < n_tiles) fetch(first);
    Cursor<kStages> at;
    for (int i = first; i < n_tiles; ++i, at.next()) {
      mbar_wait(&ring.empty[at.stage], at.phase ^ 1);
      uint8_t* st = ring.tiles + at.stage * L::kStageBytes;
      float* stats = reinterpret_cast<float*>(st + L::kFloats);
      for (int x = 0; x < 2; ++x) {
        stats[2 * (lane + 32 * x)] = lse2[x];
        stats[2 * (lane + 32 * x) + 1] = dscale[x];
      }
      if (i + 1 < n_tiles) fetch(i + 1);
      if (lane == 0)
        load_pair<DP, DVP>(st, &ring.full[at.stage], &map_q, a.q_order,
                           a.d_qk, &map_do, a.do_order, a.d_v, i * kStream,
                           h, b);
      else
        mbar_arrive(&ring.full[at.stage]);
    }
    return;
  }

  // the consumer warpgroup: s^T and dp^T have the block's keys as rows, the
  // tile's queries as columns
  const int t = threadIdx.x;
  const int r = 16 * (t / 32) + (t % 32) / 4, col0 = 2 * (t % 4);
  int key[2];
  bool visible[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = key0 + r + 8 * hh;
    visible[hh] = key[hh] < a.nk &&
                  (a.key_mask == nullptr ||
                   a.key_mask[static_cast<int64_t>(b) * a.nk + key[hh]] != 0);
  }
  const int ks1 = (a.d_qk + 15) / 16, ks2 = (a.d_v + 15) / 16;
  const float scale_log2 = a.scale * kLog2e;
  float dk[kDk ? NQ / 2 : 1], dv[kDv ? NV / 2 : 1];
  zero_acc(dk);
  zero_acc(dv);
  mbar_wait(&res_bar, 0);
  Cursor<kStages> at;
  for (int i = first; i < n_tiles; ++i, at.next()) {
    mbar_wait(&ring.full[at.stage], at.phase);
    const uint8_t* st = ring.tiles + at.stage * L::kStageBytes;
    const float* stats = reinterpret_cast<const float*>(st + L::kFloats);
    float s[32], dp[32];
    head_products<DP, DVP, kDk>(s, dp, res, st, ks1, ks2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + col0 + e;
        const int query = i * kStream + col;
        const float2 st2 = reinterpret_cast<const float2*>(stats)[col];
        const float lse2 = st2.x, dscale = st2.y;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          const float e = exp2_approx(fmaf(s[x], scale_log2, -lse2));
          const float p =
              !kMasked || (visible[hh] && (!a.causal || key[hh] <= query))
                  ? e
                  : 0.0f;
          if (kDk) dp[x] = p * fmaf(dp[x], a.scale, -dscale);  // ds
          s[x] = p;
        }
      }
    }
    uint32_t pa[kDv ? 4 : 1][4], da[kDk ? 4 : 1][4];
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      if constexpr (kDv) wgmma_a_frag(pa[k16], s, k16);
      if constexpr (kDk) wgmma_a_frag(da[k16], dp, k16);
    }
    // dv += p^T . dout, dk += ds^T . q: the tile's rows are the reduction,
    // its panels MN-major B operands
    if constexpr (kDv) fence_operands(dv);
    if constexpr (kDk) fence_operands(dk);
    wgmma_fence();
    constexpr uint64_t kHi = (2 * kPanel) >> 4;  // column 128 of a B operand
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      if constexpr (kDv)
        wgmma_rs_cols<NV, 1>(
            dv, pa[k16],
            sw128_desc(st + L::kFirst * kPanel + 2048 * k16, kPanel, 1024),
            kHi);
      if constexpr (kDk)
        wgmma_rs_cols<NQ, 1>(dk, da[k16],
                             sw128_desc(st + 2048 * k16, kPanel, 1024), kHi);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kDv) fence_operands(dv);
    if constexpr (kDk) fence_operands(dk);
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      if constexpr (kDv) fence_operands(pa[k16]);
      if constexpr (kDk) fence_operands(da[k16]);
    }
    release(ring, at.stage);
  }
  if constexpr (kDk)
    store_rows_bf16<NQ>(a.dk + bh * a.nk * a.d_qk, dk, key0, a.nk, a.d_qk);
  if constexpr (kDv)
    store_rows_bf16<NV>(a.dv + bh * a.nk * a.d_v, dv, key0, a.nk, a.d_v);
}

// -------------------------------------------------------------------- dq ----

// kStats (K3): no forward saved lse, so the producer streams the key tiles
// twice; the first sweep keeps per row the running max m, l = sum exp(s - m)
// and t = sum exp(s - m) dp (attention_bwd.cuh's recurrence), and ends with
// lse = m + log l and delta = t / l (+inf and 0 where l = 0), written for
// the dk/dv kernel; the second sweep is the dq sweep. Without it (K4) lse
// is the forward's and delta = rowsum(out o dout).
template <int DP, int DVP, int NQ, int NV, bool kMasked, bool kStats>
__global__ void __launch_bounds__(kThreads, Layout<DP, DVP>::kMinBlocks)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const TmaArgs a) {
  using L = Layout<DP, DVP>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t res_bar;
  if (threadIdx.x == 0) mbar_init(&res_bar, 1);
  auto ring = make_ring<kStages>(smem_raw, L::kStageBytes, L::kResident,
                                 32, kConsumers / 32);
  __syncthreads();
  uint8_t* res = ring.tiles + kStages * L::kStageBytes;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kOwn;
  const int64_t bh = static_cast<int64_t>(b) * a.n_heads + h;
  // causal: no row of this block sees a key after its last row
  const int n_keys = a.causal ? min(a.nk, q0 + kOwn) : a.nk;
  const int n_tiles = (n_keys + kStream - 1) / kStream;

  if (threadIdx.x >= kConsumers) {  // producer warp
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0)
      load_pair<DP, DVP>(res, &res_bar, &map_q, a.q_order, a.d_qk, &map_do,
                         a.do_order, a.d_v, q0, h, b);
    const uint8_t* mask_row =
        a.key_mask ? a.key_mask + static_cast<int64_t>(b) * a.nk : nullptr;
    Cursor<kStages> at;
    for (int n = 0; n < (kStats ? 2 : 1) * n_tiles; ++n, at.next()) {
      const int i = n < n_tiles ? n : n - n_tiles;  // the sweep's tile
      mbar_wait(&ring.empty[at.stage], at.phase ^ 1);
      uint8_t* st = ring.tiles + at.stage * L::kStageBytes;
      float* seen_key = reinterpret_cast<float*>(st + L::kFloats);
      for (int r = lane; r < kStream; r += 32) {
        const int kj = i * kStream + r;
        const bool seen =
            kj < a.nk && (mask_row == nullptr || mask_row[kj] != 0);
        seen_key[r] = seen ? 1.0f : 0.0f;
      }
      if (lane == 0)
        load_pair<DP, DVP>(st, &ring.full[at.stage], &map_k, a.k_order,
                           a.d_qk, &map_v, a.v_order, a.d_v, i * kStream, h,
                           b);
      else
        mbar_arrive(&ring.full[at.stage]);
    }
    return;
  }

  // the consumer warpgroup: its rows are the block's queries
  const int t = threadIdx.x;
  const int r = 16 * (t / 32) + (t % 32) / 4, col0 = 2 * (t % 4);
  const int quad = t % 4;
  const float scale_log2 = a.scale * kLog2e;
  const int ks1 = (a.d_qk + 15) / 16, ks2 = (a.d_v + 15) / 16;
  float lse2[2], dscale[2];
  int query[2];
  query[0] = q0 + r;
  query[1] = q0 + r + 8;
  Cursor<kStages> at;
  if constexpr (kStats) {
    mbar_wait(&res_bar, 0);
    // the stats sweep, in log2 units: m2 = max s scale log2 e over the
    // visible keys (-inf while none), l and t rescaled as m2 grows
    float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
          tsum[2] = {0.0f, 0.0f};
    for (int i = 0; i < n_tiles; ++i, at.next()) {
      mbar_wait(&ring.full[at.stage], at.phase);
      const uint8_t* st = ring.tiles + at.stage * L::kStageBytes;
      const float* seen_key =
          reinterpret_cast<const float*>(st + L::kFloats);
      float s[32], dp[32];
      head_products<DP, DVP>(s, dp, res, st, ks1, ks2);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + col0 + e;
          const int kj = i * kStream + col;
          const bool seen = !kMasked || seen_key[col] != 0.0f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int x = 4 * j + 2 * hh + e;
            if (kMasked && !(seen && (!a.causal || kj <= query[hh])))
              s[x] = -INFINITY;
            mx[hh] = fmaxf(mx[hh], s[x]);
          }
        }
      }
      release(ring, at.stage);  // its products and key flags are read
      float ms[2], le[2] = {0.0f, 0.0f}, te[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m2[hh], quad_max(mx[hh]) * scale_log2);
        // a row with no visible key so far keeps m2 = -inf and l = t = 0
        ms[hh] = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2_approx(m2[hh] - ms[hh]);
        l[hh] *= alpha;
        tsum[hh] *= alpha;
        m2[hh] = m_new;
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int hh = (x / 2) % 2;
        const float p = exp2_approx(fmaf(s[x], scale_log2, -ms[hh]));
        le[hh] += p;
        te[hh] = fmaf(p, dp[x], te[hh]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += le[hh];
        tsum[hh] += te[hh];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lt = quad_sum(l[hh]), tt = quad_sum(tsum[hh]);
      const float lse = lt > 0.0f ? m2[hh] * kLn2 + logf(lt) : INFINITY;
      const float delta = lt > 0.0f ? tt / lt : 0.0f;
      lse2[hh] = lse * kLog2e;  // as the dk/dv kernel reads it
      dscale[hh] = delta * a.scale;
      if (quad == 0 && query[hh] < a.nq) {
        a.lse[bh * a.nq + query[hh]] = lse;
        a.delta[bh * a.nq + query[hh]] = delta;
      }
    }
  }
  // the forward's lse, and delta = rowsum(out o dout) in fp32: the four
  // lanes of a row each sum a quarter of its columns
#pragma unroll
  for (int hh = 0; !kStats && hh < 2; ++hh) {
    float di = 0.0f;
    lse2[hh] = INFINITY;
    if (query[hh] < a.nq) {
      lse2[hh] = a.lse[bh * a.nq + query[hh]] * kLog2e;
      const int64_t row = (bh * a.nq + query[hh]) * a.d_v;
      for (int d = 2 * quad; d < a.d_v; d += 8) {
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(a.out + row + d));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(a.dout + row + d));
        di = fmaf(o.x, g.x, di);
        di = fmaf(o.y, g.y, di);
      }
    }
    const float delta = quad_sum(di);
    dscale[hh] = delta * a.scale;  // ds = p (dp scale - delta scale)
    if (quad == 0 && query[hh] < a.nq)
      a.delta[bh * a.nq + query[hh]] = delta;
  }
  float dq[NQ / 2];
  zero_acc(dq);
  mbar_wait(&res_bar, 0);
  for (int i = 0; i < n_tiles; ++i, at.next()) {
    mbar_wait(&ring.full[at.stage], at.phase);
    const uint8_t* st = ring.tiles + at.stage * L::kStageBytes;
    const float* seen_key = reinterpret_cast<const float*>(st + L::kFloats);
    float s[32], dp[32];
    head_products<DP, DVP>(s, dp, res, st, ks1, ks2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + col0 + e;
        const int kj = i * kStream + col;
        // else masked or past Nk
        const bool seen = !kMasked || seen_key[col] != 0.0f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          const float ex = exp2_approx(fmaf(s[x], scale_log2, -lse2[hh]));
          const float p =
              !kMasked || (seen && (!a.causal || kj <= query[hh])) ? ex
                                                                   : 0.0f;
          dp[x] = p * fmaf(dp[x], a.scale, -dscale[hh]);  // ds
        }
      }
    }
    uint32_t da[4][4];
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) wgmma_a_frag(da[k16], dp, k16);
    // dq += ds . k: the tile's keys are the reduction, its k panels an
    // MN-major B operand
    fence_operands(dq);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16)
      wgmma_rs_cols<NQ, 1>(dq, da[k16],
                           sw128_desc(st + 2048 * k16, kPanel, 1024),
                           (2 * kPanel) >> 4);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) fence_operands(da[k16]);
    release(ring, at.stage);
  }
  store_rows_bf16<NQ>(a.dq + bh * a.nq * a.d_qk, dq, q0, a.nq,
                      a.d_qk);
}

// ------------------------------------------------------------------ host ----

// The kernels for these head dims, each without the masking of p where
// nothing is masked: no key mask, not causal, and for the dq kernel's key
// tiles Nk a multiple of 64 (the dk/dv kernel's rows past Nk are never
// stored, and its queries past Nq have lse = +inf, so p = 0 there).
template <int DP, int DVP, int NQ, int NV, bool kStats, bool kMaskDq,
          bool kMaskDkdv>
int launch_tma(const CUtensorMap (&maps)[4], const TmaArgs& a, int batch,
               cudaStream_t stream) {
  using L = Layout<DP, DVP>;
  const auto dq_kernel =
      flash_bwd_dq_wgmma_kernel<DP, DVP, NQ, NV, kMaskDq, kStats>;
  // dk and dv in one kernel, or (L::kSplit) a dk kernel then a dv kernel
  const auto dkdv_kernel = flash_bwd_dkdv_wgmma_kernel<
      DP, DVP, NQ, NV, kMaskDkdv, L::kSplit ? kDkOnly : kDkDv>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if constexpr (L::kSplit) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            flash_bwd_dkdv_wgmma_kernel<DP, DVP, NQ, NV, kMaskDkdv, kDvOnly>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    }
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((a.nq + kOwn - 1) / kOwn, a.n_heads, batch);
  dq_kernel<<<grid, kThreads, L::kSmem, stream>>>(maps[0], maps[1], maps[2],
                                                  maps[3], a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grid.x = (a.nk + kOwn - 1) / kOwn;
  dkdv_kernel<<<grid, kThreads, L::kSmem, stream>>>(maps[0], maps[1],
                                                    maps[2], maps[3], a);
  e = cudaGetLastError();
  if constexpr (L::kSplit) {
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkdv_wgmma_kernel<DP, DVP, NQ, NV, kMaskDkdv, kDvOnly>
        <<<grid, kThreads, L::kSmem, stream>>>(maps[0], maps[1], maps[2],
                                               maps[3], a);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

template <bool kStats, int DP, int DVP, int NQ = DP, int NV = DVP>
int launch_tma(const CUtensorMap (&maps)[4], const TmaArgs& a, int batch,
               cudaStream_t stream) {
  if (a.key_mask != nullptr || a.causal)
    return launch_tma<DP, DVP, NQ, NV, kStats, true, true>(maps, a, batch,
                                                           stream);
  return a.nk % kStream
             ? launch_tma<DP, DVP, NQ, NV, kStats, true, false>(maps, a, batch,
                                                                stream)
             : launch_tma<DP, DVP, NQ, NV, kStats, false, false>(maps, a,
                                                                 batch, stream);
}

// Both entries after their checks: the tensor maps of q, k, v and dout,
// then the kernels for the head dims.
template <bool kStats>
int launch_for_dims(TmaArgs& a, const void* q, const void* k, const void* v,
                    int batch, const int64_t (&st)[9], cudaStream_t stream) {
  CUtensorMap maps[4];
  const int n_heads = a.n_heads, nq = a.nq, nk = a.nk, d_qk = a.d_qk,
            d_v = a.d_v;
  const int64_t do_n = d_v, do_h = static_cast<int64_t>(nq) * d_v,
                do_b = do_h * n_heads;
  if (!bhnd_map(&maps[0], &a.q_order, q, batch, n_heads, nq, d_qk, st[0],
                st[1], st[2], kStream) ||
      !bhnd_map(&maps[1], &a.k_order, k, batch, n_heads, nk, d_qk, st[3],
                st[4], st[5], kStream) ||
      !bhnd_map(&maps[2], &a.v_order, v, batch, n_heads, nk, d_v, st[6],
                st[7], st[8], kStream) ||
      !bhnd_map(&maps[3], &a.do_order, a.dout, batch, n_heads, nq, d_v, do_b,
                do_h, do_n, kStream))
    return static_cast<int>(cudaErrorInvalidPitchValue);  // map refused
  if (d_qk == 48 && d_v == 32)  // the multimodal MLA: exact widths
    return launch_tma<kStats, 64, 64, 48, 32>(maps, a, batch, stream);
  if (d_qk <= 64 && d_v <= 128)
    return d_v <= 64 ? launch_tma<kStats, 64, 64>(maps, a, batch, stream)
                     : launch_tma<kStats, 64, 128>(maps, a, batch, stream);
  if (d_qk <= 128 && d_v <= 128)
    return d_v <= 64 ? launch_tma<kStats, 128, 64>(maps, a, batch, stream)
                     : launch_tma<kStats, 128, 128>(maps, a, batch, stream);
  if constexpr (!kStats) {  // K4's wider heads; K3 takes at most 128
    if (d_qk <= 192 && d_v <= 128)  // DeepSeek-V3's MLA: 192 / 128
      return launch_tma<kStats, 192, 128>(maps, a, batch, stream);
    return launch_tma<kStats, 256, 256>(maps, a, batch, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

TmaArgs make_args(const void* key_mask, const void* dout, void* lse,
                  void* dq, void* dk, void* dv, void* delta, int n_heads,
                  int nq, int nk, int d_qk, int d_v, float scale) {
  TmaArgs a;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.out = nullptr;
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.n_heads = n_heads;
  a.nq = nq;
  a.nk = nk;
  a.d_qk = d_qk;
  a.d_v = d_v;
  a.scale = scale;
  a.causal = 0;
  return a;
}

}  // namespace

// As flash_attention_bwd (flash_attention_bwd.cu) for bf16 only: q, k, v
// 16-byte aligned with element strides along batch, head and sequence that
// are multiples of 8, head dims multiples of 8 up to 256; key_mask (batch,
// nk) bytes or null; out, dout (batch, n_heads, nq, d_v) and lse
// (batch, n_heads, nq) fp32 contiguous; writes dq, dk, dv (contiguous,
// bf16) and delta (batch, n_heads, nq) fp32. Returns a cudaError_t value;
// 0 on a clean launch.
extern "C" int flash_attention_bwd_tma(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* out, const void* dout, const void* lse, void* dq, void* dk,
    void* dv, void* delta, int batch, int n_heads, int nq, int nk, int d_qk,
    int d_v, int64_t q_b, int64_t q_h, int64_t q_n, int64_t k_b, int64_t k_h,
    int64_t k_n, int64_t v_b, int64_t v_h, int64_t v_n, float scale,
    int causal, void* stream) {
  const int64_t strides[9] = {q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n};
  if (bad_tma_inputs(batch, n_heads, nq, nk, d_qk, d_v, strides,
                     {q, k, v, out, dout}, 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0 || n_heads == 0) return 0;
  TmaArgs a = make_args(key_mask, dout, const_cast<void*>(lse), dq, dk, dv,
                        delta, n_heads, nq, nk, d_qk, d_v, scale);
  a.out = static_cast<const bf16*>(out);
  a.causal = causal;
  return launch_for_dims<false>(a, q, k, v, batch, strides,
                                static_cast<cudaStream_t>(stream));
}

// K3-bwd's TMA route: as attention_vmem_bwd (attention_vmem_bwd.cu) for
// bf16 only, on q, k, v as flash_attention_bwd_tma takes them; no forward
// output (the dq kernel's kStats sweep takes each row's lse and delta);
// dout (batch, n_heads, nq, d_v) contiguous and 16-byte aligned; writes dq,
// dk, dv (contiguous, bf16) and lse, delta (batch, n_heads, nq) fp32.
// Returns a cudaError_t value; 0 on a clean launch.
extern "C" int attention_vmem_bwd_tma(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int batch, int n_heads, int nq, int nk, int d_qk, int d_v, int64_t q_b,
    int64_t q_h, int64_t q_n, int64_t k_b, int64_t k_h, int64_t k_n,
    int64_t v_b, int64_t v_h, int64_t v_n, float scale, void* stream) {
  const int64_t strides[9] = {q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n};
  if (bad_tma_inputs(batch, n_heads, nq, nk, d_qk, d_v, strides,
                     {q, k, v, dout}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || batch == 0 || n_heads == 0) return 0;
  TmaArgs a = make_args(key_mask, dout, lse, dq, dk, dv, delta, n_heads, nq,
                        nk, d_qk, d_v, scale);
  return launch_for_dims<true>(a, q, k, v, batch, strides,
                               static_cast<cudaStream_t>(stream));
}
