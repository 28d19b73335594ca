// Gaussian splatting for Hopper (sm_90a): K8 tile binning, K9 compositing
// forward and backward.
//
// Replace the XLA programs of deepearth_tpu/reconstruction/gaussian_splat.py
// (no Pallas kernel there: the TPU has no tile rasterizer, so JAX selects
// with lax.top_k and composites with cumprod over dense (pixels, K) arrays):
//
//   K8  splat_bin            render_tiled's intersect test and top_k
//                            (gaussian_splat.py:253-259): per 16 x 16 tile,
//                            the first K depth-sorted Gaussians whose
//                            radius box meets the tile and whose depth is
//                            in front of the camera.
//   K9  splat_composite_fwd  front-to-back "over" compositing of an ordered
//                            list per region (:261-283 tiled, one list a
//                            tile; :143-157 dense, one list for the image).
//   K9  splat_composite_bwd  its gradient with respect to every list
//                            entry's mean, quadratic form, opacity and
//                            colour, and the background.
//
// JAX's semantics are kept: every entry of a list is composited (no early
// stop at low transmittance, no skipped zero-opacity slot), alpha =
// clip(o * exp(-q / 2), 0, 0.995) with jnp.clip's gradient (1 inside, 1/2
// on a bound, 0 outside), an entry of zero opacity shows nothing (the
// caller zeroes the unfilled slots and the Gaussians behind the camera).
//
// What bounds K9 on the card. Per (pixel, list entry) the forward issues
// ~15 fp32 instructions and one exp, the backward ~50, one exp and one
// reciprocal: the issue slots of the fp32 pipes, if the list's entries
// reach the pixels without costing more issue slots than that. The design:
//
// * The list is split into S runs ("segments"; S from K and the region's
//   size alone: kernels.splat_plan). "Over" is associative, (C1, T1) o
//   (C2, T2) = (C1 + T1 C2, T1 T2): a warp composites one run over its
//   pixels, then the block combines the runs' (C, T) per pixel in a fixed
//   order through shared memory. A 16 x 16 tile (two pixel groups) and its
//   S runs are one block of 2 S warps; the dense image has a block for each
//   group's S runs.
// * A warp's pixels are an 8 x 16 group, 4 side by side in a row a thread:
//   one read of an entry serves 4 pixel-entries, the row's dy terms are
//   shared, and each thread has 4 independent transmittance chains. A warp
//   stages its run 32 entries at a time in shared memory, each entry as
//   three float4 (x, y, a', b' | c', o, r, g | b, a, b, c; a' = -a log2(e)
//   / 2 so that alpha's exp is one ex2): three 16-byte broadcast reads an
//   entry, where nine 4-byte ones were. The next 32 entries are loaded into
//   registers while these are composited.
// * The transmittance is a mantissa and a binary exponent (it underflows
//   fp32 after ~17 entries at alpha = 0.995). With a backward to follow,
//   the forward keeps per (pixel, run) the transmittance after the run (a
//   prefix product) and the colour seen behind it (a suffix composite with
//   the background): 20 bytes, found without subtraction or division.
//   Summing a run's colours apart also keeps the small terms a running sum
//   over the whole list would round away.
// * The backward walks each run back to front from that state, carrying
//   the colour behind an entry as its dot with dout (q_{j-1} = a_j c_j +
//   (1 - a_j) q_j) and the transmittance before an entry by multiplying
//   with the reciprocal of the same (1 - a_j) the forward multiplied in
//   (one device function forms alpha for both), the scale 2^exponent
//   changing only when the mantissa is renormalised. An entry whose exp is
//   0 at every pixel of the warp is a no-op and is skipped. Each thread
//   sums its 4 pixels' nine gradients in registers, a transposing
//   butterfly sums them over the warp (12 shuffles an entry where nine
//   warp sums took 45), the block's warps of one run add in a fixed order
//   through shared memory, and one atomic add a block and gradient entry
//   remains: a tile is one block, so the tiled gradients are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // K8's block
constexpr int kWarps = kThreads / 32;
constexpr float kClip = 0.995f;

// K9's layout
constexpr int kPix = 4;            // pixels a thread, side by side in a row
constexpr int kGroupW = 4 * kPix;  // a warp's pixels: 16 columns
constexpr int kGroupH = 8;         //                  by 8 rows
constexpr int kBatch = 32;         // entries a warp stages at a time
constexpr int kMaxWarps = 16;      // segments x pixel groups of one block
constexpr int kMaxSegments = 15;   // one named barrier a segment (1..15)
constexpr int kFields = 9;  // d mean x, y; d a, b, c; d opacity; d r, g, b
constexpr int kState = 5;   // kept a (pixel, segment): T mantissa, exponent;
                            // the colour behind (3)
constexpr float kExp2Scale = -0.72134752044448170f;  // -log2(e) / 2
static_assert(kPix == 4, "a thread's pixels are read as one float4");

__global__ void __launch_bounds__(kThreads)
    splat_bin_kernel(const float* __restrict__ xy,
                     const float* __restrict__ radius,
                     const uint8_t* __restrict__ valid, int g, int tiles_x,
                     int tile_size, int k, int* __restrict__ idx,
                     int* __restrict__ count) {
  __shared__ int warp_hits[kWarps];
  __shared__ int filled;
  int tile = blockIdx.x;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the tile's centre and half width, as JAX forms them in fp32
  float cx = (float)((tile % tiles_x) * tile_size) + tile_size / 2.0f;
  float cy = (float)((tile / tiles_x) * tile_size) + tile_size / 2.0f;
  float half = tile_size / 2.0f;
  if (threadIdx.x == 0) filled = 0;
  __syncthreads();
  for (int base = 0; base < g; base += kThreads) {
    int i = base + threadIdx.x;
    bool hit = false;
    if (i < g && valid[i]) {
      float reach = half + radius[i];
      hit = fabsf(xy[2 * i] - cx) <= reach && fabsf(xy[2 * i + 1] - cy) <= reach;
    }
    unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = filled;
    for (int w = 0; w < warp; ++w) before += warp_hits[w];
    int slot = before + __popc(ballot & ((1u << lane) - 1u));
    if (hit && slot < k) idx[(long long)tile * k + slot] = i;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = filled;
      for (int w = 0; w < kWarps; ++w) total += warp_hits[w];
      filled = total;
    }
    __syncthreads();
    if (filled >= k) break;
  }
  int n = filled < k ? filled : k;
  // unfilled slots point at Gaussian 0 (their opacity is zeroed)
  for (int s = n + threadIdx.x; s < k; s += kThreads)
    idx[(long long)tile * k + s] = 0;
  if (threadIdx.x == 0) count[tile] = n;
}

// -- K9 ---------------------------------------------------------------------

// One list of `k` entries a region, each at xy (2), abc (3), opac (1) and
// color (3) floats; region r of a width x height image tiled by region_w x
// region_h regions, row-major. Each list is cut into `segments` runs of
// seg_len entries (the last may be shorter or empty); a block holds
// groups_per_block pixel groups of one region for every segment.
struct Lists {
  const float* xy;
  const float* abc;
  const float* opac;
  const float* color;
  int k, height, width, region_h, region_w;
  int segments, seg_len, groups_per_block, blocks_per_list;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One entry as a lane loads it (zeros past the segment: alpha 0, a factor
// of exactly 1 and no colour).
struct Entry {
  float x, y, a, b, c, o, r, g, bl;
};

__device__ __forceinline__ Entry fetch(const Lists& p, long long list, int e,
                                       int end) {
  Entry v{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (e < end) {
    long long i = list * p.k + e;
    v.x = __ldg(p.xy + 2 * i);
    v.y = __ldg(p.xy + 2 * i + 1);
    v.a = __ldg(p.abc + 3 * i);
    v.b = __ldg(p.abc + 3 * i + 1);
    v.c = __ldg(p.abc + 3 * i + 2);
    v.o = __ldg(p.opac + i);
    v.r = __ldg(p.color + 3 * i);
    v.g = __ldg(p.color + 3 * i + 1);
    v.bl = __ldg(p.color + 3 * i + 2);
  }
  return v;
}

// An entry in shared memory: (x, y, a', b'), (c', o, r, g), (b, a, b, c)
// with a' = a * kExp2Scale (and b', c'), so that 2^(a'dx^2 + b'dx dy +
// c'dy^2) = exp(-q / 2).
__device__ __forceinline__ void stage(float4* slot, const Entry& v) {
  slot[0] = make_float4(v.x, v.y, __fmul_rn(v.a, kExp2Scale),
                        __fmul_rn(v.b, kExp2Scale));
  slot[1] = make_float4(__fmul_rn(v.c, kExp2Scale), v.o, v.r, v.g);
  slot[2] = make_float4(v.bl, v.a, v.b, v.c);
}

// A thread's kPix pixels: centres x0 + i, y; their region-local index
// (row-major) and flat image index from local0 / image0 + i; bit i of
// `active` set if pixel i lies in the region.
struct Pixels {
  float x0, y;
  int local0;
  long long image0;
  unsigned active;
};

__device__ __forceinline__ Pixels pixels_of(const Lists& p, int list,
                                            int group, int lane) {
  int groups_x = (p.region_w + kGroupW - 1) / kGroupW;
  int groups = groups_x * ((p.region_h + kGroupH - 1) / kGroupH);
  int ly = group / groups_x * kGroupH + (lane >> 2);
  int lx = group % groups_x * kGroupW + (lane & 3) * kPix;
  int regions_x = p.width / p.region_w;
  int py = list / regions_x * p.region_h + ly;
  int px = list % regions_x * p.region_w + lx;
  Pixels out;
  out.x0 = px + 0.5f;
  out.y = py + 0.5f;
  out.local0 = ly * p.region_w + lx;
  out.image0 = (long long)py * p.width + px;
  out.active = 0;
  if (group < groups && ly < p.region_h) {
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      if (lx + i < p.region_w) out.active |= 1u << i;
  }
  return out;
}

// The terms of the quadratic form shared by a row of pixels.
struct Row {
  float dy, bdy, cdy2;
};

__device__ __forceinline__ Row row_of(float4 f0, float4 f1, float y) {
  Row r;
  r.dy = __fsub_rn(y, f0.y);
  r.bdy = __fmul_rn(f0.w, r.dy);
  r.cdy2 = __fmul_rn(__fmul_rn(f1.x, r.dy), r.dy);
  return r;
}

// Alpha at one pixel, dx = its x - the entry's: e = exp(-q / 2), raw = o e,
// alpha = clip(raw, 0, 0.995), for o = max(opacity, 0) (an entry of
// negative opacity has alpha 0 and, raw < 0, no gradient: the backward
// skips it). The forward and the backward both call this (rounding as
// written: no contraction), so the (1 - alpha) the backward divides out is
// the factor the forward multiplied in.
__device__ __forceinline__ float alpha_at(float dx, const Row& r, float a2,
                                          float o, float& e, float& raw) {
  float q = __fmaf_rn(__fmaf_rn(a2, dx, r.bdy), dx, r.cdy2);
  e = ex2(q);
  raw = __fmul_rn(o, e);
  return fminf(raw, kClip);
}

// 2^e for e <= 127 (0 below 2^-149): the scale of a mantissa.
__device__ __forceinline__ float pow2(int e) {
  return e >= -126 ? __int_as_float((e + 127) << 23)
                   : (e >= -149 ? __int_as_float(1 << (e + 149)) : 0.0f);
}

// The segment and pixel group of this warp, and its entries [begin, end).
struct Role {
  int list, seg, group, begin, end;
};

__device__ __forceinline__ Role role_of(const Lists& p, int warp) {
  Role r;
  r.list = blockIdx.x / p.blocks_per_list;
  r.seg = warp % p.segments;
  r.group = blockIdx.x % p.blocks_per_list * p.groups_per_block +
            warp / p.segments;
  r.begin = min(p.k, r.seg * p.seg_len);
  r.end = min(p.k, r.begin + p.seg_len);
  return r;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    splat_composite_fwd_kernel(Lists p, const float* __restrict__ background,
                               float* __restrict__ out,
                               float* __restrict__ state) {
  // each warp's staged entries, then (reused) each warp's segment results
  // as comb[warp][field][lane] float4s of its lanes' 4 pixels
  constexpr int kStage = kMaxWarps * kBatch * 3;
  constexpr int kComb = kMaxWarps * kState * 32;
  __shared__ float4 smem[kStage > kComb ? kStage : kComb];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Role role = role_of(p, warp);
  Pixels px = pixels_of(p, role.list, role.group, lane);
  float4* ent = smem + warp * kBatch * 3;
  // the transmittance within the segment is m * 2^ex: while m stays above
  // 2^-64 the plain product, below it brought back up every 8 entries (8
  // factors of at least 0.005 keep it above 2^-126). The colour is cr (cg,
  // cb) plus 2^ex times sr (sg, sb), the sum of the weights alpha * m since
  // the last renormalisation.
  float m[kPix], cr[kPix], cg[kPix], cb[kPix], sr[kPix], sg[kPix], sb[kPix];
  int ex[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    m[i] = 1.0f;
    cr[i] = cg[i] = cb[i] = sr[i] = sg[i] = sb[i] = 0.0f;
    ex[i] = 0;
  }
  Entry next = fetch(p, role.list, role.begin + lane, role.end);
  for (int base = role.begin; base < role.end; base += kBatch) {
    int n = min(kBatch, role.end - base);
    __syncwarp();
    stage(ent + 3 * lane, next);
    __syncwarp();
    next = fetch(p, role.list, base + kBatch + lane, role.end);
    for (int j0 = 0; j0 < n; j0 += 8) {
#pragma unroll
      for (int j = j0; j < j0 + 8; ++j) {
        float4 f0 = ent[3 * j], f1 = ent[3 * j + 1], f2 = ent[3 * j + 2];
        Row r = row_of(f0, f1, px.y);
        float o = fmaxf(f1.y, 0.0f);
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          float e, raw;
          float a = alpha_at(__fsub_rn(px.x0 + i, f0.x), r, f0.z, o, e, raw);
          float w = __fmul_rn(a, m[i]);
          sr[i] = __fmaf_rn(w, f1.z, sr[i]);
          sg[i] = __fmaf_rn(w, f1.w, sg[i]);
          sb[i] = __fmaf_rn(w, f2.x, sb[i]);
          m[i] = __fmul_rn(m[i], __fsub_rn(1.0f, a));
        }
      }
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (m[i] < 0x1p-64f) {
          float sc = pow2(ex[i]);
          cr[i] = __fmaf_rn(sc, sr[i], cr[i]);
          cg[i] = __fmaf_rn(sc, sg[i], cg[i]);
          cb[i] = __fmaf_rn(sc, sb[i], cb[i]);
          sr[i] = sg[i] = sb[i] = 0.0f;
          m[i] *= 0x1p64f;
          ex[i] -= 64;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    float sc = pow2(ex[i]);
    cr[i] = __fmaf_rn(sc, sr[i], cr[i]);
    cg[i] = __fmaf_rn(sc, sg[i], cg[i]);
    cb[i] = __fmaf_rn(sc, sb[i], cb[i]);
  }
  __syncthreads();  // every warp is done with its staged entries
  float4* comb = smem;
  float4* mine = comb + warp * kState * 32 + lane;
  mine[0] = make_float4(cr[0], cr[1], cr[2], cr[3]);
  mine[32] = make_float4(cg[0], cg[1], cg[2], cg[3]);
  mine[64] = make_float4(cb[0], cb[1], cb[2], cb[3]);
  mine[96] = make_float4(m[0], m[1], m[2], m[3]);
  mine[128] = make_float4((float)ex[0], (float)ex[1], (float)ex[2],
                          (float)ex[3]);
  __syncthreads();
  if (state == nullptr && role.seg != 0) return;
  // the colour seen behind this segment: the later segments composited
  // back to front over the background, B_s = C_{s+1} + T_{s+1} B_{s+1}
  int first = warp - role.seg;  // segment 0 of this pixel group
  float br[kPix], bgr[kPix], bb[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    br[i] = background ? background[0] : 0.0f;
    bgr[i] = background ? background[1] : 0.0f;
    bb[i] = background ? background[2] : 0.0f;
  }
  for (int t = p.segments - 1; t > role.seg; --t) {
    const float4* c = comb + (first + t) * kState * 32 + lane;
    float4 R = c[0], G = c[32], B = c[64], M = c[96], E = c[128];
    float vr[4] = {R.x, R.y, R.z, R.w}, vg[4] = {G.x, G.y, G.z, G.w},
          vb[4] = {B.x, B.y, B.z, B.w}, vm[4] = {M.x, M.y, M.z, M.w},
          ve[4] = {E.x, E.y, E.z, E.w};
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      float tr = __fmul_rn(vm[i], pow2((int)ve[i]));
      br[i] = __fmaf_rn(tr, br[i], vr[i]);
      bgr[i] = __fmaf_rn(tr, bgr[i], vg[i]);
      bb[i] = __fmaf_rn(tr, bb[i], vb[i]);
    }
  }
  if (role.seg == 0) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      if (!(px.active >> i & 1)) continue;
      float tr = __fmul_rn(m[i], pow2(ex[i]));
      long long o = 3 * (px.image0 + i);
      out[o] = __fmaf_rn(tr, br[i], cr[i]);
      out[o + 1] = __fmaf_rn(tr, bgr[i], cg[i]);
      out[o + 2] = __fmaf_rn(tr, bb[i], cb[i]);
    }
  }
  if (state == nullptr) return;
  // the transmittance after this segment: the product of the segments' up
  // to it (each mantissa in [2^-64, 1]; the product kept in [2^-32, 2^32)
  // by exact steps of 2^64), then normalised to a mantissa in [0.5, 1)
  float tm[kPix];
  int te[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    tm[i] = 1.0f;
    te[i] = 0;
  }
  for (int t = 0; t <= role.seg; ++t) {
    const float4* c = comb + (first + t) * kState * 32 + lane;
    float4 M = c[96], E = c[128];
    float vm[4] = {M.x, M.y, M.z, M.w}, ve[4] = {E.x, E.y, E.z, E.w};
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      tm[i] = __fmul_rn(tm[i], vm[i]);
      te[i] += (int)ve[i];
      if (tm[i] < 0x1p-32f) {
        tm[i] *= 0x1p64f;
        te[i] -= 64;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    int e2;
    tm[i] = frexpf(tm[i], &e2);
    te[i] += e2;
  }
  int pixels = p.region_h * p.region_w;
  float* st = state + ((long long)role.list * p.segments + role.seg) * kState *
                          pixels + px.local0;
  if (p.region_w % kPix == 0) {
    // a row's pixels are whole float4s: a thread's 4 all in the region or
    // none, 16-byte aligned
    if (px.active == 0) return;
    float4* st4 = reinterpret_cast<float4*>(st);
    int f4 = pixels / kPix;
    st4[0] = make_float4(tm[0], tm[1], tm[2], tm[3]);
    st4[f4] = make_float4((float)te[0], (float)te[1], (float)te[2],
                          (float)te[3]);
    st4[2 * f4] = make_float4(br[0], br[1], br[2], br[3]);
    st4[3 * f4] = make_float4(bgr[0], bgr[1], bgr[2], bgr[3]);
    st4[4 * f4] = make_float4(bb[0], bb[1], bb[2], bb[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    if (!(px.active >> i & 1)) continue;
    st[i] = tm[i];
    st[pixels + i] = (float)te[i];
    st[2 * pixels + i] = br[i];
    st[3 * pixels + i] = bgr[i];
    st[4 * pixels + i] = bb[i];
  }
}

// The field whose warp sum lane `lane` ends with in warp_fields, or -1.
// The halving steps keep, by lane bits 4, 3, 2, 1, the upper or lower part
// of 9 -> 5 -> 3 -> 2 -> 1 values (the upper part padded with a zero);
// bit 0 picks nothing, so a field is held by two lanes.
__device__ __forceinline__ int lane_field(int lane) {
  int i3 = (lane >> 1) & 3;                  // index among the 3 (bits 2, 1)
  int i5 = (lane & 8 ? 3 : 0) + i3;          // index among the 5 (bit 3)
  int f = (lane & 16 ? 5 : 0) + i5;          // index among the 9 (bit 4)
  return i3 < 3 && i5 < 5 && f < kFields ? f : -1;
}

// The warp's nine values summed over its 32 lanes by a transposing
// butterfly: each step halves the values a lane holds (9, 5, 3, 2, 1), 12
// shuffles in all, in a fixed order; the lane ends with the sum of field
// lane_field(lane).
__device__ __forceinline__ float warp_fields(const float (&v)[kFields],
                                             int lane) {
  const unsigned full = 0xffffffffu;
  bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float s5[5], s3[3], s2[2];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    float lo = v[i], hi = i + 5 < kFields ? v[i + 5] : 0.0f;
    s5[i] = (b4 ? hi : lo) + __shfl_xor_sync(full, b4 ? lo : hi, 16);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float lo = s5[i], hi = i + 3 < 5 ? s5[i + 3] : 0.0f;
    s3[i] = (b3 ? hi : lo) + __shfl_xor_sync(full, b3 ? lo : hi, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lo = s3[i], hi = i + 2 < 3 ? s3[i + 2] : 0.0f;
    s2[i] = (b2 ? hi : lo) + __shfl_xor_sync(full, b2 ? lo : hi, 4);
  }
  float s1 = (b1 ? s2[1] : s2[0]) +
             __shfl_xor_sync(full, b1 ? s2[0] : s2[1], 2);
  return s1 + __shfl_xor_sync(full, s1, 1);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float* grad_slot(int field, long long e,
                                            float* dxy, float* dabc,
                                            float* dopac, float* dcolor) {
  return field < 2    ? dxy + 2 * e + field
         : field < 5  ? dabc + 3 * e + (field - 2)
         : field == 5 ? dopac + e
                      : dcolor + 3 * e + (field - 6);
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    splat_composite_bwd_kernel(Lists p, const float* __restrict__ background,
                               const float* __restrict__ state,
                               const float* __restrict__ dout,
                               float* __restrict__ dxy,
                               float* __restrict__ dabc,
                               float* __restrict__ dopac,
                               float* __restrict__ dcolor,
                               float* __restrict__ dbackground) {
  __shared__ float4 staged[kMaxWarps * kBatch * 3];
  __shared__ float part[kMaxWarps][kBatch][kFields];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Role role = role_of(p, warp);
  Pixels px = pixels_of(p, role.list, role.group, lane);
  float4* ent = staged + warp * kBatch * 3;
  int pixels = p.region_h * p.region_w;
  const float* st = state + ((long long)role.list * p.segments + role.seg) *
                                kState * pixels + px.local0;
  // per pixel: dout, the transmittance m * sc (sc = 2^ex) and q, the colour
  // seen behind the entry dotted with dout; a pixel off the region has
  // dout 0 and adds nothing
  float gr[kPix], gg[kPix], gb[kPix], m[kPix], sc[kPix], q[kPix];
  int ex[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    gr[i] = gg[i] = gb[i] = q[i] = 0.0f;
    m[i] = 1.0f;
    ex[i] = 0;
    if (px.active >> i & 1) {
      long long o = 3 * (px.image0 + i);
      gr[i] = dout[o];
      gg[i] = dout[o + 1];
      gb[i] = dout[o + 2];
      m[i] = st[i];
      ex[i] = (int)st[pixels + i];
      q[i] = st[2 * pixels + i] * gr[i] + st[3 * pixels + i] * gg[i] +
             st[4 * pixels + i] * gb[i];
    }
    sc[i] = pow2(ex[i]);
  }
  // the background's gradient: T_final * dout, summed over the pixels
  if (dbackground != nullptr && role.seg == p.segments - 1) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      float t = m[i] * sc[i];
      s0 += t * gr[i];
      s1 += t * gg[i];
      s2 += t * gb[i];
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      atomicAdd(dbackground, s0);
      atomicAdd(dbackground + 1, s1);
      atomicAdd(dbackground + 2, s2);
    }
  }
  int seg_warps = p.groups_per_block;  // the block's warps of this segment
  int gi = warp / p.segments;
  int field = lane_field(lane);
  int batches = (role.end - role.begin + kBatch - 1) / kBatch;
  Entry next{};
  if (batches > 0)
    next = fetch(p, role.list, role.begin + (batches - 1) * kBatch + lane,
                 role.end);
  for (int bi = batches - 1; bi >= 0; --bi) {
    int base = role.begin + bi * kBatch;
    int n = min(kBatch, role.end - base);
    __syncwarp();
    stage(ent + 3 * lane, next);
    __syncwarp();
    if (bi > 0) next = fetch(p, role.list, base - kBatch + lane, role.end);
    // back to front in groups of 4 (the staged zeros past n add nothing to
    // the walk, and their sums are not added out)
    for (int j0 = ((n + 3) & ~3) - 4; j0 >= 0; j0 -= 4) {
#pragma unroll
      for (int jj = 3; jj >= 0; --jj) {
        int j = j0 + jj;
        float4 f0 = ent[3 * j], f1 = ent[3 * j + 1], f2 = ent[3 * j + 2];
        Row r = row_of(f0, f1, px.y);
        float o = fmaxf(f1.y, 0.0f);
        float dx[kPix], e[kPix], raw[kPix], al[kPix];
        bool live = false;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          dx[i] = __fsub_rn(px.x0 + i, f0.x);
          al[i] = alpha_at(dx[i], r, f0.z, o, e[i], raw[i]);
          live |= e[i] != 0.0f;
        }
        float sum = 0.0f;
        // an exp of 0 at every pixel of the warp, or a negative opacity:
        // alpha 0, no gradient, the transmittance and q unchanged
        if (__any_sync(0xffffffffu, live) && f1.y >= 0.0f) {
          float dop = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
          float dr = 0.0f, dg = 0.0f, db = 0.0f;
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            float keep = __fsub_rn(1.0f, al[i]);
            // the transmittance before this entry
            m[i] = keep < 1.0f ? __fmul_rn(m[i], rcp(keep)) : m[i];
            float t = m[i] * sc[i];
            float cdot = f1.z * gr[i] + f1.w * gg[i] + f2.x * gb[i];
            float dalpha = t * (cdot - q[i]);
            q[i] = al[i] * cdot + keep * q[i];
            float w = al[i] * t;
            dr += w * gr[i];
            dg += w * gg[i];
            db += w * gb[i];
            // jnp.clip (raw >= 0 here): 1 inside, 1/2 on either bound, 0
            // above
            float pass = raw[i] < kClip ? (raw[i] > 0.0f ? 1.0f : 0.5f)
                                        : (raw[i] == kClip ? 0.5f : 0.0f);
            float draw = dalpha * pass;
            dop += draw * e[i];
            // d q = -draw * raw / 2; its sums over the pixels, dx^0..2
            float d = draw * raw[i];
            a0 += d;
            float ddx = d * dx[i];
            a1 += ddx;
            a2 += ddx * dx[i];
          }
          float a = f2.y, b = f2.z, c = f2.w, dy = r.dy;
          float v[kFields] = {a * a1 + 0.5f * b * dy * a0,
                              0.5f * b * a1 + c * dy * a0,
                              -0.5f * a2,
                              -0.5f * a1 * dy,
                              -0.5f * a0 * dy * dy,
                              dop,
                              dr,
                              dg,
                              db};
          sum = warp_fields(v, lane);
        }
        if (field >= 0 && !(lane & 1)) part[warp][j][field] = sum;
      }
      // 4 factors of at most 200 keep m under 2^63
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (m[i] > 0x1p32f) {
          m[i] *= 0x1p-64f;
          ex[i] += 64;
          sc[i] = pow2(ex[i]);
        }
      }
    }
    // the segment's warps (one a pixel group) add in group order; one
    // atomic add a block and gradient entry
    named_sync(1 + role.seg, 32 * seg_warps);
    for (int v = gi * 32 + lane; v < n * kFields; v += 32 * seg_warps) {
      int j = v / kFields, f = v - j * kFields;
      float total = 0.0f;
      for (int g = 0; g < seg_warps; ++g)
        total += part[g * p.segments + role.seg][j][f];
      if (total != 0.0f)
        atomicAdd(grad_slot(f, (long long)role.list * p.k + base + j, dxy,
                            dabc, dopac, dcolor),
                  total);
    }
    named_sync(1 + role.seg, 32 * seg_warps);
  }
}

// The launch shape of K9: a block of segments x groups_per_block warps, a
// row of blocks a list; 0 or cudaErrorInvalidValue.
int k9_lists(Lists& p, int lists, int segments, int groups_per_block,
             dim3* grid, dim3* block) {
  int groups = ((p.region_w + kGroupW - 1) / kGroupW) *
               ((p.region_h + kGroupH - 1) / kGroupH);
  if (segments < 1 || segments > kMaxSegments || groups_per_block < 1 ||
      segments * groups_per_block > kMaxWarps || p.region_h < 1 ||
      p.region_w < 1)
    return (int)cudaErrorInvalidValue;
  p.segments = segments;
  p.seg_len = (p.k + segments - 1) / segments;
  p.groups_per_block = groups_per_block;
  p.blocks_per_list = (groups + groups_per_block - 1) / groups_per_block;
  *grid = dim3(p.blocks_per_list * lists);
  *block = dim3(32 * segments * groups_per_block);
  return 0;
}

}  // namespace

extern "C" {

// K8: xy (G, 2), radius (G) fp32 and valid (G) uint8 of the depth-sorted
// Gaussians; tiles_x * tiles_y tiles of tile_size pixels. Writes idx
// (tiles, k) int32 (the first k hits in order, then 0) and count (tiles)
// int32 (the hits kept, at most k).
int splat_bin(const float* xy, const float* radius, const uint8_t* valid,
              int g, int tiles_x, int tiles_y, int tile_size, int k, int* idx,
              int* count, cudaStream_t stream) {
  int tiles = tiles_x * tiles_y;
  if (tiles == 0 || k == 0) return 0;
  splat_bin_kernel<<<tiles, kThreads, 0, stream>>>(xy, radius, valid, g,
                                                   tiles_x, tile_size, k, idx,
                                                   count);
  return (int)cudaGetLastError();
}

// K9 forward: `lists` lists of k entries (xy (L, k, 2), abc (L, k, 3), opac
// (L, k), color (L, k, 3) fp32), list r composited over region r of a
// height x width image cut into region_h x region_w regions; background (3)
// or null; each list cut into `segments` segments, groups_per_block 8 x 16
// pixel groups of a region a block (kernels.splat_plan). Writes out
// (height, width, 3) fp32 and, if not null, state (L, segments, 5,
// region_h * region_w) fp32: per segment and region pixel the
// transmittance after the segment as mantissa and binary exponent (an
// integer) and the colour seen behind the segment, which the backward
// reads.
int splat_composite_fwd(const float* xy, const float* abc, const float* opac,
                        const float* color, const float* background, int lists,
                        int k, int height, int width, int region_h,
                        int region_w, int segments, int groups_per_block,
                        float* out, float* state, cudaStream_t stream) {
  Lists p{xy, abc, opac, color, k, height, width, region_h, region_w};
  dim3 grid, block;
  int rc = k9_lists(p, lists, segments, groups_per_block, &grid, &block);
  if (rc != 0 || lists == 0) return rc;
  splat_composite_fwd_kernel<<<grid, block, 0, stream>>>(p, background, out,
                                                         state);
  return (int)cudaGetLastError();
}

// K9 backward: the forward's inputs and plan, its state and dout (height,
// width, 3) fp32. Adds the gradients into dxy, dabc, dopac, dcolor (the
// inputs' shapes) and, if not null, dbackground (3), all zeroed by the
// caller.
int splat_composite_bwd(const float* xy, const float* abc, const float* opac,
                        const float* color, const float* background,
                        const float* state, const float* dout, int lists,
                        int k, int height, int width, int region_h,
                        int region_w, int segments, int groups_per_block,
                        float* dxy, float* dabc, float* dopac, float* dcolor,
                        float* dbackground, cudaStream_t stream) {
  Lists p{xy, abc, opac, color, k, height, width, region_h, region_w};
  dim3 grid, block;
  int rc = k9_lists(p, lists, segments, groups_per_block, &grid, &block);
  if (rc != 0 || lists == 0) return rc;
  splat_composite_bwd_kernel<<<grid, block, 0, stream>>>(
      p, background, state, dout, dxy, dabc, dopac, dcolor, dbackground);
  return (int)cudaGetLastError();
}

}  // extern "C"
