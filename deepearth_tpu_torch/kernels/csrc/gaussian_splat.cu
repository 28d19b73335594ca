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
// stop at low transmittance), alpha = clip(o * exp(-q / 2), 0, 0.995) with
// jnp.clip's gradient (1 inside, 1/2 on a bound, 0 outside), an entry of
// zero opacity contributes nothing (the caller zeroes the unfilled slots
// and the Gaussians behind the camera).
//
// What bounds them on the card. K8 reads each tile's candidates (12 bytes a
// sorted Gaussian) until it has K hits: L2 traffic, one compare per
// (tile, Gaussian). K9-fwd does one exp and ~23 fp32 operations per
// (pixel, list entry), K9-bwd one exp and ~67: the exp units (16 a clock on
// each SM) and the fp32 pipes;
// the lists are read once per block through shared memory. The design: a
// block of 256 threads is 256 pixels of one region; the region's list is
// streamed through shared memory in batches of 64 entries, every thread
// walking the batch in order. The forward keeps the transmittance as
// mantissa and binary exponent, so that an underflowed product still
// recovers, and for a backward writes the final one per pixel (8 bytes).
// The backward reads it and walks the list once, back to front, carrying
// the colour seen behind an entry (q_{j-1} = a_j c_j + (1 - a_j) q_j, no
// division) and recovering the transmittance before an entry by dividing
// out (1 - a_j) from the final one. Each entry's
// gradient is summed over the block's pixels (warp shuffles, then the
// block's warps through shared memory) before one atomic add per block and
// gradient entry: a tile is one block, so the tiled gradients are written
// once and are deterministic; the dense image has 256 blocks a list.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;
constexpr int kFields = 9;  // d mean x, y; d a, b, c; d opacity; d r, g, b
constexpr float kClip = 0.995f;

// One region's list of `k` entries, each at xy (2), abc (3), opac (1) and
// color (3) floats; region r of a width x height image tiled by
// region_w x region_h regions, row-major.
struct Lists {
  const float* xy;
  const float* abc;
  const float* opac;
  const float* color;
  int k;
  int height, width, region_h, region_w;
};

struct Batch {
  float x[kBatch], y[kBatch], a[kBatch], b[kBatch], c[kBatch], o[kBatch],
      r[kBatch], g[kBatch], bl[kBatch];
};

// Entries n up to the next multiple of 8 are loaded as zeros: alpha 0, a
// factor of exactly 1 and no colour.
__device__ __forceinline__ void load_batch(Batch& s, const Lists& p,
                                           long long list, int base, int n) {
  int t = threadIdx.x;
  if (t >= n && t < ((n + 7) & ~7)) {
    s.x[t] = s.y[t] = s.a[t] = s.b[t] = s.c[t] = s.o[t] = 0.0f;
    s.r[t] = s.g[t] = s.bl[t] = 0.0f;
  } else if (t < n) {
    long long e = list * p.k + base + t;
    s.x[t] = p.xy[2 * e];
    s.y[t] = p.xy[2 * e + 1];
    s.a[t] = p.abc[3 * e];
    s.b[t] = p.abc[3 * e + 1];
    s.c[t] = p.abc[3 * e + 2];
    s.o[t] = p.opac[e];
    s.r[t] = p.color[3 * e];
    s.g[t] = p.color[3 * e + 1];
    s.bl[t] = p.color[3 * e + 2];
  }
}

// The pixel of this thread: its centre, its flat index into the image, and
// whether it lies in the region.
struct Pixel {
  float x, y;
  long long index;
  bool active;
};

__device__ __forceinline__ Pixel pixel_of(const Lists& p, int list) {
  int local = blockIdx.x * kThreads + threadIdx.x;
  int regions_x = p.width / p.region_w;
  int ry = list / regions_x, rx = list % regions_x;
  int ly = local / p.region_w, lx = local % p.region_w;
  int py = ry * p.region_h + ly, px = rx * p.region_w + lx;
  Pixel out;
  out.active = local < p.region_h * p.region_w;
  out.x = px + 0.5f;
  out.y = py + 0.5f;
  out.index = (long long)py * p.width + px;
  return out;
}

struct Alpha {
  float dx, dy, e, raw, alpha;
};

__device__ __forceinline__ Alpha alpha_of(const Batch& s, int j, Pixel px) {
  Alpha a;
  a.dx = px.x - s.x[j];
  a.dy = px.y - s.y[j];
  float q = s.a[j] * a.dx * a.dx + s.b[j] * a.dx * a.dy +
            s.c[j] * a.dy * a.dy;
  a.e = expf(-0.5f * q);
  a.raw = s.o[j] * a.e;
  a.alpha = fminf(fmaxf(a.raw, 0.0f), kClip);
  return a;
}

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

__global__ void __launch_bounds__(kThreads)
    splat_composite_fwd_kernel(Lists p, const float* __restrict__ background,
                               float* __restrict__ out,
                               float* __restrict__ t_final) {
  __shared__ Batch s;
  int list = blockIdx.y;
  Pixel px = pixel_of(p, list);
  // the transmittance is m * scale, scale = 2^ex, and the colour r (g, b)
  // plus scale times the sum sr (sg, sb) of the weights alpha * m since the
  // last renormalisation: while m stays above 2^-64 that is the plain
  // product and sum, and below it m is brought back up every 8 entries
  float m = 1.0f, scale = 1.0f;
  float r = 0.0f, gr = 0.0f, bl = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
  int ex = 0;
  for (int base = 0; base < p.k; base += kBatch) {
    int n = min(kBatch, p.k - base);
    __syncthreads();
    load_batch(s, p, list, base, n);
    __syncthreads();
    if (!px.active) continue;
    for (int j0 = 0; j0 < n; j0 += 8) {
#pragma unroll
      for (int j = j0; j < j0 + 8; ++j) {
        Alpha a = alpha_of(s, j, px);
        float w = a.alpha * m;
        sr += w * s.r[j];
        sg += w * s.g[j];
        sb += w * s.bl[j];
        m *= 1.0f - a.alpha;
      }
      // 8 factors of at least 0.005 keep m from 2^-64 above 2^-126
      if (m < 0x1p-64f) {
        r += scale * sr;
        gr += scale * sg;
        bl += scale * sb;
        sr = sg = sb = 0.0f;
        m *= 0x1p64f;
        ex -= 64;
        scale *= 0x1p-64f;
      }
    }
  }
  if (!px.active) return;
  r += scale * sr;
  gr += scale * sg;
  bl += scale * sb;
  if (background != nullptr) {
    float t = m * scale;
    r += t * background[0];
    gr += t * background[1];
    bl += t * background[2];
  }
  out[3 * px.index] = r;
  out[3 * px.index + 1] = gr;
  out[3 * px.index + 2] = bl;
  if (t_final != nullptr) {
    t_final[2 * px.index] = m;
    t_final[2 * px.index + 1] = (float)ex;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    splat_composite_bwd_kernel(Lists p, const float* __restrict__ background,
                               const float* __restrict__ t_final,
                               const float* __restrict__ dout,
                               float* __restrict__ dxy,
                               float* __restrict__ dabc,
                               float* __restrict__ dopac,
                               float* __restrict__ dcolor,
                               float* __restrict__ dbackground) {
  __shared__ Batch s;
  __shared__ float part[kWarps][kBatch][kFields];
  __shared__ float bg_part[kWarps][3];
  int list = blockIdx.y;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Pixel px = pixel_of(p, list);
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  // the forward's final transmittance, m * 2^ex
  float m = 1.0f;
  int ex = 0;
  if (px.active) {
    g0 = dout[3 * px.index];
    g1 = dout[3 * px.index + 1];
    g2 = dout[3 * px.index + 2];
    m = t_final[2 * px.index];
    ex = (int)t_final[2 * px.index + 1];
  }
  // the background's gradient: T_final * dout, summed over the pixels
  if (dbackground != nullptr) {
    float t_final = px.active ? ldexpf(m, ex) : 0.0f;
    float b0 = warp_sum(t_final * g0), b1 = warp_sum(t_final * g1),
          b2 = warp_sum(t_final * g2);
    if (lane == 0) {
      bg_part[warp][0] = b0;
      bg_part[warp][1] = b1;
      bg_part[warp][2] = b2;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += bg_part[w][threadIdx.x];
      atomicAdd(dbackground + threadIdx.x, v);
    }
  }
  // back to front: q is the colour seen behind the entry
  float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
  if (background != nullptr) {
    q0 = background[0];
    q1 = background[1];
    q2 = background[2];
  }
  int n_batches = (p.k + kBatch - 1) / kBatch;
  for (int bi = n_batches - 1; bi >= 0; --bi) {
    int base = bi * kBatch;
    int n = min(kBatch, p.k - base);
    __syncthreads();
    load_batch(s, p, list, base, n);
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float f[kFields];
      for (int i = 0; i < kFields; ++i) f[i] = 0.0f;
      if (px.active) {
        Alpha a = alpha_of(s, j, px);
        float keep = 1.0f - a.alpha;
        m /= keep;  // the transmittance before this entry
        if (ex < 0 && m > 0x1p32f) {
          m *= 0x1p-64f;
          ex += 64;
        }
        float t = ldexpf(m, ex);
        float dalpha = t * ((s.r[j] - q0) * g0 + (s.g[j] - q1) * g1 +
                            (s.bl[j] - q2) * g2);
        float w = a.alpha * t;
        f[6] = w * g0;
        f[7] = w * g1;
        f[8] = w * g2;
        q0 = a.alpha * s.r[j] + keep * q0;
        q1 = a.alpha * s.g[j] + keep * q1;
        q2 = a.alpha * s.bl[j] + keep * q2;
        // jnp.clip: 1 inside, 1/2 on either bound, 0 outside
        float pass = (a.raw > 0.0f && a.raw < kClip)
                         ? 1.0f
                         : ((a.raw == 0.0f || a.raw == kClip) ? 0.5f : 0.0f);
        float draw = dalpha * pass;
        f[5] = draw * a.e;
        float dq = -0.5f * draw * a.raw;
        f[2] = dq * a.dx * a.dx;
        f[3] = dq * a.dx * a.dy;
        f[4] = dq * a.dy * a.dy;
        f[0] = -dq * (2.0f * s.a[j] * a.dx + s.b[j] * a.dy);
        f[1] = -dq * (s.b[j] * a.dx + 2.0f * s.c[j] * a.dy);
      }
      bool nonzero = false;
      for (int i = 0; i < kFields; ++i) nonzero |= f[i] != 0.0f;
      bool any = __any_sync(0xffffffffu, nonzero);
      if (any) {
        for (int i = 0; i < kFields; ++i) f[i] = warp_sum(f[i]);
      }
      if (lane == 0) {
        for (int i = 0; i < kFields; ++i) part[warp][j][i] = any ? f[i] : 0.0f;
      }
    }
    __syncthreads();
    for (int v = threadIdx.x; v < n * kFields; v += kThreads) {
      int j = v / kFields, field = v % kFields;
      float sum = 0.0f;
      for (int w = 0; w < kWarps; ++w) sum += part[w][j][field];
      if (sum == 0.0f) continue;
      long long e = (long long)list * p.k + base + j;
      float* dst = field < 2   ? dxy + 2 * e + field
                   : field < 5 ? dabc + 3 * e + (field - 2)
                   : field == 5 ? dopac + e
                                : dcolor + 3 * e + (field - 6);
      atomicAdd(dst, sum);
    }
  }
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
// or null. Writes out (height, width, 3) fp32 and, if not null, t_final
// (height, width, 2) fp32: each pixel's final transmittance as mantissa m
// and binary exponent e (an integer), m * 2^e, which the backward reads.
int splat_composite_fwd(const float* xy, const float* abc, const float* opac,
                        const float* color, const float* background, int lists,
                        int k, int height, int width, int region_h,
                        int region_w, float* out, float* t_final,
                        cudaStream_t stream) {
  Lists p{xy, abc, opac, color, k, height, width, region_h, region_w};
  dim3 grid((region_h * region_w + kThreads - 1) / kThreads, lists);
  if (lists == 0) return 0;
  splat_composite_fwd_kernel<<<grid, kThreads, 0, stream>>>(p, background,
                                                            out, t_final);
  return (int)cudaGetLastError();
}

// K9 backward: the forward's inputs, its t_final and dout (height, width,
// 3) fp32. Adds the gradients into dxy, dabc, dopac, dcolor (the inputs'
// shapes) and, if not null, dbackground (3), all zeroed by the caller.
int splat_composite_bwd(const float* xy, const float* abc, const float* opac,
                        const float* color, const float* background,
                        const float* t_final, const float* dout, int lists,
                        int k, int height, int width, int region_h,
                        int region_w, float* dxy, float* dabc, float* dopac,
                        float* dcolor, float* dbackground,
                        cudaStream_t stream) {
  Lists p{xy, abc, opac, color, k, height, width, region_h, region_w};
  dim3 grid((region_h * region_w + kThreads - 1) / kThreads, lists);
  if (lists == 0) return 0;
  splat_composite_bwd_kernel<<<grid, kThreads, 0, stream>>>(
      p, background, t_final, dout, dxy, dabc, dopac, dcolor, dbackground);
  return (int)cudaGetLastError();
}

}  // extern "C"
