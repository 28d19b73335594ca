// Multi-resolution hash-grid encoding, forward (K2-fwd).
//
// Replaces: deepearth_tpu/ops/hash_encoding.py `hash_encode` and its
// `_packed_gather` (XLA on the TPU: Mosaic cannot express a random gather
// into a large table, so the JAX package never had a Pallas kernel here).
//
// Bound on the H100: random 8-byte gathers. At the A-stack shape a point
// reads 8 corners x 16 spatial levels plus 2 corners x 8 temporal levels,
// each one float2 from a table row chosen by the hash. The 16-level spatial
// table is 16 x 2^19 x 2 x 4 B = 64 MiB, larger than the 50 MB L2, so the
// fine levels miss to HBM; the coarse levels (16^3 .. 128^3 cells map onto
// few distinct rows) stay resident in L2.
//
// Design: one thread per (point, level). Consecutive threads take the levels
// of one point, so the (N, L*F) output row of a point is written by
// neighbouring threads. The thread computes floor(res*x) with one fp32
// multiply (as JAX does), the 2^D corner hashes in uint32, and the d-linear
// weights, then issues one float2 load per corner. Weights and sums use
// round-to-nearest intrinsics so that no multiply-add is contracted: the
// result is bit-identical to the plain PyTorch version, which sums the
// corners in the same order (corner c has offset bit d = (c >> d) & 1).
// Nothing is staged in shared memory: there is no reuse across threads to
// exploit beyond what L2 already gives.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t hash_prime(int d) {
  // XOR-prime spatial hash (deepearth_tpu/ops/hash_encoding.py HASH_PRIMES)
  return d == 0 ? 1u : d == 1 ? 2654435761u : d == 2 ? 805459861u : 3674653429u;
}

template <int D, bool LINEAR, int FS>
__global__ void hash_encode_fwd_kernel(const float* __restrict__ coords,
                                       const float* __restrict__ tables,
                                       const float* __restrict__ resolutions,
                                       float* __restrict__ out, int64_t n,
                                       int n_levels, int64_t level_stride,
                                       uint32_t table_size, int f_runtime) {
  constexpr int NC = LINEAR ? (1 << D) : 1;
  const int F = FS > 0 ? FS : f_runtime;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * n_levels) return;
  const int64_t p = tid / n_levels;
  const int l = static_cast<int>(tid - p * n_levels);

  const float res = resolutions[l];
  int grid[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float s = __fmul_rn(res, coords[p * D + d]);
    const float fl = floorf(s);
    grid[d] = static_cast<int>(fl);
    frac[d] = __fsub_rn(s, fl);
  }

  const bool pow2 = (table_size & (table_size - 1)) == 0;
  int64_t row[NC];
  float w[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    uint32_t h = 0;
    float wc = 1.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int bit = (c >> d) & 1;
      h ^= static_cast<uint32_t>(grid[d] + bit) * hash_prime(d);
      if (LINEAR) wc = __fmul_rn(wc, bit ? frac[d] : __fsub_rn(1.0f, frac[d]));
    }
    h = pow2 ? (h & (table_size - 1)) : (h % table_size);
    row[c] = static_cast<int64_t>(l) * level_stride + h;
    w[c] = wc;
  }

  float* o = out + (p * n_levels + l) * F;
  if constexpr (FS == 2) {
    const float2* t2 = reinterpret_cast<const float2*>(tables);
    float ax = 0.0f, ay = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float2 v = __ldg(t2 + row[c]);
      ax = __fadd_rn(ax, __fmul_rn(w[c], v.x));
      ay = __fadd_rn(ay, __fmul_rn(w[c], v.y));
    }
    *reinterpret_cast<float2*>(o) = make_float2(ax, ay);
  } else {
    for (int f = 0; f < F; ++f) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc = __fadd_rn(acc, __fmul_rn(w[c], __ldg(tables + row[c] * F + f)));
      o[f] = acc;
    }
  }
}

template <int D, bool LINEAR>
void launch_d(const float* coords, const float* tables, const float* res,
              float* out, int64_t n, int n_levels, int64_t level_stride,
              uint32_t table_size, int f, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t total = n * n_levels;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (f == 2)
    hash_encode_fwd_kernel<D, LINEAR, 2><<<blocks, kThreads, 0, stream>>>(
        coords, tables, res, out, n, n_levels, level_stride, table_size, f);
  else
    hash_encode_fwd_kernel<D, LINEAR, 0><<<blocks, kThreads, 0, stream>>>(
        coords, tables, res, out, n, n_levels, level_stride, table_size, f);
}

template <bool LINEAR>
int launch(const float* coords, const float* tables, const float* res,
           float* out, int64_t n, int d, int n_levels, int64_t level_stride,
           uint32_t table_size, int f, cudaStream_t stream) {
  switch (d) {
    case 1: launch_d<1, LINEAR>(coords, tables, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 2: launch_d<2, LINEAR>(coords, tables, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 3: launch_d<3, LINEAR>(coords, tables, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 4: launch_d<4, LINEAR>(coords, tables, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// coords (n, d) fp32, tables (n_levels, level_stride, f) fp32, resolutions
// (n_levels,) fp32, out (n, n_levels * f) fp32; all contiguous on the device.
// Returns a cudaError_t value; 0 on a clean launch.
extern "C" int hash_encode_fwd(const void* coords, const void* tables,
                               const void* resolutions, void* out, int64_t n,
                               int d, int n_levels, int64_t level_stride,
                               int64_t table_size, int f, int linear,
                               void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(coords);
  const auto* t = static_cast<const float*>(tables);
  const auto* r = static_cast<const float*>(resolutions);
  auto* o = static_cast<float*>(out);
  const auto ts = static_cast<uint32_t>(table_size);
  const int rc = linear
      ? launch<true>(c, t, r, o, n, d, n_levels, level_stride, ts, f, s)
      : launch<false>(c, t, r, o, n, d, n_levels, level_stride, ts, f, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
