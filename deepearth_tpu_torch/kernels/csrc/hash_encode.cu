// Multi-resolution hash-grid encoding, forward (K2-fwd) and backward
// (K2-bwd).
//
// Replaces: deepearth_tpu/ops/hash_encoding.py `hash_encode` and its
// `_packed_gather` (K2-fwd), and the gather's hand-written transpose
// `_packed_gather_bwd` (K2-bwd). Both are XLA on the TPU: Mosaic cannot
// express a random gather or scatter into a large table, so the JAX package
// never had a Pallas kernel here.
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
//
// K2-bwd is the same thread layout: thread (point, level) recomputes the
// corners and weights with the forward's own cell_corners, then adds
// w_c * grad_out[point, level, f] into the fp32 table gradient with
// atomicAdd. It is bound by the atomics: on the fine levels nearly every
// update goes to its own row (random 4-byte read-modify-writes in L2), while
// on the coarse levels (16^3 cells at level 0) many points share a row and
// their atomics serialise. Atomics make the order of each sum differ from
// run to run, so the result is not bit-reproducible; every sum is over the
// same terms as the plain version's index_add_.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t hash_prime(int d) {
  // XOR-prime spatial hash (deepearth_tpu/ops/hash_encoding.py HASH_PRIMES)
  return d == 0 ? 1u : d == 1 ? 2654435761u : d == 2 ? 805459861u : 3674653429u;
}

// The 2^D (linear) or 1 (nearest) table rows that point p reads on level l,
// and their d-linear weights. The forward and the backward both call this,
// so the backward scatters to exactly the rows, with exactly the weights,
// that the forward gathered.
template <int D, bool LINEAR>
__device__ __forceinline__ void cell_corners(
    const float* __restrict__ coords, const float* __restrict__ resolutions,
    int64_t p, int l, int64_t level_stride, uint32_t table_size,
    int64_t* row, float* w) {
  constexpr int NC = LINEAR ? (1 << D) : 1;
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
  int64_t row[NC];
  float w[NC];
  cell_corners<D, LINEAR>(coords, resolutions, p, l, level_stride, table_size,
                          row, w);

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

// K2-bwd: the transpose of the gather. Thread (p, l) recomputes its corners
// and adds w_c * grad_out[p, l, f] into grad_tables[row_c, f] with fp32
// atomics; grad_tables must be zero on entry.
template <int D, bool LINEAR, int FS>
__global__ void hash_encode_bwd_kernel(const float* __restrict__ coords,
                                       const float* __restrict__ grad_out,
                                       const float* __restrict__ resolutions,
                                       float* __restrict__ grad_tables,
                                       int64_t n, int n_levels,
                                       int64_t level_stride,
                                       uint32_t table_size, int f_runtime) {
  constexpr int NC = LINEAR ? (1 << D) : 1;
  const int F = FS > 0 ? FS : f_runtime;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * n_levels) return;
  const int64_t p = tid / n_levels;
  const int l = static_cast<int>(tid - p * n_levels);
  int64_t row[NC];
  float w[NC];
  cell_corners<D, LINEAR>(coords, resolutions, p, l, level_stride, table_size,
                          row, w);

  const float* g = grad_out + (p * n_levels + l) * F;
  if constexpr (FS == 2) {
    const float2 gv = *reinterpret_cast<const float2*>(g);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      atomicAdd(grad_tables + row[c] * 2, __fmul_rn(w[c], gv.x));
      atomicAdd(grad_tables + row[c] * 2 + 1, __fmul_rn(w[c], gv.y));
    }
  } else {
    for (int f = 0; f < F; ++f) {
      const float gf = g[f];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        atomicAdd(grad_tables + row[c] * F + f, __fmul_rn(w[c], gf));
    }
  }
}

constexpr int kThreads = 256;

// One thread per (point, level); F = 2 is a compile-time case.
template <bool BWD, int D, bool LINEAR, int FS>
void launch_f(const float* coords, const float* in, const float* res,
              float* out, int64_t n, int n_levels, int64_t level_stride,
              uint32_t table_size, int f, cudaStream_t stream) {
  const int64_t total = n * n_levels;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if constexpr (BWD)
    hash_encode_bwd_kernel<D, LINEAR, FS><<<blocks, kThreads, 0, stream>>>(
        coords, in, res, out, n, n_levels, level_stride, table_size, f);
  else
    hash_encode_fwd_kernel<D, LINEAR, FS><<<blocks, kThreads, 0, stream>>>(
        coords, in, res, out, n, n_levels, level_stride, table_size, f);
}

template <bool BWD, int D, bool LINEAR>
void launch_d(const float* coords, const float* in, const float* res,
              float* out, int64_t n, int n_levels, int64_t level_stride,
              uint32_t table_size, int f, cudaStream_t stream) {
  if (f == 2)
    launch_f<BWD, D, LINEAR, 2>(coords, in, res, out, n, n_levels,
                                level_stride, table_size, f, stream);
  else
    launch_f<BWD, D, LINEAR, 0>(coords, in, res, out, n, n_levels,
                                level_stride, table_size, f, stream);
}

template <bool BWD, bool LINEAR>
int launch(const float* coords, const float* in, const float* res,
           float* out, int64_t n, int d, int n_levels, int64_t level_stride,
           uint32_t table_size, int f, cudaStream_t stream) {
  switch (d) {
    case 1: launch_d<BWD, 1, LINEAR>(coords, in, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 2: launch_d<BWD, 2, LINEAR>(coords, in, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 3: launch_d<BWD, 3, LINEAR>(coords, in, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    case 4: launch_d<BWD, 4, LINEAR>(coords, in, res, out, n, n_levels, level_stride, table_size, f, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <bool BWD>
int run(const void* coords, const void* in, const void* resolutions,
        void* out, int64_t n, int d, int n_levels, int64_t level_stride,
        int64_t table_size, int f, int linear, void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(coords);
  const auto* i = static_cast<const float*>(in);
  const auto* r = static_cast<const float*>(resolutions);
  auto* o = static_cast<float*>(out);
  const auto ts = static_cast<uint32_t>(table_size);
  const int rc = linear
      ? launch<BWD, true>(c, i, r, o, n, d, n_levels, level_stride, ts, f, s)
      : launch<BWD, false>(c, i, r, o, n, d, n_levels, level_stride, ts, f, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
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
  return run<false>(coords, tables, resolutions, out, n, d, n_levels,
                    level_stride, table_size, f, linear, stream);
}

// coords (n, d) fp32, grad_out (n, n_levels * f) fp32, resolutions
// (n_levels,) fp32, grad_tables (n_levels, level_stride, f) fp32 and zero on
// entry; all contiguous on the device. Adds the gradient of the gather into
// grad_tables. Returns a cudaError_t value; 0 on a clean launch.
extern "C" int hash_encode_bwd(const void* coords, const void* grad_out,
                               const void* resolutions, void* grad_tables,
                               int64_t n, int d, int n_levels,
                               int64_t level_stride, int64_t table_size,
                               int f, int linear, void* stream) {
  return run<true>(coords, grad_out, resolutions, grad_tables, n, d, n_levels,
                   level_stride, table_size, f, linear, stream);
}
