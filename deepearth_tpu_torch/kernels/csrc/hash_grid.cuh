// The cell arithmetic of the multi-resolution hash grid, shared by K2-fwd
// (hash_encode.cu's per-table kernel and grid4d_encode.cu's whole Grid4D
// encode) and K2-bwd (hash_encode.cu). Every kernel that gathers or
// scatters a corner builds its row and weight here, so the backward
// scatters to exactly the rows, with exactly the weights, that the forward
// gathered, and the two forward kernels agree bit for bit.
//
// The operations are those of the plain PyTorch version
// (ops/hash_encoding.py _cell_corners) in the same order: floor(res * x)
// from one fp32 multiply, the XOR-prime hash in uint32, and the d-linear
// weight as a product over d = 0..D-1 of frac or 1 - frac. Round-to-nearest
// intrinsics keep the compiler from contracting a multiply-add.

#pragma once

#include <stdint.h>

namespace hash_grid {

__device__ __forceinline__ uint32_t hash_prime(int d) {
  // XOR-prime spatial hash (deepearth_tpu/ops/hash_encoding.py HASH_PRIMES)
  return d == 0 ? 1u : d == 1 ? 2654435761u : d == 2 ? 805459861u : 3674653429u;
}

// The cell of a point x on a level of resolution res: its lowest corner and
// the fractions of the way across it.
template <int D>
__device__ __forceinline__ void cell_position(const float (&x)[D], float res,
                                              int (&grid)[D],
                                              float (&frac)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float s = __fmul_rn(res, x[d]);
    const float fl = floorf(s);
    grid[d] = static_cast<int>(fl);
    frac[d] = __fsub_rn(s, fl);
  }
}

// Corner c of that cell (offset bit d = (c >> d) & 1): its row within the
// level's table and its d-linear weight (1 for nearest).
template <int D, bool LINEAR>
__device__ __forceinline__ void cell_corner(const int (&grid)[D],
                                            const float (&frac)[D], int c,
                                            uint32_t table_size, uint32_t& h,
                                            float& w) {
  uint32_t hc = 0;
  float wc = 1.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int bit = (c >> d) & 1;
    hc ^= static_cast<uint32_t>(grid[d] + bit) * hash_prime(d);
    if (LINEAR) wc = __fmul_rn(wc, bit ? frac[d] : __fsub_rn(1.0f, frac[d]));
  }
  const bool pow2 = (table_size & (table_size - 1)) == 0;
  h = pow2 ? (hc & (table_size - 1)) : (hc % table_size);
  w = wc;
}

}  // namespace hash_grid
