// Pieces shared by the attention kernels on the TMA route, K4-fwd
// (flash_attention_fwd_tma.cu) and K3-bwd / K4-bwd
// (flash_attention_bwd_tma.cu): 4-D tensor maps over strided (B, H, N, D)
// bf16 views, loads of a box of rows of one head into a 64-wide swizzled
// panel, and the store of a warpgroup's accumulator as bf16 rows.

#pragma once

#include <initializer_list>

#include "attention_common.cuh"
#include "hopper_gemm.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// Where a tensor's (n, h, b) axes sit in its tensor map (dims 1..3, ordered
// by stride).
struct MapOrder {
  int n, h, b;
};

// A box of rows from `row` of head (b, h) of a (B, H, N, D) tensor, columns
// [64 p, 64 p + 64) of its head dim, into one panel (the box's rows are the
// map's, see bhnd_map).
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          MapOrder o, uint64_t* bar, int p,
                                          int row, int h, int b) {
  int c[4];
  c[0] = 64 * p;
  c[o.n] = row;
  c[o.h] = h;
  c[o.b] = b;
  hopper::tma_load_4d(dst, map, bar, c[0], c[1], c[2], c[3]);
}

// Stores a warpgroup's 64 x N accumulator, times `row_scale` of its two rows
// (1 for a gradient, 1 / l for attention's output), rounded to bf16, as rows
// [row0, row0 + 64) of a (n_rows, width) matrix whose rows are `ld`
// elements apart; rows past n_rows and columns past width (even) are
// dropped.
template <int N>
__device__ __forceinline__ void store_rows_bf16(bf16* dst,
                                                const float (&acc)[N / 2],
                                                int row0, int n_rows,
                                                int width, int ld,
                                                const float (&row_scale)[2]) {
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4, col0 = 2 * (t % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row >= n_rows) continue;
    bf16* to = dst + static_cast<int64_t>(row) * ld;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < width)
        *reinterpret_cast<uint32_t*>(to + col) =
            pack_bf16(acc[4 * j + 2 * h] * row_scale[h],
                      acc[4 * j + 2 * h + 1] * row_scale[h]);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_rows_bf16(bf16* dst,
                                                const float (&acc)[N / 2],
                                                int row0, int n_rows,
                                                int width) {
  const float one[2] = {1.0f, 1.0f};
  store_rows_bf16<N>(dst, acc, row0, n_rows, width, width, one);
}

// A tensor map over (B, H, N, D) bf16 with unit stride along D and the
// given element strides along B, H, N (multiples of 8), boxes of
// `box_rows` rows by 64 columns; dims 1..3 ordered by stride, their places
// in `order`.
bool bhnd_map(CUtensorMap* map, MapOrder* order, const void* base, int b,
              int h, int n, int d, int64_t sb, int64_t sh, int64_t sn,
              int box_rows) {
  struct Axis {
    int64_t stride;
    int extent, which;  // which: 0 = n, 1 = h, 2 = b
  } axes[3] = {{sn, n, 0}, {sh, h, 1}, {sb, b, 2}};
  for (int i = 1; i < 3; ++i)  // insertion sort, stable
    for (int j = i; j > 0 && axes[j].stride < axes[j - 1].stride; --j) {
      const Axis tmp = axes[j];
      axes[j] = axes[j - 1];
      axes[j - 1] = tmp;
    }
  uint64_t dims[4] = {static_cast<uint64_t>(d), 0, 0, 0};
  uint64_t strides[3];
  uint32_t box[4] = {64, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<uint64_t>(axes[i].extent);
    strides[i] = static_cast<uint64_t>(axes[i].stride) * 2;
    if (axes[i].which == 0) box[i + 1] = static_cast<uint32_t>(box_rows);
    slot[axes[i].which] = i + 1;
  }
  *order = MapOrder{slot[0], slot[1], slot[2]};
  return hopper_host::bf16_map(map, base, 4, dims, strides, box);
}

// The 64-wide panels that hold `d` columns of a head dim: the panels a
// TMA route loads (any further panels of its tiles stay unread where they
// feed the head-dim products, and feed only columns dropped at the store
// where they are a B operand).
__host__ __device__ __forceinline__ int head_panels(int d) {
  return (d + 63) / 64;
}

// The checks the TMA entries make of their q, k, v: head dims multiples of
// 8 up to `max_dim` (128 for K3, 256 for K4), B and H within the grid's y
// and z, strides positive multiples of 8 elements, and 16-byte-aligned
// bases (a null base passes).
bool bad_tma_inputs(int batch, int n_heads, int nq, int nk, int d_qk,
                    int d_v, const int64_t (&strides)[9],
                    std::initializer_list<const void*> bases,
                    int max_dim = 128) {
  bool bad = nq < 0 || nk < 1 || d_qk < 8 || d_qk > max_dim || d_qk % 8 ||
             d_v < 8 || d_v > max_dim || d_v % 8 || batch > 65535 ||
             n_heads > 65535;
  for (const int64_t s : strides) bad = bad || s < 1 || s % 8;
  for (const void* p : bases)
    bad = bad || reinterpret_cast<uintptr_t>(p) % 16;
  return bad;
}

}  // namespace
