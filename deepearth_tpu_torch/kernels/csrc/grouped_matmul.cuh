// What the grouped matmul's kernels share (K5-fwd in grouped_matmul.cu and
// grouped_matmul_tma.cu, K5-bwd in grouped_matmul_bwd.cu and
// grouped_matmul_bwd_tma.cu): the on-device walk from a block to its rows
// of expert-sorted lhs, and the staging width of a row.
//
// Group g holds rows [offset_g, offset_g + size_g), offset_g the sum of the
// sizes before g, every bound cut at M; a negative size counts as 0. The
// sizes stay on the device: each block reads them itself, so no launch
// waits for the host.

#pragma once

#include "attention_common.cuh"

namespace {

constexpr int kMaxGroups = 1024;

// The row segment of the block's tile: rows [lo, hi) of group g, or g = -1
// for the zero-filled rows past the last group; lo == hi for a surplus
// block.
struct TileRows {
  int g, lo, hi;
};

// Row tiles of BM rows per group, blockIdx.x the tile: group g owns
// ceil(size_g / BM) tiles from its own first row, so no tile mixes two
// groups, and the rows past the last group form one more segment. That is
// at most ceil(M / BM) + E tiles; the host launches that many and the
// surplus blocks get lo == hi. Thread 0 walks the sizes (staged in shared
// memory by the whole block); every thread gets the result through shared
// memory.
template <int BM>
__device__ TileRows find_tile(const int* group_sizes, int n_groups, int m) {
  __shared__ int sizes[kMaxGroups];
  __shared__ TileRows found;
  for (int e = threadIdx.x; e < n_groups; e += blockDim.x)
    sizes[e] = group_sizes[e];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = blockIdx.x;
    TileRows r{-1, 0, 0};
    int tiles = 0, start = 0;
    bool done = false;
    for (int e = 0; e <= n_groups && !done; ++e) {
      // e == n_groups: the rows past the last group, written as zeros
      const int size = e < n_groups ? max(sizes[e], 0) : m - start;
      const int64_t stop = static_cast<int64_t>(start) + size;
      const int end = stop < m ? static_cast<int>(stop) : m;
      const int n_tiles = (end - start + BM - 1) / BM;
      if (t < tiles + n_tiles) {
        const int lo = start + (t - tiles) * BM;
        r = TileRows{e < n_groups ? e : -1, lo, min(lo + BM, end)};
        done = true;
      }
      tiles += n_tiles;
      start = end;
    }
    found = r;
  }
  __syncthreads();
  return found;
}

// find_tile's walk as tables, for a persistent block that walks many row
// tiles of BM rows: tile_start[e] the first row tile of group e (e =
// n_groups: the rows past the last group), row_start[e] its first row;
// tile_start[n_groups + 1] the number of row tiles, row_start[n_groups + 1]
// = m. `sizes` are the group sizes, already clamped at 0. One thread fills
// them.
template <int BM>
__device__ void row_tile_tables(const int* sizes, int n_groups, int m,
                                int* tile_start, int* row_start) {
  int start = 0, tiles = 0;
  for (int e = 0; e <= n_groups; ++e) {
    tile_start[e] = tiles;
    row_start[e] = start;
    const int64_t stop =
        static_cast<int64_t>(start) + (e < n_groups ? sizes[e] : m - start);
    const int end = stop < m ? static_cast<int>(stop) : m;
    tiles += (end - start + BM - 1) / BM;
    start = end;
  }
  tile_start[n_groups + 1] = tiles;
  row_start[n_groups + 1] = m;
}

// Row tile `rt` of those tables: rows [lo, hi) of group g, g = -1 for the
// rows past the last group.
template <int BM>
__device__ __forceinline__ TileRows row_tile(int rt, const int* tile_start,
                                             const int* row_start,
                                             int n_groups) {
  int lo = 0, hi = n_groups;  // the last e with tile_start[e] <= rt
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_start[mid] <= rt)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int first = row_start[lo] + (rt - tile_start[lo]) * BM;
  return TileRows{lo < n_groups ? lo : -1, first,
                  min(first + BM, row_start[lo + 1])};
}

// The widest staging load for rows `ld` elements apart from a base pointer,
// in elements: 16 bytes (cp.async) where the rows and the base allow it,
// else for bf16 2 elements (stage_rows' 4-byte moves), else 1.
template <typename T>
int row_vec(const void* base, int64_t ld) {
  const int widest[2] = {static_cast<int>(16 / sizeof(T)),
                         sizeof(T) == 2 ? 2 : 0};
  for (const int vec : widest)
    if (vec > 1 && ld % vec == 0 &&
        reinterpret_cast<uintptr_t>(base) % (sizeof(T) * vec) == 0)
      return vec;
  return 1;
}

}  // namespace
