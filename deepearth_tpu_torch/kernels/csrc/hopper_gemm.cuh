// Hopper (sm_90a) building blocks for a warp-specialised GEMM mainloop:
// TMA tile loads into 128-byte-swizzled shared memory, completion on
// mbarriers, wgmma (m64n128k16, bf16 in, fp32 accumulate) on descriptors
// of those tiles, and the host-side encoding of the TMA tensor maps.
//
// Shared-memory tiles are what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B:
// rows of 128 bytes (64 bf16), the 16-byte chunks of row r at chunk
// c ^ (r % 8), each tile 1024-byte aligned. wgmma reads them in one of two
// canonical layouts (the descriptors below):
//  - K-major: the tile's rows are the M (or N) index, the 64 bf16 of a row
//    the reduction index. The k16 slice j starts 32 j bytes into the rows;
//    8-row groups are 1024 bytes apart (SBO).
//  - MN-major: the tile's rows are the reduction index, a row's 64 bf16
//    the M (or N) index. The k16 slice j starts 16 j rows (2048 j bytes)
//    in; 8-row groups 1024 bytes apart (SBO); further 64-wide M/N chunks
//    are further tiles, LBO bytes apart.
// The register-A form (wgmma_*_rs) takes A from registers in the fragment
// layout of mma.sync m16n8k16 (warp w of the warpgroup holding rows
// 16 w .. 16 w + 15): an fp32 accumulator of one product, rounded to bf16
// by wgmma_a_frag, is the A operand of the next.
// Used by K5-bwd's TMA route (grouped_matmul_bwd_tma.cu), K5-fwd's
// (grouped_matmul_tma.cu), K4-fwd's (flash_attention_fwd_tma.cu), K3-fwd's
// (attention_vmem_fwd_tma.cu), K3-bwd's and K4-bwd's
// (flash_attention_bwd_tma.cu), and K7's tensor-core route
// (quant_matmul_tc.cu: its ring and its uint8 tensor map).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kTileRowBytes = 128;  // one swizzled row: 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transfer to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spins until the phase of parity `parity` has completed. A wait of more
// than 2^34 clocks (~9 s) can only be a lost arrival: it traps, and the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA ----

// A box of the tensor map at (c0 innermost, c1) into shared memory,
// completing on `bar`; out-of-bounds elements arrive as zeros and count
// toward the transferred bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A box of shared memory to the tensor map at (c0 innermost, c1, c2);
// out-of-bounds elements are not written. Completes as a bulk group of the
// issuing thread: bulk_commit(), then bulk_wait_read() before the shared
// memory is written again, bulk_wait() before the block exits.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N bulk groups still read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads (wgmma, TMA) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `threads` threads, e.g. one warpgroup.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- wgmma ----

// Descriptor of a 128-byte-swizzled bf16 operand at `tile` (see the head
// of this file for LBO and SBO); layout type 1 = SWIZZLE_128B. The operand
// `bytes` further on (16-byte multiples) is desc + (bytes >> 4): shared
// addresses stay below 2^18, so the start-address field does not carry.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warp are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving the accumulator's registers across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register A operands: the compiler must not reuse their
// registers before the wgmma that reads them has completed.
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 128 fp32, the wgmma accumulator layout) += A (64 x 16) . B
// (16 x 128), bf16 operands read from shared memory through the
// descriptors; TransA / TransB 0 for a K-major operand, 1 for an MN-major
// one; scale_d 0: d = A . B, d's old values ignored. Asynchronous: complete
// after wgmma_commit() and wgmma_wait().
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// The accumulator of wgmma_m64n128k16 for thread t of the warpgroup:
// d[4 j + 2 h + e] is row 16 (t / 32) + (t % 32) / 4 + 8 h, column
// 8 j + 2 (t % 4) + e of the 64 x 128 tile (of any m64nN, N = 8 j_max).

// d (64 x 64 fp32) += A (64 x 16) . B (16 x 64), both from shared memory
// through descriptors, as wgmma_m64n128k16.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b,
                                                int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// d (64 x N fp32) += A . B, both from shared memory, N = 64 or 128.
template <int N, int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d = 1) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64)
    wgmma_m64n64k16<TransA, TransB>(d, a, b, scale_d);
  else
    wgmma_m64n128k16<TransA, TransB>(d, a, b, scale_d);
}

// d (64 x 64 fp32) += A (64 x 16, bf16 in registers: the fragment of
// wgmma_a_frag) . B (16 x 64, shared memory through its descriptor).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}

// d (64 x 128 fp32) += A (64 x 16, bf16 in registers: the fragment of
// wgmma_a_frag) . B (16 x 128, shared memory through its descriptor).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}


// d (64 x 32 fp32) += A (64 x 16, bf16 in registers: the fragment of
// wgmma_a_frag) . B (16 x 32, shared memory through its descriptor).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}

// d (64 x 48 fp32) += A (64 x 16, bf16 in registers: the fragment of
// wgmma_a_frag) . B (16 x 48, shared memory through its descriptor).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}

// d (64 x N fp32) += A (registers) . B, N = 32, 48, 64 or 128.
template <int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 32 || N == 48 || N == 64 || N == 128,
                "wgmma_rs: N is 32, 48, 64 or 128");
  if constexpr (N == 32)
    wgmma_m64n32k16_rs<TransB>(d, a, b);
  else if constexpr (N == 48)
    wgmma_m64n48k16_rs<TransB>(d, a, b);
  else if constexpr (N == 64)
    wgmma_m64n64k16_rs<TransB>(d, a, b);
  else
    wgmma_m64n128k16_rs<TransB>(d, a, b);
}

// d (64 x N fp32) += A (registers) . B, N = 32, 48, 64, 128, 192 or 256,
// the B operand MN-major in 64-column panels. Above 128 columns as two
// products over the same A: columns [0, 128) from b, [128, N) from b
// advanced by `hi` (the byte offset of B's column 128, >> 4). The two
// halves of d are the register layout of one m64nN accumulator.
template <int N, int TransB>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b, uint64_t hi) {
  if constexpr (N <= 128) {
    wgmma_rs<N, TransB>(d, a, b);
  } else {
    static_assert(N == 192 || N == 256, "wgmma_rs_cols: N is 192 or 256");
    wgmma_rs<128, TransB>(*reinterpret_cast<float(*)[64]>(&d[0]), a, b);
    wgmma_rs<N - 128, TransB>(
        *reinterpret_cast<float(*)[N / 2 - 64]>(&d[64]), a, b + hi);
  }
}

// The register A operand of columns 16 t .. 16 t + 15 of an accumulator
// (its 8-column groups 2 t and 2 t + 1), rounded to bf16.
template <int N>
__device__ __forceinline__ void wgmma_a_frag(uint32_t (&a)[4],
                                             const float (&d)[N], int t) {
  const float* lo = d + 8 * t;  // group 2 t: d[8 t .. 8 t + 3]
  const __nv_bfloat162 v0 = __floats2bfloat162_rn(lo[0], lo[1]);
  const __nv_bfloat162 v1 = __floats2bfloat162_rn(lo[2], lo[3]);
  const __nv_bfloat162 v2 = __floats2bfloat162_rn(lo[4], lo[5]);
  const __nv_bfloat162 v3 = __floats2bfloat162_rn(lo[6], lo[7]);
  a[0] = *reinterpret_cast<const uint32_t*>(&v0);
  a[1] = *reinterpret_cast<const uint32_t*>(&v1);
  a[2] = *reinterpret_cast<const uint32_t*>(&v2);
  a[3] = *reinterpret_cast<const uint32_t*>(&v3);
}

// `bytes` (a multiple of 16) of shared memory at `src` to global memory at
// `dst` (both 16-byte aligned), without a tensor map; completes as a bulk
// group of the issuing thread, as tma_store_3d.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// The registers a thread of this warpgroup may hold, raised or lowered to N
// (a multiple of 8, 24..256); every warp of the warpgroup executes the
// same one. A block launched with R registers a thread can raise some
// warpgroups above R by what others give up: a producer warpgroup that
// drops to 40 lets two consumer warpgroups rise from 168 to 232. The
// branch to each role must be warp-uniform as the compiler sees it (a
// role taken through __shfl_sync) for ptxas to allocate it apart.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -------------------------------------------------------------- the ring ----

// A ring of `Stages` stages in dynamic shared memory, fed by TMA: full[s]
// completes when stage s has landed, empty[s] when its consumers have
// released it.
template <int Stages>
struct Ring {
  uint8_t* tiles;  // the stages, then `extra` bytes, 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
};

// Dynamic shared memory for `stages` stages of `stage_bytes` and `extra`
// bytes after them, with room to align and the barriers.
constexpr int ring_smem_bytes(int stages, int stage_bytes, int extra) {
  return stages * stage_bytes + extra + 1024 + 2 * stages * 8;
}

// The ring at `raw`, 1024-byte aligned for the swizzle, its barriers after
// the stages and `extra` bytes; thread 0 initialises them (full: `full_count`
// arrivals a round, empty: `empty_count`), made visible by the caller's
// __syncthreads.
template <int Stages>
__device__ Ring<Stages> make_ring(uint8_t* raw, int stage_bytes, int extra,
                                  int full_count, int empty_count) {
  const uint32_t base = smem_u32(raw);
  uint8_t* tiles = raw + ((1024 - (base & 1023)) & 1023);
  Ring<Stages> ring{tiles, reinterpret_cast<uint64_t*>(
                               tiles + Stages * stage_bytes + extra),
                    nullptr};
  ring.empty = ring.full + Stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&ring.full[s], full_count);
      mbar_init(&ring.empty[s], empty_count);
    }
    fence_barrier_init();
  }
  return ring;
}

// A position in the ring: stage and the parity of its current round.
template <int Stages>
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == Stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// After a wgmma group has read its stage: releases the stage (lane 0 of
// each consumer warp arrives).
template <int Stages>
__device__ __forceinline__ void release(Ring<Stages>& ring, int stage) {
  if (threadIdx.x % 32 == 0) mbar_arrive(&ring.empty[stage]);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

}  // namespace hopper

// ------------------------------------------------------------------ host ----

namespace hopper_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query: the library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a row-major tensor of `rank` (2 to 5) dims of `type`,
// given innermost first with their row strides in bytes (rank - 1 of them,
// multiples of 16), read in boxes of `box` elements (box[0] one swizzled
// row: 128 bytes), 128-byte swizzled, zeros out of bounds. Encoded on the
// host per call: no device work, no synchronisation.
inline bool tiled_map(CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, int rank, const uint64_t* dims,
                      const uint64_t* strides, const uint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  // the encoder (a driver-API call) needs a current context; a thread
  // whose first CUDA call this is (autograd's backward thread, at its first
  // node) has none until the runtime binds its device's primary context
  int device = 0;
  if (encode == nullptr || cudaGetDevice(&device) != cudaSuccess ||
      cudaSetDevice(device) != cudaSuccess)
    return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = strides[i];
  }
  return encode(map, type, rank, const_cast<void*>(base), d, s, b, e,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tiled_map over bf16 (box[0] = 64 elements).
inline bool bf16_map(CUtensorMap* map, const void* base, int rank,
                     const uint64_t* dims, const uint64_t* strides,
                     const uint32_t* box) {
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                   strides, box);
}

inline int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return sms;
}

// 2-D map over a row-major (rows, cols) bf16 matrix, boxes of 64 columns
// by `box_rows` rows.
inline bool matrix_map(CUtensorMap* map, const void* base, int rows,
                       int cols, int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * 2};
  const uint32_t box[2] = {64, static_cast<uint32_t>(box_rows)};
  return bf16_map(map, base, 2, dims, strides, box);
}

// One persistent block of `threads` per SM, or per tile where there are
// fewer tiles.
template <typename... Params, typename... Args>
int launch_persistent(void (*kernel)(Params...), int tiles, int threads,
                      int smem, cudaStream_t stream, Args... args) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<tiles < sms ? tiles : sms, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper_host
